"""A CPU emulation of ``csrc/nms.cu``'s walk against the Pallas kernel.

The CUDA kernel runs only on a card; this file repeats, in numpy, what
each CTA and each thread of it does: the band and halo rows it stages
(widened to 16-byte boundaries on the aligned path, -inf outside the
plane), the 4 consecutive cells each thread makes from the staged tile
(five compares a cell, no NaN-propagating maximum), and where it stores
them. It
holds the result bit for bit against
``torch_ekpose_tpu/ops/pallas_nms.py::masked_peak_scores`` in interpret
mode and against the port's twin, and checks that every cell is written
exactly once, that no read leaves the staged tile or the plane, and that
the aligned path's copies and stores are 16-byte aligned.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from torch_ekpose_tpu.ops import pallas_nms  # noqa: E402
import torch_port_inputs as inputs  # noqa: E402
from torch_ekpose_tpu_torch.ops import nms  # noqa: E402

torch.set_num_threads(2)  # xdist already runs one process per core

NEG = np.float32(-np.inf)


def emulate(storage, shape, strides, thresh, aligned):
    """The kernel's walk over ``[b, c, h, w]`` maps with dense planes at
    ``strides`` (elements) in flat float32 ``storage``. Returns the dense
    output and how often each of its cells was written."""
    b, c, h, w = shape
    plan = nms.plan_nms(b, c, h, w, aligned)
    assert plan.threads % 32 == 0 and plan.threads <= nms.MAX_THREADS
    assert plan.smem_bytes <= nms.MAX_SMEM_BYTES
    t = np.float32(thresh)
    hw = h * w
    out = np.zeros(b * c * hw, np.float32)
    writes = np.zeros(b * c * hw, np.int64)
    tid = np.arange(plan.threads)
    for bi in range(b):
        for ci in range(c):
            start = bi * strides[0] + ci * strides[1]
            plane = storage[start:start + hw]
            assert plane.size == hw
            out_start = (bi * c + ci) * hw
            if aligned:
                assert start % 4 == 0 and out_start % 4 == 0
            for band in range(plan.n_bands):
                y0 = band * plan.band_rows
                y1 = min(h, y0 + plan.band_rows)
                assert y0 < h
                # staging: rows y0 - 1 .. y1, -inf outside the plane
                lo, hi = (y0 - 1) * w, (y1 + 1) * w
                if aligned:
                    lo, hi = lo & ~3, (hi + 3) & ~3
                in_lo, in_hi = max(lo, 0) - lo, min(hi, hw) - lo
                assert (hi - lo) * 4 <= plan.smem_bytes
                # the allocation past the staged span holds garbage
                tile = np.full(plan.smem_bytes // 4, np.nan, np.float32)
                tile[:hi - lo] = NEG
                if aligned:
                    assert in_lo % 4 == 0 and in_hi % 4 == 0
                    for i in range(in_lo, in_hi, 4):   # 16-byte copies
                        assert (start + lo + i) % 4 == 0
                        tile[i:i + 4] = plane[lo + i:lo + i + 4]
                else:
                    tile[in_lo:in_hi] = plane[lo + in_lo:lo + in_hi]
                base, cells = y0 * w, (y1 - y0) * w
                if aligned:
                    assert base % 4 == 0 and cells % 4 == 0
                for it in range(-(-cells // (4 * plan.threads))):
                    rel = 4 * (tid + it * plan.threads)
                    rel = rel[rel < cells]
                    cell = base + rel - lo          # index in the tile
                    if aligned:
                        assert (cell % 4 == 0).all()
                    v = [tile[cell + k - 1] for k in range(6)]
                    x = rel % w
                    for k in range(4):
                        ok = rel + k < cells
                        assert aligned is False or ok.all()
                        # a cell that is written reads only staged cells
                        for r in (cell + k, cell + k - 1, cell + k + 1,
                                  cell + k - w, cell + k + w):
                            assert (r[ok] >= 0).all() and \
                                (r[ok] < hi - lo).all()
                        m = v[k + 1]
                        with np.errstate(invalid="ignore"):
                            peak = ((m > t) & (m >= tile[cell + k - w])
                                    & (m >= tile[cell + k + w])
                                    & ((x == 0) | (m >= v[k]))
                                    & ((x + 1 == w) | (m >= v[k + 2])))
                        dst = out_start + (base + rel + k)[ok]
                        out[dst] = np.where(peak, m, NEG)[ok]
                        writes[dst] += 1
                        x = np.where(x + 1 == w, 0, x + 1)
    return out.reshape(shape), writes.reshape(shape)


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


#: every case on the 4-byte path, and on the 16-byte path where its
#: planes allow it (H * W % 4 == 0), as the wrapper picks it
WALKS = [(label, aligned) for label, (shape, _, _) in inputs.NMS_CASES.items()
         for aligned in (True, False)
         if not aligned or (shape[2] * shape[3]) % 4 == 0]


@pytest.mark.parametrize("label,aligned", WALKS,
                         ids=[f"{label}-{'16B' if a else '4B'}"
                              for label, a in WALKS])
def test_walk_equals_pallas(label, aligned):
    full = inputs.nms_case(np.random.default_rng(11), label)
    shape, keep, _ = inputs.NMS_CASES[label]
    maps = torch.from_numpy(full)[:, :keep] if keep else \
        torch.from_numpy(full)
    b, c, h, w = maps.shape
    assert nms.is_aligned(maps) == ((h * w) % 4 == 0)
    got, writes = emulate(full.reshape(-1), tuple(maps.shape),
                          maps.stride()[:2], inputs.NMS_THRESH, aligned)
    assert (writes == 1).all()
    dense = np.ascontiguousarray(maps.numpy())
    want = np.asarray(pallas_nms.masked_peak_scores(
        jnp.asarray(dense.reshape(b * c, h, w)), inputs.NMS_THRESH,
        interpret=True))
    np.testing.assert_array_equal(_bits(got), _bits(want.reshape(dense.shape)))
    twin = nms.masked_peak_scores(maps, inputs.NMS_THRESH).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(twin))
    if label.endswith("specials"):
        assert np.isnan(dense).any() and (dense == np.float32(
            inputs.NMS_THRESH)).any() and np.signbit(dense[dense == 0]).any()
        assert np.isfinite(got).sum() > 100


def test_plan_at_the_decode_shape():
    """The serving decode's [8, 18, 46, 54]: 6 bands of 8 rows (the last
    6; a band starts on a 16-byte boundary: 54 cells a row, so an even
    row), 864 CTAs of 128 threads, all resident in one wave on 132 SMs."""
    plan = nms.plan_nms(8, 18, 46, 54, aligned=True)
    assert plan == nms.NmsPlan(8, 6, 128, ((8 + 2) * 54 + 8) * 4)
    ctas = 8 * 18 * plan.n_bands
    per_sm = min(2048 // plan.threads, 32, 228 * 1024 // plan.smem_bytes)
    assert ctas == 864 and ctas <= nms.N_SMS * per_sm
    assert nms.plan_nms(8, 18, 46, 54, aligned=False).band_rows == 8
    assert nms.plan_nms(8, 18, 45, 53, aligned=False).band_rows == 8
    assert nms.plan_nms(2, 3, 12, 33, aligned=True).band_rows == 8  # 6 -> 8
    assert nms.plan_nms(1, 1, 1, 1, aligned=False) == nms.NmsPlan(
        1, 1, 32, (3 + 8) * 4)
    # a plane too wide for 3 rows in 48 KB is refused, not sent elsewhere
    with pytest.raises(ValueError, match="shared memory"):
        nms.plan_nms(1, 1, 4, 5000, aligned=False)


def test_is_aligned_reads_base_and_strides():
    x = torch.zeros(2, 19, 46, 54)
    assert nms.is_aligned(x[:, :18]) and nms.is_aligned(x)
    assert nms.is_aligned(x[:, 1:])              # planes of 9,936 B
    assert not nms.is_aligned(torch.zeros(3, 5, 45, 53))
    flat = torch.zeros(1 + 2 * 4 * 8 * 8)
    assert not nms.is_aligned(flat[1:].view(2, 4, 8, 8))   # base off by 4 B


def test_phase_probes_fit_the_kernel():
    """``scripts/profile_torch_nms.py``'s probes find each of their
    anchors in ``csrc/nms.cu`` once, so the per-phase profile stays
    buildable as the kernel changes."""
    import importlib.util
    import os

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        os.pardir)
    spec = importlib.util.spec_from_file_location(
        "profile_torch_nms",
        os.path.join(root, "scripts", "profile_torch_nms.py"))
    prof = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(prof)
    with open(prof.SOURCE) as f:
        kernel = f.read()
    src = prof.instrumented_source(kernel)
    assert src.count("clock64()") == 3 and src.count("%%globaltimer") == 2
    assert src.count("long long* prof") == 2
    assert src.count("thresh, prof);") == 2
    with pytest.raises(ValueError, match="anchor"):
        prof.instrumented_source(kernel.replace(
            "  __syncthreads();\n\n  // A thread", "  // A thread"))
