"""The port's batched decode against the JAX package's.

``torch_ekpose_tpu_torch.decode.device.decode_batched`` (CPU: the kernel
twins) against ``decode_jax_batched(..., use_pallas_loops=False)`` on the
same maps. Integer fields of the packed buffer must be equal; the float
fields (peak scores, person score sums) within rtol 1e-6, a few f32 ulps
for a sum of ~20 terms (on these scenes they are in fact equal). The
people must also equal JAX's and the numpy oracle's, and every scene with
people in it must decode at least one, so no comparison passes on two
empty lists.
"""

import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from torch_ekpose_tpu.config import Config  # noqa: E402
from torch_ekpose_tpu.data import gen_targets_np  # noqa: E402
from torch_ekpose_tpu.decode import device as D  # noqa: E402
from torch_ekpose_tpu.decode import oracle  # noqa: E402
from torch_ekpose_tpu.decode.synthetic import (  # noqa: E402
    canonical_humans,
    synth_scene,
)
import torch_port_inputs as inputs  # noqa: E402
from torch_ekpose_tpu_torch.decode import device as PD  # noqa: E402

torch.set_num_threads(2)  # xdist already runs one process per core

GY, GX, STRIDE = 46, 46, 8
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_decode_golden.npz")
OFFSETS = np.array([
    (0, -95), (0, -70), (-25, -70), (-32, -35), (-36, 0), (25, -70),
    (32, -35), (36, 0), (-18, 0), (-20, 45), (-20, 90), (18, 0),
    (20, 45), (20, 90), (-8, -103), (8, -103), (-17, -99), (17, -99),
])


@pytest.fixture(scope="module")
def small_cfg():
    cfg = Config()
    # the JAX decode tests' small capacities (K = 8, 24 person rows)
    cfg.DECODE.max_peaks_per_part = 8
    cfg.DECODE.max_people = 8
    return cfg


def _people_scene(rng, n_people, scale=(0.5, 0.9), noise=0.015, vis=0.9):
    """gen_targets_np people with noise, as tests/test_decode_device.py
    draws them."""
    kpts = np.zeros((n_people, 18, 3))
    for p in range(n_people):
        cx, cy = rng.uniform(80, 290), rng.uniform(120, 250)
        s = rng.uniform(*scale)
        kpts[p, :, :2] = (np.array([cx, cy]) + OFFSETS * s
                          + rng.normal(0, 3, (18, 2)))
        kpts[p, :, 2] = rng.choice([0, 2], size=18, p=[1 - vis, vis])
    heat, pafs = gen_targets_np(kpts, GY, GX, STRIDE, 7.0)
    heat = (heat + rng.normal(0, noise, heat.shape)).astype(np.float32)
    pafs = (pafs + rng.normal(0, noise, pafs.shape)).astype(np.float32)
    return heat, pafs


def _straddle_scene(cfg):
    """Isolated peaks at, just above and just below THRESH_HEATMAP and
    PAF noise at THRESH_PAF (tests/test_decode_device.py); no people."""
    rng = np.random.default_rng(77)
    heat = np.zeros((GY, GX, 19), dtype=np.float32)
    thr = cfg.TEST.THRESH_HEATMAP
    spots = [(8, 8, thr + 0.05), (8, 30, thr + 0.004), (30, 8, thr - 0.004),
             (30, 30, thr + 0.2), (20, 20, thr + 0.11)]
    for j, (y, x, v) in enumerate(spots):
        heat[y, x, j % 18] = v
        heat[y - 1, x, j % 18] = v * 0.5
        heat[y, x - 1, j % 18] = v * 0.5
    heat[..., 18] = np.clip(1 - heat[..., :18].max(-1), 0, 1)
    heat += rng.normal(0, 0.001, heat.shape).astype(np.float32)
    pafs = rng.normal(0, cfg.TEST.THRESH_PAF, (GY, GX, 38)).astype(np.float32)
    return heat, pafs


def _decode_both(heat, pafs, cfg):
    """(port packed, JAX packed) for [B, H, W, C] maps."""
    port = PD.build_packed_decoder(cfg)(
        torch.from_numpy(heat), torch.from_numpy(pafs)).numpy()
    ref = np.asarray(D.build_packed_decoder(cfg, batched=True, pallas=False)(
        jnp.asarray(heat), jnp.asarray(pafs)))
    return port, ref


def _assert_same(heat, pafs, cfg, min_people, vs_oracle=True):
    port, ref = _decode_both(heat, pafs, cfg)
    k, cap = cfg.DECODE.max_peaks_per_part, cfg.DECODE.max_people * 3
    assert inputs.packed_mismatches(port, ref, k, cap, rtol=1e-6) == []
    up_h, up_w = heat.shape[1] * STRIDE, heat.shape[2] * STRIDE
    for i in range(len(heat)):
        got = PD.packed_to_humans(port[i], up_h, up_w, cfg)
        want = D.packed_to_humans(ref[i], up_h, up_w, cfg)
        assert canonical_humans(got) == canonical_humans(want)
        assert len(got) >= min_people
        if min_people:
            np.testing.assert_allclose(
                sorted(h.score for h in got), sorted(h.score for h in want),
                rtol=1e-6)
        if min_people and vs_oracle:
            oracle_humans = oracle.paf_to_pose_numpy(heat[i], pafs[i], cfg)
            assert canonical_humans(got) == canonical_humans(oracle_humans)
    return port


def test_decode_matches_jax_random_scenes(small_cfg):
    rng = np.random.default_rng(100)
    scenes = [_people_scene(rng, int(rng.integers(1, 4))) for _ in range(4)]
    _assert_same(np.stack([s[0] for s in scenes]),
                 np.stack([s[1] for s in scenes]), small_cfg, min_people=1)


@pytest.mark.parametrize("seed", range(2))
def test_decode_matches_jax_crowded(small_cfg, seed):
    """Nine overlapping people saturate K = 8 peaks per part. The numpy
    oracle keeps every peak (the reference's unbounded assembler), so the
    people are held against JAX's decode only."""
    rng = np.random.default_rng(seed + 500)
    heat, pafs = _people_scene(rng, 9, scale=(0.3, 0.5), noise=0.02, vis=1.0)
    port = _assert_same(heat[None], pafs[None], small_cfg, min_people=1,
                        vs_oracle=False)
    res = PD.unpack_result(port[0], 8, 24)
    assert PD.cap_saturation(res)[0]


def test_decode_matches_jax_threshold_straddle(small_cfg):
    """Peaks straddling the heatmap threshold, PAFs around the PAF
    threshold: the accept/reject boundaries agree. The scene has no
    people, so this one checks the peaks found instead."""
    heat, pafs = _straddle_scene(small_cfg)
    port = _assert_same(heat[None], pafs[None], small_cfg, min_people=0)
    res = PD.unpack_result(port[0], 8, 24)
    assert res.peak_valid.sum() == 4      # the spot below thresh drops


def test_decode_matches_jax_dim_people(small_cfg):
    """People whose joint peaks straddle the heatmap threshold (maps
    scaled so the Gaussians top out near it)."""
    rng = np.random.default_rng(42)
    scenes = [_people_scene(rng, 2, noise=0.004) for _ in range(2)]
    heat = np.stack([s[0] for s in scenes])
    heat[..., :18] *= np.float32(small_cfg.TEST.THRESH_HEATMAP + 0.02)
    _assert_same(heat, np.stack([s[1] for s in scenes]), small_cfg,
                 min_people=1)


def test_decode_matches_jax_synth_scenes(small_cfg):
    """decode/synthetic.py scenes (noise-free, with subnormal Gaussian
    tails) and an empty frame in one batch."""
    rng = np.random.default_rng(3)
    scenes = [synth_scene(rng, n) for n in (1, 2, 4)]
    heat = np.stack([s[0] for s in scenes] + [np.zeros_like(scenes[0][0])])
    pafs = np.stack([s[1] for s in scenes] + [np.zeros_like(scenes[0][1])])
    port, ref = _decode_both(heat, pafs, small_cfg)
    assert inputs.packed_mismatches(port, ref, 8, 24, rtol=1e-6) == []
    counts = [len(PD.packed_to_humans(row, 368, 432, small_cfg))
              for row in port]
    assert min(counts[:3]) >= 1 and counts[3] == 0


@pytest.mark.parametrize("seed", range(5))
def test_decode_matches_jax_synth_seeds_every_slot(seed):
    """decode/synthetic.py scenes at the default config (K = 32, so most
    peak slots hold no peak and refine a patch of Gaussian tails near the
    float32 normal limit): every field of the packed buffer, the unused
    slots' refined coordinates too, against
    ``decode_jax_batched(..., use_pallas_loops=False)``; integer fields
    exact, float fields within rtol 1e-5; people found. The refinement's
    two bicubic products must flush as XLA's dot does for this."""
    rng = np.random.default_rng(seed)
    scenes = [synth_scene(rng, n) for n in (1, 3, 2)]
    heat = np.stack([s[0] for s in scenes])
    pafs = np.stack([s[1] for s in scenes])
    cfg = Config()
    port, ref = _decode_both(heat, pafs, cfg)
    k, cap = cfg.DECODE.max_peaks_per_part, cfg.DECODE.max_people * 3
    assert inputs.packed_mismatches(port, ref, k, cap, rtol=1e-5) == []
    people = [len(PD.packed_to_humans(row, 368, 432, cfg)) for row in port]
    assert min(people) >= 1, people


def test_addcmul_is_one_fma_on_the_cpu():
    """The refinement's emulation of XLA's dot (decode/device.py::
    _xla_dot5) needs ``torch.addcmul`` to round once, as an fma does: on
    the CPU its result equals s + a * b rounded once (computed exactly in
    float64 with a round-to-odd step), and two roundings differ."""
    s, a, b = inputs.fma_operands("cpu")
    want = inputs.fma_once(s, a, b)
    assert torch.equal(torch.addcmul(s, a, b), want)
    assert not torch.equal(s + a * b, want)


def _load_golden_script():
    spec = importlib.util.spec_from_file_location(
        "make_torch_golden",
        os.path.join(ROOT, "scripts", "make_torch_golden.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_golden_file_is_current():
    """The committed golden decode equals a fresh run of
    scripts/make_torch_golden.py, and every scene has people."""
    fresh = _load_golden_script().make_golden()
    committed = np.load(GOLDEN)
    assert sorted(committed.files) == sorted(fresh)
    for name, value in fresh.items():
        np.testing.assert_array_equal(committed[name], value, err_msg=name)
    assert (committed["n_humans"] >= 1).all()
    assert os.path.getsize(GOLDEN) < 1 << 20


def test_port_decode_matches_golden():
    """The port's CPU decode of the golden scenes at the default config
    (K = 32, 96 person rows), as chip_smoke.py checks it on the card."""
    golden = np.load(GOLDEN)
    cfg = Config()
    got = PD.build_packed_decoder(cfg)(
        torch.from_numpy(golden["heatmaps"]),
        torch.from_numpy(golden["pafs"])).numpy()
    assert inputs.packed_mismatches(
        got, golden["packed"], 32, 96, rtol=1e-6) == []
    counts = [len(PD.packed_to_humans(row, 368, 432, cfg)) for row in got]
    assert counts == golden["n_humans"].tolist()


def test_pack_unpack_roundtrip(small_cfg):
    """unpack_result inverts pack_result field by field."""
    rng = np.random.default_rng(5)
    heat, pafs = _people_scene(rng, 2)
    res = PD.decode_batched(torch.from_numpy(heat[None]),
                            torch.from_numpy(pafs[None]),
                            max_peaks=8, subset_cap=24)
    packed = PD.pack_result(res).numpy()
    back = PD.unpack_result(packed[0], 8, 24)
    for name in PD.DecodeResult._fields:
        np.testing.assert_array_equal(
            getattr(back, name), getattr(res, name)[0].numpy(), err_msg=name)
    assert back.peak_xy.dtype == np.int32 and back.peak_valid.dtype == bool
