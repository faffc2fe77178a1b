"""The port's CUDA kernels on a card: each decode kernel against its plain
PyTorch twin at the decode path's shapes (exact), the decode against the
JAX package's golden file, and the VGG-prefix conv kernels against their
twins (float32 within 1e-4 of max|twin| with TF32 off: the sums run in
another order; bf16 within 0.02 of max|twin|: one sum-order difference
can move a value across a bf16 rounding boundary, and the next layer
carries it on), on each of ``conv_chain``'s routes (``-k sm90`` picks the
TMA + wgmma one, ``-k f32`` the float32 one), and an AOT artifact's
CUDA-graph replay against its programs run op by op (``-k aot``).

Marked ``gpu``; they skip without a card (the decision is made in a
fixture, so every xdist worker collects the same tests). The file
imports no JAX, so it runs on a machine without it. From the repo root:

    python -m pytest -m gpu --noconftest tests/test_torch_gpu.py

(``--noconftest``: ``tests/conftest.py`` configures JAX.)
"""

import contextlib
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_ekpose_tpu_torch.config import Config  # noqa: E402
import torch_port_inputs as inputs  # noqa: E402
from torch_ekpose_tpu_torch.decode import device as PD  # noqa: E402
from torch_ekpose_tpu_torch.models.vgg import (  # noqa: E402
    PREFIX_END, VGG19Backbone, chain_params)
from torch_ekpose_tpu_torch.ops import block1, conv_chain as cc  # noqa: E402
from torch_ekpose_tpu_torch.ops import match, merge, nms  # noqa: E402

pytestmark = pytest.mark.gpu

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "torch_decode_golden.npz")
B, K, CAP = 8, 32, 96


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels run only there)")
    return torch.device("cuda")


def _kernel_vs_twin(kernel, twin, *args):
    before = kernel.launches
    got = kernel(*args)
    want = twin(*args)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and g.dtype == w.dtype
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    return got


@pytest.mark.parametrize("seed", range(2))
def test_nms_kernel_equals_twin(cuda, seed):
    maps = torch.from_numpy(inputs.nms_maps(
        np.random.default_rng(seed), B, 19, 46, 54)).to(cuda)
    (out,) = _kernel_vs_twin(nms.masked_peak_scores,
                             nms.masked_peak_scores_torch, maps[:, :18], 0.25)
    assert out.shape == (B, 18, 46, 54) and torch.isinf(out).any()


@pytest.mark.parametrize("label", list(inputs.NMS_CASES))
def test_nms_kernel_walk_cases_bit_equal(cuda, label):
    """The shapes of tests/test_torch_nms_walk.py on the card, bit for bit
    (-0.0 and all): on the path the wrapper picks, and, for planes that
    take the 16-byte path, once more from a base 4 bytes off, which takes
    the 4-byte path. Each call launches the kernel once."""
    full = inputs.nms_case(np.random.default_rng(11), label)
    shape, keep, _ = inputs.NMS_CASES[label]
    dense = torch.from_numpy(full).to(cuda)
    shifted = torch.empty(dense.numel() + 1, device=cuda)[1:].view(shape)
    shifted.copy_(dense)
    for base in [dense] + ([shifted] if nms.is_aligned(dense) else []):
        maps = base[:, :keep] if keep else base
        assert nms.is_aligned(maps) == (base is dense
                                        and (shape[2] * shape[3]) % 4 == 0)
        before = nms.masked_peak_scores.launches
        got = nms.masked_peak_scores(maps, inputs.NMS_THRESH)
        want = nms.masked_peak_scores_torch(maps, inputs.NMS_THRESH)
        torch.cuda.synchronize()
        assert nms.masked_peak_scores.launches == before + 1
        assert got.shape == want.shape and got.is_contiguous()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_device_backend_on_card_equals_cpu(cuda):
    """``decode/api.py``'s ``"device"`` backend takes numpy maps to the
    card and finds the people the CPU twins find on a golden scene."""
    from torch_ekpose_tpu_torch.decode import api

    golden = np.load(GOLDEN)
    heat, pafs = golden["heatmaps"][0], golden["pafs"][0]
    launches = nms.masked_peak_scores.launches
    on_card = api.paf_to_pose(heat, pafs, backend="device")
    assert nms.masked_peak_scores.launches == launches + 1
    on_cpu = api.paf_to_pose(heat, pafs, backend="device", device="cpu")
    assert len(on_card) == golden["n_humans"][0] >= 1
    assert [sorted(h.body_parts) for h in on_card] == [
        sorted(h.body_parts) for h in on_cpu]


@pytest.mark.parametrize("k", [8, 32, 64, 96, 128, match.MAX_K, 160, 192, 224])
def test_match_kernel_equals_twin(cuda, k):
    """Every ``greedy_match_kernel<R>`` instance, R = ceil(K / 32) = 1 ... 8,
    bit for bit against the twin."""
    scores = torch.from_numpy(inputs.match_scores(
        np.random.default_rng(k), B, k)).to(cuda)
    _, _, _, valid = _kernel_vs_twin(match.greedy_match,
                                     match.greedy_match_torch, scores)
    assert valid.any() and not valid.all()


@pytest.mark.parametrize("cap", [CAP, 8])
def test_merge_kernel_equals_twin(cuda, cap):
    tables = inputs.merge_inputs(np.random.default_rng(cap), B, K, K // 2)
    args = [torch.from_numpy(tables[f]).to(cuda) for f in (
        "pair", "p1", "p2", "cid1", "cid2", "score", "n_valid",
        "peak_score")]
    subset, active = _kernel_vs_twin(merge.merge_people,
                                     merge.merge_people_torch, *args, cap)
    assert not active[0].any() and active[1:].any()   # image 0 is empty


@pytest.mark.parametrize("cap", [192, 384, merge.MAX_CAP])
def test_merge_kernel_equals_twin_at_large_cap(cuda, cap):
    """One image opens over 128 rows; the table is in dynamic shared
    memory sized by cap, up to the limit."""
    tables = inputs.merge_inputs(np.random.default_rng(7), B, 128, 40)
    args = [torch.from_numpy(tables[f]).to(cuda) for f in (
        "pair", "p1", "p2", "cid1", "cid2", "score", "n_valid",
        "peak_score")]
    subset, active = _kernel_vs_twin(merge.merge_people,
                                     merge.merge_people_torch, *args, cap)
    assert not active[0].any() and active.sum(1).max() > 128


def test_decode_kernels_refuse_past_their_limits(cuda):
    scores = torch.zeros((1, 19, match.MAX_K + 1, match.MAX_K + 1),
                         device=cuda)
    tables = inputs.merge_inputs(np.random.default_rng(0), 2, 8, 4)
    args = [torch.from_numpy(tables[f]).to(cuda) for f in (
        "pair", "p1", "p2", "cid1", "cid2", "score", "n_valid",
        "peak_score")]
    before = match.greedy_match.launches, merge.merge_people.launches
    with pytest.raises(ValueError, match=f"K <= {match.MAX_K} "):
        match.greedy_match(scores)
    with pytest.raises(ValueError, match=f"cap <= {merge.MAX_CAP} "):
        merge.merge_people(*args, merge.MAX_CAP + 1)
    assert (match.greedy_match.launches,
            merge.merge_people.launches) == before


def test_crowded_decode_on_card_matches_cpu(cuda):
    """Crowded frames at K = 96 and cap 192 (64 people): the card's decode
    equals the CPU twins' on the same maps (integer fields exact, float
    fields within rtol 1e-5: cuBLAS sums the refinement matmuls in
    another order), with people found and more than 64 peaks in a part."""
    heat, pafs = inputs.crowded_maps(np.random.default_rng(0), B, 12)
    cfg = Config()
    cfg.DECODE.max_peaks_per_part = 96
    cfg.DECODE.max_people = 64
    decoder = PD.build_packed_decoder(cfg)
    got = decoder(torch.from_numpy(heat).to(cuda),
                  torch.from_numpy(pafs).to(cuda)).cpu().numpy()
    want = decoder(torch.from_numpy(heat), torch.from_numpy(pafs)).numpy()
    assert inputs.packed_mismatches(got, want, 96, 192, rtol=1e-5) == []
    with pytest.warns(RuntimeWarning, match="peak capacity saturated"):
        people = [len(PD.packed_to_humans(row, 368, 432, cfg)) for row in got]
    assert min(people) >= 1
    assert PD.unpack_result(got[0], 96, 192).peak_valid.reshape(
        18, 96).sum(1).max() > 64


def test_decode_on_card_matches_golden(cuda):
    """The JAX package's decode of four scenes (written on the CPU by
    scripts/make_torch_golden.py): integer fields exact, float fields
    within rtol 1e-5 (cuBLAS sums the refinement matmuls in another
    order), the same people, and the three kernels launched once each."""
    golden = np.load(GOLDEN)
    cfg = Config()
    counts = [f.launches for f in (nms.masked_peak_scores,
                                   match.greedy_match, merge.merge_people)]
    packed = PD.build_packed_decoder(cfg)(
        torch.from_numpy(golden["heatmaps"]).to(cuda),
        torch.from_numpy(golden["pafs"]).to(cuda)).cpu().numpy()
    assert [f.launches for f in (nms.masked_peak_scores, match.greedy_match,
                                 merge.merge_people)] == [c + 1 for c in counts]
    assert inputs.packed_mismatches(
        packed, golden["packed"], 32, 96, rtol=1e-5) == []
    people = [len(PD.packed_to_humans(row, 368, 432, cfg)) for row in packed]
    assert people == golden["n_humans"].tolist() and min(people) >= 1


@contextlib.contextmanager
def _no_tf32():
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = old


def _conv_vs_twin(kernel, twin, x, *args, launches=None, **kwargs):
    """Call once, compare with the twin within 1e-4 (float32) or 0.02
    (bf16) of max|twin|; return the relative error. ``launches`` maps each
    counted wrapper to the launches the call must add (``kernel``'s own
    count rising by one when not given)."""
    launches = launches or {kernel: 1}
    before = {f: f.launches for f in launches}
    got = kernel(x, *args, **kwargs)
    with _no_tf32():
        want = twin(x, *args, **kwargs)
    torch.cuda.synchronize()
    assert {f: f.launches - before[f] for f in launches} == launches
    assert got.shape == want.shape and got.dtype == want.dtype == x.dtype
    assert torch.isfinite(got).all()
    scale = want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item() / scale
    assert err <= (1e-4 if x.dtype == torch.float32 else 0.02), err
    return err


def _chain_params(rng, chain, dev, bias=None):
    return [(torch.from_numpy(rng.standard_normal((3, 3, ci, co)) * 0.2)
             .float().to(dev),
             torch.from_numpy(rng.standard_normal(co) * 0.1).float().to(dev)
             if bias is None else torch.full((co,), bias, device=dev))
            for ci, co in chain]


# the JAX package's tests/test_pallas_conv.py shapes, and a bias-50 border
CHAINS = [
    (36, 24, [(3, 16), (16, 16)], True, None),
    (20, 16, [(8, 8)], False, None),
    (34, 20, [(4, 8), (8, 8)], False, None),
    (32, 24, [(16, 24), (24, 32)], True, None),
    (16, 16, [(8, 8), (8, 8), (8, 8)], False, None),
    (16, 16, [(4, 8), (8, 8)], False, 50.0),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,w,chain,pool,bias", CHAINS)
def test_conv_chain_kernel_matches_twin(cuda, dtype, h, w, chain, pool, bias):
    """float32 runs one ``conv3x3_f32`` launch a layer; bf16 (narrow
    chains) one fused ``conv_chain.cu`` launch."""
    rng = np.random.default_rng(h * w)
    x = torch.from_numpy(rng.standard_normal((2, h, w, chain[0][0]))).to(
        cuda, dtype)
    f32 = dtype == torch.float32
    _conv_vs_twin(cc.conv_chain, cc.conv_chain_torch, x,
                  _chain_params(rng, chain, cuda, bias), pool=pool,
                  launches=_routes(fused=int(not f32), sm90=0,
                                   f32=len(chain) if f32 else 0))


def _routes(fused, sm90, block1_sm90=0, f32=0):
    """``_conv_vs_twin``'s ``launches`` for a ``conv_chain`` call."""
    return {cc.conv_chain: fused, cc.conv3x3_sm90: sm90,
            block1.block1_fused: block1_sm90, cc.conv3x3_f32: f32}


@pytest.mark.parametrize("name", list(inputs.NARROW_CHAINS))
def test_narrow_chain_walk_cases_match_twin(cuda, name):
    """The chains whose walk tests/test_torch_conv_narrow.py emulates, in
    bf16 through one fused ``conv_chain.cu`` launch (on the card's plan:
    its SMs pick the tile)."""
    shape, chain, pool, bias = inputs.NARROW_CHAINS[name]
    x, params = inputs.narrow_arrays(np.random.default_rng(sum(shape)),
                                     shape, chain, bias)
    chans = [shape[3]] + [co for _, co in chain]
    assert cc.plan_chain(chans, torch.bfloat16, pool) == "fused"
    _conv_vs_twin(cc.conv_chain, cc.conv_chain_torch,
                  torch.from_numpy(x).to(cuda, torch.bfloat16),
                  [(torch.from_numpy(w).to(cuda), torch.from_numpy(b).to(cuda))
                   for w, b in params], pool=pool,
                  launches=_routes(fused=1, sm90=0))


def test_narrow_chain_without_tma(cuda):
    """An input TMA cannot describe (W * C * 2 % 16 != 0) comes through
    registers; a pooled one at an odd width as well as a 16-byte one."""
    rng = np.random.default_rng(5)
    for shape, chain, pool in (((2, 18, 38, 3), [(3, 16), (16, 16)], True),
                               ((1, 17, 21, 5), [(5, 24)], False)):
        x, params = inputs.narrow_arrays(rng, shape, chain)
        assert shape[2] * shape[3] * 2 % 16
        _conv_vs_twin(cc.conv_chain, cc.conv_chain_torch,
                      torch.from_numpy(x).to(cuda, torch.bfloat16),
                      [(torch.from_numpy(w).to(cuda),
                        torch.from_numpy(b).to(cuda)) for w, b in params],
                      pool=pool, launches=_routes(fused=1, sm90=0))


def test_addcmul_is_one_fma_on_the_card(cuda):
    """The refinement's emulation of XLA's dot (decode/device.py::
    _xla_dot5) needs ``torch.addcmul`` to round once, as an fma does: its
    result equals s + a * b rounded once (computed exactly in float64
    with a round-to-odd step), on the card as on the CPU
    (tests/test_torch_decode.py::test_addcmul_is_one_fma_on_the_cpu)."""
    s, a, b = inputs.fma_operands(cuda)
    want = inputs.fma_once(s, a, b)
    assert torch.equal(torch.addcmul(s, a, b), want)
    assert not torch.equal(s + a * b, want)        # two roundings differ


@pytest.mark.parametrize("shape,ci,co,pool", [
    ((2, 19, 37), 3, 64, False),       # conv1_1: 3 of 8 chunk channels
    ((1, 12, 22), 5, 7, True),         # co % 4 != 0: scalar stores
    ((2, 10, 18), 64, 130, True),      # two N tiles of 128, the last padded
    ((1, 9, 33), 17, 96, False),       # three K chunks, one ragged
])
def test_conv3x3_f32_matches_twin_at_odd_widths(cuda, shape, ci, co, pool):
    """One ``conv3x3_f32`` launch on widths the prefix never gives it:
    ci and co padded inside the kernel, ragged tiles, both N tiles."""
    rng = np.random.default_rng(ci * co)
    x = torch.from_numpy(rng.standard_normal(shape + (ci,))).to(
        cuda, torch.float32)
    (w, b), = _chain_params(rng, [(ci, co)], cuda)
    _conv_vs_twin(cc.conv3x3_f32, lambda x, w, b, pool: cc.conv_chain_torch(
        x, [(w, b)], pool), x, w, b, pool=pool)


def test_f32_kernel_refuses_what_it_does_not_take(cuda):
    x = torch.zeros((1, 8, 16, 8), device=cuda)
    (w, b), = _chain_params(np.random.default_rng(3), [(8, 16)], cuda)
    before = cc.conv3x3_f32.launches
    with pytest.raises(ValueError, match="expected float32"):
        cc.conv3x3_f32(x.to(torch.bfloat16), w, b)
    with pytest.raises(ValueError, match="layer 1"):
        cc.conv3x3_f32(x[..., :4].contiguous(), w, b)
    with pytest.raises(ValueError, match="even H and W"):
        cc.conv3x3_f32(x[:, :7], w, b, pool=True)
    assert cc.conv3x3_f32.launches == before


@pytest.mark.parametrize("name", list(inputs.SM90_CHAINS))
def test_sm90_route_matches_twin(cuda, name):
    shape, chain, pool, bias = inputs.SM90_CHAINS[name]
    x, params = inputs.chain_arrays(np.random.default_rng(sum(shape)), shape,
                                    chain, bias)
    x = torch.from_numpy(x).to(cuda, torch.bfloat16)
    params = [(torch.from_numpy(w).to(cuda), torch.from_numpy(b).to(cuda))
              for w, b in params]
    assert cc.plan_chain([shape[3]] + [co for _, co in chain],
                         x.dtype) == "sm90"
    _conv_vs_twin(cc.conv_chain, cc.conv_chain_torch, x, params, pool=pool,
                  launches=_routes(fused=0, sm90=len(chain)))


def test_sm90_kernel_refuses_what_it_does_not_take(cuda):
    rng = np.random.default_rng(1)
    x = torch.zeros((1, 8, 16, 64), device=cuda, dtype=torch.bfloat16)
    (w, b), (w_narrow, b_narrow) = _chain_params(rng, [(64, 128), (64, 64)],
                                                 cuda)
    before = cc.conv3x3_sm90.launches
    with pytest.raises(ValueError, match="ci % 64 == 0 and co % 64"):
        cc.conv3x3_sm90(x[..., :32].contiguous(), w[:, :, :32], b)
    with pytest.raises(ValueError, match="ci % 64 == 0 and co % 64"):
        cc.conv3x3_sm90(x, w_narrow[..., :48], b_narrow[:48])
    with pytest.raises(ValueError, match="expected bfloat16"):
        cc.conv3x3_sm90(x.float(), w, b)
    assert cc.conv3x3_sm90.launches == before


def _block1_counts(conv1=0, pooled=0, chain=0, f32=0):
    """``_conv_vs_twin``'s ``launches`` for a block-1 call: every counted
    conv wrapper, with what it must add (``conv1_fused``,
    ``block1_fused``, the fused ``conv_chain`` kernel, ``conv3x3_f32``)."""
    return {block1.conv1_fused: conv1, block1.block1_fused: pooled,
            cc.conv_chain: chain, cc.conv3x3_sm90: 0, cc.conv3x3_f32: f32}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 16, 24), (1, 38, 70)])
def test_block1_kernels_match_twins(cuda, dtype, shape):
    """bf16 launches ``ekp_block1_sm90`` in each mode; float32 runs the
    same function as one ``conv3x3_f32`` launch a layer, the block-1
    counts unchanged."""
    rng = np.random.default_rng(shape[1])
    x = torch.from_numpy(rng.standard_normal(shape + (3,))).to(cuda, dtype)
    (w1, b1), (w2, b2) = _chain_params(rng, [(3, 64), (64, 64)], cuda)
    sm90 = dtype == torch.bfloat16
    _conv_vs_twin(block1.conv1_fused, block1.conv1_fused_torch, x, w1, b1,
                  launches=_block1_counts(conv1=int(sm90),
                                          f32=int(not sm90)))
    _conv_vs_twin(block1.block1_fused, block1.block1_fused_torch, x, w1, b1,
                  w2, b2, launches=_block1_counts(pooled=int(sm90),
                                                  f32=2 * int(not sm90)))


@pytest.mark.parametrize("shape,bias", [
    ((2, 38, 70), 50.0),           # ragged tiles and a relu(50) border
    ((1, 368, 432), None),         # the prefix's full width: 7 column tiles
    ((3, 16, 124), None),          # W a multiple of the fused tile (62)
])
def test_block1_sm90_route_matches_twin(cuda, shape, bias):
    rng = np.random.default_rng(sum(shape))
    x = torch.from_numpy(rng.standard_normal(shape + (3,))).to(
        cuda, torch.bfloat16)
    (w1, b1), (w2, b2) = _chain_params(rng, [(3, 64), (64, 64)], cuda, bias)
    assert block1.plan_block1(64, 64, x.dtype) == "sm90"
    _conv_vs_twin(block1.conv1_fused, block1.conv1_fused_torch, x, w1, b1,
                  launches=_block1_counts(conv1=1))
    _conv_vs_twin(block1.block1_fused, block1.block1_fused_torch, x, w1, b1,
                  w2, b2, launches=_block1_counts(pooled=1))


def test_block1_narrow_bf16_takes_conv_chain(cuda):
    rng = np.random.default_rng(32)
    x = torch.from_numpy(rng.standard_normal((2, 20, 30, 3))).to(
        cuda, torch.bfloat16)
    (w1, b1), (w2, b2) = _chain_params(rng, [(3, 32), (32, 32)], cuda)
    assert block1.plan_block1(32, 32, x.dtype) == "chain"
    _conv_vs_twin(block1.conv1_fused, block1.conv1_fused_torch, x, w1, b1,
                  launches=_block1_counts(chain=1))
    _conv_vs_twin(block1.block1_fused, block1.block1_fused_torch, x, w1, b1,
                  w2, b2, launches=_block1_counts(chain=1))


def test_block1_refusals_launch_nothing(cuda):
    rng = np.random.default_rng(2)
    (w1, b1), (w2, b2) = _chain_params(rng, [(3, 64), (64, 64)], cuda)
    x = torch.zeros((1, 8, 8, 3), device=cuda, dtype=torch.bfloat16)
    counted = (block1.conv1_fused, block1.block1_fused, cc.conv_chain,
               cc.conv3x3_sm90, cc.conv3x3_f32)
    before = [f.launches for f in counted]
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        block1.block1_fused(x.half(), w1, b1, w2, b2)
    with pytest.raises(ValueError, match="expected x"):
        block1.conv1_fused(torch.zeros((1, 8, 8, 4), device=cuda,
                                       dtype=torch.bfloat16), w1, b1)
    with pytest.raises(ValueError, match="another device"):
        block1.block1_fused(x, w1, b1, w2.cpu(), b2)
    with pytest.raises(ValueError, match="even H and W"):
        block1.block1_fused(x[:, :7], w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert [f.launches for f in counted] == before


def test_block1_wgmma_descriptor(cuda):
    """One wgmma.m64n256k16 through the kernel's no-swizzle descriptors
    (A as w2 is laid out, B as the conv1_1 region with a group stride
    other than 256 pixels) equals a @ b^T: pins the LBO / SBO meaning."""
    rng = np.random.default_rng(11)
    a = torch.from_numpy(rng.standard_normal((64, 16))).to(
        cuda, torch.bfloat16)
    b = torch.from_numpy(rng.standard_normal((256, 16))).to(
        cuda, torch.bfloat16)
    got = block1._wgmma_probe(a, b)
    want = a.double() @ b.double().t()
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("block", [1, 2, 3])
def test_conv_chain_at_vgg_prefix_shapes(cuda, block):
    """bf16, batch 1, the prefix's full 368x432 widths, seeded weights:
    block 1 on ``block1_sm90`` (one ``block1_fused`` launch), blocks 2 and
    3 one sm90 launch a layer."""
    torch.manual_seed(block)
    model = VGG19Backbone(device=cuda)
    h, w, c = {1: (368, 432, 3), 2: (184, 216, 64), 3: (92, 108, 128)}[block]
    x = torch.rand((1, h, w, c), device=cuda).to(torch.bfloat16)
    params = chain_params(model, block)
    assert cc.plan_chain([c] + [p[0].shape[3] for p in params], x.dtype,
                         True) == ("block1" if block == 1 else "sm90")
    _conv_vs_twin(cc.conv_chain, cc.conv_chain_torch, x, params, pool=True,
                  launches=_routes(fused=0, sm90=0, block1_sm90=1)
                  if block == 1 else _routes(fused=0, sm90=len(params)))


@pytest.mark.parametrize("block", [1, 2, 3])
def test_conv_chain_f32_at_vgg_prefix_shapes(cuda, block):
    """float32, batch 1, the prefix's full 368x432 widths, seeded weights:
    one ``conv3x3_f32`` launch a layer (block 1: conv1_1 from 3 channels
    and conv1_2 at N tile 64; blocks 2-3 at N tile 128), within 1e-4 of
    max|twin| with TF32 off, and no other conv kernel."""
    torch.manual_seed(block)
    model = VGG19Backbone(device=cuda)
    h, w, c = {1: (368, 432, 3), 2: (184, 216, 64), 3: (92, 108, 128)}[block]
    x = torch.rand((1, h, w, c), device=cuda)
    params = chain_params(model, block)
    assert cc.plan_chain([c] + [p[0].shape[3] for p in params], x.dtype,
                         True) == "f32"
    _conv_vs_twin(cc.conv_chain, cc.conv_chain_torch, x, params, pool=True,
                  launches=_routes(fused=0, sm90=0, f32=len(params)))


def test_conv1_2_at_vgg_prefix_shape_takes_bn64(cuda):
    """conv1_2 + pool after conv1_1 alone (the ``conv1_fused`` route's
    second call), batch 1 at 368x432: one ``conv3x3_sm90`` launch at N
    tile 64, no fused ``conv_chain`` launch."""
    torch.manual_seed(1)
    model = VGG19Backbone(device=cuda)
    (w1, b1), (w2, b2) = chain_params(model, 1)
    x = torch.rand((1, 368, 432, 3), device=cuda).to(torch.bfloat16)
    y = block1.conv1_fused_torch(x, w1, b1)
    assert cc.plan_chain([64, 64], y.dtype, True) == "sm90"
    assert cc.sm90_tile_n(64) == 64
    _conv_vs_twin(cc.conv_chain, cc.conv_chain_torch, y, [(w2, b2)],
                  pool=True, launches=_routes(fused=0, sm90=1))


def test_prefix_kernels_match_cudnn_backbone(cuda):
    """The three block-1 routes of prefix_forward in float32 against
    backbone[:19] on cuDNN with TF32 off."""
    from torch_ekpose_tpu_torch.models.vgg import prefix_forward

    torch.manual_seed(0)
    model = VGG19Backbone(device=cuda)
    x = torch.rand((2, 48, 64, 3), device=cuda)
    with _no_tf32(), torch.no_grad():
        want = model.backbone[:PREFIX_END](x.permute(0, 3, 1, 2))
    want = want.permute(0, 2, 3, 1)
    for route in ("conv_chain", "block1_fused", "conv1_fused"):
        got = prefix_forward(model, x, route)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item() / want.abs().max().item()
        assert got.shape == (2, 6, 8, 256) and err <= 1e-4, (route, err)


def test_conv_kernels_refuse_what_they_do_not_take(cuda):
    x = torch.zeros((1, 8, 8, 3), device=cuda, dtype=torch.float16)
    (w1, b1), = _chain_params(np.random.default_rng(0), [(3, 64)], cuda)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        cc.conv_chain(x, [(w1, b1)])
    with pytest.raises(ValueError, match="layer 1"):
        cc.conv_chain(x.float(), [(w1[:, :, :2], b1)])
    with pytest.raises(ValueError, match="1 to 8 layers"):
        cc.conv_chain(x.float(), [])
    with pytest.raises(ValueError, match="another device"):
        block1.conv1_fused(x.float(), w1.cpu(), b1.cpu())


def test_aot_graph_replay_matches_eager(cuda, tmp_path):
    """An artifact exported and loaded on the card (shufflenetV2_0.5x,
    float32 with TF32 off, batch 2 of 64x64 frames, on weights that make
    every BN work with its head set to make people): the CUDA-graph replay
    is bit-equal to the two loaded programs run op by op, and finds
    people. A replay runs no Python, so the kernels' counts stay; the
    eager run raises each by one."""
    from torch_ekpose_tpu_torch.models.factory import get_model
    from torch_ekpose_tpu_torch.runtime import aot
    from torch_ekpose_tpu_torch.runtime.estimator import PoseEstimator

    frames = np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3),
                                               dtype=np.uint8)
    name = "shufflenetV2_0.5x"
    state = inputs.working_state_dict(get_model(name, device="cpu"), 0)
    est = PoseEstimator(name, state, device=cuda, compute_dtype=torch.float32,
                        precision="highest", dest_size=64)
    inputs.peaky_head_(est, frames)
    path = str(tmp_path / "pose.ekx")
    aot.export_pipeline(est, path, 2, 64, 64)
    pipe = aot.load_pipeline(path)
    assert pipe.graph is not None
    kernels = (nms.masked_peak_scores, match.greedy_match, merge.merge_people)
    before = [f.launches for f in kernels]
    got = pipe.packed(frames)
    torch.cuda.synchronize()
    assert [f.launches for f in kernels] == before
    want = pipe.run_eager(torch.from_numpy(frames).to(cuda))
    torch.cuda.synchronize()
    assert [f.launches for f in kernels] == [c + 1 for c in before]
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert min(len(h) for h in pipe.estimate_batch(frames)) >= 1
