"""The host side of ``conv_chain``'s sm90 route on the CPU: the route rule,
the ``[co][9 ci]`` weight packing, and a plain emulation of the kernel's
walk (``csrc/conv3x3_sm90.cu``) held against ``conv_chain_torch``.

The emulation follows the kernel, not the math: 8x16 output tiles, each
summed over 9 shifted boxes x 64-channel chunks (what TMA loads, zero
outside the image) times the packed weight's matching ``[128, 64]`` box,
in float32; bias, ReLU, then the 2x2 pool taken inside the tile, then the
ragged edge cut off. In float32 it must equal the twin within 1e-5 of
max|twin| (the sums run in another order). It catches index and layout
mistakes before the kernel runs on a card; it is on no path of the port.
The N tile 64 variant (``co % 128 != 0``: conv1_2) is walked the same way
with its own tile (16x16 pixels, the weights as wgmma's A and each
warpgroup's 128 pixels as B) and its epilogue's register-to-staging map.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402

from torch_ekpose_tpu_torch.ops import conv_chain as cc  # noqa: E402

torch.set_num_threads(2)  # xdist already runs one process per core

TILE_H, TILE_W, CHUNK, TILE_N = 8, 16, 64, 128


def _emulate_layer(x, w, b, pool):
    """One ``ekp_conv3x3_sm90`` launch, walked as the kernel walks it."""
    bsz, h, wd, ci = x.shape
    co = w.shape[3]
    ty, tx = -(-h // TILE_H), -(-wd // TILE_W)
    # TMA's zero fill: one pixel before the image, the tiles' reach after
    xp = F.pad(x, (0, 0, 1, tx * TILE_W + 1 - wd, 1, ty * TILE_H + 1 - h))
    wk = cc.pack_weight_kmajor(w, torch.float32)            # [co, 9 ci]
    acc = torch.zeros(bsz * ty * tx, TILE_H * TILE_W, co)
    for tap in range(9):
        dy, dx = divmod(tap, 3)
        box = xp[:, dy:dy + ty * TILE_H, dx:dx + tx * TILE_W]
        box = box.reshape(bsz, ty, TILE_H, tx, TILE_W, ci).permute(
            0, 1, 3, 2, 4, 5).reshape(-1, TILE_H * TILE_W, ci)
        for c in range(0, ci, CHUNK):
            for n in range(0, co, TILE_N):                  # blockIdx.y
                acc[:, :, n:n + TILE_N] += (
                    box[:, :, c:c + CHUNK]
                    @ wk[n:n + TILE_N, tap * ci + c:tap * ci + c + CHUNK].T)
    tiles = torch.relu(acc + b).view(bsz, ty, tx, TILE_H, TILE_W, co)
    if pool:
        tiles = tiles.view(bsz, ty, tx, TILE_H // 2, 2, TILE_W // 2, 2,
                           co).amax(dim=(4, 6))
        h, wd = h // 2, wd // 2
    out = tiles.permute(0, 1, 3, 2, 4, 5).reshape(
        bsz, ty * tiles.shape[3], tx * tiles.shape[4], co)
    return out[:, :h, :wd].contiguous()


def _emulate_chain(x, params, pool):
    for i, (w, b) in enumerate(params):
        x = _emulate_layer(x, w, b, pool and i == len(params) - 1)
    return x


def _params(rng, chain, bias=None):
    return [(torch.from_numpy(rng.standard_normal((3, 3, ci, co)).astype(
        np.float32) * 0.05),
             torch.from_numpy(rng.standard_normal(co).astype(np.float32)
                              * 0.1) if bias is None
             else torch.full((co,), bias))
            for ci, co in chain]


@pytest.mark.parametrize(
    "shape,chain,pool,bias",
    [
        ((2, 16, 32, 64), [(64, 128), (128, 128)], True, None),
        ((1, 16, 16, 128), [(128, 256)], False, None),
        ((2, 20, 28, 64), [(64, 128), (128, 128)], True, None),
        ((1, 20, 28, 128), [(128, 128)], False, None),
        ((1, 12, 18, 64), [(64, 128), (128, 128)], False, 50.0),
    ],
    ids=["block2_like_pool", "ci128_widening", "ragged_20x28_pool",
         "ragged_20x28_ci128", "bias50_border"],
)
def test_kernel_walk_equals_twin(shape, chain, pool, bias):
    rng = np.random.default_rng(sum(shape))
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    params = _params(rng, chain, bias)
    got = _emulate_chain(x, params, pool)
    want = cc.conv_chain_torch(x, params, pool)
    assert got.shape == want.shape
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= 1e-5 * scale
    if bias is not None:        # a relu(50) leak past the border would show
        assert scale > 50 and want[:, 0, 0].max() < want[:, 5, 5].max()


@pytest.mark.parametrize(
    "chans,dtype,route",
    [
        ([64, 128, 128], torch.bfloat16, "sm90"),                # block 2
        ([128, 256, 256, 256, 256], torch.bfloat16, "sm90"),     # block 3
        ([3, 64, 64], torch.bfloat16, "fused"),       # block 1, no pool
        ([64, 64], torch.bfloat16, "sm90"),           # block 1 after conv1_1
        ([64, 128, 128], torch.float32, "f32"),
        ([128, 256, 256, 256, 256], torch.float32, "f32"),
        ([3, 16, 16], torch.bfloat16, "fused"),       # the CHAINS test shapes
        ([16, 24, 32], torch.bfloat16, "fused"),
        ([8, 8, 8, 8], torch.bfloat16, "fused"),
        ([64, 128, 96], torch.bfloat16, "fused"),     # one layer fails
        ([96, 128], torch.bfloat16, "fused"),
        ([64], torch.bfloat16, "fused"),              # no layer
    ],
)
def test_plan_chain_routes_by_shape(chans, dtype, route):
    assert cc.plan_chain(chans, dtype) == route


@pytest.mark.parametrize("ci,co", [(64, 128), (128, 256)])
def test_kmajor_packing_round_trips(ci, co):
    w = torch.from_numpy(np.random.default_rng(ci).standard_normal(
        (3, 3, ci, co)).astype(np.float32))
    wk = cc.pack_weight_kmajor(w)
    assert wk.shape == (co, 9 * ci) and wk.dtype == torch.bfloat16
    assert wk.is_contiguous()
    back = wk.t().reshape(3, 3, ci, co)
    assert torch.equal(back, w.to(torch.bfloat16))
    dy, dx, c, n = 2, 1, ci - 3, co - 5            # one entry by its index
    assert wk[n, (3 * dy + dx) * ci + c] == w[dy, dx, c, n].to(torch.bfloat16)


def test_cpu_tensors_take_the_twin():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((1, 8, 16, 64)).astype(
        np.float32)).to(torch.bfloat16)
    (w, b), = _params(rng, [(64, 128)])
    before = cc.conv3x3_sm90.launches, cc.conv_chain.launches
    got = cc.conv3x3_sm90(x, w, b, pool=True)
    assert torch.equal(got, cc.conv_chain_torch(x, [(w, b)], True))
    assert torch.equal(cc.conv_chain(x, [(w, b)], pool=True), got)
    assert (cc.conv3x3_sm90.launches, cc.conv_chain.launches) == before
    with pytest.raises(ValueError, match="even H and W"):
        cc.conv3x3_sm90(x[:, :7], w, b, pool=True)


# ---------------------------------------------------------------------------
# the N tile 64 variant (co % 64 == 0, co % 128 != 0)
# ---------------------------------------------------------------------------

BN64_TILE_H, BN64_TILE_N = 16, 64


def _bn64_fragment_map():
    """(pixel, channel) of every accumulator register of the two consumer
    warpgroups, as the kernel's epilogue writes them: register
    ``4 j + 2 h + e`` of lane ``l`` of warp ``q`` holds the product's row
    ``m = 16 q + l / 4 + 8 h`` (a channel) and column
    ``n = 8 j + 2 (l % 4) + e`` (a warpgroup's pixel)."""
    wg, q, lane, j, h, e = np.meshgrid(np.arange(2), np.arange(4),
                                       np.arange(32), np.arange(16),
                                       np.arange(2), np.arange(2),
                                       indexing="ij")
    m = 16 * q + lane // 4 + 8 * h
    n = 8 * j + 2 * (lane % 4) + e
    reg = 4 * j + 2 * h + e
    return (wg.ravel(), m.ravel(), n.ravel(), reg.ravel(),
            (wg * 128 + n).ravel(), m.ravel())


def _emulate_bn64_layer(x, w, b, pool):
    """One ``ekp_conv3x3_sm90`` launch at N tile 64, walked as the kernel
    walks it: per 16x16 tile and 64-channel N block, 9 taps x 64-channel
    chunks of ``W[n0:n0 + 64, chunk] @ box[pixels, chunk]^T`` per
    warpgroup, then the epilogue through the fragment map into a
    ``[256 pixel][64 channel]`` staging tile, the pool from it, and the
    ragged edge cut off."""
    bsz, h, wd, ci = x.shape
    co = w.shape[3]
    assert co % BN64_TILE_N == 0 and cc.sm90_tile_n(co) in (64, 128)
    ty, tx = -(-h // BN64_TILE_H), -(-wd // TILE_W)
    xp = F.pad(x, (0, 0, 1, tx * TILE_W + 1 - wd, 1, ty * BN64_TILE_H + 1 - h))
    wk = cc.pack_weight_kmajor(w, torch.float32)            # [co, 9 ci]
    n_tiles = bsz * ty * tx
    # acc[tile, n block, warpgroup, m (channel), n (pixel of the half)]
    acc = torch.zeros(n_tiles, co // BN64_TILE_N, 2, 64, 128)
    for tap in range(9):
        dy, dx = divmod(tap, 3)
        box = xp[:, dy:dy + ty * BN64_TILE_H, dx:dx + tx * TILE_W]
        box = box.reshape(bsz, ty, BN64_TILE_H, tx, TILE_W, ci).permute(
            0, 1, 3, 2, 4, 5).reshape(n_tiles, 2, 128, ci)   # wg halves
        for c in range(0, ci, CHUNK):
            k0 = tap * ci + c
            for nb in range(co // BN64_TILE_N):
                a = wk[nb * 64:(nb + 1) * 64, k0:k0 + CHUNK]  # [64, 64]
                acc[:, nb] += a @ box[..., c:c + CHUNK].transpose(-1, -2)
    wg, m, n, reg, pix, chan = _bn64_fragment_map()
    staging = torch.full((n_tiles, co // BN64_TILE_N, 256, 64), float("nan"))
    bias = b.view(co // BN64_TILE_N, 64)
    staging[:, :, pix, chan] = torch.relu(acc[:, :, wg, m, n]
                                          + bias[None, :, chan])
    tiles = staging.view(bsz, ty, tx, co // BN64_TILE_N, BN64_TILE_H,
                         TILE_W, 64).permute(0, 1, 2, 4, 5, 3, 6).reshape(
        bsz, ty, tx, BN64_TILE_H, TILE_W, co)
    if pool:
        tiles = tiles.view(bsz, ty, tx, BN64_TILE_H // 2, 2, TILE_W // 2, 2,
                           co).amax(dim=(4, 6))
        h, wd = h // 2, wd // 2
    out = tiles.permute(0, 1, 3, 2, 4, 5).reshape(
        bsz, ty * tiles.shape[3], tx * tiles.shape[4], co)
    return out[:, :h, :wd].contiguous()


def test_bn64_fragment_map_covers_the_staging_tile_once():
    """Every (pixel, channel) of the 256 x 64 staging tile gets exactly
    one accumulator register, and each thread holds 64 registers."""
    wg, m, n, reg, pix, chan = _bn64_fragment_map()
    flat = pix * 64 + chan
    assert np.array_equal(np.sort(flat), np.arange(256 * 64))
    assert reg.max() == 63 and m.max() == 63 and n.max() == 127


@pytest.mark.parametrize(
    "shape,co,pool,bias",
    [
        ((2, 20, 28, 64), 64, True, None),      # ragged, pooled: conv1_2-like
        ((1, 18, 24, 64), 64, False, 50.0),     # bias-50 border, no pool
        ((1, 12, 34, 128), 192, True, None),    # three N blocks, ci 128
    ],
    ids=["ragged_pool", "bias50_border", "co192_ci128"],
)
def test_bn64_kernel_walk_equals_twin(shape, co, pool, bias):
    rng = np.random.default_rng(sum(shape) + co)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    (w, b), = _params(rng, [(shape[3], co)], bias)
    assert cc.sm90_tile_n(co) == 64
    got = _emulate_bn64_layer(x, w, b, pool)
    want = cc.conv_chain_torch(x, [(w, b)], pool)
    assert got.shape == want.shape and not torch.isnan(got).any()
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= 1e-5 * scale
    if bias is not None:        # a relu(50) leak past the border would show
        assert scale > 50 and want[:, 0, 0].max() < want[:, 5, 5].max()


@pytest.mark.parametrize(
    "chans,dtype,pool,route,tiles",
    [
        ([3, 64, 64], torch.bfloat16, True, "block1", None),     # block 1
        ([3, 64, 64], torch.bfloat16, False, "fused", None),     # no pool
        ([64, 64], torch.bfloat16, True, "sm90", [64]),          # conv1_2
        ([64, 128, 128], torch.bfloat16, True, "sm90", [128, 128]),
        ([128, 256, 256, 256, 256], torch.bfloat16, True, "sm90",
         [128] * 4),
        ([128, 64, 192], torch.bfloat16, False, "sm90", [64, 64]),
        ([3, 64, 64], torch.float32, True, "f32", None),
        ([64, 64], torch.float32, True, "f32", None),
        ([3, 32, 32], torch.bfloat16, True, "fused", None),      # narrow
        ([3, 64, 128], torch.bfloat16, True, "fused", None),     # c2 != 64
        ([64, 96], torch.bfloat16, True, "fused", None),         # 96 % 64
    ],
    ids=["block1_bf16", "block1_unpooled", "conv1_2", "block2", "block3",
         "bn64_co192", "block1_f32", "conv1_2_f32", "narrow_block1",
         "wide_conv1_2", "co96"],
)
def test_plan_chain_routes_block1_and_bn64(chans, dtype, pool, route, tiles):
    """The routing rule: the pooled bf16 [3, 64, 64] chain goes to
    ``block1_sm90``; a bf16 chain of ``ci % 64 == 0`` and ``co % 64 == 0``
    layers to ``conv3x3_sm90``, at N tile 128 where ``co % 128 == 0`` and
    64 otherwise; float32 chains to ``conv3x3_f32``, one launch a layer;
    narrow bf16 chains to the fused kernel."""
    assert cc.plan_chain(chans, dtype, pool) == route
    if tiles is not None:
        assert [cc.sm90_tile_n(co) for co in chans[1:]] == tiles
