"""The float32 route of ``conv_chain`` on the CPU: a plain numpy emulation of
``csrc/conv3x3_f32.cu``'s tile walk, one launch per layer, held against
the JAX package's Pallas ``conv_chain`` in interpret mode in float32.

The emulation follows the kernel, not the math: the host side's own
packing (``pack_weight`` to ``[9][ci_pad][co_pad]``, ``pad_bias``,
``f32_tile_n``, ``F32_CHUNK``); tiles of 8x16 pixels x 128 channels, or
16x16 x 64 where ``co <= 64``, partial at the ragged edge; per 8-channel
chunk the (tile + 2)-pixel input box, zero outside the image and beyond
``ci`` (conv1_1's ``ci = 3`` is one chunk of which the kernel walks 3
channels); each of the 256 threads summing its 2x4 pixels x 8 channels
(channels ``4 cg ..`` and ``kTileN / 2 + 4 cg ..``) tap by tap with one
rounding a step (float64 product and sum, rounded: the FMA); then bias,
ReLU, the 2x2 pool inside the thread's 2x4 pixels, and the masked store.
Tolerances are ``tests/test_torch_conv.py``'s: atol 2e-5 (the sums run in
another order than the Pallas kernel's), atol 1e-4 / rtol 1e-5 where
values reach the hundreds (the bias-50 border, and the 130-channel chain,
whose 64- and 130-deep sums of weights of 0.2 grow past 100). It catches index, layout
and padding mistakes before the kernel runs on a card; no path of the
port calls it.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from torch_ekpose_tpu.ops.pallas_conv import conv_chain as jax_conv_chain  # noqa: E402
from torch_ekpose_tpu_torch.ops import conv_chain as cc  # noqa: E402

torch.set_num_threads(2)  # xdist already runs one process per core

THREADS, TILE_W, ROW_STRIDE = 256, 16, 20


def _thread_map(tile_n):
    """Each thread's 8 pixels (row, column within the tile, ``[256, 2, 4]``)
    and 8 channels (within the N tile, ``[256, 8]``)."""
    tid = np.arange(THREADS)
    groups_n = tile_n // 8
    cg, pg = tid % groups_n, tid // groups_n
    pr, pc = pg >> 2, pg & 3
    rows = 2 * pr[:, None, None] + np.arange(2)[None, :, None] + 0 * np.arange(
        4)[None, None, :]
    cols = 4 * pc[:, None, None] + np.arange(4)[None, None, :] + 0 * rows
    chans = np.concatenate([4 * cg[:, None] + np.arange(4),
                            tile_n // 2 + 4 * cg[:, None] + np.arange(4)], 1)
    return pr, pc, rows, cols, chans


def emulate_layer(x: np.ndarray, w: np.ndarray, b: np.ndarray,
                  pool: bool) -> np.ndarray:
    """One ``ekp_conv3x3_f32`` launch, walked as the kernel walks it."""
    bsz, h, wd, ci = x.shape
    co = w.shape[3]
    tile_n = cc.f32_tile_n(co)
    tile_h = 8 if tile_n == 128 else 16
    chunk = cc.F32_CHUNK
    ci_pad = -(-ci // chunk) * chunk
    co_pad = -(-co // tile_n) * tile_n
    wp = cc.pack_weight(torch.from_numpy(w).reshape(9, ci, co), ci_pad,
                        co_pad, torch.float32).numpy()
    bp = cc.pad_bias(torch.from_numpy(b), co_pad).numpy()
    ty, tx, tn = -(-h // tile_h), -(-wd // TILE_W), co_pad // tile_n
    # every tile's box, zero outside the image and beyond ci
    xp = np.zeros((bsz, ty * tile_h + 2, tx * TILE_W + 2, ci_pad), np.float32)
    xp[:, 1:h + 1, 1:wd + 1, :ci] = x
    pr, pc, rows, cols, chans = _thread_map(tile_n)
    six = 4 * pc[:, None] + np.arange(6)           # a thread's box columns
    acc = np.zeros((bsz, ty, tx, tn, THREADS, 2, 4, 8), np.float32)
    for c0 in range(0, ci_pad, chunk):
        # the staged box [b, ty, tx, k, row, column] and slab [tap, k, n]
        box = np.zeros((bsz, ty, tx, chunk, tile_h + 2, ROW_STRIDE),
                       np.float32)
        for yt in range(ty):
            for xt in range(tx):
                box[:, yt, xt, :, :, :TILE_W + 2] = xp[
                    :, yt * tile_h:yt * tile_h + tile_h + 2,
                    xt * TILE_W:xt * TILE_W + TILE_W + 2,
                    c0:c0 + chunk].transpose(0, 3, 1, 2)
        slab = wp[:, c0:c0 + chunk]
        for k in range(min(chunk, ci - c0)):
            for dy in range(3):
                # av [b, ty, tx, thread, i, 6]: rows 2 pr + i + dy
                r_idx = 2 * pr[:, None] + np.arange(2)[None, :] + dy
                av = box[:, :, :, k][:, :, :, r_idx[:, :, None],
                                     six[:, None, :]]
                for dx in range(3):
                    # bv [tn, thread, 8]
                    bv = slab[3 * dy + dx, k][
                        np.arange(tn)[:, None, None] * tile_n + chans[None]]
                    a = av[:, :, :, None, :, :, dx:dx + 4, None]
                    acc[:] = (a.astype(np.float64)
                              * bv[None, None, None, :, :, None, None, :]
                              + acc).astype(np.float32)
    bias = bp[np.arange(tn)[:, None, None] * tile_n + chans[None]]
    v = np.maximum(acc + bias[None, None, None, :, :, None, None, :], 0)
    out_h, out_w = (h // 2, wd // 2) if pool else (h, wd)
    out = np.full((bsz, out_h, out_w, co), np.nan, np.float32)
    if pool:                      # the thread's 2x4 pixels -> 1x2 pooled
        v = v.reshape(*v.shape[:5], 2, 2, 2, 8).max(axis=(5, 7))[
            ..., None, :, :]                     # [..., thread, 1, 2, 8]
        rows, cols = pr[:, None, None] + 0 * np.arange(2)[None, None, :], (
            2 * pc[:, None, None] + np.arange(2)[None, None, :])
        step_h, step_w = tile_h // 2, TILE_W // 2
    else:
        step_h, step_w = tile_h, TILE_W
    for yt in range(ty):
        for xt in range(tx):
            for nt in range(tn):
                y = yt * step_h + rows               # [thread, i, q]
                xx = xt * step_w + cols
                ch = nt * tile_n + chans             # [thread, e]
                keep = ((y < out_h) & (xx < out_w))[..., None] & (
                    ch < co)[:, None, None, :]
                tb, ti, tq, te = np.nonzero(keep)
                out[:, y[tb, ti, tq], xx[tb, ti, tq], ch[tb, te]] = v[
                    :, yt, xt, nt, tb, ti, tq, te]
    assert not np.isnan(out).any()            # every output written once
    return out


def emulate_chain(x, params, pool):
    for i, (w, b) in enumerate(params):
        x = emulate_layer(x, w, b, pool and i == len(params) - 1)
    return x


def _params(rng, chain, bias=None):
    return [(rng.standard_normal((3, 3, ci, co)).astype(np.float32) * 0.2,
             rng.standard_normal(co).astype(np.float32) * 0.1
             if bias is None else np.full(co, bias, np.float32))
            for ci, co in chain]


@pytest.mark.parametrize(
    "shape,chain,pool,bias,atol,rtol",
    [
        ((2, 36, 24), [(3, 16), (16, 16)], True, None, 2e-5, 0),
        ((2, 20, 16), [(8, 8)], False, None, 2e-5, 0),
        ((2, 34, 20), [(4, 8), (8, 8)], False, None, 2e-5, 0),
        ((2, 32, 24), [(16, 24), (24, 32)], True, None, 2e-5, 0),
        ((2, 16, 16), [(8, 8), (8, 8), (8, 8)], False, None, 2e-5, 0),
        ((2, 16, 16), [(4, 8), (8, 8)], False, 50.0, 1e-4, 1e-5),
        ((1, 38, 70), [(3, 64), (64, 64)], True, None, 2e-5, 0),
        ((1, 14, 22), [(64, 130), (130, 96)], False, None, 1e-4, 1e-5),
    ],
    ids=["block1_like", "single", "ragged", "widening", "three_deep",
         "bias50_border", "block1_38x70", "n_tile_128"],
)
def test_f32_tile_walk_matches_pallas(shape, chain, pool, bias, atol, rtol):
    """The ``CHAINS`` shapes of ``tests/test_torch_conv.py``, vgg2016's
    block 1 at 38x70 (neither side a multiple of the 16x16 tile), and a
    chain past 64 channels (N tile 128, 8x16 pixels, two N tiles with the
    last padded, ``co % 4 != 0``)."""
    rng = np.random.default_rng(sum(shape) + len(chain))
    x = rng.standard_normal(shape + (chain[0][0],)).astype(np.float32)
    params = _params(rng, chain, bias)
    got = emulate_chain(x, params, pool)
    want = np.asarray(jax_conv_chain(
        jnp.asarray(x), [(jnp.asarray(w), jnp.asarray(b)) for w, b in params],
        pool=pool, row_tile=8, interpret=True))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)
    assert (atol, rtol) == (2e-5, 0) or np.abs(want).max() > 50
    if bias is not None:       # relu(50) leaking past the border would show
        assert np.abs(want).max() > 50
