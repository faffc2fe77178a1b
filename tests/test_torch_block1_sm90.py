"""The host side of ``ekp_block1_sm90`` on the CPU: the route rule, the
weight packing, and a plain emulation of the kernel's walk
(``csrc/block1_sm90.cu``) held against the twins.

The emulation follows the kernel, not the math: tiles of 8 rows x 62
(fused) or 64 (conv1_1 alone) columns; each tile's input box (3 channels,
200 elements a row, zero outside the image) read at the kernel's patch
offsets ``(k // 9) * 200 + k % 9``; conv1_1 with K padded to 32; the fused
block's conv1_2 as w2 (from the packed ``[72][64][8]`` A operand) times
256-pixel windows of the ``[pixel][channel]`` region of 64-pixel rows,
moved by ``dy * 64 + dx`` pixels a tap; the pool over virtual rows and
columns; the ragged edge and the discarded columns cut off. In float32 on
bf16-representable weights it must equal the twin within 1e-5 of
max|twin| (the sums run in another order). It catches index and layout
mistakes before the kernel runs on a card; it is on no path of the port.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402

from torch_ekpose_tpu_torch.ops import block1, conv_chain as cc  # noqa: E402

torch.set_num_threads(2)  # xdist already runs one process per core

BOX_W, COLS, TILE_H = 200, 64, 8
OFFSETS = [k // 9 * BOX_W + k % 9 for k in range(27)]


def _emulate(x, w1, b1, w2=None, b2=None):
    """One ``ekp_block1_sm90`` launch (fused when ``w2`` is given), walked
    tile by tile as the kernel walks it, in float32."""
    fused = w2 is not None
    bsz, h, w, _ = x.shape
    tile_w, halo, rows = (62, 1, 10) if fused else (64, 0, 8)
    packed = block1.pack_block1(w1, w2).float()
    w1k = F.pad(packed[:27 * 64].view(27, 64), (0, 0, 0, 5))   # K to 32
    wa = None if not fused else (
        packed[27 * 64:].view(72, 64, 8).permute(1, 0, 2).reshape(64, 576))
    out = torch.zeros((bsz, h // 2, w // 2, 64) if fused else (bsz, h, w, 64))
    img = F.pad(x.reshape(bsz, h, w * 3), (6 + 3 * 64, 3 * 64 + 6, 3, 10))
    pix = torch.arange(rows * COLS)
    base = pix // COLS * BOX_W + pix % COLS * 3
    patch_idx = base[:, None] + torch.tensor(OFFSETS + [OFFSETS[-1]] * 5)
    for b in range(bsz):
        for y0 in range(0, h, TILE_H):
            for x0 in range(0, w, tile_w):
                # the input box: rows y0 - halo - 1 .., elements
                # 3 (x0 - halo - 1) .., zero outside the image
                iy, ie = y0 - halo - 1 + 3, 3 * (x0 - halo - 1) + 6 + 3 * 64
                box = img[b, iy:iy + rows + 2, ie:ie + BOX_W]
                region = box.reshape(-1)[patch_idx] @ w1k + b1
                region = torch.relu(region).view(rows, COLS, 64)
                ry, rx = y0 - halo + torch.arange(rows), x0 - halo + \
                    torch.arange(COLS)
                inside = (((ry >= 0) & (ry < h))[:, None]
                          & ((rx >= 0) & (rx < w))[None, :])
                region = region * inside[..., None]
                if not fused:
                    ys, xs = min(rows, h - y0), min(COLS, w - x0)
                    out[b, y0:y0 + ys, x0:x0 + xs] = region[:ys, :xs]
                    continue
                flat = F.pad(region.reshape(-1, 64), (0, 0, 0, 8))  # 648 px
                acc = torch.zeros(64, 8 * COLS)
                n = torch.arange(8 * COLS)
                for tap in range(9):
                    dy, dx = divmod(tap, 3)
                    acc += wa[:, tap * 64:tap * 64 + 64] @ \
                        flat[n + dy * COLS + dx].T
                pooled = acc.view(64, 4, 2, 32, 2).amax(dim=(2, 4))
                pooled = torch.relu(pooled + b2[:, None, None])[:, :, :31]
                py, px = y0 // 2, x0 // 2
                ys, xs = min(4, h // 2 - py), min(31, w // 2 - px)
                out[b, py:py + ys, px:px + xs] = \
                    pooled[:, :ys, :xs].permute(1, 2, 0)
    return out


def _inputs(rng, shape, bias=None):
    """float32 x and bf16-representable float32 weights and biases."""
    x = torch.from_numpy(rng.standard_normal(shape + (3,)).astype(np.float32))
    ws = [torch.from_numpy(rng.standard_normal(s).astype(np.float32) * 0.2)
          .to(torch.bfloat16).float() for s in ((3, 3, 3, 64),
                                                 (3, 3, 64, 64))]
    bs = [torch.from_numpy(rng.standard_normal(64).astype(np.float32) * 0.1)
          if bias is None else torch.full((64,), bias) for _ in range(2)]
    return x.to(torch.bfloat16).float(), ws[0], bs[0], ws[1], bs[1]


@pytest.mark.parametrize("fused", [False, True], ids=["conv1", "fused"])
@pytest.mark.parametrize(
    "shape,bias", [((1, 38, 70), None), ((2, 16, 24), 50.0),
                   ((1, 20, 132), None)],
    ids=["ragged_38x70", "bias50_border", "three_col_tiles"])
def test_kernel_walk_equals_twin(fused, shape, bias):
    x, w1, b1, w2, b2 = _inputs(np.random.default_rng(sum(shape)), shape,
                                bias)
    if fused:
        got = _emulate(x, w1, b1, w2, b2)
        want = block1.block1_fused_torch(x, w1, b1, w2, b2)
    else:
        got = _emulate(x, w1, b1)
        want = block1.conv1_fused_torch(x, w1, b1)
    assert got.shape == want.shape
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= 1e-5 * scale
    if bias is not None and fused:  # a relu(50) leak past the border shows
        assert want[:, 0, 0].max() < want[:, 4, 4].max()


@pytest.mark.parametrize(
    "c1,c2,dtype,route",
    [
        (64, 64, torch.bfloat16, "sm90"),       # vgg2016's block 1
        (64, None, torch.bfloat16, "sm90"),     # conv1_1 alone
        (64, 64, torch.float32, "chain"),
        (64, None, torch.float32, "chain"),
        (32, 32, torch.bfloat16, "chain"),
        (32, None, torch.bfloat16, "chain"),
        (64, 128, torch.bfloat16, "chain"),
        (128, 64, torch.bfloat16, "chain"),
    ],
)
def test_plan_block1_routes_by_dtype_and_width(c1, c2, dtype, route):
    assert block1.plan_block1(c1, c2, dtype) == route


@pytest.mark.parametrize("layout", ["hwio", "module_view"])
def test_pack_block1_round_trips(layout):
    rng = np.random.default_rng(5)
    if layout == "hwio":
        w1 = torch.from_numpy(rng.standard_normal((3, 3, 3, 64)).astype(
            np.float32))
        w2 = torch.from_numpy(rng.standard_normal((3, 3, 64, 64)).astype(
            np.float32))
    else:   # what models.vgg.chain_params gives: OIHW permuted to HWIO
        w1 = torch.from_numpy(rng.standard_normal((64, 3, 3, 3)).astype(
            np.float32)).permute(2, 3, 1, 0)
        w2 = torch.from_numpy(rng.standard_normal((64, 64, 3, 3)).astype(
            np.float32)).permute(2, 3, 1, 0)
    packed = block1.pack_block1(w1, w2)
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    assert packed.shape == (27 * 64 + 9 * 64 * 64,)
    assert packed.data_ptr() % 16 == 0 and (27 * 64 * 2) % 16 == 0
    assert torch.equal(packed[:27 * 64].view(3, 3, 3, 64),
                       w1.to(torch.bfloat16))
    back = packed[27 * 64:].view(9, 8, 64, 8).transpose(2, 3).reshape(
        3, 3, 64, 64)
    assert torch.equal(back, w2.to(torch.bfloat16))
    g, co, j = 37, 5, 3                         # one entry by its index
    k = 8 * g + j
    dy, dx, ci = k // 192, k // 64 % 3, k % 64
    assert packed[27 * 64 + (g * 64 + co) * 8 + j] == \
        w2[dy, dx, ci, co].to(torch.bfloat16)
    assert torch.equal(block1.pack_block1(w1), packed[:27 * 64])


def test_cpu_tensors_take_the_twins():
    x, w1, b1, w2, b2 = _inputs(np.random.default_rng(8), (1, 8, 12))
    xb = x.to(torch.bfloat16)
    counts = (block1.conv1_fused.launches, block1.block1_fused.launches,
              cc.conv_chain.launches)
    assert torch.equal(block1.conv1_fused(xb, w1, b1),
                       block1.conv1_fused_torch(xb, w1, b1))
    assert torch.equal(block1.block1_fused(xb, w1, b1, w2, b2),
                       block1.block1_fused_torch(xb, w1, b1, w2, b2))
    assert (block1.conv1_fused.launches, block1.block1_fused.launches,
            cc.conv_chain.launches) == counts
