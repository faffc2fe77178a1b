"""The host side of ``conv_chain``'s fused route on the CPU: the tile plan
(``fused_plan``), the weight packing (``pack_chain``) and a plain
emulation of ``csrc/conv_chain.cu``'s walk, held against
``conv_chain_torch``.

The emulation follows the kernel, not the math. For each output tile of
the plan it takes the input box as TMA brings it (dense rows of
``in_pitch`` elements, zero outside the image), then runs each layer over
its region (the tile plus ``n - 1 - j`` pixels of halo) as the kernel's
M tiles order it: 64 rows of consecutive pixels, or for the last layer
four 2x8 pixel blocks a tile (columns past a narrower tile dropped). The
first layer with ci <= 8 reads its A rows through the kernel's table of
patch offsets (K = round_up(9 ci, 16)); other layers read the 9 shifted
windows of a region padded to ``pad_ch(ci)`` channels, 16-channel slice
by slice. B is read back from the packed tensor by the kernel's chunked
``[K / 8][nc][8]`` addressing. The epilogue adds the bias, applies ReLU and zeroes pixels outside the image; the last layer
pools inside the tile as the registers pair its rows (rows r and r + 8 of
a block, lanes g and g ^ 1), and only pixels inside the image are
stored. In float32 it must equal the twin within 1e-5 of max|twin| (the
sums run in another order). It catches index and layout mistakes before
the kernel runs on a card; it is on no path of the port. The plan's
fields are held to the kernel's ``Plan`` and ``Layer`` structs, and every
fused-route chain the ``mma.sync`` kernel before this one took must plan
(TMA only where TMA can describe the box, weights resident, by chunk or
by K slice).
"""

import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402

import torch_port_inputs as inputs  # noqa: E402
from torch_ekpose_tpu_torch.ops import conv_chain as cc  # noqa: E402

torch.set_num_threads(2)  # xdist already runs one process per core


def _row_pixels(plan, j):
    """(pr, pc, valid) of every M-tile row of layer j, in the kernel's
    order (``row_pixel`` in csrc/conv_chain.cu)."""
    n = plan.n_layers
    halo = n - 1 - j
    rows, cols = plan.th + 2 * halo, plan.tw + 2 * halo
    if j == n - 1:
        bx = -(-plan.tw // 8)
        mtiles = -(-(plan.th // 2) * bx // 4)
        blk = torch.arange(4 * mtiles)[:, None]                 # 4 mt + w
        r = torch.arange(16)[None, :]
        pr, pc = 2 * (blk // bx) + r // 8, 8 * (blk % bx) + r % 8
        valid = (blk < (plan.th // 2) * bx) & (pc < plan.tw)
        pr, pc, valid = pr.reshape(-1), pc.reshape(-1), valid.reshape(-1)
    else:
        m = torch.arange(64 * -(-rows * cols // 64))
        valid = m < rows * cols
        pr, pc = m // cols, m % cols
    pr, pc = torch.where(valid, pr, 0), torch.where(valid, pc, 0)
    return pr, pc, valid


def _patch_offsets(plan, ci):
    e = torch.clamp(torch.arange(16 * plan.layers[0].ksteps), max=9 * ci - 1)
    return e // (3 * ci) * plan.in_pitch + e % (3 * ci) + plan.box_shift


def _unpack_chain(wp, plan):
    """Each layer's ``[K, n]`` matrix back from ``pack_chain``'s tensor,
    read by the kernel's addressing: entry (k, c0 + n) of chunk c0 at
    ``w_off / 2 + c0 K + ((k // 8) nc + n) 8 + k % 8`` elements."""
    mats = []
    for L in plan.layers:
        k = 16 * L.ksteps
        kk = torch.arange(k)[:, None]
        nn = torch.arange(L.nc)[None, :]
        mats.append(torch.cat([
            wp[L.w_off // 2 + c0 * k + ((kk // 8) * L.nc + nn) * 8 + kk % 8]
            for c0 in range(0, L.n, L.nc)], dim=1))
    return mats


def _emulate(x, params, pool, plan):
    """``ekp_conv_chain`` on float32 ``x`` [B, H, W, C], walked as the
    kernel walks it under ``plan``."""
    wp, bp = cc._pack_chain(params, plan, torch.float32)
    mats = _unpack_chain(wp, plan)
    n, (bsz, h, w, c) = plan.n_layers, x.shape
    # the [B, H, W * C] input with TMA's zero fill around it; a box row
    # starts box_shift elements before the tile's (16-byte aligned)
    left = n * c + plan.box_shift
    xe = F.pad(x.reshape(bsz, h, w * c),
               (left, plan.tw * c + plan.in_pitch, n, plan.th + n))
    f = 2 if pool else 1
    co = plan.layers[-1].co
    out = torch.zeros(bsz, h // f, w // f, co)
    for t in range(bsz * plan.tiles_y * plan.tiles_x):
        b, r = divmod(t, plan.tiles_y * plan.tiles_x)
        y0, x0 = r // plan.tiles_x * plan.th, r % plan.tiles_x * plan.tw
        box = xe[b, y0:y0 + plan.box_rows, x0 * c:x0 * c + plan.in_pitch]
        assert plan.tma != 3 or ((x0 - n) * c - plan.box_shift) % 8 == 0
        region = None
        for j, layer in enumerate(plan.layers):
            last, halo = j == n - 1, n - 1 - j
            cols = plan.tw + 2 * halo
            pr, pc, valid = _row_pixels(plan, j)
            if j == 0 and plan.patch:
                base = pr * plan.in_pitch + pc * c
                a = box.reshape(-1)[base[:, None]
                                    + _patch_offsets(plan, c)[None, :]]
            else:
                if j == 0:        # the repacked box, padded to pad_ch(ci)
                    s0 = plan.box_shift
                    region = F.pad(box[:, s0:s0 + plan.box_cols * c].reshape(
                        plan.box_rows, plan.box_cols, c),
                        (0, cc.pad_ch(c) - c))
                # step 9 kk + 3 dy + dx: slice kk of tap (dy, dx)
                a = torch.cat([region[pr + dy, pc + dx, 16 * kk:16 * kk + 16]
                               for kk in range(layer.ks if not plan.sliced
                                               else cc.pad_ch(layer.ci) // 16)
                               for dy in range(3) for dx in range(3)], 1)
            bias = bp[layer.b_off:layer.b_off + layer.n]
            y = torch.relu(a @ mats[j] + bias)                  # [rows, n]
            if not last:
                iy, ix = y0 - halo + pr, x0 - halo + pc
                inside = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
                y = torch.where(inside[:, None], y, 0.0)
                region = torch.zeros(plan.th + 2 * halo, cols,
                                     cc.pad_ch(layer.n))
                region[pr[valid], pc[valid], :layer.n] = y[valid]
                continue
            if pool:
                # [mt, warp, row (h, g)]: rows g, g + 8 of a block, then
                # lanes g, g ^ 1 (the pool windows of the block's columns)
                blocks = y.view(-1, 2, 4, 2, layer.n).amax(dim=(1, 3))
                pr, pc, valid = pr.view(-1, 16)[:, 0] // 2, pc.view(
                    -1, 16)[:, 0] // 2, valid.view(-1, 16)[:, 0]
                pr = pr[:, None].expand(-1, 4).reshape(-1)
                pc = (pc[:, None] + torch.arange(4)).reshape(-1)
                valid = valid[:, None].expand(-1, 4).reshape(-1)
                y = blocks.reshape(-1, layer.n)
            oy, ox = y0 // f + pr, x0 // f + pc
            keep = valid & (oy < h // f) & (ox < w // f)
            out[b, oy[keep], ox[keep]] = y[keep, :co]
    return out


def _torch_arrays(rng, shape, chain, bias=None):
    x, params = inputs.narrow_arrays(rng, shape, chain, bias)
    return torch.from_numpy(x), [(torch.from_numpy(w), torch.from_numpy(b))
                                 for w, b in params]


#: ``inputs.NARROW_CHAINS`` planned for one SM, where large tiles win
PLAN_SMS = {"timed_tile": 1}
H100_SMS = 132


def _plan(chans, shape, pool, n_sms=H100_SMS):
    """The card's plan for a TMA-ready input of ``shape``."""
    return cc.fused_plan(tuple(chans), *shape[:3], pool, n_sms,
                         shape[2] * shape[3] * 2 % 16 == 0)


@pytest.mark.parametrize("name", list(inputs.NARROW_CHAINS))
def test_kernel_walk_equals_twin(name):
    shape, chain, pool, bias = inputs.NARROW_CHAINS[name]
    x, params = _torch_arrays(np.random.default_rng(sum(shape)), shape,
                              chain, bias)
    chans = (chain[0][0],) + tuple(co for _, co in chain)
    plan = _plan(chans, shape, pool, PLAN_SMS.get(name, H100_SMS))
    got = _emulate(x, params, pool, plan)
    want = cc.conv_chain_torch(x, params, pool)
    assert got.shape == want.shape
    scale = want.abs().max().item()
    assert scale > 0
    assert (got - want).abs().max().item() <= 1e-5 * scale
    if bias is not None:        # a relu(50) leak past the border would show
        assert scale > 50
    if name == "staged_weights":
        assert not plan.resident and plan.layers[0].ksteps == 27
    if name == "timed_tile":
        assert (plan.th, plan.tw, plan.patch, plan.tma, plan.resident) == (
            32, 48, 1, 3, 1)
    # the box by TMA: [B, H, W, C] where C % 8 == 0 (at most 256), else
    # [B, H, W * C] where a box row is at most 256 elements and starts on
    # 16 bytes, else registers
    ci = chans[0]
    assert plan.tma == (4 if ci % 8 == 0 and ci <= 256 else 3 if (
        plan.in_pitch <= 256 and plan.tw * ci % 8 == 0) else 0)
    if name == "n8":                  # N = 8 and the next layer's K padding
        assert [(L.n, L.nc) for L in plan.layers] == [(8, 8)] * 3
    if name == "ci320":
        assert plan.tma == 0 and not plan.sliced
    if name == "sliced":              # 4 loads of 32 slices, a 4x4 tile
        L = plan.layers[0]
        assert plan.sliced and not plan.resident and L.nc == 8
        assert L.ks < cc.pad_ch(L.ci) // 16 and plan.tw < 8


def test_plan_of_the_timed_block():
    """[3, 32, 32] + pool at batch 8, 368x432 on an H100: 32x48 tiles
    (the first layer recomputes 11% of its pixels), the patch layer
    (K = 32), weights resident, TMA, within the opt-in shared memory;
    and the plan's offsets in order, 128-byte aligned, disjoint."""
    plan = _plan((3, 32, 32), (8, 368, 432, 3), True)
    assert (plan.th, plan.tw, plan.tiles_y, plan.tiles_x) == (32, 48, 12, 9)
    assert plan.patch and plan.resident and plan.tma == 3
    assert [L.ksteps for L in plan.layers] == [2, 18]
    assert plan.in_pitch == 160 and plan.box_rows == 36
    assert plan.box_shift == 2        # -2 x 3 elements, rounded to 8
    assert (34 * 50) / (32 * 48) < 1.15
    offs = [plan.off_patch, plan.off_in0, plan.off_in1,
            plan.off_buf0, plan.off_buf1, plan.off_w]
    assert offs == sorted(offs) and all(o % 128 == 0 for o in offs)
    assert plan.off_w + plan.w_bytes + 128 <= plan.smem <= 232448
    assert len(plan.ints()) == 25 + 8 * cc.MAX_LAYERS


@pytest.mark.parametrize("chans,h,w", [
    ((3, 32, 32), 36, 24),
    ((16, 24, 32), 20, 20),
    ((64, 128, 96), 16, 16),          # chunks of 32: four, then three
    ((48,) * 9, 12, 16),              # streamed one chunk at a time
    ((2048, 8), 4, 6),                # streamed K slice by K slice
])
def test_pack_chain_round_trips(chans, h, w):
    """pack_chain -> _unpack_chain (the kernel's addressing) gives back
    each layer's [K, n] matrix: the HWIO weight at row (3 dy + dx) ci + c
    (patch) or 144 (c // 16) + 16 (3 dy + dx) + c % 16, zero elsewhere;
    each bias padded to n."""
    _, params = _torch_arrays(np.random.default_rng(sum(chans)), (1, 1, 1, 1),
                              list(zip(chans, chans[1:])))
    plan = _plan(chans, (1, h, w, chans[0]), False)
    wp, bp = cc.pack_chain(params, plan)
    assert wp.dtype == torch.bfloat16 and bp.dtype == torch.float32
    assert wp.numel() * 2 == plan.w_bytes
    assert bp.numel() == sum(L.n for L in plan.layers)
    for j, ((wt, b), L, mat) in enumerate(zip(params, plan.layers,
                                              _unpack_chain(wp, plan))):
        want = torch.zeros(16 * L.ksteps, L.n, dtype=torch.bfloat16)
        wt = wt.reshape(9, L.ci, L.co).to(torch.bfloat16)
        if j == 0 and plan.patch:
            want[:9 * L.ci, :L.co] = wt.reshape(-1, L.co)
        else:
            cp = cc.pad_ch(L.ci)
            taps = torch.zeros(9, cp, L.co, dtype=torch.bfloat16)
            taps[:, :L.ci] = wt
            want[:, :L.co] = taps.view(9, cp // 16, 16, L.co).transpose(
                0, 1).reshape(-1, L.co)
        assert torch.equal(mat, want)
        assert torch.equal(bp[L.b_off:L.b_off + L.co], b)
        assert not bp[L.b_off + L.co:L.b_off + L.n].any()
    if chans[0] == 64:
        assert [L.nc for L in plan.layers] == [32, 32]
    if plan.sliced:                   # the slices cover K, the slot fits
        L = plan.layers[0]
        assert L.ks * 144 * L.nc * 2 <= plan.smem - plan.off_w - 128


def _struct_fields(source, name):
    """The int fields of ``struct name`` in a CUDA source, in order."""
    body = re.search(r"struct %s \{(.*?)\n\};" % name, source, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    return [f.strip() for decl in re.findall(r"\bint ([^;]*);", body)
            for f in decl.split(",")]


def test_plan_fields_are_the_kernels():
    """FusedPlan.ints() is read as csrc/conv_chain.cu's Plan and Layer:
    the same fields in the same order."""
    path = os.path.join(os.path.dirname(cc.__file__), os.pardir, "csrc",
                        "conv_chain.cu")
    with open(path) as f:
        source = f.read()
    assert _struct_fields(source, "Layer") == list(cc.FusedLayer._fields)
    assert _struct_fields(source, "Plan") == list(cc.FusedPlan._fields[:-1])
    assert "Layer layer[kMaxLayers];" in source


def test_fused_plan_refuses_what_fits_nowhere(monkeypatch):
    monkeypatch.setattr(cc, "_SMEM_MAX", 2048)
    cc.fused_plan.cache_clear()
    try:
        with pytest.raises(ValueError, match="no tile of the fused kernel"):
            _plan((8, 8), (1, 16, 16, 8), False)
    finally:
        cc.fused_plan.cache_clear()


def _mma_sync_kernel_took(chans, h, w):
    """Whether the mma.sync kernel this one replaced took the chain: one
    of its tiles, 32x32 to 2x2 (at most the image rounded up to even),
    whose two ping-pong buffers (the input box and the odd layers' outputs,
    the even layers' outputs; pad_ch(c) + 8 elements a pixel) fit 232448
    bytes of shared memory."""
    n = len(chans) - 1
    for th, tw in ((32, 32), (32, 16), (16, 16), (16, 8), (8, 8), (8, 4),
                   (4, 4), (2, 2)):
        th, tw = min(th, -(-h // 2) * 2), min(tw, -(-w // 2) * 2)
        sizes = [(th + 2 * n) * (tw + 2 * n) * (cc.pad_ch(chans[0]) + 8), 0]
        for j in range(n):
            halo = n - 1 - j
            sizes[(j + 1) % 2] = max(sizes[(j + 1) % 2], (th + 2 * halo) * (
                tw + 2 * halo) * (cc.pad_ch(chans[j + 1]) + 8))
        if (-(-sizes[0] // 8) * 8 + sizes[1]) * 2 <= 232448:
            return True
    return False


def test_fused_plan_takes_every_chain_the_mma_sync_kernel_took():
    """Every fused-route chain the replaced kernel took plans, from 3 to
    7000 input channels, up to 8 layers up to 1024 wide, at 368x432 and
    6x10: the TMA box only where TMA can describe it, weights resident,
    streamed by chunk, or K slice by K slice, and tiles down to 2x2."""
    took = planned = 0
    for ci in (3, 8, 24, 100, 320, 1024, 2048, 4096, 7000):
        for co in (8, 100, 256, 1024):
            for depth in (1, 2, 4, 8):
                chans = (ci,) + (co,) * depth
                if cc.plan_chain(chans, torch.bfloat16) != "fused":
                    continue
                for h, w in ((368, 432), (6, 10)):
                    if not _mma_sync_kernel_took(chans, h, w):
                        continue
                    took += 1
                    plan = _plan(chans, (1, h, w, ci), False)
                    assert plan.smem <= 232448
                    assert plan.tma != 4 or ci <= 256
                    assert plan.tma != 3 or (plan.in_pitch <= 256
                                             and plan.tw * ci % 8 == 0)
                    planned += 1
    assert took == planned and took > 100
