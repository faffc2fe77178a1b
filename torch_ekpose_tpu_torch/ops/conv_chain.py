"""Chains of 3x3 convs for the VGG prefix (kernels ``csrc/conv_chain.cu``,
``csrc/conv3x3_sm90.cu`` and ``csrc/conv3x3_f32.cu``).

Counterpart of the JAX package's ``ops/pallas_conv.py``: N chained
(3x3 SAME conv + bias + ReLU) layers, then an optional 2x2/2 max pool.
Each layer's result is rounded to the input's dtype, and a chained layer
sees zeros beyond the image border, exactly as the unfused chain does.

The public layouts are the JAX package's: ``x`` NHWC, each weight
``[3, 3, ci, co]`` HWIO, each bias ``[co]``. The TPU kernel's ``row_tile``
and ``interpret`` knobs are not carried over. On a card, :func:`plan_chain`
picks the kernel by dtype and shape: every float32 chain runs as one
:func:`conv3x3_f32` launch per layer (FFMA, the pool in the last launch,
each intermediate a float32 NHWC tensor); vgg2016's block 1 (bf16
``[3, 64, 64]`` with the pool) runs as one ``block1_fused`` launch
(``ops/block1.py``, the same function); a bf16 chain whose every layer
has ``ci % 64 == 0`` and ``co % 64 == 0`` (blocks 2 and 3, conv1_2 after
conv1_1 alone) runs as one :func:`conv3x3_sm90` launch per layer (TMA +
wgmma, each intermediate a bf16 NHWC tensor); every other bf16 chain
(narrow chains) runs fused in one ``ekp_conv_chain`` launch (persistent
CTAs, 2-D tiles with halo recompute, weights resident in shared memory,
wgmma), laid out by :func:`fused_plan`. :func:`pack_weight`,
:func:`pack_weight_kmajor` and :func:`pack_chain` put weights into each
kernel's layout; they run on every call, a few small copies beside the
kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from torch_ekpose_tpu_torch.ops import _build

__all__ = ["FusedPlan", "conv3x3_f32", "conv3x3_sm90", "conv_chain",
           "conv_chain_torch", "f32_tile_n", "fused_plan", "pack_chain",
           "pack_weight", "pack_weight_kmajor", "pad_ch", "plan_chain",
           "sm90_tile_n"]

Params = Sequence[Tuple[torch.Tensor, torch.Tensor]]

#: the most layers one ``ekp_conv_chain`` launch takes (``kMaxLayers``)
MAX_LAYERS = 8
_DTYPES = (torch.bfloat16, torch.float32)
#: ``ekp_conv3x3_sm90``'s K chunk (ci must be a multiple) and its two
#: N tiles (co must be a multiple of one)
SM90_CI, SM90_TILES_N = 64, (128, 64)
#: ``ekp_conv3x3_f32``'s K chunk (ci is padded to a multiple)
F32_CHUNK = 8
#: ``ekp_conv_chain``: its warpgroups (384 threads), the widest first
#: layer it takes as one patch product (K = round_up(9 ci, 16)), the
#: wgmma N of a weight chunk (one for the whole chain: one kernel per width,
#: as ptxas serializes the wgmmas of a kernel that holds several
#: accumulator shapes, and wider ones leave it too few registers to keep a
#: batch in flight), and the output tiles (rows x columns)
#: :func:`fused_plan` weighs (even, as the pool needs; the last layer's
#: 2x8 pixel blocks drop the columns past a tile narrower than 8)
FUSED_WARPGROUPS = 3
PATCH_MAX_CI = 8
CHUNK_WIDTHS = (32, 24, 16, 8)
FUSED_TILES_H = (32, 16, 8, 4, 2)
FUSED_TILES_W = (64, 48, 32, 24, 16, 8, 4, 2)


def pad_ch(c: int) -> int:
    """Channels padded to the kernels' 16-wide K chunk and N tile."""
    return -(-c // 16) * 16


def conv_chain_torch(x: torch.Tensor, params: Params,
                     pool: bool) -> torch.Tensor:
    """Plain PyTorch twin (the CPU path and the kernel's oracle).

    Each layer sums in float32 over operands of ``x.dtype`` (as the JAX
    package's ``conv_chain_xla`` does with ``preferred_element_type``),
    adds the bias, applies ReLU and rounds to ``x.dtype``. A caller on a
    card turns TF32 off for an exact float32 reference.
    """
    dtype = x.dtype
    y = x.permute(0, 3, 1, 2).float()
    for w, b in params:
        w = w.to(dtype).float().permute(3, 2, 0, 1)          # HWIO -> OIHW
        y = F.conv2d(y, w, b.float(), padding=1)
        y = torch.relu(y).to(dtype).float()
    if pool:
        y = F.max_pool2d(y, 2, 2)
    return y.to(dtype).permute(0, 2, 3, 1).contiguous()


def pack_weight(w: torch.Tensor, k_pad: int, n_pad: int,
                dtype: torch.dtype) -> torch.Tensor:
    """``[taps, k, n]`` weights -> ``ekp_conv3x3_f32``'s plain layout,
    zero-padded to ``[taps, k_pad, n_pad]`` in ``dtype``."""
    _, k, n = w.shape
    return F.pad(w.to(dtype), (0, n_pad - n, 0, k_pad - k)).contiguous()


def pad_bias(b: torch.Tensor, n_pad: int) -> torch.Tensor:
    return F.pad(b.float(), (0, n_pad - b.shape[0])).contiguous()


def sm90_tile_n(co: int):
    """``ekp_conv3x3_sm90``'s N tile for ``co`` output channels: 128 where
    ``co % 128 == 0`` (blocks 2-3), else 64 where ``co % 64 == 0``
    (conv1_2), else None (the kernel does not take it)."""
    return next((n for n in SM90_TILES_N if co % n == 0), None)


def f32_tile_n(co: int) -> int:
    """``ekp_conv3x3_f32``'s N tile for ``co`` output channels: 64 (with
    16x16 pixels) where ``co <= 64``, else 128 (with 8x16 pixels); ``co``
    is padded to a multiple of it."""
    return 64 if co <= 64 else 128


def plan_chain(chans: Sequence[int], dtype: torch.dtype,
               pool: bool = False) -> str:
    """The kernel a CUDA chain takes, from its channels (the input's, then
    each layer's output), dtype and pool: ``"f32"`` (one ``conv3x3_f32``
    launch per layer) for every float32 chain; ``"block1"`` (one
    ``block1_fused`` launch) for the pooled two-layer chain from 3
    channels that :func:`~torch_ekpose_tpu_torch.ops.block1.plan_block1`
    sends to ``block1_sm90`` (bf16, 64 and 64 channels); else ``"sm90"``
    (one ``conv3x3_sm90`` launch per layer) when it is bf16 and every
    layer has ``ci % 64 == 0`` and ``co % 64 == 0``; else ``"fused"`` (one
    ``ekp_conv_chain`` launch, bf16)."""
    from torch_ekpose_tpu_torch.ops.block1 import plan_block1

    if dtype == torch.float32:
        return "f32"
    layers = list(zip(chans, chans[1:]))
    if pool and len(layers) == 2 and chans[0] == 3 and plan_block1(
            chans[1], chans[2], dtype) == "sm90":
        return "block1"
    if dtype == torch.bfloat16 and layers and all(
            ci % SM90_CI == 0 and sm90_tile_n(co) for ci, co in layers):
        return "sm90"
    return "fused"


def pack_weight_kmajor(w: torch.Tensor,
                       dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``[3, 3, ci, co]`` HWIO -> ``[co, 9 ci]``, row ``n`` holding
    ``w[dy, dx, c, n]`` at ``k = (3 dy + dx) ci + c``: the K-major B operand
    of ``ekp_conv3x3_sm90``."""
    ci, co = w.shape[2], w.shape[3]
    return w.to(dtype).reshape(9 * ci, co).t().contiguous()


def check_input(name: str, x: torch.Tensor) -> None:
    """Raise unless ``x`` is a CUDA NHWC tensor the kernels take."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype not in _DTYPES or x.dim() != 4:
        raise ValueError(f"{name}: expected bfloat16 or float32 NHWC, got "
                         f"{x.dtype} {tuple(x.shape)}")


def _check_layer(name: str, x: torch.Tensor, ci: int, w: torch.Tensor,
                 b: torch.Tensor, layer: int) -> int:
    """Raise unless ``(w, b)`` is a 3x3 layer on ``ci`` channels on ``x``'s
    device; return its ``co``."""
    if (w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, ci)
            or tuple(b.shape) != (w.shape[3],)):
        raise ValueError(
            f"{name}: layer {layer} takes [3, 3, {ci}, co] and [co], got "
            f"{tuple(w.shape)} and {tuple(b.shape)}")
    if w.device != x.device or b.device != x.device:
        raise ValueError(f"{name}: weights on another device")
    return w.shape[3]


def conv3x3_sm90(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 pool: bool = False) -> torch.Tensor:
    """One 3x3 SAME conv + bias + ReLU (+ 2x2/2 max pool), bf16 NHWC
    ``[B, H, W, ci]`` -> ``[B, H, W, co]`` or ``[B, H/2, W/2, co]``.

    A CPU tensor takes the twin; a CUDA tensor launches
    ``ekp_conv3x3_sm90`` (bf16, ``ci % 64 == 0``, ``co % 64 == 0``, the N
    tile :func:`sm90_tile_n`, float32 sums) or raises.
    """
    if pool and (x.shape[1] % 2 or x.shape[2] % 2):
        raise ValueError("pooled conv3x3_sm90 needs even H and W")
    if x.device.type == "cpu":
        return conv_chain_torch(x, [(w, b)], pool)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_sm90: unsupported device {x.device}")
    if x.dtype != torch.bfloat16 or x.dim() != 4:
        raise ValueError(f"conv3x3_sm90: expected bfloat16 NHWC, got "
                         f"{x.dtype} {tuple(x.shape)}")
    bsz, h, w_, ci = x.shape
    co = _check_layer("conv3x3_sm90", x, ci, w, b, 1)
    tile_n = sm90_tile_n(co)
    if ci % SM90_CI or tile_n is None:
        raise ValueError(f"conv3x3_sm90: needs ci % {SM90_CI} == 0 and "
                         f"co % {SM90_TILES_N[-1]} == 0, got {ci} -> {co}")
    x = x.contiguous()
    if x.data_ptr() % 16:
        raise ValueError("conv3x3_sm90: input not 16-byte aligned")
    wk = pack_weight_kmajor(w)
    bias = b.float().contiguous()
    shape = (bsz, h // 2, w_ // 2, co) if pool else (bsz, h, w_, co)
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _build.lib().ekp_conv3x3_sm90(
            _build.ptr(x), _build.ptr(out), _build.ptr(wk), _build.ptr(bias),
            bsz, h, w_, ci, co, int(pool), tile_n, _build.stream_of(x))
    _build.check(err, "ekp_conv3x3_sm90")
    conv3x3_sm90.launches += 1
    return out


#: launches of the CUDA kernel since the count was last set to 0
conv3x3_sm90.launches = 0


def conv3x3_f32(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                pool: bool = False) -> torch.Tensor:
    """One 3x3 SAME conv + bias + ReLU (+ 2x2/2 max pool), float32 NHWC
    ``[B, H, W, ci]`` -> ``[B, H, W, co]`` or ``[B, H/2, W/2, co]``.

    A CPU tensor takes the twin; a CUDA tensor launches
    ``ekp_conv3x3_f32`` (float32, any ``ci`` and ``co``, FFMA sums: the
    twin's with TF32 off, in another order) or raises.
    """
    if pool and (x.shape[1] % 2 or x.shape[2] % 2):
        raise ValueError("pooled conv3x3_f32 needs even H and W")
    if x.device.type == "cpu":
        return conv_chain_torch(x, [(w, b)], pool)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_f32: unsupported device {x.device}")
    if x.dtype != torch.float32 or x.dim() != 4:
        raise ValueError(f"conv3x3_f32: expected float32 NHWC, got "
                         f"{x.dtype} {tuple(x.shape)}")
    bsz, h, w_, ci = x.shape
    co = _check_layer("conv3x3_f32", x, ci, w, b, 1)
    tile_n = f32_tile_n(co)
    co_pad = -(-co // tile_n) * tile_n
    x = x.contiguous()
    wp = pack_weight(w.reshape(9, ci, co), -(-ci // F32_CHUNK) * F32_CHUNK,
                     co_pad, torch.float32)
    bias = pad_bias(b, co_pad)
    shape = (bsz, h // 2, w_ // 2, co) if pool else (bsz, h, w_, co)
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _build.lib().ekp_conv3x3_f32(
            _build.ptr(x), _build.ptr(out), _build.ptr(wp), _build.ptr(bias),
            bsz, h, w_, ci, co, int(pool), tile_n, _build.stream_of(x))
    _build.check(err, "ekp_conv3x3_f32")
    conv3x3_f32.launches += 1
    return out


#: launches of the CUDA kernel since the count was last set to 0
conv3x3_f32.launches = 0


class FusedLayer(NamedTuple):
    """One layer of a :class:`FusedPlan` (``csrc/conv_chain.cu``'s
    ``Layer``)."""

    ci: int          # real channels in and out
    co: int
    n: int           # channels computed: round_up(co, nc)
    nc: int          # N of a weight chunk: one of CHUNK_WIDTHS, the chain's
    ksteps: int      # k16 steps: the patch's, or 9 x pad_ch(ci) / 16
    w_off: int       # byte offset of its packed weights
    b_off: int       # float offset of its padded bias
    ks: int          # 16-channel K slices a weight load of a sliced plan;
                     # pad_ch(ci) / 16 otherwise


class FusedPlan(NamedTuple):
    """How one ``ekp_conv_chain`` launch walks a chain: its output tile,
    the input box, and the byte offsets of everything in shared memory
    (from its 128-byte aligned start; ``smem`` includes 128 bytes to
    align it). :meth:`ints` is what the kernel reads."""

    n_layers: int
    batch: int
    height: int
    width: int
    pool: int
    th: int           # output tile rows and columns
    tw: int
    tiles_y: int
    tiles_x: int
    patch: int        # the first layer is one patch product
    resident: int     # every weight stays in shared memory; else one slot
    sliced: int       # the slot holds K slices of a chunk, not a chunk
    tma: int          # the box comes by TMA as [B, H, W, C] (4: C a
                      # multiple of 8, at most 256) or [B, H, W * C] (3:
                      # in_pitch at most 256, tw C a multiple of 8); 0:
                      # through registers
    smem: int
    off_in0: int      # the dense input box: two buffers for a patch
    off_in1: int      # layer, one (TMA) or none (registers) otherwise
    off_buf0: int     # the ping-pong regions; buffer n % 2 stages the tile
    off_buf1: int
    off_w: int
    off_patch: int    # the patch offsets, 16 ksteps int32
    in_pitch: int     # box row, elements (a multiple of 8)
    box_rows: int
    box_cols: int
    box_shift: int    # the box's first element in a row: (-n ci) % 8, so
                      # that a TMA box starts on 16 bytes
    w_bytes: int
    layers: Tuple[FusedLayer, ...]

    def ints(self) -> list:
        """The plan as ``csrc/conv_chain.cu``'s ``Plan``: the fields in
        order, then ``MAX_LAYERS`` layers (zeros past the chain)."""
        head = list(self[:-1])
        body = [v for layer in self.layers for v in layer]
        return head + body + [0] * (len(FusedLayer._fields)
                                    * (MAX_LAYERS - len(self.layers)))


#: the shared memory a plan may take (patched by a test)
_SMEM_MAX = _build.SMEM_OPTIN
#: bytes of one 16-channel K slice of a chunk, per column: 9 taps x 16 x bf16
_SLICE_BYTES = 9 * 16 * 2


def _up(v: int, m: int) -> int:
    return -(-v // m) * m


def _fused_layers(chans, patch: bool, nc: int) -> Tuple[FusedLayer, ...]:
    layers, w_off, b_off = [], 0, 0
    for j, (ci, co) in enumerate(zip(chans, chans[1:])):
        ksteps = (_up(9 * ci, 16) if j == 0 and patch else 9 * pad_ch(ci)) // 16
        n = _up(co, nc)
        layers.append(FusedLayer(ci, co, n, nc, ksteps, w_off, b_off,
                                 pad_ch(ci) // 16))
        w_off += 16 * ksteps * n * 2
        b_off += n
    return tuple(layers)


def _fused_layout(chans, batch: int, h: int, w: int, pool: bool, th: int,
                  tw: int, nc: int, tma: bool, sliced: bool):
    """The plan for one tile and chunk width, or None where nothing fits
    ``_SMEM_MAX``. Resident weights where they fit, else one chunk at a
    time, or under ``sliced`` as many K slices as fit."""
    n, ci = len(chans) - 1, chans[0]
    patch = ci <= PATCH_MAX_CI
    layers = _fused_layers(chans, patch, nc)
    box_rows, box_cols = th + 2 * n, tw + 2 * n
    box_shift = -n * ci % 8
    in_pitch = _up(box_shift + box_cols * ci, 8)
    mode = 0
    if tma:
        # a [B, H, W * C] box starts on 16 bytes only where every tile's
        # first element x0 C does (box_shift is one number)
        mode = (4 if ci % 8 == 0 and ci <= 256 else
                3 if in_pitch <= 256 and tw * ci % 8 == 0 else 0)
    boxes = 2 if patch else 1 if mode else 0
    sizes = [0, 0]
    if not patch:                       # the repacked box
        sizes[0] = box_rows * box_cols * (pad_ch(ci) + 8) * 2
    for j, L in enumerate(layers):
        # each output has a spare pixel after it (rows past the region)
        halo = n - 1 - j
        if j == n - 1:                  # the tile, staged for the store
            pix = th * tw // 4 if pool else th * tw
            need = (pix + 1) * (L.n + 8) * 2
        else:
            need = ((th + 2 * halo) * (tw + 2 * halo) + 1) * (
                pad_ch(L.n) + 8) * 2
        sizes[(j + 1) % 2] = max(sizes[(j + 1) % 2], need)
    box = 2 * box_rows * in_pitch
    offsets, at = {}, 128               # three mbarriers first
    for name, size in (("patch", 4 * _up(9 * ci, 16) if patch else 0),
                       ("in0", box if boxes else 0),
                       ("in1", box if boxes == 2 else 0),
                       ("buf0", sizes[0]), ("buf1", sizes[1])):
        offsets[name] = at
        at += _up(size, 128)
    room = _SMEM_MAX - at - 128         # the slot, from a 128-byte start
    w_bytes = sum(16 * L.ksteps * L.n * 2 for L in layers)
    chunk = [16 * L.ksteps * nc * 2 for L in layers]
    if sliced:
        slot = chunk[0] if patch else 0
        if slot > room or room < _SLICE_BYTES * nc:
            return None
        resident, sliced_layers = 0, []
        for j, L in enumerate(layers):
            if not (j == 0 and patch):
                # as many slices as fit, evened out over the loads
                loads = -(-L.ks // min(L.ks, room // (_SLICE_BYTES * nc)))
                L = L._replace(ks=-(-L.ks // loads))
                slot = max(slot, L.ks * _SLICE_BYTES * nc)
            sliced_layers.append(L)
        layers = tuple(sliced_layers)
    elif w_bytes <= room:
        resident, slot = 1, w_bytes
    elif max(chunk) <= room:
        resident, slot = 0, max(chunk)
    else:
        return None
    return FusedPlan(
        n, batch, h, w, int(pool), th, tw, -(-h // th), -(-w // tw),
        int(patch), resident, int(sliced), mode, at + _up(slot, 128) + 128,
        offsets["in0"], offsets["in1"], offsets["buf0"], offsets["buf1"], at,
        offsets["patch"], in_pitch, box_rows, box_cols,
        box_shift, w_bytes, layers)


#: the cost model's SM clocks, from scripts/profile_torch_chain.py's trace of
#: the timed block at its 32x48 tile (PERF.md section 6): a
#: warpgroup's M tile takes ~1138 + ~55 a k16 step (layer 1, 2 steps: 1248;
#: layer 2, 18 steps: 2131), a tile's box wait and store ~4672
_MT_CLOCKS, _STEP_CLOCKS, _TILE_CLOCKS = 1138, 55, 4672
#: bytes a clock one SM reads from L2 (a streamed weight copy)
_L2_BYTES_A_CLOCK = 64


def _fused_cost(plan: FusedPlan, n_sms: int) -> float:
    """A plan's time in SM clocks, to rank tiles: the waves of tiles over
    the SMs times a tile's time, each layer's M tiles taken in turn by the
    warpgroups, plus each streamed weight copy."""
    tile = _TILE_CLOCKS
    for j, L in enumerate(plan.layers):
        halo = plan.n_layers - 1 - j
        if j == plan.n_layers - 1:
            mtiles = -(-(plan.th // 2) * -(-plan.tw // 8) // 4)
        else:
            mtiles = -(-(plan.th + 2 * halo) * (plan.tw + 2 * halo) // 64)
        turns = -(-mtiles // FUSED_WARPGROUPS) * (L.n // L.nc)
        tile += turns * (_MT_CLOCKS + _STEP_CLOCKS * L.ksteps)
        if not plan.resident:
            copies = turns if plan.sliced and not (j == 0 and plan.patch) \
                else L.n // L.nc
            tile += copies * 16 * L.ksteps * L.nc * 2 / _L2_BYTES_A_CLOCK
    return -(-plan.batch * plan.tiles_y * plan.tiles_x // n_sms) * tile


@functools.lru_cache(maxsize=256)
def fused_plan(chans: Tuple[int, ...], batch: int, h: int, w: int,
               pool: bool, n_sms: int, tma: bool) -> FusedPlan:
    """The ``ekp_conv_chain`` plan for a bf16 chain (``chans``: the
    input's channels, then each layer's output) on a ``[batch, h, w, ci]``
    input on a card of ``n_sms`` SMs: of the tiles ``FUSED_TILES_H`` x
    ``FUSED_TILES_W`` (at most the image, rounded up to even rows and 8
    columns) whose buffers fit, the one :func:`_fused_cost` ranks first
    (ties: the larger tile). The chunk width is the widest layer's output
    rounded up to 8, at most 32 (every layer's output is padded to a
    multiple of it), or a narrower one of ``CHUNK_WIDTHS`` where nothing
    fits, or last the sliced kernel (8 wide, the weights K slice by K
    slice). ``tma`` says the input can be a TMA tensor (16-byte aligned,
    ``w * ci * 2 % 16 == 0``); a tile whose TMA box does not fit comes
    through registers. Raises ValueError where nothing fits."""
    widest = min(CHUNK_WIDTHS[0], _up(max(chans[1:]), 8))
    modes = [(nc, False) for nc in CHUNK_WIDTHS if nc <= widest]
    tiles = [(th, tw)
             for th in sorted({min(t, _up(h, 2)) for t in FUSED_TILES_H},
                              reverse=True)
             for tw in sorted({min(t, _up(w, 8)) for t in FUSED_TILES_W},
                              reverse=True)]
    for nc, sliced in modes + [(CHUNK_WIDTHS[-1], True)]:
        best = None
        for th, tw in tiles:
            plan = _fused_layout(chans, batch, h, w, pool, th, tw, nc, tma,
                                 sliced)
            if plan is None and tma:
                plan = _fused_layout(chans, batch, h, w, pool, th, tw, nc,
                                     False, sliced)
            if plan is not None:
                key = (_fused_cost(plan, n_sms), -th * tw)
                if best is None or key < best[0]:
                    best = (key, plan)
        if best is not None:
            return best[1]
    raise ValueError(f"conv_chain: no tile of the fused kernel fits "
                     f"{_SMEM_MAX} bytes of shared memory for channels "
                     f"{list(chans)}")


def _pack_chain(params: Params, plan: FusedPlan, dtype: torch.dtype):
    ws, bs = [], []
    for j, ((w, b), L) in enumerate(zip(params, plan.layers)):
        if j == 0 and plan.patch:
            wk = w.to(dtype).reshape(-1, L.co)
        else:                    # [dy, dx, kk, 16, co] -> [kk, dy, dx, 16, co]
            cp = pad_ch(L.ci)
            wk = F.pad(w.to(dtype), (0, 0, 0, cp - L.ci)).reshape(
                9, cp // 16, 16, L.co).transpose(0, 1).reshape(-1, L.co)
        k = 16 * L.ksteps
        wk = F.pad(wk, (0, L.n - L.co, 0, k - wk.shape[0]))
        # [K, n] -> [chunk][K / 8][nc][8]
        ws.append(wk.view(k // 8, 8, L.n // L.nc, L.nc).permute(2, 0, 3, 1)
                  .reshape(-1))
        bs.append(F.pad(b.float(), (0, L.n - L.co)))
    return torch.cat(ws).contiguous(), torch.cat(bs).contiguous()


def pack_chain(params: Params, plan: FusedPlan) -> Tuple[torch.Tensor,
                                                        torch.Tensor]:
    """Every layer's weight and bias in ``ekp_conv_chain``'s layout: one
    bf16 tensor holding, layer after layer (at ``w_off``), the ``[K, n]``
    matrix of its 3x3 weights (zero past ci, co and K; row k = (3 dy + dx)
    ci + c for the patch layer, else 144 kk + 16 (3 dy + dx) + c % 16 for
    channel c of 16-channel slice kk = c // 16, so that a slice is
    contiguous) cut into chunks of ``nc`` columns, each chunk in wgmma's
    no-swizzle K-major layout ``[K / 8][nc][8]``; and one float32 tensor of
    the biases, each zero-padded to ``n`` (at ``b_off``)."""
    return _pack_chain(params, plan, torch.bfloat16)


@functools.lru_cache(maxsize=16)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=256)
def _plan_ints(plan: FusedPlan):
    ints = plan.ints()
    return (ctypes.c_int * len(ints))(*ints)


def _conv_chain_fused(x: torch.Tensor, params: Params, chans: Sequence[int],
                      pool: bool) -> torch.Tensor:
    """The whole bf16 chain in one ``ekp_conv_chain`` launch."""
    x = x.contiguous()
    bsz, h, w_, ci = x.shape
    tma = x.data_ptr() % 16 == 0 and w_ * ci * 2 % 16 == 0
    plan = fused_plan(tuple(chans), bsz, h, w_, bool(pool),
                      _sm_count(x.device.index), tma)
    wp, bp = pack_chain(params, plan)
    shape = (bsz, h // 2, w_ // 2, chans[-1]) if pool else (bsz, h, w_,
                                                            chans[-1])
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    ints = _plan_ints(plan)
    with torch.cuda.device(x.device):
        err = _build.lib().ekp_conv_chain(
            _build.ptr(x), _build.ptr(out), _build.ptr(wp), _build.ptr(bp),
            ints, len(ints), _build.stream_of(x))
    _build.check(err, "ekp_conv_chain")
    conv_chain.launches += 1
    return out


def conv_chain(x: torch.Tensor, params: Params,
               pool: bool = False) -> torch.Tensor:
    """``[B, H, W, C]`` -> the chain's output, ``[B, H, W, co]`` or
    ``[B, H/2, W/2, co]`` when pooling, in ``x.dtype``.

    A CPU tensor takes the twin; a CUDA tensor runs the kernel
    :func:`plan_chain` picks (bf16 or float32, float32 sums) or raises.
    ``conv_chain.launches`` counts ``ekp_conv_chain`` launches only; the
    other routes' launches are counted by ``conv3x3_f32.launches``,
    ``conv3x3_sm90.launches`` and ``block1_fused.launches``.
    """
    params = list(params)
    if pool and (x.shape[1] % 2 or x.shape[2] % 2):
        raise ValueError("pooled conv_chain needs even H and W")
    if x.device.type == "cpu":
        return conv_chain_torch(x, params, pool)
    check_input("conv_chain", x)
    if not 1 <= len(params) <= MAX_LAYERS:
        raise ValueError(f"conv_chain: 1 to {MAX_LAYERS} layers, got "
                         f"{len(params)}")
    chans = [x.shape[3]]
    for w, b in params:
        chans.append(_check_layer("conv_chain", x, chans[-1], w, b,
                                  len(chans)))
    route = plan_chain(chans, x.dtype, pool)
    if route == "fused":
        return _conv_chain_fused(x, params, chans, pool)
    if route == "block1":
        from torch_ekpose_tpu_torch.ops.block1 import block1_fused

        return block1_fused(x, *params[0], *params[1])
    layer = conv3x3_f32 if route == "f32" else conv3x3_sm90
    last = len(params) - 1
    for i, (w, b) in enumerate(params):
        x = layer(x, w, b, pool=pool and i == last)
    return x


#: launches of ``ekp_conv_chain`` since the count was last set to 0
conv_chain.launches = 0
