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
(narrow chains) runs fused in one ``ekp_conv_chain`` launch, 2-D tiles
with halo recompute. :func:`pack_weight` and :func:`pack_weight_kmajor`
put a weight into each kernel's layout; they run on every call, a few
small copies beside the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from torch_ekpose_tpu_torch.ops import _build

__all__ = ["conv3x3_f32", "conv3x3_sm90", "conv_chain", "conv_chain_torch",
           "f32_tile_n", "pack_weight", "pack_weight_kmajor", "pad_ch",
           "plan_chain", "sm90_tile_n"]

Params = Sequence[Tuple[torch.Tensor, torch.Tensor]]

#: the most layers one ``ekp_conv_chain`` launch takes (``kMaxLayers``)
MAX_LAYERS = 8
_DTYPES = (torch.bfloat16, torch.float32)
#: ``ekp_conv3x3_sm90``'s K chunk (ci must be a multiple) and its two
#: N tiles (co must be a multiple of one)
SM90_CI, SM90_TILES_N = 64, (128, 64)
#: ``ekp_conv3x3_f32``'s K chunk (ci is padded to a multiple)
F32_CHUNK = 8


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
    """``[taps, k, n]`` weights -> the kernels' layout, zero-padded to
    ``[taps, k_pad, n_pad]``: plain for float32 (``ekp_conv3x3_f32``); for
    bf16 (``ekp_conv_chain``) in mma.sync
    fragment order ``[tap][k / 16][n / 8][lane][4]``, where lane
    ``4 * n + q`` holds rows ``k = 2q, 2q + 1, 2q + 8, 2q + 9`` of column
    ``n`` (PTX's m16n8k16 B fragment)."""
    taps, k, n = w.shape
    w = F.pad(w.to(dtype), (0, n_pad - n, 0, k_pad - k))
    if dtype == torch.bfloat16:
        # k = 8 * kh + 2 * q + kl  ->  [tap, kc, nt, n8, q, kh, kl]
        w = w.view(taps, k_pad // 16, 2, 4, 2, n_pad // 8, 8)
        w = w.permute(0, 1, 5, 6, 3, 2, 4)
    return w.contiguous()


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


def _conv_chain_fused(x: torch.Tensor, params: Params, chans: Sequence[int],
                      pool: bool) -> torch.Tensor:
    """The whole bf16 chain in one ``ekp_conv_chain`` launch."""
    x = x.contiguous()
    ws = [pack_weight(w.reshape(9, ci, co), pad_ch(ci), pad_ch(co), x.dtype)
          for (w, _), ci, co in zip(params, chans, chans[1:])]
    bs = [pad_bias(b, pad_ch(co)) for (_, b), co in zip(params, chans[1:])]
    n, (bsz, h, w_, _) = len(params), x.shape
    shape = (bsz, h // 2, w_ // 2, chans[-1]) if pool else (bsz, h, w_,
                                                            chans[-1])
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    w_ptrs = (ctypes.c_void_p * n)(*(t.data_ptr() for t in ws))
    b_ptrs = (ctypes.c_void_p * n)(*(t.data_ptr() for t in bs))
    ch_arr = (ctypes.c_int * (n + 1))(*chans)
    with torch.cuda.device(x.device):
        err = _build.lib().ekp_conv_chain(
            _build.ptr(x), _build.ptr(out), w_ptrs, b_ptrs, ch_arr, n, bsz,
            h, w_, int(pool), _build.stream_of(x),
        )
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
