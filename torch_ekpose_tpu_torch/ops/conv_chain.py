"""Fused chains of 3x3 convs for the VGG prefix (kernel ``csrc/conv_chain.cu``).

Counterpart of the JAX package's ``ops/pallas_conv.py``: N chained
(3x3 SAME conv + bias + ReLU) layers, then an optional 2x2/2 max pool,
in one pass. Each layer's result is rounded to the input's dtype, and a
chained layer sees zeros beyond the image border, exactly as the unfused
chain does.

The public layouts are the JAX package's: ``x`` NHWC, each weight
``[3, 3, ci, co]`` HWIO, each bias ``[co]``. The TPU kernel's ``row_tile``
and ``interpret`` knobs are not carried over: the CUDA kernel picks its own
2-D tile. :func:`pack_weight` puts a weight into the kernel's layout
(``csrc/conv_common.cuh``); it runs on every call, a few small copies
beside the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from torch_ekpose_tpu_torch.ops import _build

__all__ = ["conv_chain", "conv_chain_torch", "pack_weight", "pad_ch"]

Params = Sequence[Tuple[torch.Tensor, torch.Tensor]]

#: the most layers one ``ekp_conv_chain`` launch takes (``kMaxLayers``)
MAX_LAYERS = 8
_DTYPES = (torch.bfloat16, torch.float32)


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
    ``[taps, k_pad, n_pad]``: plain for float32; for bf16 in mma.sync
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


def check_input(name: str, x: torch.Tensor) -> None:
    """Raise unless ``x`` is a CUDA NHWC tensor the kernels take."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype not in _DTYPES or x.dim() != 4:
        raise ValueError(f"{name}: expected bfloat16 or float32 NHWC, got "
                         f"{x.dtype} {tuple(x.shape)}")


def conv_chain(x: torch.Tensor, params: Params,
               pool: bool = False) -> torch.Tensor:
    """``[B, H, W, C]`` -> the chain's output, ``[B, H, W, co]`` or
    ``[B, H/2, W/2, co]`` when pooling, in ``x.dtype``.

    A CPU tensor takes the twin; a CUDA tensor launches ``ekp_conv_chain``
    (bf16 or float32, float32 sums) or raises.
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
        if (w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, chans[-1])
                or tuple(b.shape) != (w.shape[3],)):
            raise ValueError(
                f"conv_chain: layer {len(chans)} takes [3, 3, {chans[-1]}, co]"
                f" and [co], got {tuple(w.shape)} and {tuple(b.shape)}")
        if w.device != x.device or b.device != x.device:
            raise ValueError("conv_chain: weights on another device")
        chans.append(w.shape[3])
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
            h, w_, int(pool), int(x.dtype == torch.bfloat16),
            _build.stream_of(x),
        )
    _build.check(err, "ekp_conv_chain")
    conv_chain.launches += 1
    return out


#: launches of the CUDA kernel since the count was last set to 0
conv_chain.launches = 0
