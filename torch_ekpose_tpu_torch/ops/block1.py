"""VGG block 1 fused (kernel ``csrc/block1_sm90.cu``).

Counterpart of the two TPU kernels of the JAX package's
``scripts/profile_block1.py``:

- :func:`conv1_fused` = relu(conv1_1(x)), SAME padding;
- :func:`block1_fused` = pool(relu(conv1_2(relu(conv1_1(x))))), with a
  2x2/2 max pool;

each with conv1_1 as one product of 27-deep patches. The TPU script's
variants A and B compute the same function with differently shaped MXU
products; on Hopper they are one kernel, so there is no ``variant``
argument. The twins are :func:`conv_chain_torch` on ``[(w1, b1)]``
without a pool and on ``[(w1, b1), (w2, b2)]`` with one. Layouts are the
JAX package's: ``x`` ``[B, H, W, 3]`` NHWC, ``w1`` ``[3, 3, 3, c1]`` and
``w2`` ``[3, 3, c1, c2]`` HWIO, biases ``[c]``.

On a card, :func:`plan_block1` picks the kernel by dtype and widths:
vgg2016's block 1 in bf16 (``c1 == c2 == 64``) launches
``ekp_block1_sm90`` (persistent CTAs, conv1_2 on wgmma); every other input
runs the same function through :func:`conv_chain`: float32 as one
``conv3x3_f32`` launch per layer (``conv3x3_f32.launches``), bf16 of
other widths on its fused kernel (``conv_chain.launches``).
``conv1_fused.launches`` and ``block1_fused.launches`` count
``ekp_block1_sm90`` launches in their mode only.
"""

from __future__ import annotations

import torch

from torch_ekpose_tpu_torch.ops import _build
from torch_ekpose_tpu_torch.ops.conv_chain import (
    check_input, conv_chain, conv_chain_torch)

__all__ = ["block1_fused", "block1_fused_torch", "conv1_fused",
           "conv1_fused_torch", "pack_block1", "plan_block1"]

#: the channels ``ekp_block1_sm90`` takes (vgg2016's block 1)
SM90_CHANNELS = 64


def conv1_fused_torch(x, w1, b1):
    """Plain PyTorch twin of :func:`conv1_fused`."""
    return conv_chain_torch(x, [(w1, b1)], pool=False)


def block1_fused_torch(x, w1, b1, w2, b2):
    """Plain PyTorch twin of :func:`block1_fused`."""
    return conv_chain_torch(x, [(w1, b1), (w2, b2)], pool=True)


def plan_block1(c1: int, c2, dtype: torch.dtype) -> str:
    """The kernel a CUDA block-1 call takes: ``"sm90"``
    (``ekp_block1_sm90``) for bf16 with ``c1 == 64`` and, for the fused
    block, ``c2 == 64`` (``c2`` None: conv1_1 alone); else ``"chain"``
    (:func:`conv_chain`, which routes by
    :func:`~torch_ekpose_tpu_torch.ops.conv_chain.plan_chain`)."""
    if dtype == torch.bfloat16 and c1 == SM90_CHANNELS and c2 in (
            None, SM90_CHANNELS):
        return "sm90"
    return "chain"


def pack_block1(w1: torch.Tensor, w2=None) -> torch.Tensor:
    """HWIO ``w1 [3, 3, 3, 64]`` (and ``w2 [3, 3, 64, 64]`` for the fused
    block) -> one bf16 buffer in ``ekp_block1_sm90``'s layout, one copy
    each: ``w1`` as ``[27 k][64 co]`` (``k = (3 dy + dx) 3 + c``; the
    kernel pads K to 32 with zeros), then ``w2`` as wgmma's K-major A
    operand ``[72][64 co][8]``, element ``(g, co, j)`` being ``w2``'s row
    ``k = 8 g + j = (3 dy + dx) 64 + ci``."""
    c1 = w1.shape[3]
    n1 = 27 * c1
    n2 = 0 if w2 is None else 9 * c1 * w2.shape[3]
    buf = torch.empty(n1 + n2, dtype=torch.bfloat16, device=w1.device)
    buf[:n1].view(3, 3, 3, c1).copy_(w1)
    if w2 is not None:
        c2 = w2.shape[3]
        buf[n1:].view(9, c1 // 8, c2, 8).copy_(
            w2.reshape(9, c1 // 8, 8, c2).transpose(2, 3))
    return buf


def _check(name, x, w1, b1, w2=None, b2=None):
    check_input(name, x)
    c1 = w1.shape[3]
    c2 = None if w2 is None else w2.shape[3]
    if (x.shape[3] != 3 or tuple(w1.shape) != (3, 3, 3, c1)
            or tuple(b1.shape) != (c1,)
            or (w2 is not None and (tuple(w2.shape) != (3, 3, c1, c2)
                                    or tuple(b2.shape) != (c2,)))):
        raise ValueError(f"{name}: expected x [B, H, W, 3], w1 [3, 3, 3, c1]"
                         f", w2 [3, 3, c1, c2] and matching biases")
    tensors = [w1, b1] + ([] if w2 is None else [w2, b2])
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"{name}: weights on another device")
    return plan_block1(c1, c2, x.dtype)


def _launch_sm90(x, w1, b1, w2=None, b2=None):
    """One ``ekp_block1_sm90`` launch: conv1_1 alone when ``w2`` is None."""
    x = x.contiguous()
    bsz, h, w, _ = x.shape
    fused = w2 is not None
    wpack = pack_block1(w1, w2)
    pb1 = b1.float().contiguous()
    pb2 = b2.float().contiguous() if fused else None
    shape = (bsz, h // 2, w // 2, 64) if fused else (bsz, h, w, 64)
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _build.lib().ekp_block1_sm90(
            _build.ptr(x), _build.ptr(out), _build.ptr(wpack),
            _build.ptr(pb1), None if pb2 is None else _build.ptr(pb2),
            bsz, h, w, int(fused), _build.stream_of(x))
    _build.check(err, "ekp_block1_sm90")
    return out


def conv1_fused(x, w1, b1):
    """``[B, H, W, 3]`` -> relu(conv1_1(x)) ``[B, H, W, c1]``, x.dtype.

    A CPU tensor takes the twin; a CUDA tensor launches the kernel
    :func:`plan_block1` picks, or raises.
    """
    if x.device.type == "cpu":
        return conv1_fused_torch(x, w1, b1)
    if _check("conv1_fused", x, w1, b1) == "chain":
        return conv_chain(x, [(w1, b1)], pool=False)
    out = _launch_sm90(x, w1, b1)
    conv1_fused.launches += 1
    return out


def block1_fused(x, w1, b1, w2, b2):
    """``[B, H, W, 3]`` -> block 1 pooled, ``[B, H/2, W/2, c2]``, x.dtype.

    A CPU tensor takes the twin; a CUDA tensor launches the kernel
    :func:`plan_block1` picks, or raises.
    """
    if x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError("block1_fused needs even H and W")
    if x.device.type == "cpu":
        return block1_fused_torch(x, w1, b1, w2, b2)
    if _check("block1_fused", x, w1, b1, w2, b2) == "chain":
        return conv_chain(x, [(w1, b1), (w2, b2)], pool=True)
    out = _launch_sm90(x, w1, b1, w2, b2)
    block1_fused.launches += 1
    return out


def _wgmma_probe(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [64, 16] @ b [256, 16]^T`` in float32 through one
    ``wgmma.m64n256k16`` with ``ekp_block1_sm90``'s shared-memory
    descriptors (bf16 CUDA tensors). A test hook that pins the descriptor
    layout on the card; no path calls it."""
    a = a.to(torch.bfloat16).contiguous()
    b = b.to(torch.bfloat16).contiguous()
    if a.shape != (64, 16) or b.shape != (256, 16) or a.device.type != "cuda":
        raise ValueError("_wgmma_probe: a [64, 16] and b [256, 16] on a card")
    d = torch.empty((64, 256), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        err = _build.lib().ekp_block1_sm90_probe(
            _build.ptr(a), _build.ptr(b), _build.ptr(d), _build.stream_of(a))
    _build.check(err, "ekp_block1_sm90_probe")
    return d


#: launches of ``ekp_block1_sm90`` in each mode since the count was last
#: set to 0
conv1_fused.launches = 0
block1_fused.launches = 0
