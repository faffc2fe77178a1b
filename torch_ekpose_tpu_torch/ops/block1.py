"""VGG block 1 fused (kernel ``csrc/block1.cu``).

Counterpart of the two TPU kernels of the JAX package's
``scripts/profile_block1.py``:

- :func:`conv1_fused` = relu(conv1_1(x)), SAME padding;
- :func:`block1_fused` = pool(relu(conv1_2(relu(conv1_1(x))))), with a
  2x2/2 max pool;

each with conv1_1 as one product of 27-deep patches. The TPU script's
variants A and B compute the same function with differently shaped MXU
products; on Hopper they are one kernel, so there is no ``variant``
argument (``csrc/block1.cu`` says why). The twins are
:func:`conv_chain_torch` on ``[(w1, b1)]`` without a pool and on
``[(w1, b1), (w2, b2)]`` with one. Layouts are the JAX package's: ``x``
``[B, H, W, 3]`` NHWC, ``w1`` ``[3, 3, 3, c1]`` and ``w2``
``[3, 3, c1, c2]`` HWIO, biases ``[c]``.
"""

from __future__ import annotations

import torch

from torch_ekpose_tpu_torch.ops import _build
from torch_ekpose_tpu_torch.ops.conv_chain import (
    check_input, conv_chain_torch, pack_weight, pad_bias, pad_ch)

__all__ = ["block1_fused", "block1_fused_torch", "conv1_fused",
           "conv1_fused_torch"]


def conv1_fused_torch(x, w1, b1):
    """Plain PyTorch twin of :func:`conv1_fused`."""
    return conv_chain_torch(x, [(w1, b1)], pool=False)


def block1_fused_torch(x, w1, b1, w2, b2):
    """Plain PyTorch twin of :func:`block1_fused`."""
    return conv_chain_torch(x, [(w1, b1), (w2, b2)], pool=True)


def _launch(name, x, w1, b1, w2=None, b2=None):
    check_input(name, x)
    c1 = w1.shape[3]
    c2 = c1 if w2 is None else w2.shape[3]
    if (x.shape[3] != 3 or tuple(w1.shape) != (3, 3, 3, c1)
            or tuple(b1.shape) != (c1,)
            or (w2 is not None and (tuple(w2.shape) != (3, 3, c1, c2)
                                    or tuple(b2.shape) != (c2,)))):
        raise ValueError(f"{name}: expected x [B, H, W, 3], w1 [3, 3, 3, c1]"
                         f", w2 [3, 3, c1, c2] and matching biases")
    tensors = [w1, b1] + ([] if w2 is None else [w2, b2])
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"{name}: weights on another device")
    x = x.contiguous()
    bsz, h, w, _ = x.shape
    pw1 = pack_weight(w1.reshape(1, 27, c1), 32, pad_ch(c1), x.dtype)
    pb1 = pad_bias(b1, pad_ch(c1))
    if w2 is None:
        pw2 = pb2 = None
        out = torch.empty((bsz, h, w, c1), dtype=x.dtype, device=x.device)
    else:
        pw2 = pack_weight(w2.reshape(9, c1, c2), pad_ch(c1), pad_ch(c2),
                          x.dtype)
        pb2 = pad_bias(b2, pad_ch(c2))
        out = torch.empty((bsz, h // 2, w // 2, c2), dtype=x.dtype,
                          device=x.device)
    with torch.cuda.device(x.device):
        err = _build.lib().ekp_block1(
            _build.ptr(x), _build.ptr(out), _build.ptr(pw1), _build.ptr(pb1),
            None if pw2 is None else _build.ptr(pw2),
            None if pb2 is None else _build.ptr(pb2), c1, c2, bsz, h, w,
            int(w2 is None), int(x.dtype == torch.bfloat16),
            _build.stream_of(x),
        )
    _build.check(err, "ekp_block1")
    return out


def conv1_fused(x, w1, b1):
    """``[B, H, W, 3]`` -> relu(conv1_1(x)) ``[B, H, W, c1]``, x.dtype.

    A CPU tensor takes the twin; a CUDA tensor launches ``ekp_block1``
    with ``conv1_only`` set, or raises.
    """
    if x.device.type == "cpu":
        return conv1_fused_torch(x, w1, b1)
    out = _launch("conv1_fused", x, w1, b1)
    conv1_fused.launches += 1
    return out


def block1_fused(x, w1, b1, w2, b2):
    """``[B, H, W, 3]`` -> block 1 pooled, ``[B, H/2, W/2, c2]``, x.dtype.

    A CPU tensor takes the twin; a CUDA tensor launches ``ekp_block1`` or
    raises.
    """
    if x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError("block1_fused needs even H and W")
    if x.device.type == "cpu":
        return block1_fused_torch(x, w1, b1, w2, b2)
    out = _launch("block1_fused", x, w1, b1, w2, b2)
    block1_fused.launches += 1
    return out


#: launches of the CUDA kernel since the count was last set to 0
conv1_fused.launches = 0
block1_fused.launches = 0
