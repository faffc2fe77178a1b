"""Weight-exact space-to-depth execution of stride-1 3x3 conv chains.

Counterpart of the JAX package's ``ops/s2d_conv.py`` (NCHW here). A
stride-1 SAME 3x3 conv at full resolution decomposes exactly over the
2x2 pixel parities of a space-to-depth tiling: output pixels of parity
(py, px) read a 2x2 window of s2d cells, so the conv equals four
stride-1 2x2 convs over the s2d tensor, one per output parity, each
kernel a fixed rearrangement of the original 3x3 weights (7 of its 16
taps are structurally zero) over 4x the input channels. Chained convs
stay in s2d space, and a trailing 2x2/2 max pool is an elementwise max
over the four parity slices.

The packed channel order is the JAX package's, ``(py, px, c)``, so every
output equals its function's after an NHWC <-> NCHW transpose. The
parity kernels are rebuilt from the weights on every call (a pad, two
``unfold`` views and one copy, all differentiable), so checkpoints are
untouched and nothing goes stale when the weights change. Plain torch
ops: cuDNN on the card, as the JAX package's are XLA convs.

A height-split input (``parallel/spatial.py``) runs the chain on each
stripe with ``2 * len(params)`` halo rows (:meth:`Stripes.s2d_rows`).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

__all__ = ["depth_to_space", "depth_to_space_grouped", "s2d_conv_chain",
           "space_to_depth"]

#: [(weight [co, ci, 3, 3] OIHW, bias [co]), ...]
Params = Sequence[Tuple[torch.Tensor, torch.Tensor]]


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, 4C, H/2, W/2], channel order (py, px, c)."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // 2, 2, w // 2, 2)
    return x.permute(0, 3, 5, 1, 2, 4).reshape(b, 4 * c, h // 2, w // 2)


def depth_to_space(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`space_to_depth`."""
    return depth_to_space_grouped(x, x.shape[1] // 4)


def depth_to_space_grouped(x: torch.Tensor, co: int) -> torch.Tensor:
    """d2s of a parity-concatenated [B, 4 co, H/2, W/2] tensor (the four
    parity groups of ``co`` channels, (py, px) order) -> [B, co, H, W]."""
    b, _, h2, w2 = x.shape
    x = x.reshape(b, 2, 2, co, h2, w2).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(b, co, h2 * 2, w2 * 2)


def _parity_kernels(weight: torch.Tensor) -> torch.Tensor:
    """A 3x3 OIHW kernel [co, ci, 3, 3] -> the four parity kernels
    [4 (py, px), co, 4 ci (qy, qx, c), 2, 2] over the s2d tensor.

    Along one axis, tap ``(kd, q)`` of parity ``p`` reads the original tap
    ``a = 2 kd + q - 1 + p`` (zero outside 0..2), with the conv's padding
    (1, 0) for parity 0 and (0, 1) for parity 1. With the 3 taps padded
    by one zero on each side, parity ``p``'s taps are the 4 consecutive
    padded taps from ``p``, read as (kd, q): one ``unfold`` per axis."""
    co, ci = weight.shape[:2]
    taps = F.pad(weight, (1, 1, 1, 1)).unfold(2, 4, 1).unfold(3, 4, 1)
    # [co, ci, py, px, (kdy, qy), (kdx, qx)]
    taps = taps.reshape(co, ci, 2, 2, 2, 2, 2, 2)
    # -> [py, px, co, qy, qx, ci, kdy, kdx]
    return taps.permute(2, 3, 0, 5, 7, 1, 4, 6).reshape(4, co, 4 * ci, 2, 2)


def s2d_conv_chain(x: torch.Tensor, params: Params,
                   pool: bool = False) -> torch.Tensor:
    """Chained SAME 3x3 conv + bias + ReLU [+ a final 2x2/2 max pool],
    computed in space-to-depth form: the plain chain's function (ReLU and
    the parity decomposition commute; the pool window is the parity
    group).

    ``x`` is the full-resolution [B, C, H, W] input, H and W even.
    Returns full resolution or, with ``pool=True``, the pooled
    [B, co, H/2, W/2] output directly, in ``x.dtype``. Each conv
    accumulates in float32 and adds the bias before its one rounding to
    the dtype (cuDNN's epilogue; exact in float32)."""
    if x.shape[-2] % 2 or x.shape[-1] % 2:
        raise ValueError("s2d_conv_chain needs even H and W")
    if hasattr(x, "s2d_rows"):               # parallel.spatial.Stripes
        return x.s2d_rows(len(params), pool, lambda rows, move: (
            s2d_conv_chain(rows, [(move(w), move(b)) for w, b in params],
                           pool)))
    dtype = x.dtype
    cur = space_to_depth(x)         # parity-packed; stays packed
    for weight, bias in params:
        kernels = _parity_kernels(weight.to(dtype))
        bias = bias.to(dtype)
        h2, w2 = cur.shape[-2:]
        padded = F.pad(cur, (1, 1, 1, 1))
        # parity p pads (1, 0) (p = 0) or (0, 1) (p = 1): a window of the
        # one padded tensor starting at p
        cur = torch.cat([
            torch.relu(F.conv2d(
                padded[:, :, py:py + h2 + 1, px:px + w2 + 1],
                kernels[2 * py + px], bias))
            for py in (0, 1) for px in (0, 1)], dim=1)
    co = params[-1][0].shape[0]
    if pool:
        p = cur.split(co, dim=1)
        return torch.maximum(torch.maximum(p[0], p[1]),
                             torch.maximum(p[2], p[3]))
    return depth_to_space_grouped(cur, co)
