"""Operations the reference families share: the ImageNet preprocess, a
conv that can emulate int8 arithmetic, inference BatchNorm, and float32
without TF32."""

from __future__ import annotations

import contextlib
from typing import List, Optional

import torch
import torch.nn.functional as F

__all__ = ["IMAGENET_MEAN", "IMAGENET_STD", "BN_EPS", "batch_norm", "conv",
           "fake_int8", "no_tf32", "preprocess"]

#: ImageNet statistics, RGB order (torchvision's)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
#: torch's BatchNorm2d epsilon, which the reference repository keeps
BN_EPS = 1e-5


def preprocess(frames: torch.Tensor) -> torch.Tensor:
    """uint8 BGR ``[B, H, W, 3]`` -> float32 NCHW RGB, ImageNet-normalised
    (/255, BGR -> RGB, minus mean, over std)."""
    x = frames.float().flip(-1) / 255.0
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)
    std = torch.tensor(IMAGENET_STD, device=x.device)
    return ((x - mean) / std).permute(0, 3, 1, 2).contiguous()


def fake_int8(x: torch.Tensor, dim: Optional[int] = None) -> torch.Tensor:
    """Symmetric int8 rounding of ``x``: one scale for the tensor
    (``dim=None``, activations) or one per index of ``dim`` (weights'
    output channels), ``max|x| / 127``; values stay float32."""
    if dim is None:
        amax = x.abs().amax()
    else:
        keep = [d for d in range(x.dim()) if d != dim]
        amax = x.abs().amax(dim=keep, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    return torch.round(x / scale).clamp(-127, 127) * scale


def conv(x: torch.Tensor, weight: torch.Tensor, bias=None, stride: int = 1,
         groups: int = 1, int8: bool = False,
         record: Optional[List[tuple]] = None) -> torch.Tensor:
    """SAME-padded conv (``k // 2``). ``int8`` rounds the input per tensor
    and the weight per output channel to int8 first (the products and sums
    of int8 values are exact in float32 at these depths). ``record``, when
    given, gets ``(input shape, weight shape, output shape)``."""
    if int8:
        x, weight = fake_int8(x), fake_int8(weight, dim=0)
    out = F.conv2d(x, weight, bias, stride=stride,
                   padding=weight.shape[-1] // 2, groups=groups)
    if record is not None:
        record.append((tuple(x.shape), tuple(weight.shape), tuple(out.shape)))
    return out


def batch_norm(x: torch.Tensor, params: dict, prefix: str) -> torch.Tensor:
    """Inference BatchNorm with the running statistics of ``prefix``."""
    return F.batch_norm(x, params[prefix + ".running_mean"],
                        params[prefix + ".running_var"],
                        params[prefix + ".weight"], params[prefix + ".bias"],
                        False, 0.0, BN_EPS)


@contextlib.contextmanager
def no_tf32():
    """TF32 off for float32 convs and matmuls inside the block, the
    flags restored after."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
