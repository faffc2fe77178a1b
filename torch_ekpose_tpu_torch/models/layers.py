"""Conv building blocks (NCHW, cuDNN).

Counterpart of the JAX package's ``models/layers.py``: the vgg conv +
ReLU pair with SAME padding (``k // 2``), the conv + BN + ReLU
block, the depthwise-separable ``DSConv``, a general max pool and the
width-multiplier ``depth_fn``. Blocks are plain ``nn`` modules at the
reference's attribute names and ``nn.Sequential`` indices, so the
``state_dict`` keys are the reference's.

BatchNorm is ``nn.BatchNorm2d`` (eps 1e-5): in eval mode it normalizes
with the float32 running statistics in float32 and returns the input's
dtype, which is the JAX package's ``TorchBatchNorm`` at inference. Its
weight and bias stay float32 tensors in a bf16 model (holding
bf16-rounded values, see ``models/factory.py::cast_params``), as the CUDA
kernel takes a bf16 input only with float32 parameters and statistics.

Initialization mirrors the reference (reference
lib/network/vgg2016.py:107-126, mobilenet.py): Kaiming-normal fan-out with
zero bias for every conv (depthwise and pointwise included), N(0, 0.01)
for each stage's final projection, BN weight 1, bias 0, mean 0, var 1. It
draws from an explicit ``torch.Generator`` on the CPU, so it is the same
on any device.
"""

from __future__ import annotations

import math
from typing import List

import torch
from torch import nn

__all__ = ["ConvBN", "DSConv", "batch_norm", "conv_relu", "depth_fn",
           "init_conv_", "max_pool"]

#: BatchNorm epsilon of the reference (torch's default) and the JAX package
BN_EPS = 1e-5


def conv_relu(in_ch: int, out_ch: int, kernel: int, device) -> List[nn.Module]:
    """Conv (SAME padding, bias) followed by ReLU."""
    return [
        nn.Conv2d(in_ch, out_ch, kernel, padding=kernel // 2, device=device),
        nn.ReLU(inplace=True),
    ]


def batch_norm(channels: int, device) -> nn.BatchNorm2d:
    """The reference's ``nn.BatchNorm2d`` (eps 1e-5, momentum 0.1)."""
    return nn.BatchNorm2d(channels, eps=BN_EPS, device=device)


class ConvBN(nn.Module):
    """Conv (no bias) -> BN -> ReLU, as attributes ``conv`` and ``bn``
    (reference lib/network/mobilenet.py:6-17)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 stride: int = 1, device=None):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride=stride,
                              padding=kernel // 2, bias=False, device=device)
        self.bn = batch_norm(out_ch, device)
        self.act = nn.ReLU(inplace=True)

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


class DSConv(nn.Module):
    """Depthwise k x k (no bias) -> pointwise 1x1 (no bias) -> BN ->
    optional ReLU (reference lib/network/mobilenet.py:20-33). ``relu=False``
    is each stage's output projection."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 stride: int = 1, relu: bool = True, device=None):
        super().__init__()
        self.depthwise = nn.Conv2d(in_ch, in_ch, kernel, stride=stride,
                                   padding=kernel // 2, groups=in_ch,
                                   bias=False, device=device)
        self.pointwise = nn.Conv2d(in_ch, out_ch, 1, bias=False,
                                   device=device)
        self.bn = batch_norm(out_ch, device)
        self.act = nn.ReLU(inplace=True) if relu else nn.Identity()

    def forward(self, x):
        return self.act(self.bn(self.pointwise(self.depthwise(x))))


def max_pool(window: int = 2, stride: int = 2, padding: int = 0) -> nn.Module:
    """Max pool; the padding is -inf, as in the JAX package."""
    return nn.MaxPool2d(kernel_size=window, stride=stride, padding=padding)


def depth_fn(conv_width: float, min_depth: int = 8):
    """Width-multiplier helper (reference lib/network/mobilenet.py:45-46);
    Python's ``round``, as the JAX package's."""

    def depth(d: int) -> int:
        return max(round(d * conv_width), min_depth)

    return depth


@torch.no_grad()
def init_conv_(conv: nn.Conv2d, generator: torch.Generator,
               final: bool = False) -> None:
    """Kaiming-normal fan-out (ReLU gain) weights and zero bias, or
    N(0, 0.01) weights for a final projection (``final=True``). Fan-out
    is ``out_ch * kh * kw``, also for a depthwise kernel."""
    out_ch, _, kh, kw = conv.weight.shape
    std = 0.01 if final else math.sqrt(2.0 / (out_ch * kh * kw))
    conv.weight.normal_(0.0, std, generator=generator)
    if conv.bias is not None:
        conv.bias.zero_()

