"""Conv building blocks for vgg2016 (NCHW, cuDNN).

Counterpart of the JAX package's ``models/layers.py``, reduced to what
vgg2016 uses: a conv + ReLU pair with SAME padding (``k // 2``) and the
2x2/2 max pool. Blocks are lists of plain ``nn`` modules so they sit in an
``nn.Sequential`` at the reference's indices (``conv, relu, conv, relu,
pool, ...``) and the ``state_dict`` keys are the reference's.

Initialization mirrors the reference (reference
lib/network/vgg2016.py:107-126): Kaiming-normal fan-out with zero bias for
every conv, N(0, 0.01) for each stage's final projection. It draws from an
explicit ``torch.Generator`` on the CPU, so it is the same on any device.
"""

from __future__ import annotations

import math
from typing import List

import torch
from torch import nn

__all__ = ["conv_relu", "init_conv_", "max_pool"]


def conv_relu(in_ch: int, out_ch: int, kernel: int, device) -> List[nn.Module]:
    """Conv (SAME padding, bias) followed by ReLU."""
    return [
        nn.Conv2d(in_ch, out_ch, kernel, padding=kernel // 2, device=device),
        nn.ReLU(inplace=True),
    ]


def max_pool() -> nn.Module:
    """The 2x2 / stride-2 max pool of VGG19's first three blocks."""
    return nn.MaxPool2d(kernel_size=2, stride=2)


@torch.no_grad()
def init_conv_(conv: nn.Conv2d, generator: torch.Generator,
               final: bool = False) -> None:
    """Kaiming-normal fan-out (ReLU gain) weights and zero bias, or
    N(0, 0.01) weights for a final projection (``final=True``)."""
    out_ch, _, kh, kw = conv.weight.shape
    std = 0.01 if final else math.sqrt(2.0 / (out_ch * kh * kw))
    conv.weight.normal_(0.0, std, generator=generator)
    conv.bias.zero_()
