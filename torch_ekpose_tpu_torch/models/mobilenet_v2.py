"""MobileNetV2 backbone (inverted residual blocks), cut at block 13.

Counterpart of the JAX package's ``models/mobilenet_v2.py`` (reference
lib/network/mobilenetV2.py:38-138): the stem ``features = (conv, bn,
relu6)`` and ``irblock1..13``, each with its layers in the ``nn.Sequential``
``conv`` at the reference's indices. The output is ``cat(out_6,
bilinear(out_13 -> out_6's size))`` at stride 8 with ``depth(32) +
depth(96)`` channels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from torch_ekpose_tpu_torch.models.layers import batch_norm, depth_fn

__all__ = ["InvertedResidual", "MNV2_PLAN", "MobileNetV2Backbone"]

#: (features, stride, expand_ratio) for irblock1..13
#: (reference mobilenetV2.py:91-112)
MNV2_PLAN = (
    (16, 1, 1), (24, 2, 6), (24, 1, 6), (32, 2, 6), (32, 1, 6), (32, 1, 6),
    (64, 2, 6), (64, 1, 6), (64, 1, 6), (64, 1, 6), (96, 1, 6), (96, 1, 6),
    (96, 1, 6),
)


def _conv(in_ch, out_ch, kernel, stride=1, groups=1, device=None):
    return nn.Conv2d(in_ch, out_ch, kernel, stride=stride,
                     padding=kernel // 2, groups=groups, bias=False,
                     device=device)


class InvertedResidual(nn.Module):
    """MNV2 inverted residual (reference mobilenetV2.py:38-76): [expand
    1x1, bn, relu6,] depthwise 3x3, bn, relu6, project 1x1, bn (linear
    bottleneck), plus the input where the stride is 1 and the widths
    agree. ``conv`` holds them at indices 0, 1, 3, 4, 6, 7 (0, 1, 3, 4
    without the expand conv)."""

    def __init__(self, inp: int, oup: int, stride: int = 1,
                 expand_ratio: int = 6, device=None):
        super().__init__()
        hidden = int(round(inp * expand_ratio))
        self.use_res = stride == 1 and inp == oup
        layers = []
        if expand_ratio != 1:
            layers += [_conv(inp, hidden, 1, device=device),
                       batch_norm(hidden, device), nn.ReLU6(inplace=True)]
        layers += [
            _conv(hidden, hidden, 3, stride, groups=hidden, device=device),
            batch_norm(hidden, device), nn.ReLU6(inplace=True),
            _conv(hidden, oup, 1, device=device), batch_norm(oup, device),
        ]
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        y = self.conv(x)
        return x + y if self.use_res else y


class MobileNetV2Backbone(nn.Module):
    """NCHW in, ``[B, out_channels, H/8, W/8]`` out."""

    def __init__(self, conv_width: float = 1.0, device=None):
        super().__init__()
        depth = depth_fn(conv_width)
        in_ch = depth(32)
        self.features = nn.Sequential(
            _conv(3, in_ch, 3, 2, device=device), batch_norm(in_ch, device),
            nn.ReLU6(inplace=True))
        for k, (feats, stride, expand) in enumerate(MNV2_PLAN, start=1):
            out_ch = depth(feats)
            self.add_module(f"irblock{k}", InvertedResidual(
                in_ch, out_ch, stride, expand, device))
            in_ch = out_ch
        self.out_channels = depth(32) + depth(96)

    def forward(self, x):
        x = self.features(x)
        for k in range(1, len(MNV2_PLAN) + 1):
            x = getattr(self, f"irblock{k}")(x)
            if k == 6:
                out6 = x  # the stride-8 tap (reference mobilenetV2.py:125)
        # bilinear, align_corners=False, of the stride-16 out13 to out6's
        # size (reference mobilenetV2.py:136-137); jax.image.resize's
        # half-pixel sampling with its border weights renormalized, at any
        # ratio (an upsample: its antialiasing does nothing)
        up = F.interpolate(x, size=out6.shape[-2:], mode="bilinear",
                           align_corners=False)
        return torch.cat([out6, up], dim=1)
