"""ShuffleNetV2 backbone, stages 2-3 only.

Counterpart of the JAX package's ``models/shufflenet_v2.py`` (reference
lib/network/shufflenetV2.py:7-168): ``conv1`` (stride 2) + 3x3/2 max pool
(padding 1) + ``stage2`` (stride 8, 4 units) + ``stage3`` (stride 16, 8
units); the output is ``cat(out2, bilinear(out3))`` at stride 8 with
``settings[1] + settings[2]`` channels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from torch_ekpose_tpu_torch.models.layers import batch_norm, max_pool

__all__ = ["SHUFFLENET_SETTINGS", "ShuffleNetV2Backbone", "ShuffleUnit",
           "channel_shuffle"]

#: width -> per-stage output channels (reference shufflenetV2.py:116-121)
SHUFFLENET_SETTINGS = {
    0.5: (24, 48, 96, 192, 1024),
    1.0: (24, 116, 232, 464, 1024),
    1.5: (24, 176, 352, 704, 1024),
    2.0: (24, 244, 488, 976, 2048),
}


def channel_shuffle(x: torch.Tensor, groups: int) -> torch.Tensor:
    """NCHW channel shuffle (reference shufflenetV2.py:7-19): channel
    ``g * (C / groups) + j`` moves to ``j * groups + g``, the JAX
    package's NHWC order."""
    n, c, h, w = x.shape
    return x.view(n, groups, c // groups, h, w).transpose(1, 2).reshape(
        n, c, h, w)


def _conv(in_ch, out_ch, kernel, stride=1, groups=1, device=None):
    return nn.Conv2d(in_ch, out_ch, kernel, stride=stride,
                     padding=kernel // 2, groups=groups, bias=False,
                     device=device)


class ShuffleUnit(nn.Module):
    """ShuffleNetV2 unit (reference shufflenetV2.py:56-105). Stride 1:
    split the channels and run the right half through ``branch2``; stride
    2: both branches read the whole input. A 2-group channel shuffle
    follows. ``branch1`` = (dw 3x3, bn, pw 1x1, bn, relu), ``branch2`` =
    (pw 1x1, bn, relu, dw 3x3, bn, pw 1x1, bn, relu)."""

    def __init__(self, inp: int, oup: int, stride: int = 1, device=None):
        super().__init__()
        self.stride = stride
        bf = oup // 2
        if stride > 1:
            self.branch1 = nn.Sequential(
                _conv(inp, inp, 3, stride, groups=inp, device=device),
                batch_norm(inp, device),
                _conv(inp, bf, 1, device=device), batch_norm(bf, device),
                nn.ReLU(inplace=True))
        self.branch2 = nn.Sequential(
            _conv(inp if stride > 1 else bf, bf, 1, device=device),
            batch_norm(bf, device), nn.ReLU(inplace=True),
            _conv(bf, bf, 3, stride, groups=bf, device=device),
            batch_norm(bf, device),
            _conv(bf, bf, 1, device=device), batch_norm(bf, device),
            nn.ReLU(inplace=True))

    def forward(self, x):
        if self.stride == 1:
            x1, x2 = x.chunk(2, dim=1)
            out = torch.cat([x1, self.branch2(x2)], dim=1)
        else:
            out = torch.cat([self.branch1(x), self.branch2(x)], dim=1)
        return channel_shuffle(out, 2)


class ShuffleNetV2Backbone(nn.Module):
    """NCHW in, ``[B, out_channels, H/8, W/8]`` out."""

    def __init__(self, conv_width: float = 1.0, device=None):
        super().__init__()
        settings = SHUFFLENET_SETTINGS[conv_width]
        self.conv1 = nn.Sequential(
            _conv(3, settings[0], 3, 2, device=device),
            batch_norm(settings[0], device), nn.ReLU(inplace=True))
        self.maxpool = max_pool(3, 2, padding=1)
        in_ch = settings[0]
        for name, out_ch, repeats in (("stage2", settings[1], 4),
                                      ("stage3", settings[2], 8)):
            units = [ShuffleUnit(in_ch, out_ch, 2, device)] + [
                ShuffleUnit(out_ch, out_ch, 1, device)
                for _ in range(repeats - 1)]
            self.add_module(name, nn.Sequential(*units))
            in_ch = out_ch
        self.out_channels = settings[1] + settings[2]

    def forward(self, x):
        out2 = self.stage2(self.maxpool(self.conv1(x)))   # stride 8
        out3 = self.stage3(out2)                          # stride 16
        # bilinear, align_corners=False, as jax.image.resize upsamples
        up = F.interpolate(out3, size=out2.shape[-2:], mode="bilinear",
                           align_corners=False)
        return torch.cat([out2, up], dim=1)
