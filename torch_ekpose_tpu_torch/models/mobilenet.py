"""MobileNet (v1) backbone with multi-scale feature concat.

Counterpart of the JAX package's ``models/mobilenet.py`` (reference
lib/network/mobilenet.py:36-83): 12 blocks, a ``ConvBN`` then eleven
``DSConv``, held in the ``nn.ModuleList`` ``model0`` (so the keys are
``model0.model0.{i}.*`` inside the network). The output is
``cat(maxpool2(out_3), out_7, out_11)``: ``depth(128) + depth(512) +
depth(512)`` channels at stride 8.
"""

from __future__ import annotations

import torch
from torch import nn

from torch_ekpose_tpu_torch.models.layers import ConvBN, DSConv, depth_fn, max_pool

__all__ = ["MOBILENET_PLAN", "MobileNetBackbone"]

#: (features, stride) per block; block 0 is a ConvBN, 1..11 DSConv
#: (reference mobilenet.py:49-62)
MOBILENET_PLAN = (
    (32, 2), (64, 1), (128, 2), (128, 1), (256, 2), (256, 1),
    (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (512, 1),
)
#: the blocks whose outputs are concatenated (stride 4, 8, 8)
TAPS = (3, 7, 11)


class MobileNetBackbone(nn.Module):
    """NCHW in, ``[B, out_channels, H/8, W/8]`` out."""

    def __init__(self, conv_width: float = 1.0, device=None):
        super().__init__()
        depth = depth_fn(conv_width)
        blocks, in_ch = [], 3
        for i, (feats, stride) in enumerate(MOBILENET_PLAN):
            out_ch = depth(feats)
            blocks.append(
                ConvBN(in_ch, out_ch, 3, stride, device) if i == 0
                else DSConv(in_ch, out_ch, 3, stride, device=device))
            in_ch = out_ch
        self.model0 = nn.ModuleList(blocks)
        # maxpool(out_3) brings the stride-4 tap down to stride 8
        # (reference mobilenet.py:78-80)
        self.pool = max_pool(2, 2)
        self.out_channels = depth(128) + depth(512) + depth(512)

    def forward(self, x):
        taps = []
        for i, block in enumerate(self.model0):
            x = block(x)
            if i in TAPS:
                taps.append(x)
        return torch.cat([self.pool(taps[0]), taps[1], taps[2]], dim=1)
