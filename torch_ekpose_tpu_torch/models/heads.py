"""The 6-stage, 2-branch CPM head and the OpenPose network (vgg flavor).

Counterpart of the JAX package's ``models/heads.py`` (reference
lib/network/vgg2016.py:37-105): stage 1 reads the backbone features;
stages 2..6 read ``concat(paf_{s-1}, heatmap_{s-1}, features)``; each
stage has an L1 branch (38 PAF channels) and an L2 branch (19 heatmap
channels). The branches are attributes ``model{s}_{b}`` of the network
itself, as in the reference, so its ``state_dict`` loads with
``strict=True``.

The forward contract is the reference's:
``((paf_6, heatmap_6), [paf_1, ht_1, ..., paf_6, ht_6])``, NCHW.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn

from torch_ekpose_tpu_torch import constants
from torch_ekpose_tpu_torch.models.layers import conv_relu

__all__ = ["CpmHead", "OpenPose", "VggBranch"]


class VggBranch(nn.Sequential):
    """One plain-conv CPM branch: 3x(3x3,128) + 1x1(512) + 1x1(out) at
    stage 1, 5x(7x7,128) + 1x1(128) + 1x1(out) at stages 2-6. The convs
    sit at the reference's ``nn.Sequential`` indices 0, 2, 4, ..."""

    def __init__(self, in_ch: int, out_ch: int, first_stage: bool,
                 device=None):
        if first_stage:
            plan = [(3, 128), (3, 128), (3, 128), (1, 512)]
        else:
            plan = [(7, 128)] * 5 + [(1, 128)]
        layers = []
        for kernel, feats in plan:
            layers += conv_relu(in_ch, feats, kernel, device)
            in_ch = feats
        # the final 1x1 projection (no ReLU; initialized N(0, 0.01))
        layers.append(nn.Conv2d(in_ch, out_ch, 1, device=device))
        super().__init__(*layers)


class CpmHead(nn.Module):
    """Six refinement stages, two branches each, registered as
    ``model{stage}_{branch}``."""

    num_stages = 6

    def __init__(self, in_ch: int = 128, device=None):
        super().__init__()
        paf_ch = constants.NUM_PAF_CHANNELS
        ht_ch = constants.NUM_HEATMAP_CHANNELS
        for stage in range(1, self.num_stages + 1):
            stage_in = in_ch if stage == 1 else paf_ch + ht_ch + in_ch
            for branch, out_ch in ((1, paf_ch), (2, ht_ch)):
                self.add_module(
                    f"model{stage}_{branch}",
                    VggBranch(stage_in, out_ch, stage == 1, device),
                )

    def head(self, features: torch.Tensor) -> List[torch.Tensor]:
        """The 12 stage outputs ``[paf_1, ht_1, ..., paf_6, ht_6]``."""
        saved_for_loss = []
        x = features
        for stage in range(1, self.num_stages + 1):
            paf = getattr(self, f"model{stage}_1")(x)
            heatmap = getattr(self, f"model{stage}_2")(x)
            saved_for_loss += [paf, heatmap]
            if stage < self.num_stages:
                x = torch.cat([paf, heatmap, features], dim=1)
        return saved_for_loss

    def forward(self, features):
        return self.head(features)


class OpenPose(CpmHead):
    """Backbone (``model0``) + CPM head with the reference's contract.

    ``forward(x)`` takes NCHW float input and returns
    ``((paf_last, heatmap_last), saved_for_loss)``.
    """

    def __init__(self, backbone: nn.Module, device=None):
        super().__init__(backbone.out_channels, device)
        self.model0 = backbone

    def forward(
        self, x
    ) -> Tuple[Tuple[torch.Tensor, torch.Tensor], List[torch.Tensor]]:
        saved_for_loss = self.head(self.model0(x))
        return (saved_for_loss[-2], saved_for_loss[-1]), saved_for_loss
