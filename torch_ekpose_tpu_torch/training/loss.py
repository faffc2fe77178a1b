"""The 6-stage CPM loss (reference train.py:300-339 ``get_loss``):

    total = sum over stages s, branches b of MSE_sum(pred, target) / batch

The heatmap target includes the background channel; the per-stage sums and
the max/min of the final maps are returned for the same 16 metric series
the reference logs (loss_stage{s}_L{1,2}, max/min_ht, max/min_paf).

Counterpart of the JAX package's ``training/loss.py`` on NCHW tensors:
predictions are upcast to float32 before the squared error, and the
background channel left out of ``max_ht``/``min_ht`` is the last one
along the channel axis. The series stay 0-dim tensors on the device, so
logging them costs no host sync until they are read.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

__all__ = ["cpm_loss", "loss_series_names"]


def loss_series_names() -> List[str]:
    """reference train.py:300-308 ``build_names``."""
    return [
        f"loss_stage{stage}_L{branch}"
        for stage in range(1, 7)
        for branch in (1, 2)
    ]


def cpm_loss(
    saved_for_loss: List[torch.Tensor],
    heatmap_target: torch.Tensor,
    paf_target: torch.Tensor,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``saved_for_loss`` is the 12-output list [paf1, ht1, ..., paf6, ht6]
    (NCHW); targets are [B, 38, H, W] PAFs and [B, 19, H, W] heatmaps."""
    batch = heatmap_target.shape[0]
    names = loss_series_names()
    logs: Dict[str, torch.Tensor] = {}
    total = 0.0
    for stage in range(6):
        paf_pred = saved_for_loss[2 * stage].float()
        ht_pred = saved_for_loss[2 * stage + 1].float()
        l1 = torch.sum((paf_pred - paf_target) ** 2)
        l2 = torch.sum((ht_pred - heatmap_target) ** 2)
        total = total + l1 + l2
        logs[names[2 * stage]] = l1.detach()
        logs[names[2 * stage + 1]] = l2.detach()
    total = total / batch

    final_ht = saved_for_loss[-1].detach().float()
    final_paf = saved_for_loss[-2].detach().float()
    logs["max_ht"] = final_ht[:, :-1].max()     # excl. background
    logs["min_ht"] = final_ht[:, :-1].min()
    logs["max_paf"] = final_paf.max()
    logs["min_paf"] = final_paf.min()
    return total, logs
