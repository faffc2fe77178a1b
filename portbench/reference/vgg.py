"""Plain float32 reference of the CMU OpenPose COCO network ("vgg2016").

Cao et al., "Realtime Multi-Person 2D Pose Estimation using Part
Affinity Fields", arXiv:1611.08050, and CMU's
``openpose/models/pose/coco/pose_deploy_linevec.prototxt``: VGG19
``conv1_1``-``conv4_2`` (3x3 convs, ReLU, three 2x2 max pools), then
``conv4_3_CPM`` and ``conv4_4_CPM``; six stages of two branches (PAF and
heatmap). Stage 1: three 3x3 convs, a 1x1 to 512, a 1x1 projection;
stages 2-6 read ``cat(paf, heat, features)``: five 7x7 convs, a 1x1, a 1x1
projection. Every conv but a projection is followed by a ReLU. The sizes
come from the configuration file; the parameter names are the reference
repository's ``state_dict`` names (``model0.backbone.<i>``,
``model<s>_<b>.<i>``).
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F

from portbench.reference.common import conv

__all__ = ["forward", "head_projections", "param_specs", "shape_head"]


def _backbone_layers(cfg: dict):
    """[(index, in, out, kernel) or (index, "pool")] of ``model0.backbone``."""
    layers, idx, c = [], 0, 3
    for block, (n, out) in enumerate(cfg["vgg_plan"]):
        for _ in range(n):
            layers.append((idx, c, out, 3))
            c, idx = out, idx + 2
        if block < len(cfg["vgg_plan"]) - 1:
            layers.append((idx, "pool"))
            idx += 1
    for out in cfg["cpm_channels"]:
        layers.append((idx, c, out, 3))
        c, idx = out, idx + 2
    return layers, c


def _branch_layers(cfg: dict, stage: int, c_in: int, c_out: int):
    """[(index, in, out, kernel)] of one branch, the projection last."""
    plan = cfg["stage1"] if stage == 1 else cfg["stage_n"]
    layers, c = [], c_in
    for i, (k, out) in enumerate(plan):
        layers.append((2 * i, c, out, k))
        c = out
    layers.append((2 * len(plan), c, c_out, 1))
    return layers


def _branches(cfg: dict):
    """(stage, branch, name prefix, layers) of the twelve branches."""
    _, feat = _backbone_layers(cfg)
    outs = {1: cfg["paf_channels"], 2: cfg["heat_channels"]}
    for stage in range(1, cfg["num_stages"] + 1):
        c_in = feat if stage == 1 else outs[1] + outs[2] + feat
        for b in (1, 2):
            yield stage, b, f"model{stage}_{b}", _branch_layers(
                cfg, stage, c_in, outs[b])


def param_specs(cfg: dict):
    specs = []
    backbone, _ = _backbone_layers(cfg)
    for layer in backbone:
        if layer[1] == "pool":
            continue
        idx, c_in, c_out, k = layer
        name = f"model0.backbone.{idx}"
        specs += [(name + ".weight", (c_out, c_in, k, k), "conv"),
                  (name + ".bias", (c_out,), "bias")]
    for _, _, prefix, layers in _branches(cfg):
        for j, (idx, c_in, c_out, k) in enumerate(layers):
            kind = "final" if j == len(layers) - 1 else "conv"
            specs += [(f"{prefix}.{idx}.weight", (c_out, c_in, k, k), kind),
                      (f"{prefix}.{idx}.bias", (c_out,), "bias")]
    return specs


def forward(params: dict, x: torch.Tensor, cfg: dict, int8: bool = False,
            record: Optional[List[tuple]] = None) -> dict:
    """NCHW float32 -> {"paf", "heat", "paf_pre", "heat_pre"} of stage 6
    (each projection's output is its own ``_pre``). ``int8``
    rounds every conv's input and weight to int8 but the first conv's and
    the projections' (the int8 serving variant's float convs)."""
    backbone, _ = _backbone_layers(cfg)
    first = True
    for layer in backbone:
        if layer[1] == "pool":
            x = F.max_pool2d(x, 2, 2)
            continue
        name = f"model0.backbone.{layer[0]}"
        x = F.relu(conv(x, params[name + ".weight"], params[name + ".bias"],
                        int8=int8 and not first, record=record))
        first = False
    features, out = x, {}
    branches = list(_branches(cfg))
    for stage in range(1, cfg["num_stages"] + 1):
        if stage > 1:
            x = torch.cat([out[1], out[2], features], dim=1)
        for _, b, prefix, layers in branches[2 * stage - 2:2 * stage]:
            y = x
            for j, (idx, _, _, _) in enumerate(layers):
                last = j == len(layers) - 1
                y = conv(y, params[f"{prefix}.{idx}.weight"],
                         params[f"{prefix}.{idx}.bias"],
                         int8=int8 and not last, record=record)
                if not last:
                    y = F.relu(y)
            out[b] = y
    return {"paf": out[1], "heat": out[2], "paf_pre": out[1],
            "heat_pre": out[2]}


def head_projections(cfg: dict):
    """The ``state_dict`` prefixes of stage 6's heatmap and PAF
    projections."""
    *_, (_, _, heat, layers) = _branches(cfg)
    paf = heat.replace("_2", "_1")
    return f"{heat}.{layers[-1][0]}", f"{paf}.{layers[-1][0]}"


@torch.no_grad()
def shape_head(params: dict, stats: dict, cfg: dict, targets: dict,
               slopes: dict) -> None:
    """Rewrite stage 6's projections in place: channel ``c`` of branch
    ``k`` ("heat", "paf"), ``W x + b``, becomes ``a (W x + b - mean_c) +
    targets[k][c]`` with ``a = slopes[k] / std_c`` (``stats[k]`` is
    ``(mean, std)``)."""
    for k, prefix in zip(("heat", "paf"), head_projections(cfg)):
        mean, std = stats[k]
        scale = slopes[k] / std
        params[prefix + ".weight"].mul_(scale[:, None, None, None])
        params[prefix + ".bias"].sub_(mean).mul_(scale).add_(targets[k])
