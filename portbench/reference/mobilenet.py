"""Plain float32 reference of tf-pose-estimation's MobileNet pose networks
("mobilenet", "mobilenet_thin").

github.com/ildoonet/tf-pose-estimation, ``tf_pose/network_mobilenet*.py``,
as the reference repository writes it in PyTorch: MobileNet v1 at width
``conv_width`` (a 3x3 stride-2 conv + BN + ReLU, then eleven
depthwise-separable blocks: depthwise 3x3, pointwise 1x1, BN, ReLU), whose
blocks 3, 7 and 11 are concatenated (block 3 max-pooled 2x2) at stride 8;
six refinement stages of two depthwise-separable branches at width
``conv_width2``: three 3x3 blocks, a 1x1 block (to 512 at stage 1, 128
after) and a 1x1 projection block without ReLU. Stages 2-6 read ``cat(paf,
heat, features)``. Channel counts are ``max(round(d * width), 8)``.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F

from portbench.reference.common import batch_norm, conv

__all__ = ["forward", "head_projections", "param_specs", "shape_head"]


def _depth(d: int, width: float) -> int:
    return max(round(d * width), 8)


def _backbone(cfg: dict):
    """[(block, in, out, stride)]; block 0 is the plain conv."""
    blocks, c = [], 3
    for i, (feats, stride) in enumerate(cfg["mobilenet_plan"]):
        out = _depth(feats, cfg["conv_width"])
        blocks.append((i, c, out, stride))
        c = out
    taps = cfg["taps"]
    feat = sum(blocks[t][2] for t in taps)
    return blocks, feat


def _branches(cfg: dict):
    """(stage, branch, prefix, [(index, in, out, kernel, relu)])."""
    _, feat = _backbone(cfg)
    w2 = cfg["conv_width2"]
    outs = {1: cfg["paf_channels"], 2: cfg["heat_channels"]}
    for stage in range(1, cfg["num_stages"] + 1):
        c_in = feat if stage == 1 else outs[1] + outs[2] + feat
        mid = _depth(512 if stage == 1 else 128, w2)
        for b in (1, 2):
            plan = [(3, _depth(128, w2))] * 3 + [(1, mid)]
            layers, c = [], c_in
            for i, (k, out) in enumerate(plan):
                layers.append((i, c, out, k, True))
                c = out
            layers.append((len(plan), c, outs[b], 1, False))
            yield stage, b, f"model{stage}_{b}", layers


def _bn_specs(name: str, c: int):
    return [(name + ".weight", (c,), "bn_weight"),
            (name + ".bias", (c,), "bn_bias"),
            (name + ".running_mean", (c,), "bn_mean"),
            (name + ".running_var", (c,), "bn_var"),
            (name + ".num_batches_tracked", (), "count")]


def _ds_specs(name: str, c_in: int, c_out: int, k: int, final: bool):
    return ([(name + ".depthwise.weight", (c_in, 1, k, k), "conv"),
             (name + ".pointwise.weight", (c_out, c_in, 1, 1),
              "final" if final else "conv")]
            + _bn_specs(name + ".bn", c_out))


def param_specs(cfg: dict):
    blocks, _ = _backbone(cfg)
    specs = []
    for i, c_in, c_out, _ in blocks:
        name = f"model0.model0.{i}"
        if i == 0:
            specs += [(name + ".conv.weight", (c_out, c_in, 3, 3), "conv")]
            specs += _bn_specs(name + ".bn", c_out)
        else:
            specs += _ds_specs(name, c_in, c_out, 3, False)
    for _, _, prefix, layers in _branches(cfg):
        for idx, c_in, c_out, k, relu in layers:
            specs += _ds_specs(f"{prefix}.{idx}", c_in, c_out, k, not relu)
    return specs


def _ds(params, x, name, stride=1, relu=True, int8=False, record=None,
        pre=None):
    dw = params[name + ".depthwise.weight"]
    x = conv(x, dw, stride=stride, groups=dw.shape[0], int8=int8,
             record=record)
    x = conv(x, params[name + ".pointwise.weight"], int8=int8, record=record)
    if pre is not None:
        pre.append(x)
    x = batch_norm(x, params, name + ".bn")
    return F.relu(x) if relu else x


def forward(params: dict, x: torch.Tensor, cfg: dict, int8: bool = False,
            record: Optional[List[tuple]] = None) -> dict:
    """NCHW float32 -> {"paf", "heat", "paf_pre", "heat_pre"} of stage 6,
    where a ``_pre`` is that projection's pointwise output before its
    BN. ``int8`` rounds every conv's input and weight to int8 but the
    first conv's and each projection block's."""
    blocks, _ = _backbone(cfg)
    taps = []
    for i, _, _, stride in blocks:
        name = f"model0.model0.{i}"
        if i == 0:
            x = conv(x, params[name + ".conv.weight"], stride=stride,
                     record=record)
            x = F.relu(batch_norm(x, params, name + ".bn"))
        else:
            x = _ds(params, x, name, stride, int8=int8, record=record)
        if i in cfg["taps"]:
            taps.append(x)
    features = torch.cat([F.max_pool2d(taps[0], 2, 2), *taps[1:]], dim=1)
    out, pre, x = {}, [], features
    branches = list(_branches(cfg))
    for stage in range(1, cfg["num_stages"] + 1):
        if stage > 1:
            x = torch.cat([out[1], out[2], features], dim=1)
        for _, b, prefix, layers in branches[2 * stage - 2:2 * stage]:
            y = x
            for idx, _, _, _, relu in layers:
                y = _ds(params, y, f"{prefix}.{idx}", relu=relu,
                        int8=int8 and relu, record=record,
                        pre=pre if not relu else None)
            out[b] = y
    return {"paf": out[1], "heat": out[2], "paf_pre": pre[-2],
            "heat_pre": pre[-1]}


def head_projections(cfg: dict):
    """The ``state_dict`` prefixes of stage 6's heatmap and PAF
    projection blocks."""
    *_, (_, _, heat, layers) = _branches(cfg)
    paf = heat.replace("_2", "_1")
    return f"{heat}.{layers[-1][0]}", f"{paf}.{layers[-1][0]}"


@torch.no_grad()
def shape_head(params: dict, stats: dict, cfg: dict, targets: dict,
               slopes: dict) -> None:
    """Rewrite stage 6's projection BNs in place: branch ``k``'s ("heat",
    "paf") running statistics become its pointwise output's per-channel
    ``mean`` and ``std ** 2`` (``stats[k]``), its weight ``slopes[k]`` and
    its bias ``targets[k]`` (one a channel)."""
    for k, prefix in zip(("heat", "paf"), head_projections(cfg)):
        mean, std = stats[k]
        params[prefix + ".bn.running_mean"].copy_(mean)
        params[prefix + ".bn.running_var"].copy_(std * std)
        params[prefix + ".bn.weight"].fill_(slopes[k])
        params[prefix + ".bn.bias"].copy_(targets[k])
