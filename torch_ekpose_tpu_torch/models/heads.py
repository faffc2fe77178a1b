"""The 6-stage, 2-branch CPM head and the OpenPose network.

Counterpart of the JAX package's ``models/heads.py`` (reference
lib/network/vgg2016.py:37-105, mobilenet.py:100-134): stage 1 reads the
backbone features; stages 2..6 read ``concat(paf_{s-1}, heatmap_{s-1},
features)``; each stage has an L1 branch (38 PAF channels) and an L2
branch (19 heatmap channels). The branches are attributes
``model{s}_{b}`` of the network itself, as in the reference, so its
``state_dict`` loads with ``strict=True``. Two branch flavors: ``"vgg"``
(plain convs, vgg2016) and ``"ds"`` (five ``DSConv``s with BN, every
other backbone).

The forward contract is the reference's:
``((paf_6, heatmap_6), [paf_1, ht_1, ..., paf_6, ht_6])``, NCHW.

Two training options run each unit (the backbone, each branch) through
:func:`run_unit`: ``compute_dtype`` casts the conv parameters at use, so
float32 master parameters train with bf16 activations, and ``remat``
(``get_model(..., remat=True)``) recomputes each unit's activations in
the backward pass, as the JAX package's ``remat`` does.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from torch_ekpose_tpu_torch import constants
from torch_ekpose_tpu_torch.models.layers import DSConv, conv_relu

__all__ = ["BRANCHES", "CpmHead", "DSBranch", "OpenPose", "VggBranch",
           "run_unit"]


@contextlib.contextmanager
def _stats_kept(unit: nn.Module):
    """BN's running statistics and ``num_batches_tracked`` as they were
    before the block: a checkpointed unit's recomputation runs BN in
    train mode again (it must save the same tensors as the forward did),
    and its second update is undone here."""
    buffers = [b for m in unit.modules()
               if isinstance(m, nn.modules.batchnorm._BatchNorm)
               for b in (m.running_mean, m.running_var,
                         m.num_batches_tracked) if b is not None]
    kept = [b.clone() for b in buffers]
    try:
        yield
    finally:
        with torch.no_grad():
            for buf, old in zip(buffers, kept):
                buf.copy_(old)


def _conv_params(unit: nn.Module) -> List[Tuple[str, nn.Parameter]]:
    """(name within ``unit``, parameter) of every conv weight and bias."""
    return [(f"{owner}.{leaf}" if owner else leaf, param)
            for owner, module in unit.named_modules()
            if isinstance(module, nn.Conv2d)
            for leaf, param in module.named_parameters(recurse=False)]


def run_unit(unit: nn.Module, x: torch.Tensor,
             compute_dtype: Optional[torch.dtype] = None,
             remat: bool = False) -> torch.Tensor:
    """``unit(x)``, with the training forward's two options.

    ``compute_dtype``: each conv's weight and bias are cast to it at use,
    by a cast autograd sees, so their gradients reach the float32
    parameters (flax's ``dtype`` on float32 ``params``); BN's weight,
    bias and statistics stay float32, as the JAX package's
    ``TorchBatchNorm`` keeps its scale and bias. ``x`` must already be in
    ``compute_dtype``.

    ``remat``: the unit runs under ``torch.utils.checkpoint``
    (non-reentrant), which keeps only its input and recomputes its
    activations in the backward pass: the same gradients, less memory.
    The recomputation leaves BN's running statistics alone, so they
    update once per forward, as without remat.
    """
    if compute_dtype is None:
        fn, args = unit, (x,)
    else:
        names, params = zip(*_conv_params(unit))

        def fn(x, *weights):
            return torch.func.functional_call(
                unit, dict(zip(names, weights)), (x,))

        args = (x, *[p.to(compute_dtype) for p in params])
    if not remat:
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False, context_fn=lambda: (
        contextlib.nullcontext(), _stats_kept(unit)))


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

    def final(self) -> nn.Conv2d:
        """The output projection (initialized N(0, 0.01))."""
        return self[-1]


class DSBranch(nn.Sequential):
    """One depthwise-separable CPM branch (reference mobilenet.py:100-134):
    3x(3x3, d2(128)), 1x1 to d2(512) at stage 1 or d2(128) at stages 2-6,
    then a 1x1 to ``out_ch`` with no ReLU. ``width`` is d2, the head's
    width multiplier; a 1x1 ``DSConv`` has a 1x1 depthwise conv too."""

    def __init__(self, in_ch: int, out_ch: int, first_stage: bool,
                 width: Callable[[int], int], device=None):
        mid = width(512) if first_stage else width(128)
        plan = [(3, width(128))] * 3 + [(1, mid)]
        layers = []
        for kernel, feats in plan:
            layers.append(DSConv(in_ch, feats, kernel, device=device))
            in_ch = feats
        layers.append(DSConv(in_ch, out_ch, 1, relu=False, device=device))
        super().__init__(*layers)

    def final(self) -> nn.Conv2d:
        """The output projection's pointwise conv (initialized
        N(0, 0.01))."""
        return self[-1].pointwise


#: the branch flavors of :class:`CpmHead`
BRANCHES = {"vgg": VggBranch, "ds": DSBranch}


class CpmHead(nn.Module):
    """Six refinement stages, two branches each, registered as
    ``model{stage}_{branch}``. ``branch`` is ``"vgg"`` or ``"ds"``;
    ``width`` is the ds head's width multiplier (``conv_width2``)."""

    num_stages = 6

    def __init__(self, in_ch: int = 128, branch: str = "vgg",
                 width: Optional[Callable[[int], int]] = None, device=None):
        super().__init__()
        if branch not in BRANCHES:
            raise ValueError(f"unknown branch flavor {branch!r}")
        extra = {} if branch == "vgg" else {"width": width}
        paf_ch = constants.NUM_PAF_CHANNELS
        ht_ch = constants.NUM_HEATMAP_CHANNELS
        for stage in range(1, self.num_stages + 1):
            stage_in = in_ch if stage == 1 else paf_ch + ht_ch + in_ch
            for b, out_ch in ((1, paf_ch), (2, ht_ch)):
                self.add_module(
                    f"model{stage}_{b}",
                    BRANCHES[branch](stage_in, out_ch, stage == 1,
                                     device=device, **extra),
                )

    def head(self, features: torch.Tensor,
             run: Callable = run_unit) -> List[torch.Tensor]:
        """The 12 stage outputs ``[paf_1, ht_1, ..., paf_6, ht_6]``; each
        branch runs through ``run(branch, x)``."""
        saved_for_loss = []
        x = features
        for stage in range(1, self.num_stages + 1):
            paf = run(getattr(self, f"model{stage}_1"), x)
            heatmap = run(getattr(self, f"model{stage}_2"), x)
            saved_for_loss += [paf, heatmap]
            if stage < self.num_stages:
                x = torch.cat([paf, heatmap, features], dim=1)
        return saved_for_loss

    def forward(self, features):
        return self.head(features)


class OpenPose(CpmHead):
    """Backbone (``model0``) + CPM head with the reference's contract.

    ``forward(x)`` takes NCHW float input and returns
    ``((paf_last, heatmap_last), saved_for_loss)``. ``remat`` (set by
    ``get_model``) recomputes the backbone's and each branch's
    activations in the backward pass while gradients are recorded;
    ``forward(x, compute_dtype)`` casts the conv parameters at use
    (:func:`run_unit`).
    """

    def __init__(self, backbone: nn.Module, branch: str = "vgg",
                 width: Optional[Callable[[int], int]] = None, device=None,
                 remat: bool = False):
        super().__init__(backbone.out_channels, branch, width, device)
        self.model0 = backbone
        self.remat = remat

    def forward(
        self, x, compute_dtype: Optional[torch.dtype] = None
    ) -> Tuple[Tuple[torch.Tensor, torch.Tensor], List[torch.Tensor]]:
        run = functools.partial(
            run_unit, compute_dtype=compute_dtype,
            remat=self.remat and torch.is_grad_enabled())
        saved_for_loss = self.head(run(self.model0, x), run)
        return (saved_for_loss[-2], saved_for_loss[-1]), saved_for_loss
