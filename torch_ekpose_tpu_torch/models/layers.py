"""Conv building blocks (NCHW, cuDNN).

Counterpart of the JAX package's ``models/layers.py``: the vgg conv +
ReLU pair with SAME padding (``k // 2``), the conv + BN + ReLU
block, the depthwise-separable ``DSConv``, a general max pool and the
width-multiplier ``depth_fn``. Blocks are plain ``nn`` modules at the
reference's attribute names and ``nn.Sequential`` indices, so the
``state_dict`` keys are the reference's.

BatchNorm is :class:`BatchNorm2d`, ``nn.BatchNorm2d`` (eps 1e-5) whose
training statistics may span several processes and height stripes (see
the class); in eval mode it normalizes
with the float32 running statistics in float32 and returns the input's
dtype, which is the JAX package's ``TorchBatchNorm`` at inference. Its
weight and bias stay float32 tensors in a bf16 model (holding
bf16-rounded values, see ``models/factory.py::cast_params``), as the CUDA
kernel takes a bf16 input only with float32 parameters and statistics.

In the folded int8 model (``models/quant.py``) the ReLU and the max pool
after a folded ``QuantConv`` are :class:`FoldReLU` and
:class:`FoldMaxPool2d`: on a ``QuantAcc`` record they defer into it (the
JAX package's ``ConvBlock`` and ``max_pool`` on a record); on a tensor
they are ``nn.ReLU`` and ``nn.MaxPool2d``.

Initialization mirrors the reference (reference
lib/network/vgg2016.py:107-126, mobilenet.py): Kaiming-normal fan-out with
zero bias for every conv (depthwise and pointwise included), N(0, 0.01)
for each stage's final projection, BN weight 1, bias 0, mean 0, var 1. It
draws from an explicit ``torch.Generator`` on the CPU, so it is the same
on any device.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from torch_ekpose_tpu_torch.models.quant import QuantAcc

__all__ = ["BatchNorm2d", "ConvBN", "DSConv", "FoldMaxPool2d", "FoldReLU",
           "batch_norm", "conv_relu", "depth_fn", "global_batch_norm",
           "init_conv_", "max_pool", "sync_batch_norm"]

#: BatchNorm epsilon of the reference (torch's default) and the JAX package
BN_EPS = 1e-5


def conv_relu(in_ch: int, out_ch: int, kernel: int, device) -> List[nn.Module]:
    """Conv (SAME padding, bias) followed by ReLU."""
    return [
        nn.Conv2d(in_ch, out_ch, kernel, padding=kernel // 2, device=device),
        nn.ReLU(inplace=True),
    ]


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose batch statistics span the GLOBAL batch, as
    the JAX package's ``TorchBatchNorm`` (``models/layers.py``) reduces
    them over a sharded array: over the ranks of ``process_group`` (data
    parallelism; :func:`sync_batch_norm` sets it) and over the stripes of
    a height-split activation (``parallel/spatial.py``).

    With neither (or a group of one rank), ``forward`` is
    ``nn.BatchNorm2d``'s. Otherwise, in
    training mode, :func:`global_batch_norm` sums the float32 sum and sum
    of squares of every stripe, all-reduces them (and the count) over the
    process group by an all-reduce whose backward all-reduces the
    gradient, and normalizes each stripe by the global
    mean and biased variance; the running variance takes Bessel's factor
    over the global count. In eval mode each stripe normalizes by the
    running statistics. The ``state_dict`` is ``nn.BatchNorm2d``'s.
    ``nn.SyncBatchNorm`` is no substitute: it refuses CPU tensors."""

    #: the ranks whose batches the statistics span (None: this process)
    process_group = None

    def forward(self, x):
        parts = getattr(x, "parts", None)        # parallel.spatial.Stripes
        if parts is None and not (self.training and self._ranks() > 1):
            return super().forward(x)
        if parts is None:
            return global_batch_norm(self, [x], self.process_group)[0]
        if self.training:
            out = global_batch_norm(self, parts, self.process_group)
        else:
            out = [F.batch_norm(p, *(x.replicas.move(t, p.device) for t in (
                self.running_mean, self.running_var, self.weight,
                self.bias)), False, 0.0, self.eps) for p in parts]
        return type(x)(out, x.replicas)

    def _ranks(self) -> int:
        if self.process_group is None:
            return 1
        import torch.distributed as dist

        return dist.get_world_size(self.process_group)


def global_batch_norm(bn: nn.BatchNorm2d, parts: Sequence[torch.Tensor],
                      group=None) -> List[torch.Tensor]:
    """Training-mode BN of ``parts`` (stripes of one activation, or one
    tensor) with the statistics of all of them and of every rank of
    ``group``; updates ``bn``'s running statistics once."""
    import torch.distributed as dist

    acc = torch.promote_types(parts[0].dtype, torch.float32)
    home = parts[0].device
    stats = sum(torch.cat([p.to(acc).sum((0, 2, 3)),
                           p.to(acc).square().sum((0, 2, 3)),
                           p.new_full((1,), p.numel() // p.shape[1],
                                      dtype=acc)]).to(home)
                for p in parts)
    if group is not None and dist.get_world_size(group) > 1:
        stats = _all_reduce(stats, group)
    c = bn.num_features
    n = stats[-1]
    mean = stats[:c] / n
    var = torch.clamp(stats[c:2 * c] / n - mean * mean, min=0.0)
    with torch.no_grad():                        # no host sync
        m = bn.momentum
        unbiased = var * (n / torch.clamp(n - 1, min=1))
        bn.num_batches_tracked.add_(1)
        bn.running_mean.mul_(1 - m).add_(m * mean.to(bn.running_mean.dtype))
        bn.running_var.mul_(1 - m).add_(m * unbiased.to(bn.running_var.dtype))
    scale = torch.rsqrt(var + bn.eps) * bn.weight.to(acc)
    shift = bn.bias.to(acc) - mean * scale
    out = []
    for p in parts:
        s = scale.to(p.device)[None, :, None, None]
        b = shift.to(p.device)[None, :, None, None]
        out.append((p.to(acc) * s + b).to(p.dtype))
    return out


class _AllReduce(torch.autograd.Function):
    """A sum over the ranks whose backward is the same sum of the
    gradients (each rank's statistics feed every rank's loss)."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    return _AllReduce.apply(x, group)


def sync_batch_norm(model: nn.Module, group) -> None:
    """Make every :class:`BatchNorm2d` of ``model`` reduce its training
    statistics over the ranks of ``group`` (None: this process alone)."""
    for module in model.modules():
        if isinstance(module, BatchNorm2d):
            module.process_group = group


def batch_norm(channels: int, device) -> BatchNorm2d:
    """The reference's ``nn.BatchNorm2d`` (eps 1e-5, momentum 0.1)."""
    return BatchNorm2d(channels, eps=BN_EPS, device=device)


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


class FoldReLU(nn.ReLU):
    """``nn.ReLU`` that defers into a folded conv's record: the next
    folded conv clips at 0 in its requantize, or :func:`realize`
    applies it."""

    def forward(self, x):
        if isinstance(x, QuantAcc):
            return x.replace(relu=True)
        return super().forward(x)


class FoldMaxPool2d(nn.MaxPool2d):
    """``nn.MaxPool2d`` that defers into a folded conv's record: the
    consumer pools its int8 requantized data (pad -128), or
    :func:`realize` its real activations (pad -inf)."""

    def forward(self, x):
        if isinstance(x, QuantAcc):
            return x.replace(pools=x.pools + ((
                self.kernel_size, self.stride, self.padding),))
        return super().forward(x)


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

