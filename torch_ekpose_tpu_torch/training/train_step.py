"""The training step on one device.

Counterpart of the JAX package's ``training/train_step.py`` (the
reference's hot loop body, reference train.py:360-382: forward,
get_loss, backward, step). The model and its ``torch.optim.Adam`` are the
state; a step runs forward, loss and backward and then one optimizer
step, with no host sync: its logs stay 0-dim tensors on the device. With
``targets="device"`` the heatmap/PAF rasterization
(:func:`~torch_ekpose_tpu_torch.data.targets.gen_targets_torch`) runs on
the card in the same step, in place of the reference's CPU-side target
loop (reference datasets.py:231-283).

Batches arrive as the loader makes them, on the step's device: NHWC
images and, with ``targets="host"``, NHWC heatmaps and PAFs; the step
permutes them to NCHW.

Precision is the JAX package's mixed precision: parameters, Adam moments
and the loss are float32; with ``compute_dtype=torch.bfloat16`` the
activations are bf16 and each conv's weight and bias is cast to bf16 at
use by a cast autograd sees (``models/heads.py::run_unit``), not by
``torch.autocast``, whose op lists differ between the CPU and CUDA. BN's
weight, bias and statistics stay float32. TF32 is off for cuDNN and
matmuls throughout, so float32 stays float32.

With ``targets="raw"`` the whole augmentation chain runs on the device
too (``data/device_aug.py``), from decode-only uint8 canvases, before the
targets and the step.

Data parallelism (``training/trainer.py``, one process per device) runs
the step's forward through ``DistributedDataParallel`` (``forward=``),
which averages the gradients over the ranks' equal local batches, so the
step takes the global batch's gradient (the loss is ``sum / local
batch``); ``--grad-accum``'s micro-steps but the last run under
``no_sync()``. ``--zero1`` makes the optimizer ZeRO-1
(``parallel/mesh.py::zero1_optimizer``); ``--spatial`` passes a
``parallel/spatial.py::SpatialForward``.

The JAX package's ``TrainState``/``create_train_state`` have no
counterpart: the module and the optimizer hold the state.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from torch_ekpose_tpu_torch import constants
from torch_ekpose_tpu_torch.data.targets import make_batched_target_fn
from torch_ekpose_tpu_torch.decode.device import tf32
from torch_ekpose_tpu_torch.training.loss import cpm_loss

__all__ = ["make_eval_step", "make_optimizer", "make_train_step",
           "set_learning_rate"]

def make_optimizer(
    model: nn.Module,
    lr: float,
    weight_decay: float,
    freeze_backbone: bool = False,
    zero1: bool = False,
) -> torch.optim.Optimizer:
    """``torch.optim.Adam(params, lr, weight_decay)``: L2 added to the
    gradient before the Adam moments (reference train.py:177-181), which
    the JAX package reproduces with ``add_decayed_weights`` + ``adam``.

    ``freeze_backbone``: the optimizer holds every parameter outside
    ``model0``, and ``model0``'s parameters stop taking gradients — the
    reference's warmup (reference train.py:130-166). Its BN running
    statistics still update in train mode, as in the JAX package.

    ``zero1``: the same Adam as ZeRO-1, each rank of the process group
    holding the moments of its part of the parameters
    (``parallel/mesh.py::zero1_optimizer``).
    """
    params = []
    for name, param in model.named_parameters():
        if freeze_backbone and name.startswith("model0."):
            param.requires_grad_(False)
        else:
            params.append(param)
    if zero1:
        from torch_ekpose_tpu_torch.parallel.mesh import zero1_optimizer

        return zero1_optimizer(params, lr, weight_decay)
    return torch.optim.Adam(params, lr=lr, weight_decay=weight_decay)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Write a new learning rate into every parameter group."""
    for group in optimizer.param_groups:
        group["lr"] = lr


def _check_targets(targets: str, grid, modes=("device", "host")) -> None:
    if targets not in modes:
        raise ValueError(f"unknown targets mode {targets!r}; expected one "
                         f"of {modes}")
    if targets != "host" and grid is None:
        raise ValueError(f"targets={targets!r} requires grid=(gy, gx)")


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """An NHWC batch as a contiguous NCHW tensor."""
    return x.permute(0, 3, 1, 2).contiguous()


def _targets_fn(targets: str, grid, stride: int, sigma: float):
    """(images, *rest) -> (NCHW images, heatmaps, pafs) for the mode."""
    if targets == "host":
        def host(images, heatmaps, pafs):
            return _nchw(images), _nchw(heatmaps), _nchw(pafs)
        return host
    rasterize = make_batched_target_fn(grid[0], grid[1], stride, sigma)

    def device(images, keypoints):
        heatmaps, pafs = rasterize(keypoints)
        return _nchw(images), heatmaps, pafs
    return device


def _reduce_logs(per_micro) -> Dict[str, torch.Tensor]:
    """The micro-batches' series reduced like the reference's
    per-iteration logs: sums add, extrema take max/min, ``Loss`` is the
    mean (the JAX package's ``compute_accum``)."""
    logs = {}
    for key in per_micro[0]:
        vals = torch.stack([m[key] for m in per_micro])
        if key == "Loss":
            logs[key] = vals.sum() / len(per_micro)
        elif key.startswith("max"):
            logs[key] = vals.max()
        elif key.startswith("min"):
            logs[key] = vals.min()
        else:
            logs[key] = vals.sum()
    return logs


def make_train_step(
    model: nn.Module,
    optimizer: torch.optim.Optimizer,
    *,
    targets: str = "host",
    grid: Optional[Tuple[int, int]] = None,
    stride: int = constants.DOWNSAMPLE,
    sigma: float = constants.TARGET_SIGMA,
    grad_accum: int = 1,
    compute_dtype: torch.dtype = torch.float32,
    forward: Optional[Callable] = None,
    shard: Tuple[int, int] = (0, 1),
):
    """Build the train step.

    ``targets="host"``: ``step(images, heatmaps, pafs)``.
    ``targets="device"``: ``step(images, keypoints)`` — targets are
    rasterized on the device; ``grid`` is (gy, gx).
    ``targets="raw"``: ``step(canvases_u8, valid_hw, keypoints,
    generator)`` — each image's augmentation is drawn from the
    ``torch.Generator`` and applied on the device
    (``data/device_aug.py::augment_batch``, output ``grid * stride``
    square), then the device targets and the step (the JAX package's
    ``step_raw``).
    Each returns the logs: the 16 series of :func:`cpm_loss` and
    ``Loss``, as 0-dim tensors on the device.

    ``grad_accum=N``: the batch splits into N micro-batches, run in
    order (BN's running statistics thread through them); their gradients
    are summed and divided by N before ONE optimizer step — the JAX
    package's ``lax.scan``. The loss is a per-sample mean, so this is the
    full batch's gradient (reference train.py:311-339).

    ``forward`` (default ``model``) runs the training forward, with
    ``model``'s signature: a ``DistributedDataParallel`` around it (its
    ``no_sync()`` holds the all-reduce back until the last micro-batch)
    or a ``SpatialForward``. ``shard=(rank, world)``: this process's
    batch is one rank's slice of the global batch; raw mode then draws
    the global batch's augmentation and keeps its slice
    (``data/device_aug.py::augment_batch``).
    """
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    _check_targets(targets, grid, ("device", "host", "raw"))
    prepare = _targets_fn("device" if targets == "raw" else targets, grid,
                          stride, sigma)
    cast = None if compute_dtype == torch.float32 else compute_dtype
    run = model if forward is None else forward
    no_sync = getattr(run, "no_sync", contextlib.nullcontext)

    def micro(images, heat_t, paf_t, sync=True):
        x = images if cast is None else images.to(cast)
        with contextlib.nullcontext() if sync else no_sync():
            _, saved = run(x, compute_dtype=cast)
            total, logs = cpm_loss(saved, heat_t, paf_t)
            total.backward()
        logs["Loss"] = total.detach()
        return logs

    def step(*batch):
        model.train()
        with tf32(False):
            images, heat_t, paf_t = prepare(*batch)
            optimizer.zero_grad(set_to_none=True)
            if grad_accum == 1:
                logs = micro(images, heat_t, paf_t)
            else:
                if images.shape[0] % grad_accum:
                    raise ValueError(
                        f"batch {images.shape[0]} does not split into "
                        f"{grad_accum} equal micro-batches")
                per_micro = [
                    micro(*mb, sync=i == grad_accum - 1)
                    for i, mb in enumerate(zip(
                        images.chunk(grad_accum), heat_t.chunk(grad_accum),
                        paf_t.chunk(grad_accum)))
                ]
                for group in optimizer.param_groups:
                    for param in group["params"]:
                        if param.grad is not None:
                            param.grad.div_(grad_accum)
                logs = _reduce_logs(per_micro)
            optimizer.step()
        return logs

    if targets != "raw":
        return step
    from torch_ekpose_tpu_torch.data.device_aug import augment_batch

    out_size = grid[0] * stride

    def step_raw(canvases_u8, valid_hw, keypoints, generator):
        images, kpts = augment_batch(canvases_u8, valid_hw, keypoints,
                                     generator, out_size=out_size,
                                     shard=shard)
        return step(images, kpts)

    return step_raw


def make_eval_step(
    model: nn.Module,
    *,
    targets: str = "host",
    grid: Optional[Tuple[int, int]] = None,
    stride: int = constants.DOWNSAMPLE,
    sigma: float = constants.TARGET_SIGMA,
    compute_dtype: torch.dtype = torch.float32,
    forward: Optional[Callable] = None,
):
    """Validation loss step (reference train.py:395-430, no backward):
    the model in eval mode (BN on its running statistics), the same
    arguments and logs as :func:`make_train_step`'s step. Validation
    never augments, so there is no ``"raw"`` mode. ``forward`` as in
    :func:`make_train_step` (a ``SpatialForward``)."""
    _check_targets(targets, grid)
    prepare = _targets_fn(targets, grid, stride, sigma)
    cast = None if compute_dtype == torch.float32 else compute_dtype
    run = model if forward is None else forward

    @torch.no_grad()
    def step(*batch):
        model.eval()
        with tf32(False):
            images, heat_t, paf_t = prepare(*batch)
            x = images if cast is None else images.to(cast)
            _, saved = run(x, compute_dtype=cast)
            total, logs = cpm_loss(saved, heat_t, paf_t)
        logs["Loss"] = total
        return logs

    return step
