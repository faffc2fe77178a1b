"""Ranks of the port's data-parallel tests (not a test file): gloo
process groups on the CPU, started by :func:`start_ranks`. Imports torch
and the port only (spawned ranks import this module, not the tests).

:func:`dp_worker` runs every data-parallel case of
``tests/test_torch_parallel_train.py`` in one 2-rank group (one start
for all of them) and rank 0 writes what the test compares with one
process on the global batch: the SGD step of vgg2016 (float32) and of a
BN model (float64, running statistics included), Adam and ZeRO-1 after
three steps with each rank's share of the moments, the checkpoints of a
ZeRO-1 trainer and of a plain one restored by the other, and where a
preemption flagged on one rank stopped each rank; with ``--grad-accum
2`` (the micro-steps under ``no_sync``) the BN model's step again, and
the series one epoch logs.
"""

from __future__ import annotations

import os
import socket
import sys
import warnings

import torch

SIZE = 32               # the trainers' square size
LR = 1e-4


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def start_ranks(fn, world: int, *args):
    """``fn(rank, world, port, *args)`` in ``world`` spawned processes,
    not waited for: returns their ``ProcessContext``, whose ``join()``
    raises if a rank failed."""
    import torch.multiprocessing as mp

    os.environ.setdefault("OMP_NUM_THREADS", "1")
    return mp.start_processes(fn, args=(world, free_port()) + args,
                              nprocs=world, start_method="spawn",
                              join=False)


def step_model(name: str, state_dict: dict, images, kpts, *,
               dtype=torch.float32, optimizer: str = "sgd", steps: int = 1,
               lr: float = LR, forward_wrap=None, grad_accum: int = 1):
    """``steps`` train steps (device targets) of ``name`` loaded from
    ``state_dict`` in ``dtype`` on these NHWC images and keypoints; in a
    process group of several ranks the forward runs through DDP and BN
    reduces over the ranks. Returns (the global batch's loss of the last
    step, the model, the optimizer)."""
    import torch.distributed as dist

    from torch_ekpose_tpu_torch.models.factory import get_model
    from torch_ekpose_tpu_torch.models.layers import sync_batch_norm
    from torch_ekpose_tpu_torch.training.train_step import (
        make_optimizer, make_train_step)

    model = get_model(name, device="cpu")
    model.load_state_dict(state_dict)
    model.to(dtype)
    forward = model if forward_wrap is None else forward_wrap(model)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world > 1:
        sync_batch_norm(model, dist.group.WORLD)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FutureWarning)
            forward = torch.nn.parallel.DistributedDataParallel(
                forward, broadcast_buffers=False)
    if optimizer == "sgd":
        opt = torch.optim.SGD(model.parameters(), lr=lr)
    else:
        opt = make_optimizer(model, lr, 5e-4, zero1=optimizer == "zero1")
    grid = (images.shape[1] // 8, images.shape[2] // 8)
    step = make_train_step(model, opt, targets="device", grid=grid,
                           forward=forward, grad_accum=grad_accum)
    x = torch.as_tensor(images, dtype=dtype)
    k = torch.as_tensor(kpts)
    for _ in range(steps):
        logs = step(x, k)
    loss = logs["Loss"].detach().double().reshape(1)
    if world > 1:
        dist.all_reduce(loss)
        loss /= world
    return float(loss), model, opt


def _state(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _trainer(name: str, out: str, **options):
    from torch_ekpose_tpu_torch.config import get_default_config
    from torch_ekpose_tpu_torch.training import Trainer

    cfg = get_default_config()
    cfg.TRAIN.square_size = SIZE
    return Trainer(name, config=cfg, out_dir=out, log_dir=out + "_logs",
                   device="cpu", **options)


class _PreemptOn:
    """Batches that set ``trainer.preempted`` at batch ``at`` on rank
    ``rank`` only (its own SIGTERM)."""

    def __init__(self, batches, trainer, rank: int, at: int):
        self.batches, self.trainer = batches, trainer
        self.hit = trainer.rank == rank
        self.at = at

    def __iter__(self):
        for i, batch in enumerate(self.batches):
            if self.hit and i == self.at:
                self.trainer.preempted = True
            yield batch


def _adam_share(opt) -> tuple:
    """(moment elements this rank holds, all parameters' elements)."""
    inner = getattr(opt, "optim", opt)
    held = sum(v.numel() for s in inner.state.values()
               for k, v in s.items() if k in ("exp_avg", "exp_avg_sq"))
    total = 2 * sum(p.numel() for g in opt.param_groups for p in g["params"])
    return held, total


def dp_worker(rank: int, world: int, port: int, work: str) -> None:
    import torch.distributed as dist

    from torch_ekpose_tpu_torch.parallel.mesh import (
        init_distributed, shard_batch)

    torch.set_num_threads(1)
    sys.modules["torch.utils.tensorboard"] = None      # JSONL metrics
    init_distributed(f"localhost:{port}", world, rank, backend="gloo")
    case = torch.load(os.path.join(work, "case.pt"), weights_only=False)
    out = {}

    def local(key):
        return shard_batch(tuple(case[key]), rank, world)

    images, kpts = local("batch")
    loss, model, _ = step_model("vgg2016", case["vgg"], images, kpts)
    out["sgd"] = (loss, _state(model))

    dense = local("dense")
    loss, model, _ = step_model(case["bn_name"], case["bn"], *dense,
                                dtype=torch.float64, lr=1e-3)
    out["bn"] = (loss, _state(model))
    loss, model, _ = step_model(case["bn_name"], case["bn"], *dense,
                                dtype=torch.float64, lr=1e-3, grad_accum=2)
    out["accum"] = (loss, _state(model))

    for kind in ("adam", "zero1"):
        loss, model, opt = step_model(case["bn_name"], case["bn"], *dense,
                                      optimizer=kind, steps=3)
        shares = [None] * world
        dist.all_gather_object(shares, _adam_share(opt))
        out[kind] = (loss, _state(model), shares)

    # a ZeRO-1 trainer's checkpoint into a plain one, and back
    name = case["bn_name"]
    zero = _trainer(name, os.path.join(work, "zero"), zero1=True)
    plain = _trainer(name, os.path.join(work, "plain"))
    x, k = (torch.from_numpy(a) for a in dense)
    zero.train_step(x, k)
    zero.save(os.path.join(work, "zero1.ckpt"))
    plain.restore(os.path.join(work, "zero1.ckpt"))
    plain.train_step(x, k)
    plain.save(os.path.join(work, "plain.ckpt"))
    zero.restore(os.path.join(work, "plain.ckpt"))
    zero.save(os.path.join(work, "zero1_again.ckpt"))

    # one epoch of one batch: rank 0 logs the global batch's series
    trainer = _trainer(name, os.path.join(work, "logs"))
    trainer.fit([dense], None, epochs=1, verbose=False)

    # a preemption flagged on rank 1 at batch 1, agreed on every 2
    trainer = _trainer(name, os.path.join(work, "preempt"))
    trainer.preempt_sync_every = 2
    batches = [tuple(a[i:i + 1] for a in dense) for i in range(2)] * 3
    trainer.fit(_PreemptOn(batches, trainer, rank=1, at=1), None,
                epochs=1, verbose=False)
    stops = [None] * world
    dist.all_gather_object(stops, (trainer.step, trainer.preempted))
    out["preempt"] = stops

    if rank == 0:
        torch.save(out, os.path.join(work, "results.pt"))
    dist.barrier()
    dist.destroy_process_group()
