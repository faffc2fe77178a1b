"""The training loop on one device (reference train.py main flow,
:32-244): optional frozen-backbone warmup, epoch train/validate loops,
plateau LR scheduling, checkpointing with FULL resume state (model +
optimizer + epoch + scheduler — the reference saves bare weights only and
cannot resume, train.py:207-218), metrics, and the training-curve PNG.

Counterpart of the JAX package's ``training/trainer.py``. One process
trains on one device; in a ``torch.distributed`` process group
(``parallel/mesh.py::init_distributed``, ``cli.train --num-devices``)
each process is one data-parallel rank on its own device, its loader
serving its slice of the global batch: the step's forward runs through
``DistributedDataParallel``, BN reduces its statistics over the ranks
(``models/layers.py::BatchNorm2d``), the logged series are the global
batch's (reduced on the device once an epoch), a preemption flag is
agreed on at a fixed cadence, and rank 0 alone writes the metrics,
checkpoints and curve. ``zero1=True`` shards Adam's moments over the
ranks (ZeRO-1); its checkpoints hold the full, consolidated state.
A ``device`` that is a sequence of K devices (the rank's row of
``parallel/mesh.py::rank_devices``) splits each image's height over them
(``parallel/spatial.py::SpatialForward``).
Batches are uploaded from pinned host memory with ``non_blocking=True``
and the per-batch loss accumulates on the device, so the loop reads the
device once per epoch. With ``targets="raw"`` the training batches are
decode-only canvases augmented on the device, each batch's draws from a
generator seeded by (seed, epoch, batch), so a resumed run draws the
same augmentation; validation stays on device targets.

:meth:`Trainer.restore` reads the port's own checkpoints and the JAX
package's flax ``.ckpt`` (``runtime/flax_msgpack.py``, no flax needed):
its ``params``/``batch_stats`` through the weight bridge, and its optax
state (``inject_hyperparams(chain(add_decayed_weights, adam))``,
optionally under ``multi_transform`` for the frozen backbone) onto
``torch.optim.Adam``: ``mu`` -> ``exp_avg``, ``nu`` -> ``exp_avg_sq``,
``count`` -> ``step``, ``learning_rate`` -> the groups' ``lr``.
"""

from __future__ import annotations

import os
import signal
import threading
import time
import warnings
import zipfile
from typing import Dict, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist

from torch_ekpose_tpu_torch.config import Config, cfg as default_cfg
from torch_ekpose_tpu_torch.models.factory import get_model, init_model
from torch_ekpose_tpu_torch.models.layers import sync_batch_norm
from torch_ekpose_tpu_torch.parallel.mesh import (
    all_reduce_flag, process_count, process_index)
from torch_ekpose_tpu_torch.parallel.spatial import SpatialForward
from torch_ekpose_tpu_torch.runtime.checkpoint import (
    params_from_jax, state_dict_from_jax)
from torch_ekpose_tpu_torch.runtime.flax_msgpack import read_flax_msgpack
from torch_ekpose_tpu_torch.training.metrics import (
    AverageMeter,
    MetricsWriter,
    save_training_curve,
)
from torch_ekpose_tpu_torch.training.schedule import ReduceLROnPlateau
from torch_ekpose_tpu_torch.training.train_step import (
    make_eval_step,
    make_optimizer,
    make_train_step,
    set_learning_rate,
)

__all__ = ["Trainer", "aug_generator", "read_checkpoint"]


def _resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device with no card
    raises instead of falling back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: training runs on the card unless the caller "
            "asks for the CPU (device='cpu', cli.train --device cpu)")
    return device


def read_checkpoint(path: str, device="cpu") -> dict:
    """The payload :meth:`Trainer.save` wrote to ``path`` (tensors on
    ``device``), or the JAX package's trainer payload (a flax msgpack:
    nested dicts of numpy arrays) where ``path`` is not a torch zip."""
    if not zipfile.is_zipfile(path):
        return read_flax_msgpack(path)
    return torch.load(path, map_location=device, weights_only=True)


def aug_generator(seed: int, epoch: int, batch: int) -> torch.Generator:
    """The CPU generator of one raw-mode batch's augmentation draws,
    seeded by (seed, epoch, batch) (the JAX package folds the same three
    into its key), so a resumed epoch draws what it drew before."""
    state = np.random.SeedSequence([seed, 0x7261, epoch, batch])
    return torch.Generator().manual_seed(
        int(state.generate_state(1, np.uint64)[0]))


class _NullMetrics:
    """The metrics sink of every rank but 0."""

    def add_scalar(self, *args, **kwargs):
        pass

    def add_scalars(self, *args, **kwargs):
        pass

    def flush(self):
        pass

    def close(self):
        pass


def _python(value):
    """A 0-d numpy leaf of a flax payload as a Python number."""
    return value.item() if hasattr(value, "item") else value


class Trainer:
    def __init__(
        self,
        model_name: str = "vgg2016",
        config: Optional[Config] = None,
        state_dict: Optional[Dict[str, torch.Tensor]] = None,
        out_dir: str = "checkpoints",
        log_dir: str = "logs",
        targets: str = "device",
        *,
        device="cuda",
        freeze_backbone: bool = False,
        compute_dtype: torch.dtype = torch.float32,
        grad_accum: int = 1,
        remat: bool = False,
        zero1: bool = False,
    ):
        self.config = config or default_cfg
        tc = self.config.TRAIN
        self.model_name = model_name
        # a sequence of devices: this rank's height-split group
        # (parallel.mesh.rank_devices), the parameters on its first
        group = ([device] if isinstance(device, (str, torch.device))
                 else list(device))
        self.device = _resolve_device(group[0])
        #: data-parallel ranks: the process group's (1 outside one)
        self.rank, self.world = process_index(), process_count()
        self.zero1 = zero1
        # remat: backward-pass recomputation of the backbone + each CPM
        # branch (torch.utils.checkpoint) — the same gradients, activation
        # memory traded for ~one extra forward; the state_dict is
        # unchanged, so checkpoints are interchangeable
        if state_dict is None:
            self.model = init_model(
                model_name, generator=torch.Generator().manual_seed(tc.seed),
                device=self.device, remat=remat,
            )
        else:
            self.model = get_model(model_name, device=self.device,
                                   remat=remat)
            self.model.load_state_dict(state_dict, strict=True)
        self.optimizer = make_optimizer(
            self.model, tc.lr, tc.weight_decay,
            freeze_backbone=freeze_backbone, zero1=zero1,
        )
        # several devices: each image's height splits over them; the data
        # axis is the processes
        forward = self.model
        if len(group) > 1:
            forward = SpatialForward(self.model, group)
        eval_forward = forward
        if self.world > 1:
            # statistics over the global batch; every rank holds equal
            # state, so DDP need not broadcast the buffers each step
            sync_batch_norm(self.model, dist.group.WORLD)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", FutureWarning)
                forward = torch.nn.parallel.DistributedDataParallel(
                    forward, broadcast_buffers=False,
                    device_ids=([self.device] if self.device.type == "cuda"
                                else None))
        grid = (tc.square_size // 8, tc.square_size // 8)
        # bf16 activations run the convs at the tensor cores' bf16 rate;
        # parameters, Adam moments and the loss stay float32
        self.train_step = make_train_step(
            self.model, self.optimizer, targets=targets, grid=grid,
            grad_accum=grad_accum, compute_dtype=compute_dtype,
            forward=forward, shard=(self.rank, self.world),
        )
        # raw mode augments TRAINING batches on the device; validation
        # never augments, so its loader serves device-target items
        self.targets = targets
        self.eval_step = make_eval_step(
            self.model, targets="device" if targets == "raw" else targets,
            grid=grid, compute_dtype=compute_dtype, forward=eval_forward,
        )
        self.scheduler = ReduceLROnPlateau(
            tc.lr, factor=tc.lr_factor, patience=tc.lr_patience
        )
        self.out_dir = out_dir
        # rank 0 alone owns the files: metrics, checkpoints, the curve
        self.is_main_process = self.rank == 0
        if self.is_main_process:
            # the training curve PNG lands here after the FIRST epoch,
            # before any checkpoint has created the directory
            os.makedirs(out_dir, exist_ok=True)
        self.metrics = (MetricsWriter(log_dir) if self.is_main_process
                        else _NullMetrics())
        self.step = 0
        self.epoch = 0
        self.best_val = float("inf")
        self.train_curve = {"train": [], "val": []}
        self.preempted = False
        # the ranks agree on a preemption (an OR over the group) at these
        # batch indices only, the same on every rank: a rank that broke
        # on its own flag would leave the others waiting in a collective
        self.preempt_sync_every = 16

    def _upload(self, batch):
        """Host numpy arrays -> tensors on the device: through pinned
        memory, without waiting for the copy, on a card."""
        out = []
        for array in batch:
            tensor = torch.from_numpy(array)
            if self.device.type == "cuda":
                tensor = tensor.pin_memory().to(self.device,
                                                non_blocking=True)
            out.append(tensor)
        return out

    def _sync_preempted(self) -> bool:
        """The preemption flag agreed on by every rank (a collective; the
        local flag alone in one process)."""
        self.preempted = all_reduce_flag(self.preempted)
        return self.preempted

    def _global(self, logs: dict, loss_sum, n_seen: int):
        """The epoch's loss sum, sample count and last logs over every
        rank, reduced on the device: the stage sums add, ``Loss`` is the
        mean of the ranks' (equal local batches), ``max_*`` / ``min_*``
        take the max / min."""
        if self.world == 1 or loss_sum is None:
            return logs, loss_sum, n_seen
        device = loss_sum.device
        if dist.get_backend() == "gloo":
            device = torch.device("cpu")
        total = torch.stack([loss_sum.float().to(device),
                             torch.tensor(float(n_seen), device=device)])
        dist.all_reduce(total)
        names = list(logs)
        values = torch.stack([logs[k].float().to(device) for k in names])
        ops = [dist.ReduceOp.MAX if k.startswith("max")
               else dist.ReduceOp.MIN if k.startswith("min")
               else dist.ReduceOp.SUM for k in names]
        out = {}
        for op in (dist.ReduceOp.SUM, dist.ReduceOp.MAX, dist.ReduceOp.MIN):
            idx = [i for i, o in enumerate(ops) if o == op]
            if not idx:
                continue
            part = values[idx].clone()
            dist.all_reduce(part, op=op)
            for i, v in zip(idx, part):
                out[names[i]] = v / self.world if names[i] == "Loss" else v
        return {k: out[k] for k in names}, total[0], int(total[1])

    # -- epoch loops -----------------------------------------------------

    def _run_epoch(self, loader: Iterable, train: bool) -> float:
        data_time = AverageMeter()
        t_loop = time.time()
        end = t_loop
        logs = {}
        # the per-batch loss accumulates ON DEVICE: reading the scalar
        # each step would sync the host with the card per batch and
        # stall the launch queue; one read per epoch costs nothing
        loss_sum = None
        n_seen = 0
        n_batches = 0
        for batch in loader:
            # one process: the local flag, every batch. Several ranks:
            # the agreed flag, at the fixed cadence only
            if self.world == 1:
                if self.preempted:
                    break
            elif (n_batches % self.preempt_sync_every == 0
                    and self._sync_preempted()):
                break
            data_time.update(time.time() - end)
            batch = self._upload(batch)
            if train and self.targets == "raw":
                logs = self.train_step(*batch, aug_generator(
                    self.config.TRAIN.seed, self.epoch, n_batches))
                self.step += 1
            elif train:
                logs = self.train_step(*batch)
                self.step += 1
            else:
                logs = self.eval_step(*batch)
            n = batch[0].shape[0]
            weighted = logs["Loss"] * n
            loss_sum = weighted if loss_sum is None else loss_sum + weighted
            n_seen += n
            n_batches += 1
            end = time.time()
        logs, loss_sum, n_seen = self._global(logs, loss_sum, n_seen)
        avg_loss = (
            float(loss_sum) / n_seen if loss_sum is not None else 0.0
        )
        # launches are async, so per-batch wall times would measure only
        # the host loop; the honest per-batch figure is the epoch wall —
        # measured AFTER the float() above synchronized — over batches
        batch_time = (time.time() - t_loop) / max(n_batches, 1)
        tag = "train" if train else "val"
        step = self.epoch
        self.metrics.add_scalar(f"Loss/{tag}", avg_loss, step)
        if logs:
            self.metrics.add_scalars(
                {
                    f"{k}/{tag}": float(v)
                    for k, v in logs.items() if k != "Loss"
                },
                step,
            )
        self.metrics.add_scalar(f"BatchTime/{tag}", batch_time, step)
        self.metrics.add_scalar(f"DataTime/{tag}", data_time.avg, step)
        return avg_loss

    def fit(
        self,
        train_loader: Iterable,
        val_loader: Optional[Iterable] = None,
        epochs: Optional[int] = None,
        save_epoch: Optional[int] = None,
        verbose: bool = True,
    ) -> Dict[str, list]:
        tc = self.config.TRAIN
        epochs = epochs if epochs is not None else tc.epochs
        save_epoch = save_epoch if save_epoch is not None else tc.save_epoch

        # Preemption safety: on SIGTERM/SIGINT finish the in-flight
        # batch, write a full-resume checkpoint, then stop cleanly.
        # Signal handlers can only be installed from the main thread;
        # elsewhere (tests, notebook executors) fit still honors an
        # externally set ``self.preempted``.
        prev_handlers = {}
        if threading.current_thread() is threading.main_thread():
            signals_seen = [0]

            def _on_signal(signum, frame):
                signals_seen[0] += 1
                if signals_seen[0] > 1:
                    # second signal: the user wants out NOW, not at the
                    # next batch boundary — restore the previous handler
                    # and re-deliver so Ctrl-C force-aborts even inside a
                    # hung batch
                    signal.signal(
                        signum, prev_handlers.get(signum, signal.SIG_DFL)
                    )
                    signal.raise_signal(signum)
                    return
                self.preempted = True

            for sig in (signal.SIGTERM, signal.SIGINT):
                prev_handlers[sig] = signal.signal(sig, _on_signal)
        try:
            return self._fit(
                train_loader, val_loader, epochs, save_epoch, verbose
            )
        finally:
            for sig, handler in prev_handlers.items():
                signal.signal(sig, handler)

    def _save_preempt(self, epoch: int, verbose: bool) -> None:
        """Checkpoint everything but mark ``epoch`` as the resume point,
        so the interrupted epoch re-runs in full."""
        path = os.path.join(self.out_dir, "preempt.ckpt")
        self.save(path, resume_epoch=epoch)
        if verbose:
            print(f"preempted: full resume state saved to {path}")

    def _fit(
        self, train_loader, val_loader, epochs, save_epoch, verbose
    ) -> Dict[str, list]:
        tc = self.config.TRAIN
        start = self.epoch
        for epoch in range(start, epochs):
            self.epoch = epoch
            t0 = time.time()
            if hasattr(train_loader, "dataset") and hasattr(
                train_loader.dataset, "reseed"
            ):
                train_loader.dataset.reseed(tc.seed + epoch)
            train_loss = self._run_epoch(train_loader, train=True)
            if self._sync_preempted():
                self._save_preempt(epoch, verbose)
                break
            val_loss = (
                self._run_epoch(val_loader, train=False)
                if val_loader is not None else train_loss
            )
            if self._sync_preempted():
                # preempted during validation: the partial val loss must
                # not reach the scheduler / best-checkpoint logic; the
                # whole epoch re-runs on resume
                self._save_preempt(epoch, verbose)
                break
            self.train_curve["train"].append(train_loss)
            self.train_curve["val"].append(val_loss)

            lr = self.scheduler.step(val_loss)
            set_learning_rate(self.optimizer, lr)
            self.metrics.add_scalar("LearningRate", lr, epoch)
            self.metrics.flush()
            if verbose:
                print(
                    f"epoch {epoch}: train {train_loss:.2f} "
                    f"val {val_loss:.2f} lr {lr:.2e} "
                    f"({(time.time() - t0) / 60:.1f} min)"
                )

            if save_epoch and (epoch + 1) % save_epoch == 0:
                self.save(os.path.join(self.out_dir, f"epoch_{epoch}.ckpt"))
            if epoch > 5 and val_loss < self.best_val:
                self.best_val = val_loss
                self.save(os.path.join(self.out_dir, "best_epoch.ckpt"))
            if self.is_main_process:
                save_training_curve(
                    os.path.join(self.out_dir, "training_curve.png"),
                    self.train_curve["train"], self.train_curve["val"],
                )
        return self.train_curve

    # -- checkpointing (full resume state) -------------------------------

    def save(self, path: str, resume_epoch: Optional[int] = None) -> None:
        """One ``torch.save`` dict: the model's ``state_dict`` (float32),
        the optimizer's, the step, the epoch to resume at, the best
        validation loss, the scheduler and the loss curves. Every rank
        calls it; a ZeRO-1 optimizer's state is consolidated (a
        collective) into the full Adam state, and rank 0 writes; the
        ranks then wait for the file."""
        if self.zero1:
            self.optimizer.consolidate_state_dict(to=0)
        if self.is_main_process:
            self._write(path, resume_epoch)
        if self.world > 1:
            dist.barrier()       # the file is there for every rank after

    def _write(self, path: str, resume_epoch: Optional[int]) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        torch.save({
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "step": self.step,
            "epoch": (
                resume_epoch if resume_epoch is not None else self.epoch + 1
            ),
            "best_val": self.best_val,
            "scheduler": self.scheduler.state_dict(),
            "train_curve": self.train_curve,
        }, path)

    def restore(self, path: str) -> None:
        """Load what :meth:`save` wrote (parameters, BN statistics and
        optimizer state come back bitwise; a ZeRO-1 optimizer keeps its
        own part of a plain Adam state, and a plain one loads a ZeRO-1
        checkpoint's full state), or a JAX trainer's flax ``.ckpt``
        (:meth:`_restore_flax`). Every rank reads the file."""
        payload = read_checkpoint(path, self.device)
        if not {"model", "opt_state"} & set(payload):
            raise SystemExit(
                f"{path} is not a trainer checkpoint: it holds "
                f"{sorted(payload)}, neither the port's 'model' nor the "
                "JAX package's 'opt_state'")
        if "model" in payload:
            self.model.load_state_dict(payload["model"], strict=True)
            self.optimizer.load_state_dict(payload["optimizer"])
        else:
            self._restore_flax(payload)
        self.step = int(_python(payload["step"]))
        self.epoch = int(_python(payload["epoch"]))
        self.best_val = float(_python(payload["best_val"]))
        self.scheduler.load_state_dict(
            {k: _python(v) for k, v in payload["scheduler"].items()})
        self.train_curve = {
            k: [float(_python(x)) for x in v]
            for k, v in payload["train_curve"].items()
        }

    def _restore_flax(self, payload: dict) -> None:
        """The JAX trainer's ``params``, ``batch_stats`` and optax state
        (``torch_ekpose_tpu/training/trainer.py::save``) into the model
        and ``torch.optim.Adam``. The moments must cover exactly the
        parameters this optimizer trains (a frozen-backbone state only a
        ``freeze_backbone`` trainer)."""
        self.model.load_state_dict(
            state_dict_from_jax(payload, self.model_name), strict=True)
        opt = payload["opt_state"]
        if "inner_states" in opt:               # multi_transform (frozen)
            opt = opt["inner_states"]["train"]["inner_state"]
        adam = opt["inner_state"]["1"]["0"]     # chain(decay, adam)[1]
        mu = params_from_jax(adam["mu"], self.model_name, partial=True)
        nu = params_from_jax(adam["nu"], self.model_name, partial=True)
        params = dict(self.model.named_parameters())
        trained = {id(p) for g in self.optimizer.param_groups
                   for p in g["params"]}
        names = {n for n, p in params.items() if id(p) in trained}
        if set(mu) != names:
            raise ValueError(
                f"the checkpoint's Adam moments cover {len(mu)} parameters, "
                f"this optimizer trains {len(names)} (a frozen-backbone "
                "state needs freeze_backbone=True, and the other way round)")
        step = float(_python(adam["count"]))
        # a plain Adam over the trained parameters takes the state; a
        # ZeRO-1 optimizer then loads its part of that Adam's state
        adam_opt = (torch.optim.Adam([dict(g) for g in
                                      self.optimizer.param_groups])
                    if self.zero1 else self.optimizer)
        adam_opt.state.clear()
        for name in names:
            param = params[name]
            adam_opt.state[param] = {
                "step": torch.tensor(step, dtype=torch.float32),
                "exp_avg": mu[name].to(param.device, param.dtype),
                "exp_avg_sq": nu[name].to(param.device, param.dtype),
            }
        set_learning_rate(
            adam_opt, float(_python(opt["hyperparams"]["learning_rate"])))
        if adam_opt is not self.optimizer:
            self.optimizer.load_state_dict(adam_opt.state_dict())
