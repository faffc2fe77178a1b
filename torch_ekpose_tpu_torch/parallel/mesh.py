"""Devices, process groups and batch shards of the parallel paths.

Counterpart of the JAX package's ``parallel/mesh.py``. The JAX package
lays one SPMD program over a ``jax.sharding.Mesh`` and lets XLA place
every array; here each piece of work names its device:

- :class:`Mesh` is a small grid of ``torch.device`` s shaped ``(data,)``
  or ``(data, spatial)``, as :func:`make_mesh` builds it. Within one
  process a device may appear more than once (``[cpu] * 4`` on a host
  without a card, ``cuda:0`` twice on a one-card machine), as the JAX
  tests' virtual CPU devices do.
- :func:`init_distributed` joins a ``torch.distributed`` process group
  (NCCL for CUDA devices, gloo for the CPU or on request): data-parallel
  training runs one process per device (``DistributedDataParallel``).
- :func:`shard_batch` is one device's or one rank's slice of a global
  batch; :func:`zero1_optimizer` is ZeRO-1
  (``torch.distributed.optim.ZeroRedundancyOptimizer`` around Adam).

The JAX helpers that only place XLA shardings have no counterpart:
``replicated``, ``place_replicated`` and ``place_tree`` (a module lives on
one device; ``parallel/inference.py`` keeps one replica per device and
DDP one per process), ``data_sharding`` and ``field_sharding`` (the batch
is split by :func:`shard_batch`, the height by
``parallel/spatial.py``), ``zero1_sharding_tree`` (ZeRO partitions the
optimizer state itself).
"""

from __future__ import annotations

import datetime
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = [
    "DATA_AXIS", "SPATIAL_AXIS", "Mesh", "all_reduce_flag",
    "broadcast_flag", "cuda_devices", "infer_compute_dtype",
    "init_distributed", "make_mesh", "process_count", "process_index",
    "rank_devices", "shard_batch", "zero1_optimizer",
]

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"
#: how long a rank waits in one collective for a peer that never joins it
COLLECTIVE_TIMEOUT = datetime.timedelta(minutes=30)


class Mesh:
    """A grid of devices: ``devices[i][j]`` is the device of data shard
    ``i`` and height stripe ``j``. ``axis_names`` is ``("data",)`` for a
    1-D mesh (one stripe) and ``("data", "spatial")`` otherwise."""

    def __init__(self, grid: Sequence[Sequence[torch.device]]):
        self.devices: Tuple[Tuple[torch.device, ...], ...] = tuple(
            tuple(torch.device(d) for d in row) for row in grid)
        widths = {len(row) for row in self.devices}
        if not self.devices or len(widths) != 1 or 0 in widths:
            raise ValueError("a mesh is a non-empty rectangular grid")

    @property
    def shape(self) -> Tuple[int, ...]:
        rows, cols = len(self.devices), len(self.devices[0])
        return (rows,) if cols == 1 else (rows, cols)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return ((DATA_AXIS,) if len(self.shape) == 1
                else (DATA_AXIS, SPATIAL_AXIS))

    @property
    def size(self) -> int:
        return len(self.devices) * len(self.devices[0])

    @property
    def flat(self) -> List[torch.device]:
        return [d for row in self.devices for d in row]

    def __repr__(self) -> str:
        return f"Mesh({dict(zip(self.axis_names, self.shape))}, {self.flat})"


def cuda_devices() -> List[torch.device]:
    """Every visible CUDA device; none raises (the parallel paths run on
    the card unless the caller names CPU devices)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the parallel paths run on the card unless the "
            "caller names the devices (e.g. devices=['cpu'] * 4)")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(num_devices: int = 0, devices=None, spatial: int = 1) -> Mesh:
    """A mesh over ``devices`` (default: every visible CUDA device), cut
    to the first ``num_devices`` when that is set. Asking for more
    devices than there are is an error that names both counts.

    ``spatial=1``: the 1-D data mesh. ``spatial=k > 1``: a
    ``(data, spatial)`` grid, devices filling the spatial axis first, so
    each row of ``k`` devices splits one image's height (the JAX
    package's order, which keeps a stripe group on adjacent devices)."""
    devices = cuda_devices() if devices is None else [
        torch.device(d) for d in devices]
    if num_devices:
        if num_devices > len(devices):
            raise ValueError(
                f"{num_devices} devices asked for, but only {len(devices)} "
                f"are available ({[str(d) for d in devices]})")
        devices = devices[:num_devices]
    if spatial < 1 or len(devices) % spatial:
        raise ValueError(
            f"spatial={spatial} does not divide the {len(devices)}-device "
            "mesh")
    return Mesh([devices[i:i + spatial]
                 for i in range(0, len(devices), spatial)])


def rank_devices(rank: int, spatial: int = 1,
                 devices=None) -> Tuple[torch.device, ...]:
    """The devices of data-parallel rank ``rank`` on its host: row
    ``rank`` (modulo the rows) of ``make_mesh(devices=devices,
    spatial=spatial)``, cut to whole rows. ``devices`` defaults to every
    visible card. The row's first device holds the rank's parameters and
    runs its collectives; the row is the ``spatial`` devices its images'
    height splits over (one device when ``spatial=1``). Pass
    ``devices=["cpu"] * spatial`` for a CPU rank."""
    devices = cuda_devices() if devices is None else list(devices)
    rows = len(devices) // spatial if spatial >= 1 else 0
    if not rows:
        raise ValueError(f"a rank of spatial={spatial} needs {spatial} "
                         f"devices, {len(devices)} are available")
    mesh = make_mesh(rows * spatial, devices=devices, spatial=spatial)
    return mesh.devices[rank % rows]


def infer_compute_dtype(state_dict) -> torch.dtype:
    """The activation dtype of a model given its ``state_dict``: bf16 when
    it holds int8 weights (``models/quant.py``), else its first floating
    dtype. Every entry is probed, as in the JAX package."""
    values = list(state_dict.values())
    if any(v.dtype == torch.int8 for v in values):
        return torch.bfloat16
    return next(v.dtype for v in values if v.is_floating_point())


def init_distributed(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    local_device_ids: Optional[Sequence[int]] = None,
    backend: Optional[str] = None,
) -> str:
    """Join a ``torch.distributed`` process group of ``num_processes``
    ranks as rank ``process_id``; ``coordinator_address`` is rank 0's
    ``host:port`` (a ``tcp://`` prefix is optional). Returns the backend.

    ``backend=None`` picks NCCL where a card is visible, else gloo; pass
    ``"gloo"`` for ranks that share one card (NCCL refuses two ranks on
    one device) or train on the CPU. With NCCL, the process's current
    CUDA device becomes ``local_device_ids[0]`` (the first card of its
    :func:`rank_devices`), or the rank modulo the visible count: every
    collective of the rank runs there. A collective that never completes
    (a dead peer) fails after :data:`COLLECTIVE_TIMEOUT`."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        ids = list(local_device_ids or [])
        torch.cuda.set_device(
            ids[0] if ids else process_id % torch.cuda.device_count())
    address = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
    dist.init_process_group(
        backend, init_method=address, world_size=num_processes,
        rank=process_id, timeout=COLLECTIVE_TIMEOUT)
    return backend


def process_index() -> int:
    """This process's rank, 0 outside a process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The process group's size, 1 outside one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def _flag_device() -> torch.device:
    """Where a collective's tensor must live for the default group's
    backend: the current card under NCCL, else the CPU."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce_flag(flag: bool) -> bool:
    """The OR of ``flag`` over every rank (a collective: every rank calls
    it at the same point); ``flag`` itself outside a process group."""
    if process_count() == 1:
        return bool(flag)
    value = torch.tensor([int(flag)], device=_flag_device())
    dist.all_reduce(value, op=dist.ReduceOp.MAX)
    return bool(value.item())


def broadcast_flag(flag: bool) -> bool:
    """Rank 0's ``flag`` on every rank (a collective)."""
    if process_count() == 1:
        return bool(flag)
    value = torch.tensor([int(flag)], device=_flag_device())
    dist.broadcast(value, src=0)
    return bool(value.item())


def shard_batch(batch, index: int, count: int):
    """Shard ``index`` of ``count`` equal slices of the leading axis of
    each array or tensor in ``batch`` (a tuple or list): one device's part
    of a sharded batch, or one rank's part of the global batch. A batch
    that does not split evenly raises ``ValueError``."""
    size = batch[0].shape[0]
    if size % count:
        raise ValueError(f"batch {size} not divisible by {count} shards")
    n = size // count
    return type(batch)(x[index * n:(index + 1) * n] for x in batch)


def zero1_optimizer(params, lr: float, weight_decay: float):
    """ZeRO-1: Adam (L2 added to the gradient, as
    ``training/train_step.py::make_optimizer``) whose state each rank
    holds for its part of the parameters only; every step all-gathers the
    updated parameters. A process group must be initialized.
    ``consolidate_state_dict`` (a collective) gathers the full state for
    a checkpoint, which a plain Adam loads, and the other way round."""
    from torch.distributed.optim import ZeroRedundancyOptimizer

    if not dist.is_initialized():
        raise RuntimeError("ZeRO-1 needs a process group "
                           "(parallel.init_distributed)")
    return ZeroRedundancyOptimizer(
        list(params), optimizer_class=torch.optim.Adam, lr=lr,
        weight_decay=weight_decay)
