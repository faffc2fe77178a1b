"""Batch-sharded inference over several devices in one process.

Counterpart of the JAX package's ``parallel/inference.py``. The JAX
package shards the batch axis of one SPMD program over a data mesh; here
one process keeps a replica of the cast model on each device of the mesh
(one per distinct device: a device named twice serves two shards in
turn), sends shard ``i`` of the batch to device ``i``, and each device
runs the forward and the batched device decode on its own shard with the
hand kernels (``csrc/{nms,match,merge}.cu``; each wrapper enters the
tensor's device before it launches). The JAX package had to give up its
Pallas kernels on a mesh larger than one device; the port does not.
Every device's packed result is copied to pinned host memory behind its
own work, and the host waits for all of them only in
:meth:`ShardedPoseEstimator.collect_batch`.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional

import numpy as np
import torch

from torch_ekpose_tpu_torch.config import Config
from torch_ekpose_tpu_torch.parallel.mesh import make_mesh, shard_batch
from torch_ekpose_tpu_torch.utils.human import Human

__all__ = ["ShardedPoseEstimator"]


def _on(device: torch.device):
    """The device's context where it is a card (its current stream is
    the one the shard's work and copy queue on)."""
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


class ShardedPoseEstimator:
    """Mesh-sharded batched pose inference.

    ``estimate_batch(images)`` has ``PoseEstimator.estimate_batch``'s
    contract ([B, H, W, 3] same-shape padded BGR frames ->
    List[List[Human]]) but splits the batch over every device of the
    mesh. ``B`` must be a multiple of the mesh size (pad the last batch
    by repeating a frame, as the bucketed eval loop does). The model's
    arguments and dtypes (int8 included) are ``PoseEstimator``'s; the
    device decode always runs (``decode_backend`` is ``"device"``).
    """

    #: each device decodes its own shard; the bucketed eval loop keys its
    #: pipelined dispatch off this
    decode_backend = "device"

    def __init__(self, model_name: str = "vgg2016",
                 state_dict: Optional[dict] = None,
                 config: Optional[Config] = None, *, mesh=None,
                 compute_dtype=torch.bfloat16, precision: str = "fast",
                 preprocess: str = "vgg", dest_size: int = 368,
                 s2d_blocks: int = 0, seed: int = 0):
        from torch_ekpose_tpu_torch.runtime.estimator import PoseEstimator

        self.mesh = mesh if mesh is not None else make_mesh()
        self.devices = self.mesh.flat
        options = dict(config=config, compute_dtype=compute_dtype,
                       precision=precision, preprocess=preprocess,
                       dest_size=dest_size, decode_backend="device",
                       s2d_blocks=s2d_blocks, seed=seed)
        #: one estimator per distinct device, the first one's model the
        #: one calibrated (static int8) and copied to the others
        self._replicas = {}
        for device in dict.fromkeys(self.devices):
            self._replicas[device] = PoseEstimator(
                model_name, state_dict, device=device, **options)
        self._primary = self._replicas[self.devices[0]]
        self.config = self._primary.config
        self.dest_size = dest_size
        self.preprocess = preprocess
        self.precision = precision
        self.compute_dtype = compute_dtype

    @property
    def num_devices(self) -> int:
        return self.mesh.size

    def calibrate(self, image_batches) -> None:
        """Static int8 scales (``int8_static``) measured on one device
        over ``image_batches``, then copied to every replica, so each
        shard serves the scales one ``PoseEstimator`` would."""
        image_batches = list(image_batches)
        self._primary.calibrate(image_batches)
        state = self._primary.model.state_dict()
        for replica in self._replicas.values():
            if replica is not self._primary:
                replica.model.load_state_dict(state)
                replica._needs_calib = False

    def estimate_batch_async(self, images: np.ndarray):
        """Dispatch every shard's forward, decode and device->host copy
        without waiting; the handle goes to :meth:`collect_batch`."""
        b, n = images.shape[0], self.mesh.size
        if b % n:
            raise ValueError(f"batch {b} not divisible by mesh size {n}")
        if self._primary._needs_calib:
            self.calibrate([images])
        shards = []
        for i, device in enumerate(self.devices):
            (part,) = shard_batch((images,), i, n)
            with _on(device):
                shards.append(self._replicas[device].estimate_batch_async(
                    part))
        return shards

    def collect_batch(self, handle) -> List[List[Human]]:
        """Wait for every shard of a dispatched batch and convert the
        packed buffers to Humans, in batch order."""
        humans = []
        for shard in handle:
            humans += self._primary.collect_batch(shard)
        return humans

    def estimate_batch(self, images: np.ndarray) -> List[List[Human]]:
        return self.collect_batch(self.estimate_batch_async(images))
