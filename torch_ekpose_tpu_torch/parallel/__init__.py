"""The parallel layer (counterpart of the JAX package's ``parallel/``):
device meshes, process groups and ZeRO-1 (``mesh.py``), batch-sharded
inference over several devices (``inference.py``) and height-split
inference and training (``spatial.py``)."""

from torch_ekpose_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    SPATIAL_AXIS,
    Mesh,
    infer_compute_dtype,
    init_distributed,
    make_mesh,
    process_count,
    process_index,
    rank_devices,
    shard_batch,
    zero1_optimizer,
)

__all__ = [
    "DATA_AXIS",
    "SPATIAL_AXIS",
    "Mesh",
    "ShardedPoseEstimator",
    "SpatialPoseEstimator",
    "infer_compute_dtype",
    "init_distributed",
    "make_mesh",
    "process_count",
    "process_index",
    "rank_devices",
    "shard_batch",
    "zero1_optimizer",
]


def __getattr__(name):
    # lazy: the estimators pull in the decode stack
    if name == "ShardedPoseEstimator":
        from torch_ekpose_tpu_torch.parallel.inference import (
            ShardedPoseEstimator)

        return ShardedPoseEstimator
    if name == "SpatialPoseEstimator":
        from torch_ekpose_tpu_torch.parallel.spatial import (
            SpatialPoseEstimator)

        return SpatialPoseEstimator
    raise AttributeError(name)
