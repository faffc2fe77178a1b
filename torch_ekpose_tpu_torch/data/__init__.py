"""COCO-format data and the training input pipeline (counterpart of the
JAX package's ``data/``): the annotation index, the transforms, the
dataset and batch loader, the target rasterizers, the synthetic scenes,
and the ``raw`` target mode's decoded-image cache (``raw_cache``) and
on-device augmentation (``device_aug``)."""

from torch_ekpose_tpu_torch.data import transforms
from torch_ekpose_tpu_torch.data.coco import COCO
from torch_ekpose_tpu_torch.data.dataset import BatchLoader, CocoKeypoints
from torch_ekpose_tpu_torch.data.device_aug import (
    augment_batch,
    augment_core,
    make_augment_fn,
    sample_params,
)
from torch_ekpose_tpu_torch.data.raw_cache import (
    RawArrayDataset,
    build_raw_cache,
    cache_exists,
)
from torch_ekpose_tpu_torch.data.targets import (
    gen_targets_np,
    gen_targets_torch,
    make_batched_target_fn,
)

__all__ = [
    "COCO",
    "BatchLoader",
    "CocoKeypoints",
    "RawArrayDataset",
    "augment_batch",
    "augment_core",
    "build_raw_cache",
    "cache_exists",
    "gen_targets_np",
    "gen_targets_torch",
    "make_augment_fn",
    "make_batched_target_fn",
    "sample_params",
    "transforms",
]
