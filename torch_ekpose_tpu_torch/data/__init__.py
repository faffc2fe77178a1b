"""COCO-format data and the training input pipeline (counterpart of the
JAX package's ``data/``): the annotation index, the transforms, the
dataset and batch loader, the target rasterizers and the synthetic
scenes. The ``raw`` target mode's device augmentation and decoded-image
cache (``device_aug``, ``raw_cache``) are not ported yet (ROADMAP Queue 1
item 5b)."""

from torch_ekpose_tpu_torch.data import transforms
from torch_ekpose_tpu_torch.data.coco import COCO
from torch_ekpose_tpu_torch.data.dataset import BatchLoader, CocoKeypoints
from torch_ekpose_tpu_torch.data.targets import (
    gen_targets_np,
    gen_targets_torch,
    make_batched_target_fn,
)

__all__ = [
    "COCO",
    "BatchLoader",
    "CocoKeypoints",
    "gen_targets_np",
    "gen_targets_torch",
    "make_batched_target_fn",
    "transforms",
]
