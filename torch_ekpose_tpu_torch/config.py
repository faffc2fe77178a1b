"""Unified configuration.

The reference splits configuration across three tiers that silently
duplicate each other: per-script argparse (reference train.py:33-56),
a yacs singleton (reference lib/config/default.py:10-24), and hard-coded
C++ constants (reference lib/pafprocess/pafprocess.h:6-13). This module
replaces all three with one dataclass tree that can be loaded from /
merged with YAML or CLI flags.

The ``cfg`` module-level default mirrors the reference's
``from lib.config import cfg`` usage (reference lib/config/__init__.py:1),
and the ``MODEL`` / ``TEST`` sub-namespaces keep the field names the
reference exposes (``cfg.MODEL.NUM_KEYPOINTS``, ``cfg.MODEL.DOWNSAMPLE``,
``cfg.TEST.THRESH_HEATMAP``, ...), so downstream code reads the same way.

The port's own copy of the JAX package's ``config.py``, built on the
port's ``constants``; ``tests/test_torch_shared.py`` holds the default
fields equal to the original's.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from torch_ekpose_tpu_torch import constants


@dataclasses.dataclass
class ModelConfig:
    """Model-family constants (reference lib/config/default.py:14-18)."""

    NUM_KEYPOINTS: int = constants.NUM_KEYPOINTS
    DOWNSAMPLE: int = constants.DOWNSAMPLE
    #: Inference compute dtype. TPU-native choice: bfloat16 feeds the MXU at
    #: full rate; parameters are kept in float32 and cast at use.
    compute_dtype: str = "bfloat16"


@dataclasses.dataclass
class TestConfig:
    """Decode thresholds (reference lib/config/default.py:21-24 merged with
    lib/pafprocess/pafprocess.h:6-13)."""

    THRESH_HEATMAP: float = constants.THRESH_HEATMAP
    THRESH_PAF: float = constants.THRESH_VECTOR_SCORE
    NUM_INTERMED_PTS_BETWEEN_KEYPOINTS: int = constants.STEP_PAF
    THRESH_VECTOR_CNT1: int = constants.THRESH_VECTOR_CNT1
    THRESH_PART_CNT: int = constants.THRESH_PART_CNT
    THRESH_HUMAN_SCORE: float = constants.THRESH_HUMAN_SCORE


@dataclasses.dataclass
class DecodeConfig:
    """Static capacities for the fixed-shape on-device decoder.

    XLA requires static shapes, so the device decoder works with padded,
    masked tensors. These bounds were chosen so that COCO val images never
    hit them (the busiest COCO images have < 30 peaks of any single part).
    """

    #: Max peaks retained per keypoint channel after NMS.
    max_peaks_per_part: int = 32
    #: Max accepted connections per limb pair.
    max_connections: int = 32
    #: Max assembled people per image.
    max_people: int = 32


@dataclasses.dataclass
class TrainConfig:
    """Training hyperparameters (reference train.py:33-56 argparse defaults
    and train.py:177-184 optimizer construction)."""

    model: str = "vgg2016"
    batch_size: int = 128
    epochs: int = 300
    lr: float = 1e-4
    weight_decay: float = 5e-4
    #: ReduceLROnPlateau settings (reference train.py:184).
    lr_factor: float = 0.8
    lr_patience: int = 5
    #: Optional frozen-backbone warmup epochs when starting from ImageNet
    #: weights (reference train.py:130-166).
    warmup_epochs: int = 5
    #: Square crop size for training (reference train.py:40 --square_size).
    square_size: int = 368
    #: Checkpoint cadence in epochs (reference train.py:44 --save_epoch).
    save_epoch: int = 20
    seed: int = 0
    #: Data-parallel mesh axis size; 0 = use all visible devices.
    num_devices: int = 0
    #: Host-side dataloader worker threads (reference train.py:41 --workers).
    workers: int = 8


@dataclasses.dataclass
class Config:
    MODEL: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    TEST: TestConfig = dataclasses.field(default_factory=TestConfig)
    DECODE: DecodeConfig = dataclasses.field(default_factory=DecodeConfig)
    TRAIN: TrainConfig = dataclasses.field(default_factory=TrainConfig)

    def replace(self, **kwargs: Any) -> "Config":
        return dataclasses.replace(self, **kwargs)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        def build(field_cls, sub):
            known = {f.name for f in dataclasses.fields(field_cls)}
            unknown = set(sub) - known
            if unknown:
                raise ValueError(
                    f"Unknown {field_cls.__name__} config keys: {sorted(unknown)}"
                )
            return field_cls(**sub)

        return cls(
            MODEL=build(ModelConfig, d.get("MODEL", {})),
            TEST=build(TestConfig, d.get("TEST", {})),
            DECODE=build(DecodeConfig, d.get("DECODE", {})),
            TRAIN=build(TrainConfig, d.get("TRAIN", {})),
        )

    @classmethod
    def from_yaml(cls, path: str) -> "Config":
        import yaml

        with open(path) as f:
            return cls.from_dict(yaml.safe_load(f) or {})


def get_default_config() -> Config:
    return Config()


#: Module-level default, analogous to the reference's yacs singleton
#: (reference lib/config/__init__.py:1). Treat as read-only; make a copy
#: via ``get_default_config()`` to customize.
cfg = get_default_config()
