"""Pre-decoded raw-array dataset cache: the multi-chip feeding answer.

The port's code-for-code copy of the JAX package's ``data/raw_cache.py``
(numpy only; ``tests/test_torch_shared.py`` holds the two equal).

Even with every transform moved on-device (data/device_aug.py), the host
still pays a PNG/JPEG decode per image. This module trades disk for CPU:
a one-time pass decodes the whole dataset into three memmapped arrays

    {prefix}_images.u8   [N, C, C, 3] uint8  (top-left-placed canvases)
    {prefix}_valid.i32   [N, 2]       int32  (h, w actually occupied)
    {prefix}_kpts.f32    [N, P, 18, 3] float32

plus a ``{prefix}_meta.json`` sidecar, after which a train epoch's
per-item host cost is a single page-in + memcpy (hundreds of MB/s per
core, thousands of img/s — measured in BENCH_INPUT.json). The reference
has no equivalent; it re-decodes and re-augments on 8 worker processes
every epoch (reference train.py:269-297).

Augmentation stays fully random per epoch because it happens on device
AFTER this cache (the cache stores pre-augmentation pixels).
"""

from __future__ import annotations

import json
import os
from typing import Tuple

import numpy as np

__all__ = ["build_raw_cache", "RawArrayDataset", "cache_exists"]


def build_raw_cache(dataset, prefix: str, progress: bool = False) -> str:
    """Decode every item of a ``target_mode="raw"`` CocoKeypoints into
    memmapped arrays under ``prefix``. Returns the meta-file path."""
    n = len(dataset)
    canvas, valid, kpts = dataset[0]
    c = canvas.shape[0]
    p = kpts.shape[0]
    images_mm = np.lib.format.open_memmap(
        f"{prefix}_images.npy", mode="w+", dtype=np.uint8,
        shape=(n, c, c, 3),
    )
    valid_mm = np.lib.format.open_memmap(
        f"{prefix}_valid.npy", mode="w+", dtype=np.int32, shape=(n, 2),
    )
    kpts_mm = np.lib.format.open_memmap(
        f"{prefix}_kpts.npy", mode="w+", dtype=np.float32,
        shape=(n, p, 18, 3),
    )
    for i in range(n):
        canvas, vhw, kp = dataset[i] if i else (canvas, valid, kpts)
        images_mm[i] = canvas
        valid_mm[i] = vhw
        kpts_mm[i] = kp
        if progress and (i + 1) % 200 == 0:
            print(f"raw cache: {i + 1}/{n}", flush=True)
    images_mm.flush()
    valid_mm.flush()
    kpts_mm.flush()
    meta_path = f"{prefix}_meta.json"
    with open(meta_path, "w") as f:
        json.dump({"n": n, "canvas": c, "max_people": p}, f)
    return meta_path


class RawArrayDataset:
    """Indexable view over a built raw cache; items match
    ``CocoKeypoints(target_mode="raw")``: (canvas u8, valid_hw i32,
    keypoints f32). Safe to hand to BatchLoader in any mode — worker
    processes re-open the memmaps lazily after pickling."""

    def __init__(self, prefix: str):
        self.prefix = prefix
        with open(f"{prefix}_meta.json") as f:
            self.meta = json.load(f)
        self._arrays = None

    def _open(self):
        if self._arrays is None:
            self._arrays = (
                np.load(f"{self.prefix}_images.npy", mmap_mode="r"),
                np.load(f"{self.prefix}_valid.npy", mmap_mode="r"),
                np.load(f"{self.prefix}_kpts.npy", mmap_mode="r"),
            )
        return self._arrays

    def __len__(self) -> int:
        return self.meta["n"]

    def __getitem__(
        self, index: int
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        images, valid, kpts = self._open()
        return (
            np.asarray(images[index]),
            np.asarray(valid[index]),
            np.asarray(kpts[index]),
        )

    def __getstate__(self):
        # drop open memmaps: worker processes re-open after unpickling
        return {"prefix": self.prefix, "meta": self.meta}

    def __setstate__(self, state):
        self.prefix = state["prefix"]
        self.meta = state["meta"]
        self._arrays = None

    def reseed(self, seed: int) -> None:
        """Augmentation happens on device; nothing to reseed here."""


def cache_exists(prefix: str) -> bool:
    try:
        with open(f"{prefix}_meta.json") as f:
            meta = json.load(f)
    except (OSError, json.JSONDecodeError):
        return False
    return all(
        os.path.exists(f"{prefix}_{name}.npy")
        for name in ("images", "valid", "kpts")
    ) and {"n", "canvas", "max_people"} <= set(meta)
