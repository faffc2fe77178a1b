"""COCO keypoint training dataset + a threaded or multi-process
prefetching batch loader.

Equivalent of the reference dataset stack (reference
lib/datasets/datasets.py:91-286 ``CocoKeypoints``; the DataLoader built at
reference train.py:253-299). Besides the reference-style host-rasterized
targets, the dataset can emit padded keypoint tensors so the heatmap/PAF
rasterization runs on the card
(:func:`torch_ekpose_tpu_torch.data.targets.gen_targets_torch`), removing
the reference's hottest CPU loop from the input pipeline. Items and
batches are numpy arrays (NHWC images); the trainer uploads them.

The loader's worker processes are spawned, not forked: the training
process has CUDA initialized, and a forked child that touches it dies.

The port's own copy of the JAX package's ``data/dataset.py``, code for
code (``tests/test_torch_shared.py`` holds the syntax trees equal); the
``raw`` mode's modules it names (``device_aug``, ``raw_cache``) are the
port's own ``data/device_aug.py`` and ``data/raw_cache.py``.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Iterator, List, Optional, Tuple

import numpy as np
import PIL.Image

from torch_ekpose_tpu_torch import constants
from torch_ekpose_tpu_torch.data import transforms as T
from torch_ekpose_tpu_torch.data.coco import COCO
from torch_ekpose_tpu_torch.data.targets import gen_targets_np

__all__ = [
    "CocoKeypoints", "BatchLoader", "ImageList", "PilImageList",
    "collate_images_anns_meta", "collate_images_targets_meta",
]


class CocoKeypoints:
    """Indexable dataset of (image, targets-or-keypoints) samples.

    ``target_mode``:
      - ``"host"``   -> items are (image [S,S,3] f32, heatmaps [g,g,19],
        pafs [g,g,38]) with host rasterization, like the reference;
      - ``"device"`` -> items are (image [S,S,3] f32,
        keypoints [max_people, 18, 3] f32) for on-device rasterization.
      - ``"raw"``    -> items are (canvas [C,C,3] uint8 RGB,
        valid_hw [2] int32, keypoints [max_people, 18, 3] f32) with NO
        host augmentation at all: decode, aspect-preserving downscale to
        fit the ``raw_canvas`` square if needed, top-left placement.
        Augmentation, normalization, and targets all happen on device
        (:mod:`torch_ekpose_tpu_torch.data.device_aug`); the host cost per item
        is one file decode + one memcpy. See also
        :mod:`torch_ekpose_tpu_torch.data.raw_cache` for skipping the decode.
    """

    def __init__(
        self,
        root: str,
        ann_file: str,
        preprocess: Optional[T.Preprocess] = None,
        image_transform=None,
        target_mode: str = "host",
        input_size: int = 368,
        stride: int = constants.DOWNSAMPLE,
        max_people: int = 32,
        n_images: Optional[int] = None,
        all_images: bool = False,
        seed: int = 0,
        raw_canvas: int = 432,
    ):
        self.root = root
        self.coco = COCO(ann_file)
        self.cat_ids = self.coco.getCatIds(catNms=["person"]) or [1]
        if all_images:
            self.ids = self.coco.getImgIds()
        else:
            self.ids = self._filter_for_keypoints(
                self.coco.getImgIds(catIds=self.cat_ids)
            )
        if n_images:
            self.ids = self.ids[:n_images]
        self.preprocess = preprocess or T.Normalize()
        self.image_transform = image_transform or T.image_transform
        self.target_mode = target_mode
        self.input_size = input_size
        self.stride = stride
        self.max_people = max_people
        self._seed = seed
        self.raw_canvas = raw_canvas

    def _filter_for_keypoints(self, ids: List[int]) -> List[int]:
        """Keep images with at least one labeled keypoint
        (reference datasets.py:126-139)."""
        keep = []
        for img_id in ids:
            anns = self.coco.loadAnns(
                self.coco.getAnnIds(imgIds=img_id, catIds=self.cat_ids)
            )
            if any(
                "keypoints" in a and any(v > 0 for v in a["keypoints"][2::3])
                for a in anns
            ):
                keep.append(img_id)
        return keep

    def __len__(self) -> int:
        return len(self.ids)

    def _keypoints18(self, anns, width=None, height=None) -> np.ndarray:
        """Annotations -> [P, 18, 3] internal keypoints with the neck
        synthesized and out-of-frame joints nulled
        (reference datasets.py:199-248)."""
        people = []
        for ann in anns:
            kp17 = np.asarray(ann["keypoints"], dtype=np.float64).reshape(
                17, 3
            )
            people.append(constants.coco_to_internal_keypoints(kp17))
        if not people:
            return np.zeros((0, 18, 3))
        kpts = np.stack(people)
        w = self.input_size if width is None else width
        h = self.input_size if height is None else height
        out = (
            (kpts[:, :, 0] >= w) | (kpts[:, :, 0] < 0)
            | (kpts[:, :, 1] >= h) | (kpts[:, :, 1] < 0)
        )
        kpts[out] = (-1.0, -1.0, 0.0)
        return kpts

    def _pad_people(self, kpts: np.ndarray) -> np.ndarray:
        """Keep labeled people, truncate/pad to ``max_people`` rows."""
        if len(kpts):
            kpts = kpts[(kpts[:, :, 2] > 0).any(axis=1)]
        padded = np.zeros((self.max_people, 18, 3), dtype=np.float32)
        n = min(len(kpts), self.max_people)
        padded[:n] = kpts[:n]
        return padded

    def _raw_item(self, image, anns):
        """target_mode="raw": decode-only item for the device-augmentation
        path — (canvas [C,C,3] uint8 RGB, valid_hw [2] int32,
        keypoints [max_people, 18, 3])."""
        w, h = image.size
        c = self.raw_canvas
        kpts = self._keypoints18(anns, width=w, height=h)
        scale = 1.0
        if max(w, h) > c:
            scale = c / max(w, h)
            new_w = max(1, round(w * scale))
            new_h = max(1, round(h * scale))
            image = image.resize((new_w, new_h), PIL.Image.BILINEAR)
            if len(kpts):
                kpts = kpts.copy()
                kpts[:, :, 0] *= new_w / w
                kpts[:, :, 1] *= new_h / h
            w, h = new_w, new_h
        arr = np.asarray(image, dtype=np.uint8)
        canvas = np.zeros((c, c, 3), dtype=np.uint8)
        canvas[:h, :w] = arr
        return (
            canvas,
            np.asarray([h, w], dtype=np.int32),
            self._pad_people(kpts),
        )

    def __getitem__(self, index: int):
        rng = np.random.default_rng(
            np.random.SeedSequence([self._seed, index])
        )
        img_id = self.ids[index]
        anns = self.coco.loadAnns(
            self.coco.getAnnIds(imgIds=img_id, catIds=self.cat_ids)
        )
        info = self.coco.loadImgs(img_id)[0]
        with open(os.path.join(self.root, info["file_name"]), "rb") as f:
            image = PIL.Image.open(f).convert("RGB")

        if self.target_mode == "raw":
            return self._raw_item(image, anns)

        image, anns, meta = self.preprocess(image, anns, None, rng)
        image = self.image_transform(image, rng)
        image = T.mask_valid_area(image, meta["valid_area"])

        kpts = self._keypoints18(anns)
        if self.target_mode == "device":
            # _pad_people keeps only people with at least one labeled
            # joint before truncating to capacity — otherwise crowd
            # images can fill every padded slot with empty rows and
            # silently drop the labeled people host mode would rasterize
            return image.astype(np.float32), self._pad_people(kpts)

        grid = self.input_size // self.stride
        heatmaps, pafs = gen_targets_np(
            kpts if len(kpts) else np.zeros((1, 18, 3)),
            grid, grid, self.stride, constants.TARGET_SIGMA,
        )
        return image.astype(np.float32), heatmaps, pafs

    def reseed(self, seed: int) -> None:
        """Change the augmentation seed (call once per epoch)."""
        self._seed = seed


class ImageList:
    """Inference dataset over image paths (reference datasets.py:289-309):
    items are (path, original_image HWC float [0,1], transformed image)."""

    def __init__(self, image_paths, preprocess=None, image_transform=None):
        self.image_paths = list(image_paths)
        self.preprocess = preprocess
        self.image_transform = image_transform or T.image_transform

    def __getitem__(self, index: int):
        path = self.image_paths[index]
        with open(path, "rb") as f:
            image = PIL.Image.open(f).convert("RGB")
        if self.preprocess is not None:
            image = self.preprocess(image, [], None)[0]
        original = np.asarray(image, dtype=np.float32) / 255.0
        return path, original, self.image_transform(image)

    def __len__(self) -> int:
        return len(self.image_paths)


class PilImageList:
    """Inference dataset over in-memory PIL images
    (reference datasets.py:312-325)."""

    def __init__(self, images, image_transform=None):
        self.images = list(images)
        self.image_transform = image_transform or T.image_transform

    def __getitem__(self, index: int):
        pil = self.images[index].copy().convert("RGB")
        original = np.asarray(pil, dtype=np.float32) / 255.0
        return index, original, self.image_transform(pil)

    def __len__(self) -> int:
        return len(self.images)


def collate_images_anns_meta(batch):
    """(stacked images, ann lists, meta lists)
    (reference datasets.py:64-68)."""
    images = np.stack([b[0] for b in batch])
    anns = [b[1] for b in batch]
    metas = [b[2] for b in batch]
    return images, anns, metas


def collate_images_targets_meta(batch):
    """(stacked images, stacked heatmaps, stacked pafs)
    (reference datasets.py:82-88)."""
    return tuple(np.stack([b[i] for b in batch]) for i in range(3))


def _stack_items(dataset, idxs) -> Tuple[np.ndarray, ...]:
    items = [dataset[int(i)] for i in idxs]
    return tuple(
        np.stack([it[f] for it in items]) for f in range(len(items[0]))
    )


def _process_worker(dataset, todo, done) -> None:
    """Loop of a spawned loader worker: tasks are
    (epoch_key, seed, batch_index, indices); ``None`` shuts down. The
    per-item pipeline is deterministic given (seed, index), so workers
    reproduce exactly what the in-process pipeline would have built."""
    import traceback

    while True:
        task = todo.get()
        if task is None:
            return
        epoch_key, seed, bi, idxs = task
        try:
            if seed is not None and hasattr(dataset, "reseed"):
                dataset.reseed(seed)
            done.put((epoch_key, bi, _stack_items(dataset, idxs)))
        except Exception:  # noqa: BLE001 - crossing a process boundary
            done.put((
                epoch_key, bi,
                RuntimeError(traceback.format_exc()),
            ))


class BatchLoader:
    """Prefetching batch iterator over an indexable dataset — the
    equivalent of the reference's torch DataLoader(num_workers=8,
    pin_memory) (reference train.py:269-276) without the torch dependency.

    ``mode="thread"``: worker threads run the (numpy/PIL, partially
    GIL-releasing) pipeline — cheap, fine for small runs. ``mode=
    "process"``: spawned worker processes, like torch's DataLoader —
    the per-item pipeline holds the GIL for much of its work, so only
    processes scale it across cores, and feeding a multi-chip training
    run needs that. Workers persist across epochs; per-epoch
    augmentation seeds ride along with each task, so the two modes
    produce byte-identical batches (tested).
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        num_workers: int = 4,
        drop_last: bool = True,
        seed: int = 0,
        prefetch: int = 4,
        mode: str = "thread",
        shard: Tuple[int, int] = (0, 1),
    ):
        if mode not in ("thread", "process"):
            raise ValueError(f"unknown loader mode {mode!r}")
        if not (0 <= shard[0] < shard[1]):
            raise ValueError(f"invalid shard {shard!r}")
        if num_workers < 0:
            raise ValueError(f"num_workers must be >= 0, got {num_workers}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        # 0 = load synchronously in the calling process (torch DataLoader
        # semantics); neither worker pool is ever started then
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch
        self.mode = mode
        self.shard = tuple(shard)
        self._epoch = 0
        self._pool = None

    def _ensure_pool(self):
        if self._pool is not None:
            return
        import multiprocessing as mp

        # spawn, not fork: the parent usually has CUDA initialized, and a
        # forked child that touches it dies
        ctx = mp.get_context("spawn")
        self._todo = ctx.Queue()
        self._done = ctx.Queue(maxsize=max(self.prefetch, 1))
        self._pool = [
            ctx.Process(
                target=_process_worker,
                args=(self.dataset, self._todo, self._done),
                daemon=True,
            )
            for _ in range(self.num_workers)
        ]
        for p in self._pool:
            p.start()

    def close(self) -> None:
        """Stop process workers (daemonic, so they also die with the
        parent; call this to release them earlier)."""
        if self._pool is None:
            return
        for _ in self._pool:
            self._todo.put(None)
        for p in self._pool:
            p.join(timeout=5)
            if p.is_alive():
                p.terminate()
        self._pool = None

    def __len__(self) -> int:
        n = len(self.dataset) // self.shard[1]   # equal-length shards
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Tuple[np.ndarray, ...]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(
                np.random.SeedSequence([self.seed, self._epoch])
            ).shuffle(order)
        if self.shard != (0, 1):
            # multi-host: same shuffle seed everywhere, disjoint strided
            # shards per process, truncated to equal length — unequal
            # batch counts would deadlock the collective train step
            # (torch DistributedSampler semantics)
            order = order[self.shard[0]::self.shard[1]]
            order = order[: len(self.dataset) // self.shard[1]]
        self._epoch += 1

        batches = [
            order[i: i + self.batch_size]
            for i in range(0, len(order), self.batch_size)
        ]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]

        if self.num_workers == 0:
            # synchronous in-process loading, either mode
            for idxs in batches:
                yield _stack_items(self.dataset, idxs)
            return

        if self.mode == "process":
            yield from self._iter_process(batches)
            return

        todo: "queue.Queue" = queue.Queue()
        done: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        for bi, idxs in enumerate(batches):
            todo.put((bi, idxs))
        results = {}
        lock = threading.Lock()

        def worker():
            while True:
                try:
                    bi, idxs = todo.get_nowait()
                except queue.Empty:
                    return
                try:
                    stacked = _stack_items(self.dataset, idxs)
                except Exception as e:  # noqa: BLE001
                    # a corrupt sample must fail the consumer, not
                    # silently hang it on done.get() forever
                    with lock:
                        results[bi] = e
                    done.put(bi)
                    continue
                with lock:
                    results[bi] = stacked
                done.put(bi)

        threads = [
            threading.Thread(target=worker, daemon=True)
            for _ in range(self.num_workers)
        ]
        for t in threads:
            t.start()

        # emit batches in order for reproducibility
        next_bi = 0
        received = set()
        while next_bi < len(batches):
            bi = done.get()
            received.add(bi)
            while next_bi in received:
                with lock:
                    out = results.pop(next_bi)
                if isinstance(out, Exception):
                    raise RuntimeError(
                        f"loader worker failed on batch {next_bi}"
                    ) from out
                yield out
                next_bi += 1

    def _iter_process(self, batches):
        self._ensure_pool()
        epoch_key = self._epoch          # already advanced by __iter__
        seed = getattr(self.dataset, "_seed", None)
        for bi, idxs in enumerate(batches):
            self._todo.put((epoch_key, seed, bi, [int(i) for i in idxs]))
        results = {}
        next_bi = 0
        while next_bi < len(batches):
            try:
                got_epoch, bi, out = self._done.get(timeout=5.0)
            except queue.Empty:
                # liveness: a worker killed hard (OOM, native crash)
                # never enqueues its result — fail instead of hanging
                dead = [p for p in self._pool if not p.is_alive()]
                if dead:
                    raise RuntimeError(
                        f"{len(dead)} loader worker(s) died "
                        f"(exitcode {dead[0].exitcode})"
                    )
                continue
            if got_epoch != epoch_key:
                # stale result from an epoch abandoned mid-iteration
                # (e.g. training preempted): drop it
                continue
            results[bi] = out
            while next_bi in results:
                out = results.pop(next_bi)
                if isinstance(out, Exception):
                    raise RuntimeError(
                        f"loader worker failed on batch {next_bi}"
                    ) from out
                yield out
                next_bi += 1
