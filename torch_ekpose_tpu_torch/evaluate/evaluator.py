"""COCO validation loop: image -> estimator -> decode -> result rows -> AP.

Counterpart of the JAX package's ``evaluate/evaluator.py`` (reference
eval.py:93-170: ``append_result`` coordinate remapping via ORDER_COCO,
``run_eval`` per-image loop, ``eval_coco`` protocol driver), with the same
functions and three differences:

- the device decode is named ``"device"`` (``"jax"`` is its alias, as in
  ``decode/api.py``); with it, every batch size takes the estimator's
  ``estimate_batch_async`` / ``collect_batch``, the decode on the card;
- ``_decode`` decodes already-fetched maps on the host, so it maps
  ``"device"`` to ``"auto"``;
- with neither cv2 nor Pillow installed, reading or writing an image
  raises one ``ImportError`` that names both.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np

from torch_ekpose_tpu_torch import constants
from torch_ekpose_tpu_torch.data.coco import COCO
from torch_ekpose_tpu_torch.evaluate.cocoeval import COCOKeypointEval
from torch_ekpose_tpu_torch.utils.human import Human, draw_humans

__all__ = ["append_result", "eval_coco", "run_eval", "read_image_bgr"]

#: the names of the device decode (``decode/api.py``'s, and its alias)
DEVICE_BACKENDS = ("device", "jax")


def _pillow(path: str):
    """Pillow's ``Image``, or one clear error where it is missing too."""
    try:
        from PIL import Image
    except ImportError:
        raise ImportError(f"{path}: reading and writing images needs cv2 or "
                          "Pillow, and neither is installed") from None
    return Image


def read_image_bgr(
    path: str, width: Optional[int] = None, height: Optional[int] = None
) -> np.ndarray:
    """Read an image as HWC uint8 BGR (cv2 convention; PIL fallback), with
    the optional resize of the reference's ``read_imgfile``
    (reference lib/config/utils.py:17-21)."""
    try:
        import cv2

        img = cv2.imread(path)
        if img is None:
            raise FileNotFoundError(path)
        if width is not None and height is not None:
            img = cv2.resize(img, (width, height))
        return img
    except ImportError:
        Image = _pillow(path)

        with open(path, "rb") as f:
            pil = Image.open(f).convert("RGB")
            if width is not None and height is not None:
                pil = pil.resize((width, height))
            rgb = np.asarray(pil)
        return rgb[:, :, ::-1].copy()


def append_result(
    image_id: int,
    humans: List[Human],
    upsample_keypoints,
    outputs: List[dict],
) -> None:
    """Convert Humans to COCO result rows (reference eval.py:93-125):
    coordinates scale by the upsampled-map-over-image ratio with a +0.5
    shift, keypoints reorder via ORDER_COCO, detection score is 1.0."""
    for human in humans:
        keypoints = np.zeros((18, 3))
        for i in range(18):
            if i in human.body_parts:
                part = human.body_parts[i]
                keypoints[i, 0] = part.x * upsample_keypoints[1] + 0.5
                keypoints[i, 1] = part.y * upsample_keypoints[0] + 0.5
                keypoints[i, 2] = 1
        keypoints = keypoints[list(constants.ORDER_COCO), :]
        outputs.append({
            "image_id": image_id,
            "category_id": 1,
            "keypoints": [float(v) for v in keypoints.reshape(51)],
            "score": 1.0,
        })


def eval_coco(
    outputs: List[dict],
    anno_file: str,
    img_ids: List[int],
    results_json: Optional[str] = None,
) -> float:
    """Score result rows against the annotation file; returns AP@OKS
    (reference eval.py:73-90)."""
    coco_gt = COCO(anno_file)
    if results_json:
        os.makedirs(
            os.path.dirname(os.path.abspath(results_json)), exist_ok=True
        )
        with open(results_json, "w") as f:
            json.dump(outputs, f)
    coco_dt = coco_gt.loadRes(outputs)
    ev = COCOKeypointEval(coco_gt, coco_dt)
    ev.params.imgIds = img_ids
    ev.evaluate()
    ev.accumulate()
    ev.summarize()
    return float(ev.stats[0])


def _on_device(estimator) -> bool:
    return getattr(estimator, "decode_backend", "") in DEVICE_BACKENDS


def run_eval(
    image_dir: str,
    anno_file: str,
    estimator,
    mode: str = "val",
    vis_dir: Optional[str] = None,
    save_every: int = 0,
    results_json: Optional[str] = None,
    n_images: Optional[int] = None,
    progress: bool = True,
    batch_size: int = 1,
) -> float:
    """Evaluate an estimator over a COCO-format dataset
    (reference eval.py:129-170).

    ``batch_size > 1`` buckets images by padded shape and batches the
    forward pass per bucket. Result rows are identical either way.
    """
    coco = COCO(anno_file)
    if mode == "val":
        cat_ids = coco.getCatIds(catNms=["person"])
        img_ids = coco.getImgIds(catIds=cat_ids)
    else:
        img_ids = coco.getImgIds()
    if n_images:
        img_ids = img_ids[:n_images]

    iterator = img_ids
    if progress:
        try:
            from tqdm import tqdm

            iterator = tqdm(img_ids)
        except ImportError:
            pass

    stride = estimator.config.MODEL.DOWNSAMPLE
    outputs: List[dict] = []
    # the device decode is batched (fixed-shape packed results, the copy
    # back enqueued behind it); batch_size=1 rides the same path so the
    # decode on the card is never silently skipped (the host-map branch
    # below would remap "device" to a host decode)
    if batch_size <= 1 and _on_device(estimator):
        _run_eval_batched(
            image_dir, coco, img_ids, estimator, iterator, stride, 1,
            outputs, vis_dir=vis_dir if save_every else None,
            save_every=save_every,
        )
        return eval_coco(outputs, anno_file, img_ids, results_json)
    if batch_size <= 1:
        for i, img_id in enumerate(iterator):
            info = coco.loadImgs(img_id)[0]
            image = read_image_bgr(
                os.path.join(image_dir, info["file_name"])
            )
            pafs, heatmaps, scale = estimator.get_outputs(image)
            humans = _decode(estimator, heatmaps, pafs)
            if vis_dir and save_every and i % save_every == 0:
                os.makedirs(vis_dir, exist_ok=True)
                out = draw_humans(image, humans)
                _write_image(os.path.join(vis_dir, info["file_name"]), out)
            upsample = (
                heatmaps.shape[0] * stride / scale,
                heatmaps.shape[1] * stride / scale,
            )
            append_result(img_id, humans, upsample, outputs)
        return eval_coco(outputs, anno_file, img_ids, results_json)

    _run_eval_batched(
        image_dir, coco, img_ids, estimator, iterator, stride, batch_size,
        outputs, vis_dir=vis_dir, save_every=save_every,
    )
    return eval_coco(outputs, anno_file, img_ids, results_json)


def _decode(estimator, heatmaps, pafs) -> List[Human]:
    from torch_ekpose_tpu_torch.decode.api import paf_to_pose

    backend = estimator.decode_backend
    if backend in DEVICE_BACKENDS:
        backend = "auto"  # host decode of already-fetched maps
    return paf_to_pose(heatmaps, pafs, estimator.config, backend=backend)


def _prefetch_read(iterator, image_dir, coco, dest_size, stride, depth):
    """Yield ``(seq, img_id, image, im_pad, scale)`` with a background
    thread keeping up to ``depth`` images decoded + padded ahead.

    cv2's PNG/JPEG decode releases the GIL, so the file reads overlap the
    main thread's waits on the device (the forward, the copy back)
    instead of serializing with them. Order is preserved (single reader
    thread, FIFO queue), so result rows are identical to the synchronous
    read.

    A tqdm-wrapped ``iterator`` is unwrapped: the reader thread consumes
    the raw id list and the bar ticks here in the consumer as items are
    actually yielded — otherwise the bar would run ``depth`` images
    ahead of real progress and update from off the main thread.
    """
    import queue
    import threading

    from torch_ekpose_tpu_torch.runtime.estimator import padding

    bar = None
    if hasattr(iterator, "iterable") and hasattr(iterator, "update"):
        bar, iterator = iterator, iterator.iterable

    q: "queue.Queue" = queue.Queue(maxsize=max(2, depth))
    stop = threading.Event()
    _END = object()

    def reader():
        try:
            for seq, img_id in enumerate(iterator):
                info = coco.loadImgs(img_id)[0]
                image = read_image_bgr(
                    os.path.join(image_dir, info["file_name"])
                )
                im_pad, scale, _ = padding(image, dest_size, stride)
                item = (seq, img_id, image, im_pad, scale)
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # propagate to the consumer
            while not stop.is_set():
                try:
                    q.put((_END, e), timeout=0.1)
                    break
                except queue.Full:
                    continue
            return
        while not stop.is_set():
            try:
                q.put((_END, None), timeout=0.1)
                break
            except queue.Full:
                continue

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item[0] is _END:
                if item[1] is not None:
                    raise item[1]
                break
            yield item
            if bar is not None:
                bar.update(1)
    finally:
        stop.set()
        if bar is not None:
            bar.close()


def _run_eval_batched(
    image_dir, coco, img_ids, estimator, iterator, stride, batch_size,
    outputs, vis_dir=None, save_every=0,
) -> None:
    """Shape-bucketed batched evaluation."""

    # padded (h, w) -> list of (img_id, padded, scale, seq, image|None)
    buckets = {}
    ready = []

    def visualize(seq, img_id, image, humans):
        if image is None:
            return
        info = coco.loadImgs(img_id)[0]
        os.makedirs(vis_dir, exist_ok=True)
        out = draw_humans(image, humans)
        _write_image(os.path.join(vis_dir, info["file_name"]), out)

    # device batches kept in flight for the device decode: the next
    # bucket's host-side image loading/padding overlaps the previous
    # batch's forward+decode on the card
    pending = []

    def drain_one():
        handle, bucket, hw = pending.pop(0)
        humans_b = estimator.collect_batch(handle)
        for (img_id, _, scale, seq, image), humans in zip(
            bucket, humans_b
        ):
            upsample = (hw[0] / scale, hw[1] / scale)
            append_result(img_id, humans, upsample, ready)
            visualize(seq, img_id, image, humans)

    def flush(bucket):
        # pad remainder buckets to the full batch size so each padded
        # shape runs at one batch shape
        stack = np.stack(
            [b[1] for b in bucket]
            + [bucket[-1][1]] * (batch_size - len(bucket))
        )
        if _on_device(estimator):
            # forward + batched decode on the card; only fixed-shape
            # packed results come back to the host
            pending.append((
                estimator.estimate_batch_async(stack), bucket,
                stack.shape[1:3],
            ))
            while len(pending) > 2:
                drain_one()
            return
        pafs_b, heatmaps_b = estimator.get_outputs_batch(stack)
        for (img_id, _, scale, seq, image), pafs, heatmaps in zip(
            bucket, pafs_b, heatmaps_b
        ):
            humans = _decode(estimator, heatmaps, pafs)
            upsample = (
                heatmaps.shape[0] * stride / scale,
                heatmaps.shape[1] * stride / scale,
            )
            append_result(img_id, humans, upsample, ready)
            visualize(seq, img_id, image, humans)

    for seq, img_id, image, im_pad, scale in _prefetch_read(
        iterator, image_dir, coco, estimator.dest_size, stride,
        depth=2 * batch_size,
    ):
        key = im_pad.shape[:2]
        keep = (
            image if vis_dir and save_every and seq % save_every == 0
            else None
        )
        buckets.setdefault(key, []).append(
            (img_id, im_pad, scale, seq, keep)
        )
        if len(buckets[key]) >= batch_size:
            flush(buckets.pop(key))
    for bucket in buckets.values():
        flush(bucket)
    while pending:
        drain_one()
    # image order does not matter to the evaluator, but keep rows grouped
    outputs.extend(ready)


def _write_image(path: str, img: np.ndarray) -> None:
    try:
        import cv2

        cv2.imwrite(path, img)
    except ImportError:
        _pillow(path).fromarray(img[:, :, ::-1]).save(path)
