"""Geometric and photometric training transforms.

Equivalent of the reference transform pipeline (reference
lib/datasets/transforms.py): PIL-image + annotation-list preprocess classes
carrying a ``meta`` dict (offset/scale/valid_area/hflip) so keypoint sets
can be mapped back through ``keypoint_sets_inverse``.

Differences from the reference, by design:

- randomness flows through an explicit ``numpy.random.Generator`` (the
  reference pulls from the global torch RNG at transforms.py:216,339,445 —
  unreproducible across workers);
- the photometric train transform reimplements torchvision's
  ColorJitter / RandomGrayscale / jpeg-compression with PIL + numpy
  (distributional rather than bit-exact parity, per SURVEY §7) and outputs
  a normalized HWC float32 array (the reference emits CHW tensors; the
  port's train step permutes a batch to NCHW on the card);
- ``RandomRotate`` rotates all 18 keypoints (the reference rotates only
  the first 13 — a latent bug at transforms.py:472 ``range(13)``; that
  class is only used by its dev loader script, never in training).

The port's own copy of the JAX package's ``data/transforms.py``, code for code
(``tests/test_torch_shared.py`` holds the syntax trees equal).
"""

from __future__ import annotations

import copy
import io
import math
from abc import ABCMeta, abstractmethod
from typing import Optional, Sequence

import numpy as np
import PIL.Image
import PIL.ImageEnhance

from torch_ekpose_tpu_torch import constants

__all__ = [
    "Preprocess", "Normalize", "Compose", "MultiScale", "RescaleRelative",
    "RescaleAbsolute", "Crop", "CenterPad", "HFlip", "RandomApply",
    "RandomRotate", "horizontal_swap_coco", "mask_valid_area",
    "image_transform", "image_transform_train", "TRAIN_PREPROCESS",
    "blur_augmentation", "display_annotations",
]


def horizontal_swap_coco(keypoints: np.ndarray) -> np.ndarray:
    """Swap left/right COCO keypoint rows (reference lib/datasets/utils.py:8)."""
    target = np.zeros(keypoints.shape, dtype=keypoints.dtype)
    for src, dst in enumerate(constants.HFLIP_COCO_SWAP):
        target[dst] = keypoints[src]
    return target


def mask_valid_area(image_hwc: np.ndarray, valid_area) -> np.ndarray:
    """Zero the image outside ``valid_area`` = (x, y, w, h)
    (reference lib/datasets/utils.py:36-54, transposed to HWC)."""
    if valid_area is None:
        return image_hwc
    if valid_area[1] >= 1.0:
        image_hwc[: int(valid_area[1]), :, :] = 0
    if valid_area[0] >= 1.0:
        image_hwc[:, : int(valid_area[0]), :] = 0
    max_i = int(math.ceil(valid_area[1] + valid_area[3]))
    max_j = int(math.ceil(valid_area[0] + valid_area[2]))
    if max_i < image_hwc.shape[0]:
        image_hwc[max_i:, :, :] = 0
    if max_j < image_hwc.shape[1]:
        image_hwc[:, max_j:, :] = 0
    return image_hwc


class Preprocess(metaclass=ABCMeta):
    @abstractmethod
    def __call__(self, image, anns, meta, rng: np.random.Generator):
        """Apply to (PIL image, annotation list, meta dict)."""

    @staticmethod
    def keypoint_sets_inverse(keypoint_sets: np.ndarray, meta) -> np.ndarray:
        """Map keypoints from preprocessed space back to the original image
        (reference transforms.py:116-132)."""
        keypoint_sets = keypoint_sets.copy()
        keypoint_sets[:, :, 0] += meta["offset"][0]
        keypoint_sets[:, :, 1] += meta["offset"][1]
        keypoint_sets[:, :, 0] = (
            keypoint_sets[:, :, 0] + 0.5
        ) / meta["scale"][0] - 0.5
        keypoint_sets[:, :, 1] = (
            keypoint_sets[:, :, 1] + 0.5
        ) / meta["scale"][1] - 0.5
        if meta["hflip"]:
            w = meta["width_height"][0]
            keypoint_sets[:, :, 0] = -keypoint_sets[:, :, 0] - 1.0 + w
            for keypoints in keypoint_sets:
                keypoints[:] = horizontal_swap_coco(keypoints)
        return keypoint_sets


class Normalize(Preprocess):
    """Convert raw COCO annotations to numpy and initialize meta
    (reference transforms.py:136-164)."""

    @staticmethod
    def normalize_annotations(anns):
        anns = copy.deepcopy(anns)
        for ann in anns:
            ann["keypoints"] = np.asarray(
                ann["keypoints"], dtype=np.float32
            ).reshape(-1, 3)
            ann["bbox"] = np.asarray(ann["bbox"], dtype=np.float32)
            ann["bbox_original"] = np.copy(ann["bbox"])
            ann.pop("segmentation", None)
        return anns

    def __call__(self, image, anns, meta, rng=None):
        anns = self.normalize_annotations(anns)
        if meta is None:
            w, h = image.size
            meta = {
                "offset": np.array((0.0, 0.0)),
                "scale": np.array((1.0, 1.0)),
                "valid_area": np.array((0.0, 0.0, w, h)),
                "hflip": False,
                "width_height": np.array((w, h)),
            }
        return image, anns, meta


class Compose(Preprocess):
    def __init__(self, preprocess_list: Sequence[Preprocess]):
        self.preprocess_list = preprocess_list

    def __call__(self, image, anns, meta, rng=None):
        rng = rng or np.random.default_rng()
        for p in self.preprocess_list:
            image, anns, meta = p(image, anns, meta, rng)
        return image, anns, meta


class MultiScale(Preprocess):
    def __init__(self, preprocess_list: Sequence[Preprocess]):
        self.preprocess_list = preprocess_list

    def __call__(self, image, anns, meta, rng=None):
        rng = rng or np.random.default_rng()
        outs = [p(image, anns, meta, rng) for p in self.preprocess_list]
        return (
            [o[0] for o in outs], [o[1] for o in outs], [o[2] for o in outs]
        )


def _scale_image_and_anns(image, anns, factor_wh, resample):
    w, h = image.size
    image = image.resize(
        (int(w * factor_wh[0]), int(h * factor_wh[1])), resample
    )
    x_scale = image.size[0] / w
    y_scale = image.size[1] / h
    for ann in anns:
        ann["keypoints"][:, 0] = (ann["keypoints"][:, 0] + 0.5) * x_scale - 0.5
        ann["keypoints"][:, 1] = (ann["keypoints"][:, 1] + 0.5) * y_scale - 0.5
        ann["bbox"] *= np.array([x_scale, y_scale, x_scale, y_scale])
    return image, anns, np.array((x_scale, y_scale))


def _apply_scale_meta(meta, scale_factors):
    meta["offset"] *= scale_factors
    meta["scale"] *= scale_factors
    meta["valid_area"][:2] *= scale_factors
    meta["valid_area"][2:] *= scale_factors


class RescaleRelative(Preprocess):
    """Random uniform rescale (reference transforms.py:204-252)."""

    def __init__(self, scale_range=(0.5, 1.0), *,
                 resample=PIL.Image.BICUBIC):
        self.scale_range = scale_range
        self.resample = resample

    def __call__(self, image, anns, meta, rng=None):
        rng = rng or np.random.default_rng()
        meta = copy.deepcopy(meta)
        anns = copy.deepcopy(anns)
        if isinstance(self.scale_range, tuple):
            lo, hi = self.scale_range
            factor = lo + rng.random() * (hi - lo)
        else:
            factor = self.scale_range
        image, anns, scale_factors = _scale_image_and_anns(
            image, anns, (factor, factor), self.resample
        )
        _apply_scale_meta(meta, scale_factors)
        for ann in anns:
            ann["valid_area"] = meta["valid_area"]
        return image, anns, meta


class RescaleAbsolute(Preprocess):
    """Rescale so the long edge hits a target
    (reference transforms.py:255-305)."""

    def __init__(self, long_edge, *, resample=PIL.Image.BICUBIC):
        self.long_edge = long_edge
        self.resample = resample

    def __call__(self, image, anns, meta, rng=None):
        rng = rng or np.random.default_rng()
        meta = copy.deepcopy(meta)
        anns = copy.deepcopy(anns)
        w, h = image.size
        edge = self.long_edge
        if isinstance(edge, (tuple, list)):
            edge = int(rng.integers(edge[0], edge[1]))
        s = edge / max(h, w)
        image, anns, scale_factors = _scale_image_and_anns(
            image, anns, (s, s), self.resample
        )
        _apply_scale_meta(meta, scale_factors)
        for ann in anns:
            ann["valid_area"] = meta["valid_area"]
        return image, anns, meta


class Crop(Preprocess):
    """Random crop to a square of ``long_edge``
    (reference transforms.py:309-359)."""

    def __init__(self, long_edge: int):
        self.long_edge = long_edge

    def __call__(self, image, anns, meta, rng=None):
        rng = rng or np.random.default_rng()
        meta = copy.deepcopy(meta)
        anns = copy.deepcopy(anns)
        image, anns, ltrb = self._crop(image, anns, rng)
        meta["offset"] += ltrb[:2]
        meta["valid_area"][:2] = np.maximum(
            0.0, meta["valid_area"][:2] - ltrb[:2]
        )
        meta["valid_area"][2:] = np.maximum(
            0.0, meta["valid_area"][2:] - ltrb[:2]
        )
        meta["valid_area"][2:] = np.minimum(
            meta["valid_area"][2:], ltrb[2:] - ltrb[:2]
        )
        for ann in anns:
            ann["valid_area"] = meta["valid_area"]
        return image, anns, meta

    def _crop(self, image, anns, rng):
        w, h = image.size
        padding = int(self.long_edge / 2.0)
        x_offset, y_offset = 0, 0
        if w > self.long_edge:
            x_offset = int(rng.integers(-padding, w - self.long_edge + padding))
            x_offset = int(np.clip(x_offset, 0, w - self.long_edge))
        if h > self.long_edge:
            y_offset = int(rng.integers(-padding, h - self.long_edge + padding))
            y_offset = int(np.clip(y_offset, 0, h - self.long_edge))
        new_w = min(self.long_edge, w - x_offset)
        new_h = min(self.long_edge, h - y_offset)
        ltrb = (x_offset, y_offset, x_offset + new_w, y_offset + new_h)
        image = image.crop(ltrb)
        for ann in anns:
            ann["keypoints"][:, 0] -= x_offset
            ann["keypoints"][:, 1] -= y_offset
            ann["bbox"][0] -= x_offset
            ann["bbox"][1] -= y_offset
        return image, anns, np.array(ltrb)


class CenterPad(Preprocess):
    """Pad to a centered target size with the imagenet-mean fill color
    (reference transforms.py:362-408)."""

    def __init__(self, target_size):
        if isinstance(target_size, int):
            target_size = (target_size, target_size)
        self.target_size = target_size

    def __call__(self, image, anns, meta, rng=None):
        meta = copy.deepcopy(meta)
        anns = copy.deepcopy(anns)
        image, anns, ltrb = self._center_pad(image, anns)
        meta["offset"] -= ltrb[:2]
        meta["valid_area"][:2] += ltrb[:2]
        for ann in anns:
            ann["valid_area"] = meta["valid_area"]
        return image, anns, meta

    def _center_pad(self, image, anns):
        w, h = image.size
        left = int((self.target_size[0] - w) / 2.0)
        top = int((self.target_size[1] - h) / 2.0)
        right = self.target_size[0] - w - left
        bottom = self.target_size[1] - h - top
        padded = PIL.Image.new(
            "RGB", self.target_size, constants.PAD_FILL_RGB
        )
        padded.paste(image, (left, top))
        for ann in anns:
            ann["keypoints"][:, 0] += left
            ann["keypoints"][:, 1] += top
            ann["bbox"][0] += left
            ann["bbox"][1] += top
        assert right >= -w and bottom >= -h
        return padded, anns, np.array((left, top, right, bottom))


class HFlip(Preprocess):
    """Horizontal flip with left/right keypoint swap
    (reference transforms.py:412-436)."""

    def __init__(self, *, swap=horizontal_swap_coco):
        self.swap = swap

    def __call__(self, image, anns, meta, rng=None):
        meta = copy.deepcopy(meta)
        anns = copy.deepcopy(anns)
        w, _ = image.size
        image = image.transpose(PIL.Image.FLIP_LEFT_RIGHT)
        for ann in anns:
            ann["keypoints"][:, 0] = -ann["keypoints"][:, 0] - 1.0 + w
            if self.swap is not None:
                ann["keypoints"] = self.swap(ann["keypoints"])
                meta["horizontal_swap"] = self.swap
            ann["bbox"][0] = -(ann["bbox"][0] + ann["bbox"][2]) - 1.0 + w
        assert meta["hflip"] is False
        meta["hflip"] = True
        meta["valid_area"][0] = -(
            meta["valid_area"][0] + meta["valid_area"][2]
        ) + w
        for ann in anns:
            ann["valid_area"] = meta["valid_area"]
        return image, anns, meta


class RandomApply(Preprocess):
    def __init__(self, transform: Preprocess, probability: float):
        self.transform = transform
        self.probability = probability

    def __call__(self, image, anns, meta, rng=None):
        rng = rng or np.random.default_rng()
        if rng.random() > self.probability:
            return image, anns, meta
        return self.transform(image, anns, meta, rng)


class RandomRotate(Preprocess):
    """Random rotation within +-max_rotate_degree, expanding the canvas
    (reference transforms.py:451-550; unlike the reference, ALL keypoints
    are rotated, not just the first 13)."""

    def __init__(self, max_rotate_degree: float = 40.0):
        self.max_rotate_degree = max_rotate_degree

    def __call__(self, image, anns, meta, rng=None):
        rng = rng or np.random.default_rng()
        meta = copy.deepcopy(meta)
        anns = copy.deepcopy(anns)
        degree = (rng.random() - 0.5) * 2 * self.max_rotate_degree

        w, h = image.size
        cx, cy = w // 2, h // 2
        rad = math.radians(degree)
        cos, sin = abs(math.cos(rad)), abs(math.sin(rad))
        nw = int(h * sin + w * cos)
        nh = int(h * cos + w * sin)
        # rotation matrix mapping source -> expanded destination
        mcos, msin = math.cos(rad), math.sin(rad)
        rot = np.array([
            [mcos, msin, (1 - mcos) * cx - msin * cy + (nw / 2 - cx)],
            [-msin, mcos, msin * cx + (1 - mcos) * cy + (nh / 2 - cy)],
        ])

        # PIL.rotate(theta) turns the image content the same visual way as
        # the cv2-style keypoint matrix above (the reference applies ONE
        # warpAffine matrix to both, reference transforms.py:470-487, so
        # image and annotations stay aligned by construction)
        image = image.rotate(
            degree, resample=PIL.Image.BICUBIC, expand=True,
            fillcolor=(128, 128, 128),
        ).resize((nw, nh))

        def rotate_xy(xy):
            v = np.array([xy[0], xy[1], 1.0])
            return rot @ v

        for ann in anns:
            for k in range(ann["keypoints"].shape[0]):
                ann["keypoints"][k, :2] = rotate_xy(ann["keypoints"][k, :2])
            ann["bbox"] = self._rotate_box(ann["bbox"], rotate_xy)
        meta["valid_area"] = self._rotate_box(meta["valid_area"], rotate_xy)
        for ann in anns:
            ann["valid_area"] = meta["valid_area"]
        return image, anns, meta

    @staticmethod
    def _rotate_box(bbox, rotate_xy):
        corners = np.array([
            [bbox[0], bbox[1]],
            [bbox[0] + bbox[2], bbox[1]],
            [bbox[0], bbox[1] + bbox[3]],
            [bbox[0] + bbox[2], bbox[1] + bbox[3]],
        ])
        rotated = np.stack([rotate_xy(c) for c in corners])
        x, y = rotated[:, 0].min(), rotated[:, 1].min()
        return np.array([
            x, y, rotated[:, 0].max() - x, rotated[:, 1].max() - y,
        ])


# ---------------------------------------------------------------------------
# photometric image transforms (PIL -> normalized HWC float32)
# ---------------------------------------------------------------------------

def _normalize_hwc(image) -> np.ndarray:
    # accepts a PIL image or a uint8 HWC array
    # in-place on a fresh f32 copy (np.array always copies, so a caller
    # passing an f32 array is never mutated) — same op sequence as
    # ((arr/255) - mean) / std, so bit-identical results, but no
    # intermediate full-image temporaries (this runs per train image on
    # the host; it was 26% of the input-pipeline item time before)
    arr = np.array(image, dtype=np.float32)
    arr /= 255.0
    arr -= np.asarray(constants.IMAGENET_MEAN, np.float32)
    arr /= np.asarray(constants.IMAGENET_STD, np.float32)
    return arr


def image_transform(
    image: PIL.Image.Image, rng: Optional[np.random.Generator] = None
) -> np.ndarray:
    """Eval-time photometric transform: normalize only
    (reference transforms.py:84-87)."""
    return _normalize_hwc(image)


#: PIL convert("L") fixed-point ITU-R 601-2 coefficients
#: (L = (19595 R + 38470 G + 7471 B + 0x8000) >> 16) — bit-exact.
_L_COEF = np.asarray([19595, 38470, 7471], np.uint32)


def _gray_u8(arr: np.ndarray) -> np.ndarray:
    """uint8 HWC RGB -> uint8 HW, bit-exact PIL ``convert("L")``."""
    return (
        (arr.astype(np.uint32) @ _L_COEF + 0x8000) >> 16
    ).astype(np.uint8)


def _finish_blend_u8(t: np.ndarray) -> np.ndarray:
    """Clip to [0, 255] and truncate — Pillow Blend.c's epilogue."""
    np.clip(t, 0.0, 255.0, out=t)
    return t.astype(np.uint8)


def _jitter_op(arr: np.ndarray, name: str, value: float) -> np.ndarray:
    """Apply one jitter op to a uint8 HWC RGB array.

    ``brightness``/``contrast``/``saturation`` (value = enhance factor)
    are BIT-IDENTICAL to ``PIL.ImageEnhance.{Brightness,Contrast,
    Color}(im).enhance(value)``: each enhance op is ``Image.blend``
    against a degenerate image, and we replicate Pillow exactly —
    fixed-point ``convert("L")`` via :func:`_gray_u8`, ImageStat's
    rounded-half-up mean, and Blend.c's float32
    ``deg + alpha*(img - deg)`` (that operand order, so the roundings
    match) followed by clip-then-truncate. Pinned per-op against PIL in
    tests/test_data_pipeline.py.

    ``hue`` (value = shift in [-0.5, 0.5]) runs through cv2's SIMD
    ``RGB2HSV_FULL`` round-trip instead of PIL's scalar converter —
    the same uint8 full-range HSV shift by ``int(value*255)``, ~9x
    faster, within ~1 unit mean of PIL's quantization (irrelevant next
    to the random +-25-unit hue shift itself; tolerance-pinned in the
    same test file).
    """
    if name == "hue":
        import cv2

        hsv = cv2.cvtColor(arr, cv2.COLOR_RGB2HSV_FULL)
        hsv[..., 0] = (
            hsv[..., 0].astype(np.int16) + int(value * 255)
        ) % 256
        return cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB_FULL)
    factor = np.float32(value)
    if name == "brightness":
        # degenerate = black: t = 0 + f*(arr - 0)
        t = np.multiply(arr, factor, dtype=np.float32)
    elif name == "contrast":
        # degenerate = constant rounded-half-up mean of the L image
        mean = np.int16(int(_gray_u8(arr).mean() + 0.5))
        t = np.multiply(
            arr.astype(np.int16) - mean, factor, dtype=np.float32
        )
        t += np.float32(mean)
    else:  # saturation: degenerate = replicated L image
        gray = _gray_u8(arr)
        t = np.multiply(
            arr.astype(np.int16) - gray[:, :, None],
            factor,
            dtype=np.float32,
        )
        t += gray[:, :, None]
    return _finish_blend_u8(t)


def _color_jitter(arr: np.ndarray, rng, strength=0.1) -> np.ndarray:
    """torchvision ColorJitter(0.1 x4), PIL backend semantics, on a
    uint8 HWC array: the four ops of :func:`_jitter_op` in a random
    order, factors/shift drawn uniformly from ``1 +- strength`` /
    ``+- strength``. Same rng stream as the PIL chain it replaced
    (permutation, then one uniform per op). The PIL chain was 52% of
    the measured train-item time, most of it hue's two scalar HSV
    converts (docs/PERF.md)."""
    ops = ["brightness", "contrast", "saturation", "hue"]
    order = rng.permutation(len(ops))
    for i in order:
        name = ops[i]
        if name == "hue":
            value = rng.uniform(-strength, strength)
        else:
            value = rng.uniform(1 - strength, 1 + strength)
        arr = _jitter_op(arr, name, value)
    return arr


def _jpeg_compression(image, quality=50):
    buf = io.BytesIO()
    image.save(buf, "jpeg", quality=quality)
    buf.seek(0)
    return PIL.Image.open(buf).convert("RGB")


def blur_augmentation(
    image: PIL.Image.Image,
    rng: Optional[np.random.Generator] = None,
    max_sigma: float = 5.0,
) -> PIL.Image.Image:
    """Random Gaussian blur (reference transforms.py:65-69; unused by the
    reference train pipeline but part of its augmentation toolkit)."""
    rng = rng or np.random.default_rng()
    sigma = max_sigma * rng.random()
    radius = max(1, int(round(3 * sigma)))
    arr = np.asarray(image, dtype=np.float64)
    xs = np.arange(-radius, radius + 1, dtype=np.float64)
    kernel = np.exp(-(xs ** 2) / (2 * max(sigma, 1e-6) ** 2))
    kernel /= kernel.sum()
    # separable blur along each spatial axis
    for axis in (0, 1):
        arr = np.apply_along_axis(
            lambda m: np.convolve(
                np.pad(m, radius, mode="edge"), kernel, mode="valid"
            ),
            axis, arr,
        )
    return PIL.Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8))


def display_annotations(image, anns, title=None):
    """Debug visualization of keypoints + boxes over an image
    (reference transforms.py:18-56); returns the matplotlib figure."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.patches as patches
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots()
    ax.imshow(image)
    for i, ann in enumerate(anns):
        kp = np.asarray(ann["keypoints"]).reshape(-1, 3)
        visible = kp[kp[:, 2] > 0]
        if len(visible) == 0:
            continue
        bbox = ann["bbox"]
        ax.add_patch(patches.Rectangle(
            (bbox[0], bbox[1]), bbox[2], bbox[3],
            linewidth=2, edgecolor=f"C{i}", facecolor="none",
        ))
        ax.scatter(visible[:, 0], visible[:, 1], c=f"C{i}", s=30, alpha=0.8)
    ax.set_title(title or "annotations")
    return fig


def image_transform_train(
    image: PIL.Image.Image, rng: Optional[np.random.Generator] = None
) -> np.ndarray:
    """Train-time photometric transform: ColorJitter(0.1 x4) + jpeg
    compression p=0.1 + grayscale p=0.01 + normalize
    (reference transforms.py:90-107)."""
    rng = rng or np.random.default_rng()
    arr = _color_jitter(np.asarray(image), rng)
    if rng.random() < 0.1:
        arr = np.asarray(_jpeg_compression(PIL.Image.fromarray(arr)))
    if rng.random() < 0.01:
        # convert("L").convert("RGB") = replicated L channel, bit-exact
        arr = np.repeat(_gray_u8(arr)[:, :, None], 3, axis=2)
    return _normalize_hwc(arr)


def TRAIN_PREPROCESS(square_size: int = 368) -> Compose:
    """The training geometric pipeline (reference train.py:88-94):
    Normalize -> RandomApply(HFlip, 0.5) -> RescaleRelative(0.5-1.0) ->
    Crop(square) -> CenterPad(square)."""
    return Compose([
        Normalize(),
        RandomApply(HFlip(), 0.5),
        RescaleRelative((0.5, 1.0)),
        Crop(square_size),
        CenterPad(square_size),
    ])
