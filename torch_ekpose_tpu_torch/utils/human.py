"""Assembled-person data model and skeleton rendering.

Equivalent of the reference's human model (reference lib/utils/common.py:
``Human`` :51-250, ``BodyPart`` :277-298, ``draw_humans`` :252-275, plus the
``get_face_box`` :93-171 and ``get_upper_body_box`` :174-244 heuristics).
Coordinates in ``BodyPart`` are normalized to [0, 1] relative to the decoded
map, exactly as the reference stores them.

Rendering is pure numpy (disk stamping + thick-line rasterization) so the
package has no hard OpenCV dependency; the drawn geometry (centers, radii,
colors, which pairs are rendered) matches the reference's cv2 calls.

The port's own copy of the JAX package's ``utils/human.py``, importing the
port's ``constants``; ``tests/test_torch_shared.py`` holds the two equal.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np

from torch_ekpose_tpu_torch import constants
from torch_ekpose_tpu_torch.constants import CocoPart

__all__ = ["BodyPart", "Human", "draw_humans"]


class BodyPart:
    """One detected keypoint. ``x``/``y`` are normalized to [0, 1]
    (reference lib/utils/common.py:277-298)."""

    __slots__ = ("uidx", "part_idx", "x", "y", "score")

    def __init__(self, uidx, part_idx, x, y, score):
        self.uidx = uidx
        self.part_idx = part_idx
        self.x, self.y = x, y
        self.score = score

    def get_part_name(self) -> CocoPart:
        return CocoPart(self.part_idx)

    def __str__(self):
        return "BodyPart:%d-(%.2f, %.2f) score=%.2f" % (
            self.part_idx, self.x, self.y, self.score,
        )

    __repr__ = __str__


def _round(value) -> int:
    return int(round(value))


class Human:
    """One assembled person: a dict of part_idx -> BodyPart plus a score
    (reference lib/utils/common.py:51-250)."""

    __slots__ = ("body_parts", "pairs", "uidx_list", "score")

    def __init__(self, pairs=()):
        self.pairs = []
        self.uidx_list = set()
        self.body_parts: Dict[int, BodyPart] = {}
        for pair in pairs:
            self.add_pair(pair)
        self.score = 0.0

    @staticmethod
    def _get_uidx(part_idx, idx):
        return "%d-%d" % (part_idx, idx)

    def add_pair(self, pair):
        self.pairs.append(pair)
        self.body_parts[pair.part_idx1] = BodyPart(
            Human._get_uidx(pair.part_idx1, pair.idx1), pair.part_idx1,
            pair.coord1[0], pair.coord1[1], pair.score,
        )
        self.body_parts[pair.part_idx2] = BodyPart(
            Human._get_uidx(pair.part_idx2, pair.idx2), pair.part_idx2,
            pair.coord2[0], pair.coord2[1], pair.score,
        )
        self.uidx_list.add(Human._get_uidx(pair.part_idx1, pair.idx1))
        self.uidx_list.add(Human._get_uidx(pair.part_idx2, pair.idx2))

    def is_connected(self, other: "Human") -> bool:
        return len(self.uidx_list & other.uidx_list) > 0

    def merge(self, other: "Human") -> None:
        for pair in other.pairs:
            self.add_pair(pair)

    def part_count(self) -> int:
        return len(self.body_parts)

    def get_max_score(self) -> float:
        return max(part.score for part in self.body_parts.values())

    def _confident_parts(self, thresh: float) -> List[BodyPart]:
        return [p for p in self.body_parts.values() if p.score > thresh]

    def get_face_box(self, img_w: int, img_h: int, mode: int = 0) -> Optional[dict]:
        """Face bounding-box heuristic (reference lib/utils/common.py:93-171).

        Returns None when the nose is missing or no scale cue (neck / eye
        span / ear span) is available. mode=0 returns a centered box; mode=1
        returns a corner-anchored box and additionally requires an eye.
        """
        parts = self._confident_parts(0.2)
        by_idx = {p.part_idx: p for p in parts}

        nose = by_idx.get(CocoPart.Nose)
        if nose is None:
            return None

        size = 0.0
        neck = by_idx.get(CocoPart.Neck)
        if neck is not None:
            size = max(size, img_h * (neck.y - nose.y) * 0.8)

        reye, leye = by_idx.get(CocoPart.REye), by_idx.get(CocoPart.LEye)
        if reye is not None and leye is not None:
            size = max(size, img_w * (reye.x - leye.x) * 2.0)
            size = max(
                size,
                img_w * math.sqrt((reye.x - leye.x) ** 2 + (reye.y - leye.y) ** 2) * 2.0,
            )
        if mode == 1 and reye is None and leye is None:
            return None

        rear, lear = by_idx.get(CocoPart.REar), by_idx.get(CocoPart.LEar)
        if rear is not None and lear is not None:
            size = max(size, img_w * (rear.x - lear.x) * 1.6)

        if size <= 0:
            return None

        if reye is None and leye is not None:
            x = nose.x * img_w - (size // 3 * 2)
        elif reye is not None and leye is None:
            x = nose.x * img_w - (size // 3)
        else:
            x = nose.x * img_w - size // 2
        x2 = x + size
        if mode == 0:
            y = nose.y * img_h - size // 3
        else:
            y = nose.y * img_h - _round(size / 2 * 1.2)
        y2 = y + size

        x = max(0, x)
        y = max(0, y)
        x2 = min(img_w - x, x2 - x) + x
        y2 = min(img_h - y, y2 - y) + y

        if _round(x2 - x) == 0 or _round(y2 - y) == 0:
            return None
        if mode == 0:
            return {"x": _round((x + x2) / 2), "y": _round((y + y2) / 2),
                    "w": _round(x2 - x), "h": _round(y2 - y)}
        return {"x": _round(x), "y": _round(y),
                "w": _round(x2 - x), "h": _round(y2 - y)}

    def get_upper_body_box(self, img_w: int, img_h: int) -> Optional[dict]:
        """Upper-body box heuristic (reference lib/utils/common.py:174-244)."""
        if not (img_w > 0 and img_h > 0):
            raise ValueError("img size should be positive")

        parts = self._confident_parts(0.3)
        by_idx = {p.part_idx: p for p in parts}
        upper_ids = (0, 1, 2, 5, 8, 11, 14, 15, 16, 17)
        coords = [
            (img_w * p.x, img_h * p.y) for p in parts if p.part_idx in upper_ids
        ]
        if len(coords) < 5:
            return None

        x = min(c[0] for c in coords)
        y = min(c[1] for c in coords)
        x2 = max(c[0] for c in coords)
        y2 = max(c[1] for c in coords)

        nose, neck = by_idx.get(CocoPart.Nose), by_idx.get(CocoPart.Neck)
        if nose is not None and neck is not None:
            y -= (neck.y * img_h - y) * 0.8

        rsh = by_idx.get(CocoPart.RShoulder)
        lsh = by_idx.get(CocoPart.LShoulder)
        if rsh is not None and lsh is not None:
            dx = (x2 - x) * 0.15
            x -= dx
            x2 += dx
        elif neck is not None:
            one_sh = lsh if (lsh is not None and rsh is None) else (
                rsh if (rsh is not None and lsh is None) else None
            )
            if one_sh is not None:
                half_w = abs(one_sh.x - neck.x) * img_w * 1.15
                x = min(neck.x * img_w - half_w, x)
                x2 = max(neck.x * img_w + half_w, x2)

        x = max(0, x)
        y = max(0, y)
        x2 = min(img_w - x, x2 - x) + x
        y2 = min(img_h - y, y2 - y) + y

        if _round(x2 - x) == 0 or _round(y2 - y) == 0:
            return None
        return {"x": _round((x + x2) / 2), "y": _round((y + y2) / 2),
                "w": _round(x2 - x), "h": _round(y2 - y)}

    def __str__(self):
        return " ".join(str(p) for p in self.body_parts.values())

    __repr__ = __str__


def _stamp_disk(img: np.ndarray, cx: int, cy: int, radius: int, color) -> None:
    h, w = img.shape[:2]
    x0, x1 = max(0, cx - radius), min(w, cx + radius + 1)
    y0, y1 = max(0, cy - radius), min(h, cy + radius + 1)
    if x0 >= x1 or y0 >= y1:
        return
    yy, xx = np.mgrid[y0:y1, x0:x1]
    mask = (xx - cx) ** 2 + (yy - cy) ** 2 <= radius * radius
    img[y0:y1, x0:x1][mask] = color


def _stamp_line(img: np.ndarray, p0, p1, thickness: int, color) -> None:
    length = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]))) + 1
    ts = np.linspace(0.0, 1.0, num=2 * length)
    xs = np.round(p0[0] + ts * (p1[0] - p0[0])).astype(int)
    ys = np.round(p0[1] + ts * (p1[1] - p0[1])).astype(int)
    r = max(0, thickness // 2)
    for x, y in zip(xs, ys):
        _stamp_disk(img, x, y, r, color)


def draw_humans(npimg: np.ndarray, humans: List[Human], imgcopy: bool = False):
    """Draw skeletons onto an image (reference lib/utils/common.py:252-275).

    Point radii / line widths scale with image size exactly as the reference
    does; only the first 17 pairs are drawn (``CocoPairsRender``).
    """
    if imgcopy:
        npimg = np.copy(npimg)
    try:
        import cv2
    except ImportError:
        cv2 = None
    image_h, image_w = npimg.shape[:2]
    scale = (image_h + image_w) / 2.0 / 1000
    point_r = max(1, int(10 * scale))
    line_w = max(1, int(2 * scale))
    for human in humans:
        centers = {}
        for i in range(CocoPart.Background.value):
            if i not in human.body_parts:
                continue
            part = human.body_parts[i]
            center = (
                int(part.x * image_w + 0.5), int(part.y * image_h + 0.5),
            )
            centers[i] = center
            color = constants.COCO_COLORS[i]
            if cv2 is not None:
                cv2.circle(npimg, center, point_r, tuple(color), -1)
            else:
                _stamp_disk(npimg, center[0], center[1], point_r, color)
        for pair_order, pair in enumerate(constants.COCO_PAIRS_RENDER):
            if pair[0] not in centers or pair[1] not in centers:
                continue
            color = constants.COCO_COLORS[pair_order]
            if cv2 is not None:
                cv2.line(npimg, centers[pair[0]], centers[pair[1]],
                         tuple(color), line_w)
            else:
                _stamp_line(npimg, centers[pair[0]], centers[pair[1]],
                            line_w, color)
    return npimg
