"""Renderable synthetic COCO-keypoints datasets.

No COCO data is needed: end-to-end proofs that need *trained* weights —
cross-stack eval AP parity, closed-loop train->eval runs — use scenes
generated here: stick figures whose joints and limbs are drawn with
distinctive colors, making the image->heatmap/PAF mapping learnable by a
CNN from scratch in a few hundred CPU steps, while
exercising the real dataset plumbing (COCO-format annotation JSON in the
17-keypoint order, the neck synthesis, the eval protocol's ORDER_COCO
remap — reference eval.py:20-35, lib/datasets/datasets.py:209-229).

The same generator family renders train scenes on the fly (no disk) and
writes held-out val sets to a COCO directory layout that both this
framework's ``cli.eval`` and the reference's ``eval.py`` loop can consume.

The port's own copy of the JAX package's ``data/synthetic_coco.py``, with
one fix: a limb is drawn only when BOTH its ends are labeled. The
original skips it only when both are out of frame, so a limb with one
truncated end (zeroed to (0, 0) by :func:`sample_pose`) is drawn to the
image's corner. The annotations and the rng stream are the original's;
``tests/test_torch_data.py`` holds the syntax trees equal apart from that
one test and compares the scenes.
"""

from __future__ import annotations

import colorsys
import json
import os
from typing import List, Optional, Tuple

import numpy as np

from torch_ekpose_tpu_torch import constants

__all__ = [
    "POSE_OFFSETS", "render_scene", "sample_pose", "write_coco_dataset",
]

#: Canonical upright stick figure, internal 18-part order, ~200 px tall at
#: scale 1 (nose above neck, arms down-angled, legs below the hips).
POSE_OFFSETS = np.array([
    (0, -95),            # 0 nose
    (0, -70),            # 1 neck
    (-25, -70),          # 2 right shoulder
    (-32, -35),          # 3 right elbow
    (-36, 0),            # 4 right wrist
    (25, -70),           # 5 left shoulder
    (32, -35),           # 6 left elbow
    (36, 0),             # 7 left wrist
    (-18, 0),            # 8 right hip
    (-20, 45),           # 9 right knee
    (-20, 90),           # 10 right ankle
    (18, 0),             # 11 left hip
    (20, 45),            # 12 left knee
    (20, 90),            # 13 left ankle
    (-8, -103),          # 14 right eye
    (8, -103),           # 15 left eye
    (-17, -99),          # 16 right ear
    (17, -99),           # 17 left ear
], dtype=np.float64)


def _joint_color(j: int) -> Tuple[int, int, int]:
    """A saturated, unique BGR color per joint (hue wheel)."""
    r, g, b = colorsys.hsv_to_rgb(j / 18.0, 1.0, 1.0)
    return int(b * 255), int(g * 255), int(r * 255)


def _limb_color(li: int) -> Tuple[int, int, int]:
    """A dimmer, unique BGR color per limb (offset half-hue steps keep
    limb colors distinct from joint colors)."""
    r, g, b = colorsys.hsv_to_rgb((li + 0.5) / 19.0, 0.85, 0.55)
    return int(b * 255), int(g * 255), int(r * 255)


def sample_pose(
    rng: np.random.Generator, h: int, w: int,
    scale_range: Tuple[float, float] = (0.55, 0.85),
    jitter: float = 3.0,
    center: Optional[Tuple[float, float]] = None,
    truncate: bool = False,
) -> np.ndarray:
    """One person's internal-order keypoints [18, 3] (x, y, vis).

    Default: fully inside the ``h`` x ``w`` canvas, vis=2 everywhere
    (the original behavior, byte-identical rng stream).

    ``center=(cx, cy)``: place the body around that point instead of a
    uniform draw (used to force inter-person overlap).

    ``truncate=True``: the center may sit so that part of the body falls
    outside the canvas (like COCO's border-cropped people,
    reference lib/datasets/datasets.py:199-229 handles exactly these);
    out-of-frame joints get vis=0 with zeroed coordinates — the COCO
    "not labeled" convention — while at least the torso is kept inside
    so the person remains detectable.
    """
    scale = rng.uniform(*scale_range)
    span = POSE_OFFSETS * scale
    if center is not None:
        cx, cy = center
    elif truncate:
        # keep the neck..hip torso box inside, let extremities overhang:
        # torso rows of POSE_OFFSETS are 1 (neck) and 8/11 (hips)
        torso = span[[1, 2, 5, 8, 11]]
        x_lo, x_hi = -torso[:, 0].min() + 2, w - torso[:, 0].max() - 2
        y_lo, y_hi = -torso[:, 1].min() + 2, h - torso[:, 1].max() - 2
        cx = rng.uniform(min(x_lo, x_hi), max(x_lo, x_hi))
        cy = rng.uniform(min(y_lo, y_hi), max(y_lo, y_hi))
    else:
        x_lo, x_hi = -span[:, 0].min() + 6, w - span[:, 0].max() - 6
        y_lo, y_hi = -span[:, 1].min() + 6, h - span[:, 1].max() - 6
        cx = rng.uniform(min(x_lo, x_hi), max(x_lo, x_hi))
        cy = rng.uniform(min(y_lo, y_hi), max(y_lo, y_hi))
    kpts = np.zeros((18, 3))
    kpts[:, :2] = np.array([cx, cy]) + span + rng.normal(0, jitter, (18, 2))
    kpts[:, 2] = 2
    if truncate or center is not None:
        outside = (
            (kpts[:, 0] < 1) | (kpts[:, 0] > w - 2)
            | (kpts[:, 1] < 1) | (kpts[:, 1] > h - 2)
        )
        kpts[outside] = 0.0  # vis=0, coords zeroed: COCO "not labeled"
        kpts[~outside, 2] = 2
    else:
        kpts[:, 0] = np.clip(kpts[:, 0], 1, w - 2)
        kpts[:, 1] = np.clip(kpts[:, 1], 1, h - 2)
    return kpts


def _textured_background(
    rng: np.random.Generator, h: int, w: int, noise: float
) -> np.ndarray:
    """A cluttered background: a low-frequency color wash plus random
    rectangles, ellipses, and line segments in dim/desaturated colors.

    Real photographs put structure behind people — edges, blobs, and
    near-limb-colored strokes that a peak-picking decoder must reject
    (the plain renderer's flat noise floor never exercises that). Colors
    stay at <= 0.45 value so the saturated joint/limb palette remains
    distinguishable, but the clutter produces real spurious gradients.
    """
    import cv2

    # low-frequency wash: tiny random field upsampled smoothly
    wash = rng.uniform(10, 80, (6, 8, 3)).astype(np.float32)
    image = cv2.resize(wash, (w, h), interpolation=cv2.INTER_CUBIC)
    image += rng.normal(0, noise, (h, w, 3)).astype(np.float32)

    def dim_color():
        r, g, b = colorsys.hsv_to_rgb(
            rng.uniform(), rng.uniform(0.2, 0.8), rng.uniform(0.15, 0.45)
        )
        return int(b * 255), int(g * 255), int(r * 255)

    image = image.clip(0, 255).astype(np.uint8)
    n_shapes = int(rng.integers(12, 24))
    for _ in range(n_shapes):
        kind = rng.integers(0, 3)
        color = dim_color()
        if kind == 0:
            x0, y0 = rng.integers(0, w), rng.integers(0, h)
            x1 = int(np.clip(x0 + rng.integers(10, w // 2), 0, w - 1))
            y1 = int(np.clip(y0 + rng.integers(10, h // 2), 0, h - 1))
            cv2.rectangle(image, (int(x0), int(y0)), (x1, y1), color,
                          thickness=int(rng.integers(1, 4)))
        elif kind == 1:
            cv2.ellipse(
                image, (int(rng.integers(0, w)), int(rng.integers(0, h))),
                (int(rng.integers(8, 60)), int(rng.integers(8, 60))),
                float(rng.uniform(0, 180)), 0, 360, color, thickness=-1,
            )
        else:
            # line clutter at limb-like thickness — the sharpest decoy
            cv2.line(
                image,
                (int(rng.integers(0, w)), int(rng.integers(0, h))),
                (int(rng.integers(0, w)), int(rng.integers(0, h))),
                color, thickness=int(rng.integers(2, 4)),
                lineType=cv2.LINE_8,
            )
    return image


def render_scene(
    rng: np.random.Generator,
    n_people: int,
    h: int,
    w: int,
    scale_range: Tuple[float, float] = (0.55, 0.85),
    noise: float = 8.0,
    background: str = "plain",
    occlusion: bool = False,
    truncate: bool = False,
    scale_strokes: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """(image [h, w, 3] uint8 BGR, keypoints [n_people, 18, 3]).

    People are drawn limbs-first (colored 3 px lines), joints on top
    (colored 4 px disks) over a dark noisy background — each joint/limb
    class has a unique color, so a from-scratch CNN can learn the
    joint-heatmap and limb-PAF mappings quickly. Defaults reproduce the
    original renderer byte-for-byte (same rng stream).

    Photo-statistics options (all default-off), modeling the real-data
    behaviors the reference's loader filters for
    (reference lib/datasets/datasets.py:126-139, 199-229):

    - ``background="textured"``: cluttered background (color wash +
      rectangles / ellipses / limb-thickness line decoys);
    - ``occlusion=True``: people are placed in overlapping clusters
      (later-drawn bodies cover earlier ones) and joints whose marker
      pixel ends up overdrawn are annotated vis=1 (labeled, not
      visible — COCO's occlusion flag);
    - ``truncate=True``: bodies may overhang the canvas border;
      out-of-frame joints get vis=0 + zeroed coords (COCO "not
      labeled") while the torso stays inside;
    - ``scale_strokes=True``: limb/joint stroke widths scale with the
      person's size, so sub-32 px figures render as coherent small
      bodies instead of a fused blob of full-width strokes.
    """
    import cv2

    if background == "textured":
        image = _textured_background(rng, h, w, noise)
    else:
        image = rng.normal(28.0, noise, (h, w, 3)).clip(0, 255)
        image = image.astype(np.uint8)

    people = []
    for p in range(n_people):
        center = None
        if occlusion and people and rng.uniform() < 0.75:
            # cluster on an already-placed person: offset by a fraction
            # of that person's span so bodies genuinely overlap
            prev = people[int(rng.integers(0, len(people)))]
            vis_prev = prev[prev[:, 2] > 0]
            if len(vis_prev):
                px, py = vis_prev[:, 0].mean(), vis_prev[:, 1].mean()
                spread = max(
                    vis_prev[:, 1].max() - vis_prev[:, 1].min(), 40.0
                )
                center = (
                    float(px + rng.uniform(-0.45, 0.45) * spread),
                    float(py + rng.uniform(-0.25, 0.25) * spread),
                )
        people.append(sample_pose(
            rng, h, w, scale_range, center=center,
            truncate=truncate and center is None,
        ))
    kpts = np.stack(people)

    for person in kpts:
        pts = person[:, :2]
        vis = person[:, 2]
        if scale_strokes:
            ys = pts[vis > 0][:, 1] if (vis > 0).any() else pts[:, 1]
            height = float(ys.max() - ys.min()) if len(ys) else 100.0
            rel = max(height / 185.0, 0.06)  # 185 px = offsets at scale 1
            lw = max(1, int(round(3 * rel / 0.7)))
            rad = max(1, int(round(4 * rel / 0.7)))
        else:
            lw, rad = 3, 4
        for li, (a, b) in enumerate(constants.COCO_PAIRS):
            if vis[a] == 0 or vis[b] == 0:
                continue  # an end out of frame sits at (0, 0): no stroke
            cv2.line(
                image,
                tuple(np.round(pts[a]).astype(int)),
                tuple(np.round(pts[b]).astype(int)),
                _limb_color(li), thickness=lw, lineType=cv2.LINE_8,
            )
        for j in range(18):
            if vis[j] == 0:
                continue
            cv2.circle(
                image, tuple(np.round(pts[j]).astype(int)), rad,
                _joint_color(j), thickness=-1, lineType=cv2.LINE_8,
            )

    if occlusion:
        # honest vis flags: a joint whose marker pixel was overdrawn by a
        # later body (or a sibling joint) is "labeled, not visible"
        for person in kpts:
            for j in range(18):
                if person[j, 2] == 0:
                    continue
                x = int(np.round(person[j, 0]))
                y = int(np.round(person[j, 1]))
                if not (0 <= x < w and 0 <= y < h):
                    person[j] = 0.0
                    continue
                if tuple(int(c) for c in image[y, x]) != _joint_color(j):
                    person[j, 2] = 1
    return image, kpts


def _coco_annotation(ann_id: int, img_id: int, person: np.ndarray) -> dict:
    """One person's internal [18, 3] keypoints -> a COCO annotation row
    (17 keypoints in COCO order; bbox/area from the keypoint extent)."""
    coco_kp = constants.internal_to_coco_keypoints(person)
    labeled = coco_kp[:, 2] > 0
    # truncated/occluded people carry v=0 joints at (0, 0); the box/area
    # must span the LABELED joints only or OKS normalization collapses
    pts = coco_kp[labeled] if labeled.any() else coco_kp
    xs, ys = pts[:, 0], pts[:, 1]
    x0, y0 = float(xs.min()), float(ys.min())
    bw, bh = float(xs.max() - x0), float(ys.max() - y0)
    # pad the tight keypoint bbox like a real person box would extend
    # beyond the joints (head top / hands / feet)
    pad = 0.1
    bbox = [x0 - pad * bw, y0 - pad * bh, bw * (1 + 2 * pad),
            bh * (1 + 2 * pad)]
    flat = []
    for x, y, v in coco_kp:
        flat.extend([float(x), float(y), int(v)])
    return {
        "id": ann_id,
        "image_id": img_id,
        "category_id": 1,
        "keypoints": flat,
        "num_keypoints": int((coco_kp[:, 2] > 0).sum()),
        "bbox": [round(v, 2) for v in bbox],
        "area": round(bbox[2] * bbox[3], 2),
        "iscrowd": 0,
    }


def write_coco_dataset(
    out_dir: str,
    n_images: int,
    h: int = 368,
    w: int = 368,
    mode: str = "val",
    seed: int = 0,
    max_people: int = 3,
    scale_range: Tuple[float, float] = (0.55, 0.85),
    min_people: int = 1,
    sizes: Optional[List[Tuple[int, int]]] = None,
    post_resize_band: Optional[Tuple[float, float]] = None,
    dest_size: int = 368,
    first_img_id: int = 1000,
    background: str = "plain",
    occlusion: bool = False,
    truncate: bool = False,
    scale_strokes: bool = False,
) -> Tuple[str, str]:
    """Write ``n_images`` rendered scenes + COCO-format annotations.

    Layout matches what both eval stacks expect
    (reference eval.py:52-54): ``{out_dir}/images/{mode}/NNNN.png`` and
    ``{out_dir}/annotations_{mode}.json``. Returns
    (image_dir, annotation_file).

    ``sizes`` (a list of (h, w) canvases, cycled per image) builds
    mixed-aspect-ratio sets that exercise several pad-to-x8 buckets of
    the eval protocol's ``padding`` (reference
    lib/evaluate/estimator.py:52-68: resize max side to ``dest_size``,
    zero-pad each dim up to a multiple of 8). With ``post_resize_band``
    the per-image render scale is chosen so people land inside that
    scale band AFTER the eval resize — i.e. render scale =
    band / (dest_size / max(h, w)) — keeping every canvas size inside a
    trained model's scale regime.
    """
    import cv2

    rng = np.random.default_rng(seed)
    image_dir = os.path.join(out_dir, "images", mode)
    os.makedirs(image_dir, exist_ok=True)

    images: List[dict] = []
    annotations: List[dict] = []
    ann_id = 1
    for i in range(n_images):
        img_id = first_img_id + i
        ih, iw = sizes[i % len(sizes)] if sizes else (h, w)
        if post_resize_band is not None:
            r = float(dest_size) / max(ih, iw)
            sr = (post_resize_band[0] / r, post_resize_band[1] / r)
        else:
            sr = scale_range
        n_people = int(rng.integers(min_people, max_people + 1))
        image, kpts = render_scene(
            rng, n_people, ih, iw, scale_range=sr,
            background=background, occlusion=occlusion, truncate=truncate,
            scale_strokes=scale_strokes,
        )
        name = f"{img_id}.png"
        cv2.imwrite(os.path.join(image_dir, name), image)
        images.append(
            {"id": img_id, "file_name": name, "width": iw, "height": ih}
        )
        for person in kpts:
            if not (person[:, 2] > 0).any():
                continue  # fully out-of-frame under truncate: no GT row
            annotations.append(_coco_annotation(ann_id, img_id, person))
            ann_id += 1

    anno = {
        "images": images,
        "annotations": annotations,
        "categories": [{
            "id": 1,
            "name": "person",
            "keypoints": list(constants.COCO_KEYPOINTS),
            "skeleton": [],
        }],
    }
    anno_file = os.path.join(out_dir, f"annotations_{mode}.json")
    with open(anno_file, "w") as f:
        json.dump(anno, f)
    return image_dir, anno_file
