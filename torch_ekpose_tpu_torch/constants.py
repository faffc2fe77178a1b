"""Skeleton topology, keypoint orderings, and decode constants.

This module is the single source of truth for every constant that the
reference implementation scatters across four places:

- the yacs config        (reference: lib/config/default.py:10-24)
- the C++ decoder header (reference: lib/pafprocess/pafprocess.h:6-24)
- the human/part model   (reference: lib/utils/common.py:6-36)
- the dataset skeleton   (reference: lib/datasets/datasets.py:14-62,
                          lib/datasets/skleton.py:1-61)

All orderings are preserved exactly: the 18-keypoint internal order, the
COCO 17-keypoint order, the `our_order` COCO->internal remap, the
`ORDER_COCO` internal->COCO remap, the 19 limb pairs and their PAF channel
assignments.

The port's own copy of the JAX package's ``constants.py``, so the port
imports nothing of that package; ``tests/test_torch_shared.py`` holds
every public name equal to the original.
"""

from __future__ import annotations

import enum

import numpy as np


class CocoPart(enum.IntEnum):
    """Internal 18-keypoint ordering (+ background).

    Matches reference lib/utils/common.py:6-25.
    """

    Nose = 0
    Neck = 1
    RShoulder = 2
    RElbow = 3
    RWrist = 4
    LShoulder = 5
    LElbow = 6
    LWrist = 7
    RHip = 8
    RKnee = 9
    RAnkle = 10
    LHip = 11
    LKnee = 12
    LAnkle = 13
    REye = 14
    LEye = 15
    REar = 16
    LEar = 17
    Background = 18


#: Internal keypoint names in model-channel order
#: (reference lib/datasets/datasets.py:40-62).
KEYPOINTS = (
    "nose",
    "neck",
    "right_shoulder",
    "right_elbow",
    "right_wrist",
    "left_shoulder",
    "left_elbow",
    "left_wrist",
    "right_hip",
    "right_knee",
    "right_ankle",
    "left_hip",
    "left_knee",
    "left_ankle",
    "right_eye",
    "left_eye",
    "right_ear",
    "left_ear",
)

NUM_KEYPOINTS = 18
NUM_HEATMAP_CHANNELS = NUM_KEYPOINTS + 1  # + background channel
NUM_LIMBS = 19
NUM_PAF_CHANNELS = 2 * NUM_LIMBS

#: COCO dataset 17-keypoint names in annotation order
#: (reference lib/datasets/skleton.py:3-21).
COCO_KEYPOINTS = (
    "nose",
    "left_eye",
    "right_eye",
    "left_ear",
    "right_ear",
    "left_shoulder",
    "right_shoulder",
    "left_elbow",
    "right_elbow",
    "left_wrist",
    "right_wrist",
    "left_hip",
    "right_hip",
    "left_knee",
    "right_knee",
    "left_ankle",
    "right_ankle",
)

#: Reorders [17 COCO keypoints + synthesized neck] into the 18-keypoint
#: internal order (reference lib/datasets/datasets.py:214 `our_order`;
#: index 17 is the appended neck row).
OUR_ORDER = (0, 17, 6, 8, 10, 5, 7, 9, 12, 14, 16, 11, 13, 15, 2, 1, 4, 3)

#: Maps the first 17 internal keypoints back to COCO annotation order for
#: result JSON (reference eval.py:35 `ORDER_COCO`).
ORDER_COCO = (0, 15, 14, 17, 16, 5, 2, 6, 3, 7, 4, 11, 8, 12, 9, 13, 10)

#: The 19 limb pairs used by the decoder, as (part_a, part_b) internal ids
#: (reference lib/pafprocess/pafprocess.h:21-24 `COCOPAIRS` and
#: lib/utils/common.py:27-30 `CocoPairs` — identical).
COCO_PAIRS = (
    (1, 2), (1, 5), (2, 3), (3, 4), (5, 6), (6, 7), (1, 8), (8, 9), (9, 10),
    (1, 11), (11, 12), (12, 13), (1, 0), (0, 14), (14, 16), (0, 15), (15, 17),
    (2, 16), (5, 17),
)

#: PAF channel pair (x_channel, y_channel) for each decoder limb
#: (reference lib/pafprocess/pafprocess.h:16-19 `COCOPAIRS_NET`).
COCO_PAIRS_NET = (
    (12, 13), (20, 21), (14, 15), (16, 17), (22, 23), (24, 25), (0, 1),
    (2, 3), (4, 5), (6, 7), (8, 9), (10, 11), (28, 29), (30, 31), (34, 35),
    (32, 33), (36, 37), (18, 19), (26, 27),
)

#: Only the first 17 limbs are drawn (reference lib/utils/common.py:36).
COCO_PAIRS_RENDER = COCO_PAIRS[:-2]

#: Per-part BGR drawing colors (reference lib/utils/common.py:32-34).
COCO_COLORS = (
    (255, 0, 0), (255, 85, 0), (255, 170, 0), (255, 255, 0), (170, 255, 0),
    (85, 255, 0), (0, 255, 0), (0, 255, 85), (0, 255, 170), (0, 255, 255),
    (0, 170, 255), (0, 85, 255), (0, 0, 255), (85, 0, 255), (170, 0, 255),
    (255, 0, 255), (255, 0, 170), (255, 0, 85),
)

#: Training-time limb list: the PAF target for channel pair (2i, 2i+1) is
#: the limb LIMB_IDS[i] (reference lib/datasets/datasets.py:14-36
#: `kp_connections` evaluated on the 18-keypoint name list).
#:
#: NOTE an inherited quirk: training rasterizes shoulder->eye fields
#: ((2, 14) and (5, 15)) into PAF channels 18-19 / 26-27, but the decoder
#: reads those same channels for the shoulder->ear pairs ((2, 16), (5, 17)
#: via COCO_PAIRS_NET). Both sides are reproduced verbatim for parity.
LIMB_IDS = (
    (1, 8), (8, 9), (9, 10), (1, 11), (11, 12), (12, 13), (1, 2), (2, 3),
    (3, 4), (2, 14), (1, 5), (5, 6), (6, 7), (5, 15), (1, 0), (0, 14),
    (0, 15), (14, 16), (15, 17),
)

#: COCO left/right swap as index pairs into COCO_KEYPOINTS
#: (reference lib/datasets/skleton.py:24-41 `HFLIP`).
HFLIP_COCO_SWAP = tuple(
    COCO_KEYPOINTS.index(
        name.replace("left_", "X_").replace("right_", "left_").replace("X_", "right_")
    )
    if name != "nose"
    else 0
    for name in COCO_KEYPOINTS
)

#: Left/right swap for the INTERNAL 18-keypoint order (same rule as
#: HFLIP_COCO_SWAP, applied to `KEYPOINTS`; nose and neck map to
#: themselves). Used by the on-device flip augmentation
#: (data/device_aug.py).
HFLIP_SWAP_INTERNAL = tuple(
    KEYPOINTS.index(
        name.replace("left_", "X_").replace("right_", "left_")
        .replace("X_", "right_")
    )
    if name not in ("nose", "neck")
    else KEYPOINTS.index(name)
    for name in KEYPOINTS
)

#: OKS per-keypoint falloff, COCO order
#: (reference lib/datasets/skleton.py:43-61 `COCO_PERSON_SIGMAS`).
COCO_PERSON_SIGMAS = (
    0.026, 0.025, 0.025, 0.035, 0.035, 0.079, 0.079, 0.072, 0.072,
    0.062, 0.062, 0.107, 0.107, 0.087, 0.087, 0.089, 0.089,
)

# ---------------------------------------------------------------------------
# Decode thresholds. The reference keeps these in two silently-diverging
# places; we reconcile them here and document which side each value is from.
# ---------------------------------------------------------------------------

#: Heatmap peak threshold used by Python NMS
#: (reference lib/config/default.py:23 cfg.TEST.THRESH_HEATMAP).
THRESH_HEATMAP = 0.15

#: Per-sample PAF dot-product threshold
#: (reference lib/pafprocess/pafprocess.h:7 THRESH_VECTOR_SCORE and
#: lib/config/default.py:24 cfg.TEST.THRESH_PAF — both 0.05).
THRESH_VECTOR_SCORE = 0.05

#: A candidate needs strictly more than this many of the STEP_PAF samples
#: above THRESH_VECTOR_SCORE (reference pafprocess.h:8 THRESH_VECTOR_CNT1).
THRESH_VECTOR_CNT1 = 6

#: Persons with fewer parts than this are dropped
#: (reference pafprocess.h:9 THRESH_PART_CNT; pafprocess.cpp:189 uses `<`).
THRESH_PART_CNT = 4

#: Persons with mean part score below this are dropped
#: (reference pafprocess.h:10 THRESH_HUMAN_SCORE).
THRESH_HUMAN_SCORE = 0.3

#: Number of line-integral samples per candidate limb
#: (reference pafprocess.h:13 STEP_PAF and
#: lib/config/default.py:25 NUM_INTERMED_PTS_BETWEEN_KEYPOINTS — both 10).
STEP_PAF = 10

#: Model output stride (reference lib/config/default.py:18 cfg.MODEL.DOWNSAMPLE).
DOWNSAMPLE = 8

#: Gaussian sigma for heatmap targets (reference lib/datasets/datasets.py:259).
TARGET_SIGMA = 7.0

#: Gaussian cutoff: exp(-4.6052) ~= 1% (reference lib/datasets/heatmap.py:28).
TARGET_GAUSSIAN_CUTOFF = 4.6052

#: PAF corridor half-width in grid units (reference lib/datasets/paf.py:16).
TARGET_PAF_THRE = 1.0

#: ImageNet normalization used by the vgg preprocess
#: (reference lib/datasets/preprocessing.py:34-36).
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

#: Inference pad fill color, RGB (reference lib/datasets/transforms.py:366 CenterPad).
PAD_FILL_RGB = (124, 116, 104)


def coco_to_internal_keypoints(coco_kpts: np.ndarray) -> np.ndarray:
    """Convert COCO [..., 17, 3] keypoints to internal [..., 18, 3] order.

    Synthesizes the neck as the shoulder midpoint, with visibility 2 only if
    both shoulders are visibility 2, else the product of the two visibility
    flags; the stacked row is rounded before reordering. Mirrors reference
    lib/datasets/datasets.py:209-229 (`add_neck`) including the `np.round`
    of the neck row only.
    """
    coco_kpts = np.asarray(coco_kpts, dtype=np.float64)
    l_sh = coco_kpts[..., COCO_KEYPOINTS.index("left_shoulder"), :]
    r_sh = coco_kpts[..., COCO_KEYPOINTS.index("right_shoulder"), :]
    neck = (l_sh + r_sh) / 2.0
    both_visible = (l_sh[..., 2] == 2) & (r_sh[..., 2] == 2)
    neck[..., 2] = np.where(both_visible, 2.0, l_sh[..., 2] * r_sh[..., 2])
    neck = np.round(neck)
    stacked = np.concatenate([coco_kpts, neck[..., None, :]], axis=-2)
    return stacked[..., list(OUR_ORDER), :]


def internal_to_coco_keypoints(internal_kpts: np.ndarray) -> np.ndarray:
    """Reorder internal [..., 18, k] keypoints to COCO [..., 17, k] order.

    Mirrors the `keypoints[ORDER_COCO, :]` remap at reference eval.py:118.
    """
    internal_kpts = np.asarray(internal_kpts)
    return internal_kpts[..., list(ORDER_COCO), :]
