"""The numpy pose decoder: the host decode's oracle backend.

The port's own copy of the JAX package's ``decode/oracle.py``, code for
code (``tests/test_torch_shared.py`` holds the two syntax trees equal),
so ``decode/api.py``'s ``"numpy"`` backend gives the JAX package's people
on the same maps. It is the reference's decode pipeline in pure numpy:

- peak NMS with the 4-neighbour (cross) local-max test and sub-pixel
  refinement of a x8 bicubic-upsampled 5x5 patch clipped at the map
  border (reference lib/utils/paf_to_pose.py:26-133);
- peak coordinates truncated to int for the assembler
  (reference lib/pafprocess/pafprocess.h:26-31);
- the all-pairs 10-sample PAF line integral on the stride-8 nearest
  upsample, read through integer division (pafprocess.cpp:220-242), in
  float32 step by step as the reference C++ computes it;
- score-descending greedy 1:1 matching per limb and the sequential
  person-row merge with the reference's quirks: the found==1 branch never
  fills the src slot, the disjointness test treats cid 0 as absent, rows
  with 3+ matches drop the connection, the last limb may not open a row
  (pafprocess.cpp:96-185);
- the final filter on part count and mean score (pafprocess.cpp:187-191).

It keeps every peak a part has: no cap on peaks or people, unlike the
fixed-shape device decode (``decode/device.py``). Line-integral samples
outside the map (a border peak refined past the edge) are clamped.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from torch_ekpose_tpu_torch import constants
from torch_ekpose_tpu_torch.config import Config, cfg as default_cfg
from torch_ekpose_tpu_torch.ops.resize import resize_image_np
from torch_ekpose_tpu_torch.utils.human import BodyPart, Human

__all__ = [
    "find_peaks",
    "nms",
    "decode",
    "humans_from_decode",
    "paf_to_pose_numpy",
]

_WIN = 2  # refinement patch half-width (reference paf_to_pose.py:92)


def find_peaks(map2d: np.ndarray, thresh: float) -> np.ndarray:
    """Local maxima of a 2D map under the 4-neighbor (cross) footprint.

    Returns [N, 2] int (x, y) in row-major scan order, matching
    ``np.nonzero`` on the reference's maximum_filter mask
    (reference paf_to_pose.py:26-36).
    """
    h, w = map2d.shape
    padded = np.full((h + 2, w + 2), -np.inf, dtype=map2d.dtype)
    padded[1:-1, 1:-1] = map2d
    neigh_max = np.maximum.reduce([
        padded[0:-2, 1:-1],  # up
        padded[2:, 1:-1],    # down
        padded[1:-1, 0:-2],  # left
        padded[1:-1, 2:],    # right
    ])
    is_peak = (map2d >= neigh_max) & (map2d > thresh)
    ys, xs = np.nonzero(is_peak)
    return np.stack([xs, ys], axis=1).astype(np.int64)


def _refine_peak(
    map2d: np.ndarray, px: int, py: int, upsamp: int
) -> Tuple[float, float, float]:
    """Sub-pixel refinement of one peak (reference paf_to_pose.py:94-131):
    bicubic x``upsamp`` a 5x5 patch, take the argmax offset from the patch
    center. Returns refined (x, y, score) in upsampled coordinates."""
    h, w = map2d.shape
    x_min, y_min = max(0, px - _WIN), max(0, py - _WIN)
    x_max, y_max = min(w - 1, px + _WIN), min(h - 1, py + _WIN)
    patch = map2d[y_min:y_max + 1, x_min:x_max + 1]
    up = resize_image_np(
        patch, patch.shape[0] * upsamp, patch.shape[1] * upsamp, "cubic"
    )
    iy, ix = np.unravel_index(int(np.argmax(up)), up.shape)
    cx = ((px - x_min) + 0.5) * upsamp - 0.5
    cy = ((py - y_min) + 0.5) * upsamp - 0.5
    x = (px + 0.5) * upsamp - 0.5 + (ix - cx)
    y = (py + 0.5) * upsamp - 0.5 + (iy - cy)
    return float(x), float(y), float(up[iy, ix])


def nms(
    heatmaps: np.ndarray,
    thresh: float,
    upsamp: int,
    num_parts: int = constants.NUM_KEYPOINTS,
    refine: bool = True,
) -> List[np.ndarray]:
    """Per-part peak lists. ``heatmaps`` is [H, W, >=num_parts].

    Returns a list of [N_j, 4] arrays (x, y, score, global_id) with
    coordinates in the x``upsamp`` frame (reference paf_to_pose.py:60-133).
    """
    out = []
    gid = 0
    for j in range(num_parts):
        map2d = np.asarray(heatmaps[:, :, j], dtype=np.float32)
        coords = find_peaks(map2d, thresh)
        peaks = np.zeros((len(coords), 4), dtype=np.float64)
        for i, (px, py) in enumerate(coords):
            if refine:
                x, y, score = _refine_peak(map2d, int(px), int(py), upsamp)
            else:
                x = (px + 0.5) * upsamp - 0.5
                y = (py + 0.5) * upsamp - 0.5
                score = float(map2d[py, px])
            peaks[i] = (x, y, score, gid)
            gid += 1
        out.append(peaks)
    return out


def _line_integral_scores(
    pafs: np.ndarray, ax: int, ay: int, bx: int, by: int,
    ch_x: int, ch_y: int, stride: int, n_steps: int,
) -> np.ndarray:
    """Dot products of the unit limb direction with the PAF at ``n_steps``
    samples from (ax, ay) to (bx, by), all in upsampled int coordinates.
    Sampling the x``stride`` nearest-upsampled PAF at location L equals
    indexing the low-res PAF at L // stride.

    All arithmetic is float32, mirroring the reference C++ step by step
    (pafprocess.cpp:56-83, 220-242): near-tie candidate scores otherwise
    sort differently than the reference's, reordering person rows.
    """
    h, w = pafs.shape[:2]
    f32 = np.float32
    dx, dy = f32(bx - ax), f32(by - ay)
    # vec.x*vec.x + vec.y*vec.y is exact for int coords < 2^12; sqrtf is
    # correctly rounded in both C and numpy
    norm = np.sqrt(f32((bx - ax) * (bx - ax) + (by - ay) * (by - ay)))
    ux, uy = dx / norm, dy / norm
    i = np.arange(n_steps, dtype=f32)
    step_x = dx / f32(n_steps)                  # (peak2.x-peak1.x)/float(n)
    step_y = dy / f32(n_steps)
    # roundpaf(v) = (int)(v + 0.5) with v float, 0.5 double (pafprocess
    # .cpp:240-242); positions are non-negative so trunc == floor
    lx = (np.float64(f32(ax) + i * step_x) + 0.5).astype(np.int64)
    ly = (np.float64(f32(ay) + i * step_y) + 0.5).astype(np.int64)
    gx = np.clip(lx // stride, 0, w - 1)
    gy = np.clip(ly // stride, 0, h - 1)
    px = np.asarray(pafs, dtype=f32)[gy, gx, ch_x]
    py = np.asarray(pafs, dtype=f32)[gy, gx, ch_y]
    return px * ux + py * uy                    # f32 per-sample dots


def decode(
    heatmaps: np.ndarray,
    pafs: np.ndarray,
    config: Optional[Config] = None,
    peaks_by_part: Optional[List[np.ndarray]] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Full decode of one image's [H, W, 19] heatmaps + [H, W, 38] PAFs.

    Returns ``(peaks_flat, subset)``:

    - ``peaks_flat`` [P, 5]: truncated-int x, y (upsampled frame), score,
      global id, part id — the assembler's view of the peak list.
    - ``subset`` [M, 20]: per person 18 part global-ids (-1 = absent),
      total score, part count.
    """
    config = config or default_cfg
    stride = config.MODEL.DOWNSAMPLE
    n_steps = config.TEST.NUM_INTERMED_PTS_BETWEEN_KEYPOINTS

    if peaks_by_part is None:
        peaks_by_part = nms(
            heatmaps, config.TEST.THRESH_HEATMAP, stride,
            config.MODEL.NUM_KEYPOINTS,
        )

    # Truncate coordinates to int, as the reference assembler stores them.
    peaks_int = [
        np.concatenate(
            [p[:, :2].astype(np.int64).astype(np.float64), p[:, 2:]], axis=1
        ) if len(p) else p.reshape(0, 4)
        for p in peaks_by_part
    ]
    flat_rows = []
    for part_id, plist in enumerate(peaks_int):
        for row in plist:
            flat_rows.append([row[0], row[1], row[2], row[3], part_id])
    peaks_flat = (
        np.array(flat_rows, dtype=np.float64)
        if flat_rows else np.zeros((0, 5), dtype=np.float64)
    )

    up_h = heatmaps.shape[0] * stride
    pafs = np.asarray(pafs, dtype=np.float32)

    # ---- per-limb candidate scoring + greedy matching ----
    connections_per_pair = []
    for pair_id in range(constants.NUM_LIMBS):
        part_a, part_b = constants.COCO_PAIRS[pair_id]
        ch_x, ch_y = constants.COCO_PAIRS_NET[pair_id]
        peaks_a, peaks_b = peaks_int[part_a], peaks_int[part_b]
        candidates = []
        for ia, pa in enumerate(peaks_a):
            for ib, pb in enumerate(peaks_b):
                ax, ay = int(pa[0]), int(pa[1])
                bx, by = int(pb[0]), int(pb[1])
                norm = float(np.hypot(bx - ax, by - ay))
                if norm < 1e-12:
                    continue
                dots = _line_integral_scores(
                    pafs, ax, ay, bx, by, ch_x, ch_y, stride, n_steps
                )
                criterion1 = int(
                    np.count_nonzero(dots > np.float32(config.TEST.THRESH_PAF))
                )
                # sequential f32 accumulation, then f32 / int division, then
                # the double min-term, narrowed back to f32 — the reference's
                # exact expression tree (pafprocess.cpp:72-83: `scores +=
                # score; ... scores / STEP_PAF + min(...)` into a float)
                acc = np.float32(0.0)
                for d in dots:
                    acc += d
                norm32 = np.sqrt(np.float32(
                    (bx - ax) * (bx - ax) + (by - ay) * (by - ay)
                ))
                score = float(np.float32(
                    np.float64(acc / np.float32(n_steps))
                    + min(0.0, 0.5 * up_h / float(norm32) - 1.0)
                ))
                if criterion1 > config.TEST.THRESH_VECTOR_CNT1 and score > 0:
                    candidates.append((score, ia, ib))
        candidates.sort(key=lambda c: c[0], reverse=True)
        conns = []  # (cid_a, cid_b, score, ia, ib)
        used_a, used_b = set(), set()
        for score, ia, ib in candidates:
            if ia in used_a or ib in used_b:
                continue
            used_a.add(ia)
            used_b.add(ib)
            conns.append(
                (int(peaks_a[ia][3]), int(peaks_b[ib][3]), score, ia, ib)
            )
        connections_per_pair.append(conns)

    # ---- sequential person-row merging ----
    subset: List[np.ndarray] = []
    peak_score_by_gid = {int(r[3]): float(r[2]) for r in peaks_flat}
    for pair_id in range(constants.NUM_LIMBS):
        p1, p2 = constants.COCO_PAIRS[pair_id]
        for cid1, cid2, score, _, _ in connections_per_pair[pair_id]:
            matches = [
                si for si, row in enumerate(subset)
                if row[p1] == cid1 or row[p2] == cid2
            ]
            # three or more matches leave the connection unassigned, as in
            # the reference (only the first two matches are recorded there)
            found = len(matches)
            if found == 1:
                row = subset[matches[0]]
                if row[p2] != cid2:
                    row[p2] = cid2
                    row[19] += 1
                    row[18] += peak_score_by_gid[cid2] + score
            elif found == 2:
                row1, row2 = subset[matches[0]], subset[matches[1]]
                disjoint = not np.any((row1[:18] > 0) & (row2[:18] > 0))
                if disjoint:
                    row1[:18] += row2[:18] + 1
                    row1[18] += row2[18] + score
                    row1[19] += row2[19]
                    subset.pop(matches[1])
                else:
                    row1[p2] = cid2
                    row1[19] += 1
                    row1[18] += peak_score_by_gid[cid2] + score
            elif found == 0 and pair_id < 18:
                row = -1.0 * np.ones(20)
                row[p1] = cid1
                row[p2] = cid2
                row[19] = 2
                row[18] = (
                    peak_score_by_gid[cid1] + peak_score_by_gid[cid2] + score
                )
                subset.append(row)
            # found > 2: dropped, as in the reference

    subset = [
        row for row in subset
        if not (
            row[19] < config.TEST.THRESH_PART_CNT
            or row[18] / row[19] < config.TEST.THRESH_HUMAN_SCORE
        )
    ]
    subset_arr = (
        np.stack(subset) if subset else np.zeros((0, 20), dtype=np.float64)
    )
    return peaks_flat, subset_arr


def humans_from_decode(
    peaks_flat: np.ndarray, subset: np.ndarray, up_h: int, up_w: int
) -> List[Human]:
    """Build Human objects from decode output, normalizing coordinates by
    the upsampled map size (reference paf_to_pose.py:361-378)."""
    humans = []
    for human_id, row in enumerate(subset):
        human = Human([])
        added = False
        for part_idx in range(constants.NUM_KEYPOINTS):
            cid = int(row[part_idx])
            if cid < 0:
                continue
            added = True
            peak = peaks_flat[cid]
            human.body_parts[part_idx] = BodyPart(
                "%d-%d" % (human_id, part_idx), part_idx,
                float(int(peak[0])) / up_w,
                float(int(peak[1])) / up_h,
                float(peak[2]),
            )
        if added:
            human.score = float(row[18] / row[19])
            humans.append(human)
    return humans


def paf_to_pose_numpy(
    heatmaps: np.ndarray, pafs: np.ndarray, config: Optional[Config] = None
) -> List[Human]:
    """End-to-end numpy decode: [H, W, 19] heatmaps + [H, W, 38] PAFs ->
    list of Humans (the oracle twin of reference paf_to_pose.py:346-380)."""
    config = config or default_cfg
    stride = config.MODEL.DOWNSAMPLE
    peaks_flat, subset = decode(heatmaps, pafs, config)
    return humans_from_decode(
        peaks_flat, subset, heatmaps.shape[0] * stride,
        heatmaps.shape[1] * stride,
    )
