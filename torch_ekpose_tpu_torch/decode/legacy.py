"""Legacy 7-limb pure-Python decoder.

The port's code-for-code copy of the JAX package's ``decode/legacy.py``
(numpy only; ``tests/test_torch_shared.py`` holds the two equal).

Functional equivalent of the reference's unused-but-shipped first-generation
decoder (reference lib/utils/paf_to_pose.py:136-343: ``find_connected_joints``,
``group_limbs_of_same_person``, ``paf_to_pose``). Differences from the
production decoder it predates:

- only 7 limb types, PAF channels 0..13 in order
  (paf_to_pose.py:16,22);
- samples the BICUBIC x8-upsampled PAF (not nearest) at rounded float peak
  coordinates (paf_to_pose.py:190-195,334);
- criterion1 asks for > 80% of samples above threshold
  (paf_to_pose.py:201-202);
- per-limb connection count capped at min(#src, #dst)
  (paf_to_pose.py:218,230);
- person filter: fewer than 3 parts or score/parts < 0.2
  (paf_to_pose.py:307-308).

Returns ``(joint_list, person_to_joint_assoc)`` exactly as the reference
does; kept for parity completeness and as a second decode oracle.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from torch_ekpose_tpu_torch.config import Config, cfg as default_cfg
from torch_ekpose_tpu_torch.decode.oracle import nms
from torch_ekpose_tpu_torch.ops.resize import resize_image_np

__all__ = ["JOINT_TO_LIMB", "paf_to_pose_legacy"]

#: (src part, dst part) for the 7 legacy limb types
#: (reference paf_to_pose.py:16).
JOINT_TO_LIMB = ((1, 2), (2, 3), (3, 4), (1, 5), (5, 6), (6, 7), (1, 0))


def _find_connected_joints(paf_upsamp, peaks_by_part, num_intermed_pts, cfg):
    connected = []
    h = paf_upsamp.shape[0]
    for limb_type, (src_type, dst_type) in enumerate(JOINT_TO_LIMB):
        joints_src = peaks_by_part[src_type]
        joints_dst = peaks_by_part[dst_type]
        if len(joints_src) == 0 or len(joints_dst) == 0:
            connected.append(np.empty((0, 5)))
            continue
        ch_x, ch_y = 2 * limb_type, 2 * limb_type + 1
        candidates = []
        for i, src in enumerate(joints_src):
            for j, dst in enumerate(joints_dst):
                limb_dir = dst[:2] - src[:2]
                limb_dist = np.sqrt(np.sum(limb_dir ** 2)) + 1e-8
                limb_dir = limb_dir / limb_dist
                xs = np.round(
                    np.linspace(src[0], dst[0], num=num_intermed_pts)
                ).astype(np.intp)
                ys = np.round(
                    np.linspace(src[1], dst[1], num=num_intermed_pts)
                ).astype(np.intp)
                xs = np.clip(xs, 0, paf_upsamp.shape[1] - 1)
                ys = np.clip(ys, 0, paf_upsamp.shape[0] - 1)
                vec = np.stack(
                    [paf_upsamp[ys, xs, ch_x], paf_upsamp[ys, xs, ch_y]],
                    axis=1,
                )
                scores = vec @ limb_dir
                penalized = scores.mean() + min(
                    0.5 * h / limb_dist - 1, 0
                )
                criterion1 = (
                    np.count_nonzero(scores > cfg.TEST.THRESH_PAF)
                    > 0.8 * num_intermed_pts
                )
                if criterion1 and penalized > 0:
                    candidates.append(
                        (i, j, penalized,
                         penalized + src[2] + dst[2])
                    )
        candidates.sort(key=lambda c: c[2], reverse=True)
        connections = []
        used_i, used_j = set(), set()
        max_connections = min(len(joints_src), len(joints_dst))
        for i, j, s, _ in candidates:
            if i in used_i or j in used_j:
                continue
            connections.append(
                (joints_src[i][3], joints_dst[j][3], s, i, j)
            )
            used_i.add(i)
            used_j.add(j)
            if len(connections) >= max_connections:
                break
        connected.append(np.asarray(connections, dtype=np.float64))
    return connected


def _group_limbs(connected, joint_list, cfg):
    num_kp = cfg.MODEL.NUM_KEYPOINTS
    people = []
    for limb_type, (src_type, dst_type) in enumerate(JOINT_TO_LIMB):
        for limb in connected[limb_type]:
            assoc = [
                idx for idx, row in enumerate(people)
                if row[src_type] == limb[0] or row[dst_type] == limb[1]
            ]
            if len(assoc) == 1:
                row = people[assoc[0]]
                if row[dst_type] != limb[1]:
                    row[dst_type] = limb[1]
                    row[-1] += 1
                    row[-2] += joint_list[int(limb[1]), 2] + limb[2]
            elif len(assoc) == 2:
                row1, row2 = people[assoc[0]], people[assoc[1]]
                membership = ((row1 >= 0) & (row2 >= 0))[:-2]
                if not membership.any():
                    row1[:-2] += row2[:-2] + 1
                    row1[-2:] += row2[-2:]
                    row1[-2] += limb[2]
                    people.pop(assoc[1])
                else:
                    row1[dst_type] = limb[1]
                    row1[-1] += 1
                    row1[-2] += joint_list[int(limb[1]), 2] + limb[2]
            else:
                row = -1.0 * np.ones(num_kp + 2)
                row[src_type] = limb[0]
                row[dst_type] = limb[1]
                row[-1] = 2
                row[-2] = joint_list[
                    limb[:2].astype(int), 2
                ].sum() + limb[2]
                people.append(row)

    people = [
        row for row in people
        if not (row[-1] < 3 or row[-2] / row[-1] < 0.2)
    ]
    return np.asarray(people) if people else np.zeros((0, num_kp + 2))


def paf_to_pose_legacy(
    heatmaps: np.ndarray,
    pafs: np.ndarray,
    config: Optional[Config] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """[H, W, 19] heatmaps + [H, W, 38] PAFs -> (joint_list [P, 5],
    person rows [M, 20]) with the legacy 7-limb pipeline
    (reference paf_to_pose.py:322-343)."""
    config = config or default_cfg
    stride = config.MODEL.DOWNSAMPLE
    peaks_by_part = nms(
        heatmaps, config.TEST.THRESH_HEATMAP, stride,
        config.MODEL.NUM_KEYPOINTS,
    )
    joint_list = np.array([
        tuple(peak) + (joint_type,)
        for joint_type, peaks in enumerate(peaks_by_part)
        for peak in peaks
    ]) if any(len(p) for p in peaks_by_part) else np.zeros((0, 5))

    paf_up = resize_image_np(
        pafs, pafs.shape[0] * stride, pafs.shape[1] * stride, "cubic"
    )
    connected = _find_connected_joints(
        paf_up, peaks_by_part,
        config.TEST.NUM_INTERMED_PTS_BETWEEN_KEYPOINTS, config,
    )
    people = _group_limbs(connected, joint_list, config)
    return joint_list, people
