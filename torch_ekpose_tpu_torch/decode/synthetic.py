"""Synthetic multi-person heatmap/PAF scenes with exactly-known structure
(a copy of the JAX package's ``decode/synthetic.py``;
``tests/test_torch_shared.py`` holds the code equal). The scenes exercise
the full decoder: multiple overlapping people, every limb painted as a
unit-vector corridor (the layout the reference's C++ assembler consumes,
reference lib/pafprocess/pafprocess.cpp:22-194). The port's AOT tests
give them to the exported decode program."""

from __future__ import annotations

import numpy as np

from torch_ekpose_tpu_torch import constants

__all__ = ["synth_scene", "canonical_humans"]


def synth_scene(rng: np.random.Generator, n_people: int, h: int = 46,
                w: int = 54):
    """(heatmaps [h,w,19], pafs [h,w,38]) for ``n_people`` clustered
    people: per-joint gaussians (sigma 1.5) and unit-vector limb
    corridors of half-width 1.5."""
    ht = np.zeros((h, w, 19), np.float32)
    paf = np.zeros((h, w, 38), np.float32)
    people = []
    for _ in range(n_people):
        cx, cy = rng.uniform(8, w - 8), rng.uniform(8, h - 8)
        kps = {}
        for j in range(18):
            x = np.clip(cx + rng.normal(0, 4), 1, w - 2)
            y = np.clip(cy + rng.normal(0, 4), 1, h - 2)
            kps[j] = (x, y)
        people.append(kps)
    yy, xx = np.mgrid[0:h, 0:w]
    for kps in people:
        for j, (x, y) in kps.items():
            g = np.exp(-((xx - x) ** 2 + (yy - y) ** 2) / (2 * 1.5 ** 2))
            ht[:, :, j] = np.maximum(ht[:, :, j], g)
        for li, (p1, p2) in enumerate(constants.COCO_PAIRS):
            x1, y1 = kps[p1]
            x2, y2 = kps[p2]
            dx, dy = x2 - x1, y2 - y1
            n = np.hypot(dx, dy)
            if n < 1e-6:
                continue
            ux, uy = dx / n, dy / n
            d = np.abs((xx - x1) * uy - (yy - y1) * ux)
            along = (xx - x1) * ux + (yy - y1) * uy
            m = (d < 1.5) & (along > -1) & (along < n + 1)
            cx_ch, cy_ch = constants.COCO_PAIRS_NET[li]
            paf[:, :, cx_ch] = np.where(m, ux, paf[:, :, cx_ch])
            paf[:, :, cy_ch] = np.where(m, uy, paf[:, :, cy_ch])
    ht[:, :, 18] = np.clip(1 - ht[:, :, :18].max(-1), 0, 1)
    return ht, paf


def canonical_humans(humans):
    """Order-independent canonical form for exact human-list comparison."""
    return sorted(
        sorted((p, round(bp.x, 4), round(bp.y, 4))
               for p, bp in h.body_parts.items())
        for h in humans
    )
