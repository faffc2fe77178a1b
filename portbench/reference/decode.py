"""Plain reference of the port's decode: peaks, and people from peaks.

Written from the decode's documented semantics (the reference
repository's ``lib/pafprocess/pafprocess.{h,cpp}`` thresholds and
assembly, with the fixed-capacity device decoder's rules: K peaks a part,
an edge-replicated 5x5 refinement patch, greedy one-to-one matching with
ties to the lowest row, then column, and a person table of ``cap`` rows):

- :func:`find_peaks`: 4-neighbour local maxima above ``THRESH_HEATMAP``,
  the K best of each part (equal scores: the lower flat index first), each
  refined by the x8 bicubic (Keys, A = -0.75) upsample of its 5x5 patch
  and truncated to an integer pixel of the input frame;
- :func:`assemble`: one frame's people from its peaks and PAF maps: the
  10-sample line integral of every candidate limb, greedy matching, the
  sequential person merge, the part-count and score filters. It computes
  in float32 in the order the device decode does, so that from the same
  peaks and PAF values it gives the same people, bit for bit;
- :func:`people_from_table`: a person table's rows as people (the
  conversion of the decode's packed result to ``Human``s).

Runs on the CPU in plain torch and numpy.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

__all__ = ["CAP", "K", "LIMB_CHANNELS", "LIMB_PARTS", "assemble",
           "bicubic_matrix", "find_peaks", "neighbour_max",
           "people_from_table"]

# the reference repository's pafprocess.h / default.py values
THRESH_HEATMAP = 0.15
THRESH_PAF = 0.05
THRESH_CNT1 = 6
THRESH_PART_CNT = 4.0
THRESH_HUMAN_SCORE = 0.3
N_STEPS = 10
STRIDE = 8
N_PARTS = 18
#: the decode's capacities: peaks a part, person rows (3 x 32 people)
K = 32
CAP = 96
#: COCO limbs as (part a, part b) and their PAF (x, y) channels
LIMB_PARTS = np.array(
    [(1, 2), (1, 5), (2, 3), (3, 4), (5, 6), (6, 7), (1, 8), (8, 9),
     (9, 10), (1, 11), (11, 12), (12, 13), (1, 0), (0, 14), (14, 16),
     (0, 15), (15, 17), (2, 16), (5, 17)], dtype=np.int64)
LIMB_CHANNELS = np.array(
    [(12, 13), (20, 21), (14, 15), (16, 17), (22, 23), (24, 25), (0, 1),
     (2, 3), (4, 5), (6, 7), (8, 9), (10, 11), (28, 29), (30, 31),
     (34, 35), (32, 33), (36, 37), (18, 19), (26, 27)], dtype=np.int64)

_F32 = np.float32
_PATCH = 5


def _keys(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    t = np.abs(t)
    return np.where(
        t <= 1.0, (a + 2.0) * t ** 3 - (a + 3.0) * t ** 2 + 1.0,
        np.where(t < 2.0, a * t ** 3 - 5.0 * a * t ** 2 + 8.0 * a * t
                 - 4.0 * a, 0.0))


def bicubic_matrix(src: int = _PATCH, factor: int = STRIDE) -> np.ndarray:
    """``[src * factor, src]`` float64 bicubic resampling matrix
    (half-pixel centres, edge-clamped taps)."""
    dst = src * factor
    s = (np.arange(dst) + 0.5) / factor - 0.5
    base = np.floor(s).astype(np.int64)
    mat = np.zeros((dst, src))
    for k in (-1, 0, 1, 2):
        np.add.at(mat, (np.arange(dst), np.clip(base + k, 0, src - 1)),
                  _keys(s - base - k))
    return mat


def neighbour_max(x: torch.Tensor) -> torch.Tensor:
    """The largest of each cell's 4 neighbours (-inf beyond the border)."""
    pad = torch.nn.functional.pad(x, (1, 1, 1, 1), value=float("-inf"))
    return torch.maximum(torch.maximum(pad[..., :-2, 1:-1], pad[..., 2:, 1:-1]),
                         torch.maximum(pad[..., 1:-1, :-2], pad[..., 1:-1, 2:]))


def find_peaks(heat: torch.Tensor) -> Tuple[np.ndarray, np.ndarray,
                                            np.ndarray]:
    """``[B, >=18, H, W]`` float32 heatmaps -> (xy ``[B, 18 K, 2]`` int,
    score ``[B, 18 K]`` float, valid ``[B, 18 K]`` bool): each part's K
    slots in descending score order, coordinates in input-frame pixels."""
    hm = heat[:, :N_PARTS].float().cpu()
    b, n, h, w = hm.shape
    peak = (hm >= neighbour_max(hm)) & (hm > THRESH_HEATMAP)
    masked = torch.where(peak, hm, torch.full_like(hm, float("-inf")))
    score, idx = torch.sort(masked.reshape(b, n, h * w), dim=-1,
                            descending=True, stable=True)
    score, idx = score[..., :K].numpy(), idx[..., :K].numpy()
    px, py = idx % w, idx // w
    offs = np.arange(-2, 3)
    gy = np.clip(py[..., None] + offs, 0, h - 1)
    gx = np.clip(px[..., None] + offs, 0, w - 1)
    flat = hm.reshape(b, n, h * w).double().numpy()
    patch = np.take_along_axis(
        flat, (gy[..., :, None] * w + gx[..., None, :]).reshape(b, n, -1),
        axis=2).reshape(b, n, K, _PATCH, _PATCH)
    up_mat = bicubic_matrix()
    up = np.einsum("ia,znkab,jb->znkij", up_mat, patch, up_mat)
    side = up.shape[-1]
    am = up.reshape(b, n, K, -1).argmax(-1)
    iy, ix = am // side, am % side
    cx = (np.minimum(px, 2) + 0.5) * STRIDE - 0.5
    cy = (np.minimum(py, 2) + 0.5) * STRIDE - 0.5
    x = np.trunc((px + 0.5) * STRIDE - 0.5 + (ix - cx)).astype(np.int64)
    y = np.trunc((py + 0.5) * STRIDE - 0.5 + (iy - cy)).astype(np.int64)
    refined = np.take_along_axis(up.reshape(b, n, K, -1), am[..., None],
                                 axis=-1)[..., 0]
    valid = score > -np.inf
    return (np.stack([x, y], -1).reshape(b, n * K, 2),
            np.where(valid, refined, 0.0).reshape(b, n * K),
            valid.reshape(b, n * K))


def _limb_scores(xy, valid, paf, h: int, w: int) -> np.ndarray:
    """[19, K, K] float32 candidate scores, -inf where a limb fails."""
    xi = xy[:, 0].reshape(N_PARTS, K)
    yi = xy[:, 1].reshape(N_PARTS, K)
    v = valid.reshape(N_PARTS, K)
    ax, ay = xi[LIMB_PARTS[:, 0]].astype(_F32), yi[LIMB_PARTS[:, 0]].astype(_F32)
    bx, by = xi[LIMB_PARTS[:, 1]].astype(_F32), yi[LIMB_PARTS[:, 1]].astype(_F32)
    dx = bx[:, None, :] - ax[:, :, None]
    dy = by[:, None, :] - ay[:, :, None]
    norm = np.sqrt(dx * dx + dy * dy)
    ok = norm >= _F32(1e-12)
    safe = np.where(ok, norm, _F32(1.0))
    ux, uy = dx / safe, dy / safe
    steps = np.arange(N_STEPS, dtype=_F32)
    # the card divides by a scalar as a product with its float32 reciprocal
    inv = _F32(1.0) / _F32(N_STEPS)
    lx = np.floor(ax[:, :, None, None] + steps * dx[..., None] * inv
                  + _F32(0.5)).astype(np.int64)
    ly = np.floor(ay[:, :, None, None] + steps * dy[..., None] * inv
                  + _F32(0.5)).astype(np.int64)
    gx = np.clip(lx // STRIDE, 0, w - 1)
    gy = np.clip(ly // STRIDE, 0, h - 1)
    limb = np.arange(len(LIMB_PARTS))[:, None, None, None]
    vx = paf[LIMB_CHANNELS[:, 0]][limb, gy, gx]
    vy = paf[LIMB_CHANNELS[:, 1]][limb, gy, gx]
    # one rounding of the exact vx*ux + vy*uy sum (the decode's fma)
    dots = (vx.astype(np.float64) * ux[..., None].astype(np.float64)
            + (vy * uy[..., None]).astype(np.float64)).astype(_F32)
    above = (dots > _F32(THRESH_PAF)).sum(-1)
    total = dots[..., 0]
    for s in range(1, N_STEPS):
        total = total + dots[..., s]
    mean = total * _F32(1.0 / N_STEPS)
    # ``c / t`` on a tensor is ``t.reciprocal() * c``
    penalty = np.minimum(
        np.reciprocal(safe) * _F32(0.5 * h * STRIDE) - _F32(1.0), _F32(0.0))
    score = mean + penalty
    good = (ok & (above > THRESH_CNT1) & (score > _F32(0.0))
            & v[LIMB_PARTS[:, 0]][:, :, None] & v[LIMB_PARTS[:, 1]][:, None, :])
    return np.where(good, score, _F32(-np.inf))


def _greedy_match(scores: np.ndarray):
    """One [K, K] matrix -> accepted (row, column, score), in order."""
    used_a = np.zeros(K, bool)
    used_b = np.zeros(K, bool)
    out = []
    for _ in range(K):
        masked = np.where(used_a[:, None] | used_b[None, :], -np.inf, scores)
        val = masked.max()
        if val == -np.inf:
            break
        a = int(np.argmax(masked.max(-1) == val))
        b = int(np.argmax(masked[a] == val))
        used_a[a] = used_b[b] = True
        out.append((a, b, masked[a, b]))
    return out


def assemble(xy: np.ndarray, score: np.ndarray, valid: np.ndarray,
             paf: np.ndarray, frame_h: int, frame_w: int) -> List[tuple]:
    """One frame's people from its peaks (``xy [18 K, 2]`` integer pixels,
    ``score [18 K]`` float32, ``valid [18 K]``) and float32 PAF maps
    ``[38, H, W]``. Each person is ``(score, ((part, x, y, part score),
    ...))``, x and y as fractions of the frame, in the person table's row
    order."""
    h, w = paf.shape[1:]
    score = np.asarray(score, dtype=_F32)
    limbs = _limb_scores(np.asarray(xy, np.int64), np.asarray(valid, bool),
                         np.asarray(paf, _F32), h, w)
    conns = []                     # limb-major, each limb in match order
    for limb in range(len(LIMB_PARTS)):
        a_part, b_part = LIMB_PARTS[limb]
        for a, b, s in _greedy_match(limbs[limb]):
            conns.append((limb, a_part * K + a, b_part * K + b, _F32(s)))
    subset = np.full((CAP, 20), -1.0, dtype=_F32)
    active = np.zeros(CAP, bool)
    n_rows = 0
    for limb, c1, c2, sc in conns:
        a_part, b_part = LIMB_PARTS[limb]
        f1, f2 = _F32(c1), _F32(c2)
        hits = np.nonzero(active & ((subset[:, a_part] == f1)
                                    | (subset[:, b_part] == f2)))[0]
        if len(hits) == 1:
            row = subset[hits[0]]
            if row[b_part] != f2:
                row[18] = row[18] + (score[c2] + sc)
                row[19] = row[19] + _F32(1.0)
                row[b_part] = f2
        elif len(hits) == 2:
            row1, row2 = subset[hits[0]], subset[hits[1]]
            if ((row1[:N_PARTS] > 0) & (row2[:N_PARTS] > 0)).any():
                row1[18] = row1[18] + (score[c2] + sc)
                row1[19] = row1[19] + _F32(1.0)
                row1[b_part] = f2
            else:
                row1[:N_PARTS] = row1[:N_PARTS] + (row2[:N_PARTS] + _F32(1.0))
                row1[18] = row1[18] + (row2[18] + sc)
                row1[19] = row1[19] + row2[19]
                active[hits[1]] = False
        elif not len(hits) and limb < N_PARTS and n_rows < CAP:
            fresh = subset[n_rows]
            fresh[a_part], fresh[b_part] = f1, f2
            fresh[18] = (score[c1] + score[c2]) + sc
            fresh[19] = _F32(2.0)
            active[n_rows] = True
            n_rows += 1
    counts, totals = subset[:, 19], subset[:, 18]
    keep = (active & (counts >= _F32(THRESH_PART_CNT))
            & (totals / np.maximum(counts, _F32(1.0))
               >= _F32(THRESH_HUMAN_SCORE)))
    return people_from_table(subset, keep, xy, score, frame_h, frame_w)


def people_from_table(subset: np.ndarray, keep: np.ndarray, xy: np.ndarray,
                      score: np.ndarray, frame_h: int,
                      frame_w: int) -> List[tuple]:
    """The people of a person table (``subset [CAP, 20]`` float32 rows:
    18 flat peak indices, -1 where a part is missing, the score total and
    the part count; ``keep [CAP]`` the rows to serve) over its frame's
    peaks, as :func:`assemble` gives them."""
    score = np.asarray(score, dtype=_F32)
    people = []
    for row in np.asarray(subset, dtype=_F32)[np.nonzero(keep)[0]]:
        parts = tuple(
            (p, float(xy[int(row[p]), 0]) / frame_w,
             float(xy[int(row[p]), 1]) / frame_h, float(score[int(row[p])]))
            for p in range(N_PARTS) if int(row[p]) >= 0)
        if parts:
            people.append((float(row[18] / row[19]), parts))
    return people
