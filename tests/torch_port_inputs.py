"""Seeded kernel inputs and the packed-buffer comparison that hold the
PyTorch port against its references.

Numpy only, so the same arrays can go to the JAX package's kernels, the
port's twins and the CUDA kernels. The CPU parity tests, the GPU tests
and ``chip_smoke.py`` (which loads this file by path) draw from here at
the decode path's shapes (NMS ``[8, 19, 46, 54]``, match
``[8, 19, 32, 32]``, merge B = 8, K = 32, cap = 96) or smaller. It
imports only the port, so it runs on a machine without JAX.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from torch_ekpose_tpu_torch.decode.device import LIMB_PAIRS

__all__ = ["match_scores", "merge_inputs", "nms_maps", "packed_mismatches"]


def nms_maps(rng: np.random.Generator, b: int, c: int, h: int,
             w: int) -> np.ndarray:
    """[B, C, H, W] float32 maps in [0, 1): smooth noise with quantized
    plateaus (equal neighbours) on about half of the cells."""
    smooth = rng.random((b, c, h, w), dtype=np.float32)
    steps = rng.integers(0, 8, (b, c, h, w)).astype(np.float32) / 8
    plateau = rng.random((b, c, h, w)) < 0.5
    return np.where(plateau, steps, smooth).astype(np.float32)


def match_scores(rng: np.random.Generator, b: int, k: int) -> np.ndarray:
    """[B, 19, K, K] float32 candidate scores: values from a 5-level set
    (exact ties), -inf at a random density per matrix (0 to 1, so some
    matrices are all -inf)."""
    vals = rng.integers(1, 6, (b, 19, k, k)).astype(np.float32) / 5
    density = rng.random((b, 19, 1, 1))
    invalid = rng.random((b, 19, k, k)) < density
    return np.where(invalid, -np.inf, vals).astype(np.float32)


def merge_inputs(rng: np.random.Generator, b: int, k: int,
                 max_per_limb: int) -> Dict[str, np.ndarray]:
    """Compacted connection tables for the person merge, as the decoder
    builds them: per limb up to ``max_per_limb`` accepted 1:1 matches
    with distinct peak indices, flattened pair-major and compacted
    valid-first (stable). Image 0 has no connection.

    Returns int32 ``pair, p1, p2, cid1, cid2`` and float32 ``score`` of
    shape [B, 19*K], int32 ``n_valid`` [B] and float32 ``peak_score``
    [B, 18*K].
    """
    pairs = np.asarray(LIMB_PAIRS)
    n = 19 * k
    out = {name: np.zeros((b, n), np.int32)
           for name in ("pair", "p1", "p2", "cid1", "cid2")}
    out["score"] = np.zeros((b, n), np.float32)
    out["n_valid"] = np.zeros(b, np.int32)
    out["peak_score"] = rng.uniform(0.1, 1.0, (b, 18 * k)).astype(np.float32)
    for bi in range(b):
        cid1 = np.zeros((19, k), np.int32)
        cid2 = np.zeros((19, k), np.int32)
        score = np.zeros((19, k), np.float32)
        valid = np.zeros((19, k), bool)
        for li, (p1, p2) in enumerate(pairs):
            m = 0 if bi == 0 else int(rng.integers(0, max_per_limb + 1))
            ia = rng.permutation(k)[:m]
            ib = rng.permutation(k)[:m]
            cid1[li, :m] = p1 * k + ia
            cid2[li, :m] = p2 * k + ib
            score[li, :m] = rng.uniform(0.1, 2.0, m)
            valid[li, :m] = True
        order = np.argsort(~valid.reshape(-1), kind="stable")
        pair = (order // k).astype(np.int32)
        out["pair"][bi] = pair
        out["p1"][bi] = pairs[pair, 0]
        out["p2"][bi] = pairs[pair, 1]
        out["cid1"][bi] = cid1.reshape(-1)[order]
        out["cid2"][bi] = cid2.reshape(-1)[order]
        out["score"][bi] = score.reshape(-1)[order]
        out["n_valid"][bi] = valid.sum()
    return out


def packed_mismatches(got: np.ndarray, want: np.ndarray, max_peaks: int,
                      subset_cap: int, rtol: float) -> list:
    """Differences between two packed decode buffers [B, L]: integer
    fields (peak coords and flags, person-table cids and counts, person
    flags) must be equal; the float fields (peak scores, person score
    sums) may differ by ``rtol``. Returns one message per differing
    field, empty when the buffers agree."""
    n = 18 * max_peaks
    bounds = np.cumsum([0, 2 * n, n, n, subset_cap * 20, subset_cap])
    names = ("peak_xy", "peak_score", "peak_valid", "subset", "person_valid")
    problems = []
    if got.shape != want.shape:
        return [f"shape {got.shape} != {want.shape}"]
    for name, lo, hi in zip(names, bounds[:-1], bounds[1:]):
        g, w = got[:, lo:hi], want[:, lo:hi]
        if name == "subset":
            g = g.reshape(len(g), subset_cap, 20)
            w = w.reshape(len(w), subset_cap, 20)
            is_float = np.zeros(20, bool)
            is_float[18] = True
        else:
            is_float = np.full(g.shape[1:], name == "peak_score")
        exact = ~np.broadcast_to(is_float, g.shape)
        if not np.array_equal(g[exact], w[exact]):
            problems.append(f"{name}: integer entries differ")
        fg, fw = g[~exact], w[~exact]
        if fg.size and not np.allclose(fg, fw, rtol=rtol, atol=0):
            err = np.max(np.abs(fg - fw) / np.maximum(np.abs(fw), 1e-30))
            problems.append(f"{name}: max relative error {err:.3g} > {rtol}")
    return problems
