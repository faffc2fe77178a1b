"""The algorithm of ``csrc/match.cu`` on the CPU: a plain numpy emulation
of the kernel's walk, held bit for bit against the JAX package's
``greedy_match_pallas`` in interpret mode.

The emulation follows the kernel, not the math: lane ``l`` of the one
warp owns the ``R = ceil(K / 32)`` rows ``l, l + 32, ...`` and caches each
row's masked max and its lowest column (a row with nothing above -inf is
dead, column -1). A round reduces an order-preserving 32-bit key of each
lane's best cached value to its max (the ``redux.sync``), takes the
lowest row holding it from ``R`` ballots read lowest ``j`` first, fetches
that row's column from its lane, kills the row, marks the column used in
lane ``col % 32``'s bit ``col // 32``, and rescans, ``j`` by ``j`` and
lane by lane, only the rows whose cached column it was: with each lane
holding the row's unused columns ``lane + 32 i``, the lowest column
still holding the old max, else one reduction for the new max and the
lowest column holding it. The inputs are
``torch_port_inputs.match_scores``: 5-level values (exact ties) and -inf
at a random density, some matrices all -inf. It catches a wrong
tie-break, invalidation or key before the kernel runs on a card; no path
of the port calls it.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from torch_ekpose_tpu.ops.pallas_match import greedy_match_pallas  # noqa: E402
import torch_port_inputs as inputs  # noqa: E402
from torch_ekpose_tpu_torch.ops import match  # noqa: E402

torch.set_num_threads(2)  # xdist already runs one process per core

LANES = 32
NEG = np.float32(-np.inf)


def order_key(v) -> np.ndarray:
    """The kernel's monotone float32 -> uint32 map (-0 as +0)."""
    u = np.atleast_1d(np.asarray(v, np.float32)).view(np.uint32).copy()
    u[u == 0x80000000] = 0
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)


def key_value(key) -> np.float32:
    key = np.uint32(key)
    u = key & np.uint32(0x7FFFFFFF) if key & np.uint32(0x80000000) else ~key
    return np.array([u], np.uint32).view(np.float32)[0]


NEG_KEY = order_key(NEG)[0]


def _lowest_hit(hit) -> int:
    """``lowest_hit``: the lowest ``lane + 32 j`` whose ``hit[lane, j]``
    holds, from one ballot per ``j`` read lowest ``j`` first; -1 if none."""
    for j in range(hit.shape[1]):
        if hit[:, j].any():
            return int(np.flatnonzero(hit[:, j])[0]) + LANES * j
    return -1


def _rescan(vals, old):
    """One rescan by the warp: ``vals[lane, i]`` is column ``lane + 32 i``
    of the row, -inf where used. The old max if a column still holds it
    (the lowest such), else one reduction for the new max and the lowest
    column holding it; (max, column, whether the max fell)."""
    at = _lowest_hit(vals == old)
    if at >= 0:
        return old, at, False
    m = order_key(vals.max(axis=1)).max()
    if m == NEG_KEY:
        return NEG, -1, True
    return key_value(m), _lowest_hit(vals == key_value(m)), True


def emulate_match(scores: np.ndarray):
    """One ``[K, K]`` matrix walked as ``greedy_match_kernel<R>`` walks it.
    Returns (ia, ib, score, valid, rounds, rescans, rescans whose max
    fell)."""
    k = scores.shape[0]
    r_own = -(-k // LANES)
    grid = np.arange(LANES)[:, None] + LANES * np.arange(r_own)[None, :]
    live = grid < k                        # rows, and columns, a lane owns
    safe = np.minimum(grid, k - 1)
    rmax = np.full((LANES, r_own), NEG, np.float32)
    rcol = np.full((LANES, r_own), -1, np.int64)
    for c in range(k):                     # the first scan: lowest column
        v = np.where(live, scores[safe, c], NEG)
        upd = v > rmax
        rmax[upd], rcol[upd] = v[upd], c
    col_used = np.zeros((LANES, r_own), bool)  # lane l, bit i: l + 32 i
    ia = np.full(k, -1, np.int32)
    ib = np.full(k, -1, np.int32)
    score = np.zeros(k, np.float32)
    valid = np.zeros(k, bool)
    rounds = rescans = fell = 0
    for t in range(k):
        rounds += 1
        best = order_key(rmax.max(axis=1)).max()
        if best == NEG_KEY:
            break
        bv = key_value(best)
        row = _lowest_hit(rmax == bv)
        owner, jj = row % LANES, row // LANES
        col = int(rcol[owner, jj])
        ia[t], ib[t], score[t], valid[t] = row, col, bv, True
        rmax[owner, jj], rcol[owner, jj] = NEG, -1
        col_used[col % LANES, col // LANES] = True
        for j in range(r_own):
            for src in np.flatnonzero(rcol[:, j] == col):
                vals = np.where(live & ~col_used,
                                scores[src + LANES * j][safe], NEG)
                rmax[src, j], rcol[src, j], dropped = _rescan(
                    vals, rmax[src, j])
                rescans += 1
                fell += dropped
    return ia, ib, score, valid, rounds, rescans, fell


def test_order_key_is_monotone_and_merges_signed_zeros():
    v = np.array([-np.inf, -3.5, -1e-30, -0.0, 0.0, 1e-30, 0.2, 1.0, np.inf],
                 np.float32)
    keys = order_key(v)
    assert (np.diff(keys.astype(np.int64)) >= 0).all()
    assert keys[3] == keys[4] and len(set(keys.tolist())) == len(v) - 1
    assert all(key_value(kk) == x for kk, x in zip(keys, v))


@pytest.mark.parametrize("k,batch", [(8, 2), (32, 2), (96, 1), (128, 1),
                                     (match.MAX_K, 1)])
def test_cached_row_maxima_equal_pallas(k, batch):
    """Bit for bit against the Pallas kernel at K = 8 ... 241, with
    matches found (past row and column 64 at K >= 96); the cache rescans
    fewer than K rows a round on average, and fewer rows in all than the
    first kernel's scan of every unused row each round."""
    scores = inputs.match_scores(np.random.default_rng(k), batch, k)
    pallas = [[np.asarray(t) for t in greedy_match_pallas(
        jnp.asarray(scores[b]), interpret=True)] for b in range(batch)]
    rounds = rescans = fell = old_scans = 0
    for b in range(batch):
        for limb in range(19):
            *got, n_rounds, n_rescans, n_fell = emulate_match(
                scores[b, limb])
            for g, p in zip(got, pallas[b]):
                np.testing.assert_array_equal(g, p[limb])
            taken = int(got[3].sum())
            assert n_rounds == taken + (taken < k)   # + the round that ends
            rounds += n_rounds
            rescans += n_rescans
            fell += n_fell
            # the old kernel: each round scans every row not yet taken
            old_scans += sum(k - t for t in range(n_rounds))
    ia = np.stack([p[0] for p in pallas])
    valid = np.stack([p[3] for p in pallas])
    assert valid.any() and not valid.all()
    if k >= 96:
        assert (ia[valid] >= 64).any()
    assert rescans / rounds < k
    assert rounds + rescans < old_scans and fell <= rescans


def test_phase_probes_fit_the_kernel():
    """``scripts/profile_torch_match.py``'s clock64 probes find each of
    their anchors in ``csrc/match.cu`` once, so the per-phase profile
    stays buildable as the kernel changes."""
    import importlib.util
    import os

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        os.pardir)
    spec = importlib.util.spec_from_file_location(
        "profile_torch_match",
        os.path.join(root, "scripts", "profile_torch_match.py"))
    prof = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(prof)
    with open(prof.SOURCE) as f:
        kernel = f.read()
    src = prof.instrumented_source(kernel)
    assert src.count("clock64()") == kernel.count("clock64()") + 7
    assert src.count("long long* prof") == 3
    with pytest.raises(ValueError, match="anchor"):
        prof.instrumented_source(src.replace("int* const out_a = ia", ""))
