"""The port's kernel twins against the JAX package's Pallas kernels.

Each twin is the CPU path of its CUDA kernel (``torch_ekpose_tpu_torch/
ops``) and the kernel's oracle on the card, so it must equal the TPU
kernel bit for bit: every comparison here is exact (atol=0), ints and
-inf included. The Pallas kernels run in interpret mode, as the JAX
package's own tests run them, next to their XLA twins. Inputs come from
``tests/torch_port_inputs.py`` with numpy seeds.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from torch_ekpose_tpu.decode import device as D  # noqa: E402
from torch_ekpose_tpu.ops.pallas_match import greedy_match_pallas  # noqa: E402
from torch_ekpose_tpu.ops.pallas_merge import (  # noqa: E402
    merge_people_pallas_batched,
)
from torch_ekpose_tpu.ops.pallas_nms import (  # noqa: E402
    masked_peak_scores,
    masked_peak_scores_xla,
)
import torch_port_inputs as inputs  # noqa: E402
from torch_ekpose_tpu_torch.ops import match, merge, nms  # noqa: E402

torch.set_num_threads(2)  # xdist already runs one process per core

MERGE_FIELDS = ("pair", "p1", "p2", "cid1", "cid2", "score", "n_valid",
                "peak_score")


# ---------------------------------------------------------------------------
# NMS
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(3))
def test_nms_twin_equals_pallas(seed):
    maps = inputs.nms_maps(np.random.default_rng(seed), 2, 18, 23, 27)
    thresh = 0.25   # a plateau level: equal values on both sides of it
    got = nms.masked_peak_scores(torch.from_numpy(maps), thresh).numpy()
    for b in range(2):
        pallas = np.asarray(masked_peak_scores(
            jnp.asarray(maps[b]), thresh, interpret=True))
        xla = np.asarray(masked_peak_scores_xla(jnp.asarray(maps[b]), thresh))
        np.testing.assert_array_equal(got[b], pallas)
        np.testing.assert_array_equal(got[b], xla)
    assert np.isfinite(got).any() and np.isinf(got).any()


def test_nms_channel_slice_view():
    """The decoder hands the twin/kernel a [:, :18] view of the 19-channel
    heatmap; the result equals that of the dense copy."""
    maps = torch.from_numpy(
        inputs.nms_maps(np.random.default_rng(9), 2, 19, 12, 10))
    view = maps[:, :18]
    assert not view.is_contiguous()
    torch.testing.assert_close(
        nms.masked_peak_scores(view, 0.15),
        nms.masked_peak_scores(view.contiguous(), 0.15), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# greedy match
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_match_twin_equals_pallas(seed):
    k = 8
    scores = inputs.match_scores(np.random.default_rng(seed), 2, k)
    got = [t.numpy() for t in match.greedy_match(torch.from_numpy(scores))]
    xla_one = jax.vmap(functools.partial(D._greedy_match_one, k=k))
    for b in range(2):
        pallas = [np.asarray(t) for t in greedy_match_pallas(
            jnp.asarray(scores[b]), interpret=True)]
        xla = [np.asarray(t) for t in xla_one(jnp.asarray(scores[b]))]
        for g, p, x in zip(got, pallas, xla):
            np.testing.assert_array_equal(g[b], p)
            np.testing.assert_array_equal(g[b], x)
    valid = got[3]
    assert valid.any() and not valid.all()   # accepts, and runs dry


# ---------------------------------------------------------------------------
# person merge
# ---------------------------------------------------------------------------

def _merge_both(tables, cap):
    """(port twin, Pallas interpret, vmapped XLA loop) outputs as numpy."""
    port = merge.merge_people(
        *(torch.from_numpy(tables[f]) for f in MERGE_FIELDS), cap)
    args = [jnp.asarray(tables[f]) for f in MERGE_FIELDS]
    pallas = merge_people_pallas_batched(*args, cap=cap, interpret=True)
    valid_sorted = (np.arange(tables["pair"].shape[1])[None]
                    < tables["n_valid"][:, None])
    xla = jax.vmap(functools.partial(D._merge_loop_xla, cap=cap))(
        args[0], args[3], args[4], args[5], jnp.asarray(valid_sorted),
        args[6], args[7])
    return ([t.numpy() for t in port], [np.asarray(t) for t in pallas],
            [np.asarray(t) for t in xla[:2]])


@pytest.mark.parametrize("seed,cap", [(0, 24), (1, 24), (2, 8), (3, 4)])
def test_merge_twin_equals_pallas(seed, cap):
    """Random tables, image 0 empty; cap 8 and 4 saturate the table."""
    tables = inputs.merge_inputs(np.random.default_rng(seed), 3, 8, 4)
    assert tables["n_valid"][0] == 0
    port, pallas, xla = _merge_both(tables, cap)
    for g, p, x in zip(port, pallas, xla):
        np.testing.assert_array_equal(g, p)
        np.testing.assert_array_equal(g, x)
    subset, active = port
    assert not active[0].any() and (subset[0] == -1).all()
    if cap <= 8:
        assert (subset[1:, :, 19] > 0).all()   # every row written


def _tables(conns, k, n_slots=12):
    """Merge inputs from (limb, cid1 local, cid2 local, score) tuples."""
    from torch_ekpose_tpu import constants

    pairs = np.asarray(constants.COCO_PAIRS)
    t = {f: np.zeros((1, n_slots), np.int32) for f in MERGE_FIELDS[:5]}
    t["score"] = np.zeros((1, n_slots), np.float32)
    for s, (limb, a, b, sc) in enumerate(conns):
        p1, p2 = pairs[limb]
        t["pair"][0, s], t["p1"][0, s], t["p2"][0, s] = limb, p1, p2
        t["cid1"][0, s], t["cid2"][0, s] = p1 * k + a, p2 * k + b
        t["score"][0, s] = sc
    t["n_valid"] = np.array([len(conns)], np.int32)
    t["peak_score"] = np.linspace(0.2, 0.9, 18 * k, dtype=np.float32)[None]
    return t


@pytest.mark.parametrize("case", ["found2_merge", "found2_overlap",
                                  "found1_guard", "limb18_no_row"])
def test_merge_branches_equal_pallas(case):
    """Hand-built scenes for each branch of the merge: two rows merged
    (no shared part), two rows overlapping on the neck (cid 1*K+1 > 0 in
    both), a found==1 connection whose cid2 is already in the row, and a
    limb >= 18 that may not open a row."""
    k = 8
    conns = {
        # rows {1: neck0, 2: rsho0} and {5: lsho0, 6: lelb0}; then the
        # neck0-lsho0 limb finds both rows, which share no part
        "found2_merge": [(0, 0, 0, 1.0), (4, 0, 0, 0.5), (1, 0, 0, 0.7)],
        # rows {1: neck1, 2} and {1: neck2, 5}: the neck1-lsho0 limb finds
        # both, and both rows have a neck
        "found2_overlap": [(0, 1, 0, 1.0), (1, 2, 0, 0.5), (1, 1, 0, 0.7)],
        # the same connection twice: the second finds the row with
        # row[p2] == cid2 already
        "found1_guard": [(0, 0, 0, 1.0), (0, 0, 0, 0.4), (2, 0, 1, 0.3)],
        # limb 18 (5, 17) matches nothing and may not open a row
        "limb18_no_row": [(0, 0, 0, 1.0), (18, 3, 3, 0.9)],
    }[case]
    tables = _tables(conns, k)
    port, pallas, xla = _merge_both(tables, 6)
    for g, p, x in zip(port, pallas, xla):
        np.testing.assert_array_equal(g, p)
        np.testing.assert_array_equal(g, x)
    subset, active = port[0][0], port[1][0]
    n_active = int(active.sum())
    assert n_active == {"found2_merge": 1, "found2_overlap": 2,
                        "found1_guard": 1, "limb18_no_row": 1}[case]


# ---------------------------------------------------------------------------
# dispatch: a wrapper takes the twin only for CPU tensors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel", ["nms", "match", "merge"])
def test_wrappers_refuse_other_devices(kernel):
    """A tensor that is neither on the CPU nor on a card is refused, never
    sent to the twin."""
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        if kernel == "nms":
            nms.masked_peak_scores(torch.empty(1, 18, 4, 4, device=meta), 0.1)
        elif kernel == "match":
            match.greedy_match(torch.empty(1, 19, 4, 4, device=meta))
        else:
            ints = [torch.empty(1, 4, dtype=torch.int32, device=meta)] * 5
            merge.merge_people(
                *ints, torch.empty(1, 4, device=meta),
                torch.empty(1, dtype=torch.int32, device=meta),
                torch.empty(1, 72, device=meta), 8)
    assert nms.masked_peak_scores.launches == 0
