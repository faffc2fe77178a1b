"""The decode kernels at the capacities a crowded scene needs: the port's
twins against the JAX package at K = 96 and 128 peaks per part and person
tables of 192 and 384 rows, exactly, and the batched decode of crowded
frames at K = 96, cap = 192 against ``decode_jax_batched(...,
use_pallas_loops=False)`` bit for bit. Also the CUDA wrappers' limits,
derived from the shared memory each kernel's block needs: they take those
sizes and refuse one past the limit.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from torch_ekpose_tpu.config import Config  # noqa: E402
from torch_ekpose_tpu.decode import device as D  # noqa: E402
from torch_ekpose_tpu.ops.pallas_match import greedy_match_pallas  # noqa: E402
from torch_ekpose_tpu.ops.pallas_merge import (  # noqa: E402
    merge_people_pallas_batched,
)
import torch_port_inputs as inputs  # noqa: E402
from torch_ekpose_tpu_torch.decode import device as PD  # noqa: E402
from torch_ekpose_tpu_torch.ops import _build, match, merge  # noqa: E402

torch.set_num_threads(2)  # xdist already runs one process per core

MERGE_FIELDS = ("pair", "p1", "p2", "cid1", "cid2", "score", "n_valid",
                "peak_score")


@pytest.mark.parametrize("k", [96, 128])
def test_match_twin_equals_pallas_at_large_k(k):
    """Past the 64 rows and columns that two 64-bit masks held."""
    scores = inputs.match_scores(np.random.default_rng(k), 2, k)
    got = [t.numpy() for t in match.greedy_match(torch.from_numpy(scores))]
    for b in range(2):
        pallas = [np.asarray(t) for t in greedy_match_pallas(
            jnp.asarray(scores[b]), interpret=True)]
        for g, p in zip(got, pallas):
            np.testing.assert_array_equal(g[b], p)
    valid = got[3]
    assert valid[..., 64:].any() and not valid.all()
    assert (got[0][valid] >= 64).any() and (got[1][valid] >= 64).any()


@pytest.mark.parametrize("cap", [192, 384])
def test_merge_twin_equals_pallas_at_large_cap(cap):
    """One image opens over 128 rows (past the old static table); at 192
    rows the table fills, at 384 it does not."""
    tables = inputs.merge_inputs(np.random.default_rng(7), 2, 128, 40)
    port = [t.numpy() for t in merge.merge_people(
        *(torch.from_numpy(tables[f]) for f in MERGE_FIELDS), cap)]
    args = [jnp.asarray(tables[f]) for f in MERGE_FIELDS]
    pallas = merge_people_pallas_batched(*args, cap=cap, interpret=True)
    valid_sorted = (np.arange(tables["pair"].shape[1])[None]
                    < tables["n_valid"][:, None])
    xla = jax.vmap(functools.partial(D._merge_loop_xla, cap=cap))(
        args[0], args[3], args[4], args[5], jnp.asarray(valid_sorted),
        args[6], args[7])
    for g, p, x in zip(port, pallas, xla[:2]):
        np.testing.assert_array_equal(g, np.asarray(p))
        np.testing.assert_array_equal(g, np.asarray(x))
    subset, active = port
    assert active.sum() > 128 and not active[0].any()
    assert ((subset[1, :, 19] > 0).all()) == (cap == 192)


def test_crowded_decode_matches_jax_bit_for_bit():
    """Crowded frames (12 people over clutter that leaves ~100 local
    maxima per part) decoded at K = 96 and 64 people (cap 192): the packed
    buffers are equal bit for bit, people are found, and some part has
    more than 64 peaks."""
    heat, pafs = inputs.crowded_maps(np.random.default_rng(0), 2, 12)
    cfg = Config()
    cfg.DECODE.max_peaks_per_part = 96
    cfg.DECODE.max_people = 64
    with pytest.warns(RuntimeWarning, match="peak capacity saturated"):
        port = PD.build_packed_decoder(cfg)(
            torch.from_numpy(heat), torch.from_numpy(pafs)).numpy()
        people = [len(PD.packed_to_humans(row, 368, 432, cfg))
                  for row in port]
    ref = np.asarray(D.build_packed_decoder(cfg, batched=True, pallas=False)(
        jnp.asarray(heat), jnp.asarray(pafs)))
    np.testing.assert_array_equal(port, ref)
    assert min(people) >= 1
    for row in port:
        res = PD.unpack_result(row, 96, 192)
        assert res.peak_valid.reshape(18, 96).sum(1).max() > 64


@pytest.mark.parametrize("kernel", ["match", "merge"])
def test_wrapper_limits_follow_shared_memory(kernel):
    """Each limit is the largest size whose block fits the 227 KB a block
    may opt into on Hopper; the new sizes pass, one past the limit is
    refused with a message that names the limit."""
    mod, sizes = {"match": (match, (32, 96, 128)),
                  "merge": (merge, (96, 192, 384))}[kernel]
    limit = mod.MAX_K if kernel == "match" else mod.MAX_CAP
    check = mod.check_k if kernel == "match" else mod.check_cap
    assert mod.smem_bytes(limit) <= _build.SMEM_OPTIN
    assert mod.smem_bytes(limit + 1) > _build.SMEM_OPTIN
    assert limit >= max(sizes)
    for size in (*sizes, limit):
        check(size)
    for bad in (limit + 1, 0):
        with pytest.raises(ValueError, match=f"<= {limit} "):
            check(bad)
