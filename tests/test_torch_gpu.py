"""The port's CUDA kernels on a card: each against its plain PyTorch twin
at the decode path's shapes (exact), and the decode against the JAX
package's golden file.

Marked ``gpu``; they skip without a card (the decision is made in a
fixture, so every xdist worker collects the same tests). The file
imports no JAX, so it runs on a machine without it. From the repo root:

    python -m pytest -m gpu --noconftest tests/test_torch_*.py

(``--noconftest``: ``tests/conftest.py`` configures JAX.)
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_ekpose_tpu.config import Config  # noqa: E402
import torch_port_inputs as inputs  # noqa: E402
from torch_ekpose_tpu_torch.decode import device as PD  # noqa: E402
from torch_ekpose_tpu_torch.ops import match, merge, nms  # noqa: E402

pytestmark = pytest.mark.gpu

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "torch_decode_golden.npz")
B, K, CAP = 8, 32, 96


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels run only there)")
    return torch.device("cuda")


def _kernel_vs_twin(kernel, twin, *args):
    before = kernel.launches
    got = kernel(*args)
    want = twin(*args)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and g.dtype == w.dtype
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    return got


@pytest.mark.parametrize("seed", range(2))
def test_nms_kernel_equals_twin(cuda, seed):
    maps = torch.from_numpy(inputs.nms_maps(
        np.random.default_rng(seed), B, 19, 46, 54)).to(cuda)
    (out,) = _kernel_vs_twin(nms.masked_peak_scores,
                             nms.masked_peak_scores_torch, maps[:, :18], 0.25)
    assert out.shape == (B, 18, 46, 54) and torch.isinf(out).any()


@pytest.mark.parametrize("k", [8, 32, 64])
def test_match_kernel_equals_twin(cuda, k):
    scores = torch.from_numpy(inputs.match_scores(
        np.random.default_rng(k), B, k)).to(cuda)
    _, _, _, valid = _kernel_vs_twin(match.greedy_match,
                                     match.greedy_match_torch, scores)
    assert valid.any() and not valid.all()


@pytest.mark.parametrize("cap", [CAP, 8])
def test_merge_kernel_equals_twin(cuda, cap):
    tables = inputs.merge_inputs(np.random.default_rng(cap), B, K, K // 2)
    args = [torch.from_numpy(tables[f]).to(cuda) for f in (
        "pair", "p1", "p2", "cid1", "cid2", "score", "n_valid",
        "peak_score")]
    subset, active = _kernel_vs_twin(merge.merge_people,
                                     merge.merge_people_torch, *args, cap)
    assert not active[0].any() and active[1:].any()   # image 0 is empty


def test_decode_on_card_matches_golden(cuda):
    """The JAX package's decode of four scenes (written on the CPU by
    scripts/make_torch_golden.py): integer fields exact, float fields
    within rtol 1e-5 (cuBLAS sums the refinement matmuls in another
    order), the same people, and the three kernels launched once each."""
    golden = np.load(GOLDEN)
    cfg = Config()
    counts = [f.launches for f in (nms.masked_peak_scores,
                                   match.greedy_match, merge.merge_people)]
    packed = PD.build_packed_decoder(cfg)(
        torch.from_numpy(golden["heatmaps"]).to(cuda),
        torch.from_numpy(golden["pafs"]).to(cuda)).cpu().numpy()
    assert [f.launches for f in (nms.masked_peak_scores, match.greedy_match,
                                 merge.merge_people)] == [c + 1 for c in counts]
    assert inputs.packed_mismatches(
        packed, golden["packed"], 32, 96, rtol=1e-5) == []
    people = [len(PD.packed_to_humans(row, 368, 432, cfg)) for row in packed]
    assert people == golden["n_humans"].tolist() and min(people) >= 1
