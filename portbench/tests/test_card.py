"""On the card: each cell of ``BENCHMARK.json`` runs a short window and
comes out correct.

    python -m pytest -m gpu portbench/tests/test_card.py
"""

from __future__ import annotations

import time

import pytest

from portbench import catalog

CELLS = [c["name"] for c in catalog.load_benchmark()["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_on_the_card(card, cell):
    from portbench.run import execute

    result = execute(cell, 2 ** 31 + 3, 2.0, False, t0=time.perf_counter())
    assert result["correct"], (result["checks"], result["_diagnostics"])
    assert result["metrics"]["frames_per_s"]["value"] > 0
