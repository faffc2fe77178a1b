"""``correct`` comes out false for the control and for planted faults, and
true for a sound run, at CPU sizes: the tiny cells run the benchmark's
configurations in float32 at 128x128 (vgg2016 at 64x64) against the real
cells' limits."""

from __future__ import annotations

import pytest

from portbench.faults import planted


def test_sound_run_is_correct(run_tiny):
    result = run_tiny("mt-crowd", 2 ** 31 + 7)
    assert result["correct"], result["checks"]
    assert result["_diagnostics"]["people_mean"] > 3
    assert result["checks"]["people_unconverted"]["value"] == 0


@pytest.mark.parametrize("cell", ["mt-crowd", "mt-empty", "vgg-crowd"])
def test_control_is_not_correct(run_tiny, cell):
    """The configuration's lower-precision control (int8) in the program's
    place."""
    result = run_tiny(cell, 2 ** 31 + 8, control=True)
    assert not result["correct"]
    assert any(v["value"] > v["limit"] for v in result["checks"].values())


@pytest.mark.parametrize("cell", ["mt-crowd", "mt-empty"])
def test_half_batch_left_out_is_not_correct(run_tiny, cell):
    """The forward computes the first half of each batch and serves its
    maps for the second half as well."""
    with planted("half"):
        result = run_tiny(cell, 2 ** 31 + 9)
    assert not result["correct"]
    assert result["checks"]["peaks_unmatched_pct"]["value"] > \
        result["checks"]["peaks_unmatched_pct"]["limit"]


@pytest.mark.parametrize("cell", ["mt-crowd", "mt-empty"])
def test_altered_answer_is_not_correct(run_tiny, cell):
    """One keypoint of one person a frame moved by a pixel (a frame without
    people given a person) where the people are produced."""
    with planted("altered"):
        result = run_tiny(cell, 2 ** 31 + 10)
    assert not result["correct"]
    assert result["checks"]["people_unconverted"]["value"] > 0


@pytest.mark.parametrize("cell", ["mt-crowd", "vgg-crowd"])
def test_bias_and_bn_left_out_is_not_correct(run_tiny, cell):
    """Every conv's bias add dropped and every BN served as the identity
    (stage 6's projections kept)."""
    with planted("no_bias"):
        result = run_tiny(cell, 2 ** 31 + 11)
    assert not result["correct"]
    assert any(v["value"] > v["limit"] for v in result["checks"].values())


def test_paf_channels_swapped_is_not_correct(run_tiny):
    """Each limb's PAF x and y channels swapped on their way to the
    decode: the peaks stay, the people go."""
    with planted("paf_swap"):
        result = run_tiny("mt-crowd", 2 ** 31 + 12)
    assert not result["correct"]
    checks = result["checks"]
    assert checks["peaks_unmatched_pct"]["value"] <= \
        checks["peaks_unmatched_pct"]["limit"]
    assert checks["person_score_gap"]["value"] > \
        checks["person_score_gap"]["limit"]
