"""A run with its timed path broken underneath comes out not correct: one
test per fault a cell can have. The harness's look for a chip is skipped
(the runs are on the CPU, at the tiny configuration's sizes); the rest of a
run is the one the benchmark makes. A step that returns its state
unchanged and half of a batch left out are training's faults, and no cell
trains; the exchange between chips has no fault to plant, since every cell
takes one chip."""

from __future__ import annotations

import pytest


def _altered_view(color):
    """One target view's colours 5 % off where the decoder produced them."""
    color = color.clone()
    color[0, -1] *= 1.05
    return color


def _uncomposited_tile(color):
    """One tile left uncomposited, its pixels at the black background: a
    256th of one view's pixels, as one 16x16 tile of a 256x256 view."""
    color = color.clone()
    side = color.shape[-1] // 16
    color[0, -1, :, :side, :side] = 0.0
    return color


@pytest.mark.parametrize("workload", ["re10k.eval", "re10k_3_view.eval"])
def test_sound_runs_are_correct(run_tiny, workload):
    assert run_tiny(workload)["correct"]


@pytest.mark.parametrize("workload", ["re10k.eval", "re10k_3_view.eval"])
def test_altered_answer_is_not_correct(run_tiny, workload):
    result = run_tiny(workload, faults={"alter_answer": _altered_view})
    assert not result["correct"], result["checks"]
    assert result["checks"]["image_gap_median"]["value"] > result["checks"]["image_gap_median"]["limit"]


def test_one_wrong_tile_is_not_correct(run_tiny):
    """A fault on under 1 % of a view's pixels passes every quantile and
    fails the RMS."""
    result = run_tiny("re10k.eval", faults={"alter_answer": _uncomposited_tile})
    checks = result["checks"]
    assert not result["correct"], checks
    assert checks["image_gap_rms"]["value"] > checks["image_gap_rms"]["limit"]
    assert all(checks[k]["value"] <= checks[k]["limit"] for k in ("image_gap_median", "image_gap_p90", "image_gap_p99"))
