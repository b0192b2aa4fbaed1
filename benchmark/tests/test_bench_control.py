"""The control comes out not correct: the reference put in the program's
place with TF32 on, against the reference in float32, at a size a test run
holds. `python3 -m benchmark.control` reads it at a cell's own size.
On the card: `python3 -m pytest benchmark/tests -m cuda`."""

from __future__ import annotations

import time

import pytest

from benchmark import control, harness

from .conftest import tiny_cell

SEEDS = (2**31 + 11, 2**31 + 12, 2**31 + 13)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_eval_control_is_not_correct(needs_cuda, seed):
    cell = tiny_cell("re10k.eval")
    reading = control.eval_readings(cell, seed, "cuda")["control_tf32"]
    assert any(reading[k] > limit for k, limit in cell.limits.items() if k in reading)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["re10k.eval", "re10k_3_view.eval"])
def test_program_is_correct_on_the_card(needs_cuda, monkeypatch, workload):
    monkeypatch.setattr(harness.work, "flops_of", lambda name: {"eval_scene": 1.0})
    result = harness.run_cell(tiny_cell(workload), SEEDS[1], 0.5, True, "cuda", time.perf_counter())
    assert result["correct"], result["checks"]
