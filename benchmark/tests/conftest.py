"""Fixtures of the benchmark's CPU tests: a tiny configuration and cell.

Tests that need an NVIDIA GPU carry the `cuda` marker and skip inside the
test where there is none; run them on the card with
`python3 -m pytest benchmark/tests -m cuda`.
"""

from __future__ import annotations

import copy
import json
import time
from pathlib import Path

import pytest
import torch

from benchmark import spec

HERE = Path(__file__).resolve().parent
TINY = json.loads((HERE / "tiny_config.json").read_text())
TINY_TRAFFIC = {"pool": 4, "check_scenes": 2, "trace_scenes": 1}
TINY_FLOPS = {"eval_scene": 3.4e9}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips where there is none")


@pytest.fixture(autouse=True)
def few_threads():
    previous = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(previous)


def tiny_cell(workload: str) -> spec.Cell:
    """Cell `workload` of `BENCHMARK.json` at the tiny configuration's sizes
    and a small pool, with its own traffic, limits and metrics."""
    cell = spec.load_cell(workload)
    cell.config = copy.deepcopy(TINY)
    cell.traffic = {**cell.traffic, **TINY_TRAFFIC}
    return cell


@pytest.fixture
def run_tiny(monkeypatch):
    """run_tiny(workload, seed=..., trace=False, faults=None) -> result dict,
    on the CPU at the tiny configuration's sizes."""
    from benchmark import harness

    monkeypatch.setattr(harness.work, "flops_of", lambda name: TINY_FLOPS)

    def run(workload, seed=2**31 + 7, trace=False, faults=None, cell=None):
        cell = cell or tiny_cell(workload)
        return harness.run_cell(cell, seed, 0.5, trace, "cpu", time.perf_counter(), faults=faults)

    return run


@pytest.fixture
def needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
