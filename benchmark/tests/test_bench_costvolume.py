"""The `mvsplat` configuration's pieces: its reference module, its FLOP
count, `costvolume_roofline.eval`'s work, and a tiny `mvsplat` cell through
the harness, on the CPU and (`-m cuda`) on the card with its TF32 control.
On the card: `python3 -m pytest benchmark/tests -m cuda`."""

from __future__ import annotations

import copy
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from benchmark import control, harness, spec, work

BENCH = Path(__file__).resolve().parents[1]
roofline = spec.metric_reader("costvolume_roofline.eval")
metric = roofline.__globals__
SEEDS = (2**31 + 31, 2**31 + 32, 2**31 + 33)


def tiny_mvsplat_cell() -> spec.Cell:
    """`mvsplat.eval` at 64x64 with 32 features, 8 candidates and U-Nets of
    16 / 8 channels, every structural setting as published; a pool of 4."""
    cell = spec.load_cell("mvsplat.eval")
    cell.config = copy.deepcopy(cell.config)
    cell.config["image_shape"] = [64, 64]
    cell.config["encoder"].update(d_feature=32, num_depth_candidates=8, costvolume_unet_feat_dim=16,
                                  depth_unet_feat_dim=8)
    cell.traffic = {**cell.traffic, "pool": 4, "check_scenes": 2, "trace_scenes": 1}
    return cell


def test_mvsplat_finds_its_reference():
    config = spec.load_json(BENCH / "configs" / "mvsplat.json")
    module = spec.reference_module(config)
    assert Path(module.__file__) == BENCH / "reference" / "costvolume.py"
    assert not hasattr(module, "settle_draws")  # MVSplat draws nothing


def test_flop_count_is_the_kept_one():
    config = spec.load_json(BENCH / "configs" / "mvsplat.json")
    assert work.count_flops(config) == work.flops_of("mvsplat")


@pytest.mark.parametrize("views", [2, 3])
def test_costvolume_roofline_counts_the_cost_volume(views):
    """v (v - 1) D h' w' c taps x 10 operations; each feature read and each
    correlation written once, 4 bytes each."""
    ops, nbytes = metric["work"](views, 256, 256)
    assert ops == views * (views - 1) * 128 * 64 * 64 * 128 * 10
    assert nbytes == 4 * (views * 128 * 64 * 64 + views * 128 * 64 * 64)
    image = torch.zeros(1, views, 3, 256, 256)
    units = [SimpleNamespace(batch={"context": {"image": image}})] * 2
    found = {"spans": {"encoder.backbone": {"calls": 2}, "encoder.costvolume": {"calls": 2, "device_ms": 4.0}},
             "counters": {}}
    run = SimpleNamespace(kind="eval", program=found, traced=[0, 1], outputs={"units": units})
    least = max(ops / 67e12, nbytes / 3.35e12)
    assert roofline(run) == pytest.approx(100.0 * 2 * least / 4e-3)
    run.program = {"spans": {"encoder.backbone": {"calls": 2}}, "counters": {}}
    assert roofline(run) is None  # a program without the span reads nothing


def test_tiny_mvsplat_cell_is_correct(monkeypatch):
    monkeypatch.setattr(harness.work, "flops_of", lambda name: {"eval_scene": 1e9})
    result = harness.run_cell(tiny_mvsplat_cell(), SEEDS[0], 0.5, True, "cpu", time.perf_counter())
    assert result["correct"], result["checks"]
    names = ("mv_transformer_ms.eval", "costvolume_ms.eval", "cv_refine_ms.eval", "depth_refine_ms.eval",
             "costvolume_roofline.eval", "backbone_ms.eval", "host_syncs.eval")
    assert set(names) <= set(result["metrics"]), sorted(result["metrics"])
    assert "epipolar_ms.eval" not in result["metrics"]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_tiny_mvsplat_control_is_not_correct(needs_cuda, seed):
    cell = tiny_mvsplat_cell()
    reading = control.eval_readings(cell, seed, "cuda")["control_tf32"]
    assert any(reading[k] > limit for k, limit in cell.limits.items() if k in reading)


@pytest.mark.cuda
def test_tiny_mvsplat_cell_is_correct_on_the_card(needs_cuda, monkeypatch):
    monkeypatch.setattr(harness.work, "flops_of", lambda name: {"eval_scene": 1.0})
    result = harness.run_cell(tiny_mvsplat_cell(), SEEDS[1], 0.5, True, "cuda", time.perf_counter())
    assert result["correct"], result["checks"]
