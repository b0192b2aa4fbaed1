"""The `gslrm` configuration's pieces: its reference module, its FLOP count,
`gslrm_linear_roofline.eval`'s work, the two metrics it adds, and a tiny
`gslrm` cell through the harness, on the CPU and (`-m cuda`) on the card
with its TF32 control. On the card: `python3 -m pytest benchmark/tests -m cuda`."""

from __future__ import annotations

import copy
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import control, gslrm_work, harness, spec, work
from benchmark.profiling import Trace
from benchmark.reference import gslrm as ref

BENCH = Path(__file__).resolve().parents[1]
roofline = spec.metric_reader("gslrm_linear_roofline.eval")
transformer_ms = spec.metric_reader("gslrm_transformer_ms.eval")
SEEDS = (2**31 + 41, 2**31 + 42, 2**31 + 43)
K10 = "void (anonymous namespace)::linear_split_kernel<128, 3>(CUtensorMap_st, CUtensorMap_st, (anonymous namespace)::Args)"
CUBLAS = "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8_stage3_warpsize2x2x1_ffma_aligna4_alignc4_execute_kernel"


def tiny_gslrm_cell() -> spec.Cell:
    """`gslrm.eval` at 32x32 with 2 blocks of width 64 and 4 heads, patch 8,
    every other setting as published; a pool of 4."""
    cell = spec.load_cell("gslrm.eval")
    cell.config = copy.deepcopy(cell.config)
    cell.config["image_shape"] = [32, 32]
    cell.config["encoder"].update(depth=2, d_model=64, heads=4)
    cell.traffic = {**cell.traffic, "pool": 4, "check_scenes": 2, "trace_scenes": 1}
    return cell


def test_gslrm_finds_its_reference():
    config = spec.load_json(BENCH / "configs" / "gslrm.json")
    module = spec.reference_module(config)
    assert Path(module.__file__) == BENCH / "reference" / "gslrm.py"
    assert not hasattr(module, "settle_draws")  # GS-LRM draws nothing


def test_flop_count_is_the_kept_one():
    config = spec.load_json(BENCH / "configs" / "gslrm.json")
    assert work.count_flops(config) == work.flops_of("gslrm")
    # The linear layers and the attention's two products, 1.2426e12 +
    # 0.4123e12, and 104 FLOP a pixel of small products: the rays' 3x3 and
    # 4x4 transforms (18 + 32) and the covariance's 3x3 product (54).
    linear = 2 * (12 * 1024**2 * 24 + 576 * 1024 + 1024 * 768) * 2048
    attention = 24 * 4 * 2048**2 * 1024
    assert work.flops_of("gslrm")["eval_scene"] == linear + attention + 104 * 2 * 256 * 256


def tiny_reference_and_context(dtype) -> tuple:
    """The reference at the tiny cell's widths on the seed's weights, and a
    scene's shimmed context views in `dtype`."""
    from benchmark import check, generator

    cell = tiny_gslrm_cell()
    encoder = check.reference_encoder(cell.config, SEEDS[0], "cpu")
    unit = generator.make_units(cell.traffic, cell.config, SEEDS[0], "cpu")[0]
    context = ref.apply_shims(unit.batch, cell.config["encoder"])["context"]
    return encoder, {k: v.to(dtype) for k, v in context.items()}


def test_reference_computes_in_float64():
    """Float32 views give the float64 computation's Gaussians rounded to
    float32, so the reference's own rounding never reorders two
    Gaussians."""
    encoder, context = tiny_reference_and_context(torch.float32)
    with torch.no_grad():
        got = encoder(context, 0, None, None)
        want = encoder({k: v.double() for k, v in context.items()}, 0, None, None)
    assert all(g.dtype == torch.float32 for g in got)
    assert all(w.dtype == torch.float64 for w in want)
    for g, w in zip(got, want):
        assert torch.equal(g, w.float())


def test_reference_computes_in_float32_where_tf32_is_allowed(monkeypatch):
    """The control's precision: float32 with TF32 products, for float32
    views only. The encoder turns TF32 off when built; the control turns it
    on afterwards."""
    encoder, context = tiny_reference_and_context(torch.float32)
    assert ref.working_dtype(torch.float32) == torch.float64
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    assert ref.working_dtype(torch.float32) == torch.float32
    assert ref.working_dtype(torch.float64) == torch.float64
    with torch.no_grad():
        got = encoder(context, 0, None, None)
        wider = encoder({k: v.double() for k, v in context.items()}, 0, None, None)
    assert not torch.equal(got[0], wider[0].float())  # float32 arithmetic, not float64 rounded


def published() -> dict:
    return spec.load_json(BENCH / "configs" / "gslrm.json")["encoder"]


def test_k10_work_is_the_hand_count_at_the_published_widths():
    encoder = published()
    assert gslrm_work.flop_per_token(encoder) == 2 * (12 * 1024**2 * 24 + 576 * 1024 + 1024 * 768)
    assert gslrm_work.tokens(encoder, 2, 256, 256) == 2048
    assert gslrm_work.flop_per_token(encoder) * 2048 == 1_242_587_725_824


def test_k10_work_is_the_references_linear_layers():
    """At a small size the hand count equals what the FLOP counter finds
    in the reference's linear layers (its total less the attention's two
    products and the 104 FLOP a pixel of the rays' and covariances' small
    products)."""
    encoder = {**published(), "depth": 2, "d_model": 64, "heads": 4}
    config = {"encoder": encoder, "image_shape": [32, 64], "reference": "gslrm"}
    with torch.device("meta"):
        model = ref.Encoder(encoder)
        ctx = {k: t.to("meta") for k, t in work._context(config, 1).items()}
        with FlopCounterMode(display=False) as counter:
            model(ctx, 0, None, None)
    t = gslrm_work.tokens(encoder, 2, 32, 64)
    small = 104 * 2 * 32 * 64
    assert counter.get_total_flops() - encoder["depth"] * 4 * t * t * 64 - small == gslrm_work.flop_per_token(encoder) * t


def test_linear_roofline_over_the_traced_scenes():
    """Two traced scenes' K10 work, as the program counted it, over K10's
    time in the trace; other kernels' time is not counted; no K10 symbol or
    no counter, no reading."""
    flops = 2 * 2048 * 606_732_288
    found = {"spans": {"encoder.backbone": {"calls": 2}}, "counters": {"linear_split_flops.traced": flops}}
    trace = Trace(device=[(K10, 0.0, 20000.0), (CUBLAS, 20000.0, 90000.0), (K10, 90000.0, 100000.0)])
    run = SimpleNamespace(kind="eval", trace=trace, traced=[0, 2], program=found)
    assert roofline(run) == pytest.approx(100.0 * flops / (495e12 / 3) / 30e-3)
    run.program = {"spans": {"encoder.backbone": {"calls": 2}}, "counters": {"linear_split_launches": 196}}
    assert roofline(run) is None  # a program that counts no K10 work
    run.program = found
    run.trace = Trace(device=[(CUBLAS, 0.0, 1000.0)])
    assert roofline(run) is None


def test_transformer_ms_reads_its_span_or_nothing():
    found = {"spans": {"encoder.backbone": {"calls": 2}, "encoder.transformer": {"calls": 2, "device_ms": 60.0}},
             "counters": {}}
    run = SimpleNamespace(kind="eval", program=found)
    assert transformer_ms(run) == pytest.approx(30.0)
    run.program = {"spans": {"encoder.backbone": {"calls": 2}}, "counters": {}}
    assert transformer_ms(run) is None  # another encoder's scenes
    run.program = {"spans": {}, "counters": {}}
    assert transformer_ms(run) is None  # a program that records no scene


def test_tiny_gslrm_cell_is_correct(monkeypatch):
    monkeypatch.setattr(harness.work, "flops_of", lambda name: {"eval_scene": 1e9})
    result = harness.run_cell(tiny_gslrm_cell(), SEEDS[0], 0.5, True, "cpu", time.perf_counter())
    assert result["correct"], result["checks"]
    names = ("gslrm_transformer_ms.eval", "backbone_ms.eval", "host_syncs.eval")
    assert set(names) <= set(result["metrics"]), sorted(result["metrics"])
    assert "gslrm_linear_roofline.eval" not in result["metrics"]  # no K10 on the CPU
    assert "epipolar_ms.eval" not in result["metrics"] and "mv_transformer_ms.eval" not in result["metrics"]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_tiny_gslrm_control_is_not_correct(needs_cuda, seed):
    cell = tiny_gslrm_cell()
    reading = control.eval_readings(cell, seed, "cuda")["control_tf32"]
    assert any(reading[k] > limit for k, limit in cell.limits.items() if k in reading)


@pytest.mark.cuda
def test_tiny_gslrm_cell_is_correct_on_the_card(needs_cuda, monkeypatch):
    monkeypatch.setattr(harness.work, "flops_of", lambda name: {"eval_scene": 1.0})
    result = harness.run_cell(tiny_gslrm_cell(), SEEDS[1], 0.5, True, "cuda", time.perf_counter())
    assert result["correct"], result["checks"]
    # The work of the tiny widths, not the published ones, over K10's time.
    assert 0 < result["metrics"]["gslrm_linear_roofline.eval"]["value"] <= 100
