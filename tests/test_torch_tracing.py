"""The port's tracer (`pixelsplat_tpu_torch/utils/tracing.py`), the
benchmark's readers of its spans and counters, and the idle table by span.

On the CPU at the benchmark's tiny sizes. The two tests marked `cuda` run
one production scene on the card and skip elsewhere:

    python -m pytest tests/test_torch_tracing.py -m cuda --noconftest -p no:cacheprovider
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import pytest
import torch

from pixelsplat_tpu_torch.utils import tracing
from pixelsplat_tpu_torch.utils.benchmarker import Benchmarker

ROOT = Path(__file__).resolve().parents[1]
TINY = json.loads((ROOT / "benchmark" / "tests" / "tiny_config.json").read_text())
NEW_METRICS = ("backbone_ms.eval", "epipolar_ms.eval", "refine_ms.eval", "settings_ms.eval", "bin_ms.eval",
               "composite_ms.eval", "host_syncs.eval")


@pytest.fixture(autouse=True)
def fresh_tracer():
    tracing.enable(False)
    tracing.reset()
    yield
    tracing.enable(False)
    tracing.reset()


def test_off_a_span_records_nothing_and_creates_no_event(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("tracing off made an event or a profiler range")

    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not tracing.active()
    assert tracing.span("a") is tracing.span("b") is tracing.sync_point("c")  # the shared no-op
    with tracing.span("a"), tracing.sync_point("c"):
        tracing.count("n", 3)
        tracing.count_device("d", torch.ones(4, dtype=torch.int32))
    assert tracing.read() == {"spans": {}, "counters": {}}


def test_on_nested_spans_and_counters_read_back():
    tracing.enable(True)
    with tracing.span("outer"):
        for _ in range(2):
            with tracing.span("inner"):
                tracing.count("n", 3)
                tracing.count_device("d", torch.tensor([1, 2, 3], dtype=torch.int32))
        with tracing.sync_point("wait"):
            pass
    got = tracing.read()
    assert {k: v["calls"] for k, v in got["spans"].items()} == {"outer": 1, "inner": 2, "wait": 1}
    assert got["spans"]["outer"]["host_ms"] >= got["spans"]["inner"]["host_ms"] >= 0
    assert got["counters"]["n"] == 6 and got["counters"]["d"] == 12 and got["counters"]["host_syncs"] == 1
    assert got["counters"]["sync_wait_ms"] >= 0
    assert tracing.read() == got  # a second read adds nothing
    tracing.reset()
    assert tracing.read() == {"spans": {}, "counters": {}}


def test_launch_counters_count_with_tracing_off():
    assert not tracing.active()
    tracing.count_launch("k1_launches")
    tracing.count_launch("k1_launches")
    assert tracing.counter("k1_launches") == 2 and tracing.counter("k2_launches") == 0


def test_held_records_nothing_and_keeps_the_launches_for_replays():
    tracing.enable(True)
    with tracing.held() as launches:
        with tracing.span("a"), tracing.sync_point("b"):
            tracing.count("n", 2)
            tracing.count_device("d", torch.ones(3, dtype=torch.int32))
            tracing.count_launch("conv7_launches")
            tracing.count_launch("conv7_launches")
    assert launches == {"conv7_launches": 2}
    assert tracing.read() == {"spans": {}, "counters": {}}
    for _ in range(2):  # two replays of the captured graph
        tracing.count_launches(launches)
    with tracing.span("a"):
        pass
    assert tracing.read()["counters"] == {"conv7_launches": 4} and tracing.read()["spans"]["a"]["calls"] == 1


def test_a_traced_launch_counter_counts_only_while_tracing_replays_included():
    with tracing.held() as launches:
        tracing.count_launch("linear_split_flops.traced", 5)
        tracing.count_launch("linear_split_launches")
    assert launches == {"linear_split_flops.traced": 5, "linear_split_launches": 1}
    tracing.count_launches(launches)  # an untraced replay
    tracing.count_launch("linear_split_flops.traced", 7)  # an untraced eager launch
    tracing.enable(True)
    tracing.count_launches(launches)
    tracing.count_launch("linear_split_flops.traced", 7)
    assert tracing.read()["counters"] == {"linear_split_flops.traced": 12, "linear_split_launches": 2}


def test_count_always_counts_the_traced_part_apart():
    tracing.count_always("encoder_graph_scenes")
    tracing.enable(True)
    tracing.count_always("encoder_graph_scenes", 2)
    tracing.enable(False)
    assert tracing.read()["counters"] == {"encoder_graph_scenes": 3, "encoder_graph_scenes.traced": 2}


def test_the_profiler_switches_tracing_on():
    assert not tracing.active()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert tracing.active()
        with tracing.span("inside"):
            pass
    assert not tracing.active()
    with tracing.span("outside"):
        pass
    assert set(tracing.read()["spans"]) == {"inside"}


def test_benchmarker_blocks_are_profiler_ranges(tmp_path, monkeypatch):
    """`time_device` records through the tracer's span: on a card (faked
    here) its tag is a range of the profiler's trace and its CUDA events
    are read only when the times are."""

    class Event:
        def __init__(self, enable_timing=False):
            assert enable_timing

        def record(self):
            self.at = len(marks)
            marks.append(self)

        def elapsed_time(self, end):
            return 1.5 * (end.at - self.at)

    marks = []
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    bench = Benchmarker("cuda:0")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with bench.time_device("forward"):
            pass
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    names = [e.get("name") for e in json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
             if e.get("cat") == "user_annotation"]
    assert names.count("forward") == 1 and len(marks) == 2
    assert bench.summarize() == {"forward": pytest.approx(1.5e-3)}


# One evaluation scene at the tiny sizes, as the benchmark's loop runs it.


@pytest.fixture(scope="module")
def tiny_scene():
    from benchmark import generator, port
    from pixelsplat_tpu_torch.training.model_wrapper import batch_to

    torch.manual_seed(0)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    traffic = json.loads((ROOT / "benchmark" / "traffic" / "eval.json").read_text())
    traffic.update(pool=1)
    wrapper = port.build(TINY, 11, "cpu")
    unit = generator.make_units(traffic, TINY, 11, "cpu")[0]
    encode, decode = wrapper.make_eval_encode(pack_soa=True), wrapper.make_eval_decode()
    h, w = TINY["image_shape"]

    def scene():
        arrays = batch_to(unit.batch, "cpu")
        gaussians = encode(arrays, False, 0, u=unit.u, view_order=unit.view_order)
        cams = arrays["target"]
        settings = wrapper.choose_eval_settings(gaussians, cams["extrinsics"], cams["intrinsics"], cams["near"], (h, w))
        return decode(gaussians, cams["extrinsics"], cams["intrinsics"], cams["near"], cams["far"], (h, w), settings)

    yield scene, traffic["targets"]
    torch.set_num_threads(threads)


def test_one_scene_yields_each_span_and_the_same_image(tiny_scene):
    scene, views = tiny_scene
    color_off, overflow_off = scene()
    assert tracing.read() == {"spans": {}, "counters": {}}
    tracing.enable(True)
    color_on, overflow_on = scene()
    tracing.enable(False)
    assert torch.equal(color_on, color_off) and torch.equal(overflow_on, overflow_off)

    got = tracing.read()
    calls = {name: s["calls"] for name, s in got["spans"].items()}
    for name in ("encoder.backbone", "encoder.epipolar", "encoder.refine", "encoder.heads", "settings.project"):
        assert calls[name] == 1, name
    for name in ("render.project", "render.bin", "render.composite"):
        assert calls[name] == views, name
    assert calls["settings.read"] == 2 and calls["settings.occupancy"] == 2
    assert "kernel.k1" not in calls  # the CPU composites with the plain version
    assert not ({"encode", "settings", "render"} & set(calls))  # the benchmark's own span names
    uploads = {name: n for name, n in calls.items() if name.startswith("upload.")}
    counters = got["counters"]
    assert counters["host_syncs"] == calls["settings.read"] + sum(uploads.values())
    h, w = TINY["image_shape"]
    enc = TINY["encoder"]
    assert counters["gaussians"] == enc["num_context_views"] * h * w * enc["gaussians_per_pixel"]
    assert counters["pairs_dropped"] == int(overflow_on) == 0 and counters["pairs_binned"] > 0
    assert counters["capacity"] in (512, 1024, 2048, 4096) and counters["pair_budget"] % 128 == 0
    assert counters["big_capacity"] >= 256


def test_a_warm_scene_uploads_nothing_in_the_encoder(tiny_scene, tmp_path):
    """Once the encoder's constants are on the device, no `upload.*` sync
    point opens inside an `encoder.*` span; the render's remain."""
    scene, views = tiny_scene
    scene()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        scene()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
              for e in json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
              if e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    encoder = [(lo, hi) for name, lo, hi in events if name.startswith("encoder.")]
    uploads = [(name, lo) for name, lo, _ in events if name.startswith("upload.")]
    assert len(encoder) == 4 and any(name == "upload.background" for name, _ in uploads)
    assert not [name for name, t in uploads if any(lo <= t <= hi for lo, hi in encoder)]
    got = tracing.read()
    calls = {name: s["calls"] for name, s in got["spans"].items()}
    assert got["counters"]["host_syncs"] == calls["settings.read"] + sum(
        n for name, n in calls.items() if name.startswith("upload."))


def test_spans_share_the_profilers_clock(tiny_scene, tmp_path):
    """With tracing off, a profiler session still records the program's
    spans: as `user_annotation` events nested in an outer range."""
    scene, views = tiny_scene
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("render"):
            scene()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = [e for e in json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
              if e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    outer = next(e for e in events if e["name"] == "render")
    lo, hi = float(outer["ts"]), float(outer["ts"]) + float(outer["dur"])
    inner = [e for e in events if e["name"].startswith(("encoder.", "settings.", "render.", "upload."))]
    assert {e["name"] for e in inner} >= {"encoder.backbone", "settings.read", "render.composite"}
    assert sum(e["name"] == "render.composite" for e in inner) == views
    assert all(lo <= float(e["ts"]) and float(e["ts"]) + float(e["dur"]) <= hi for e in inner)
    assert tracing.read()["spans"]["encoder.backbone"]["calls"] == 1


# The benchmark's readers of the program's spans and counters.


def _reader(name: str):
    path = ROOT / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"reader_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _run(program=None, kind="eval"):
    from benchmark.loops import Run

    run = Run(kind=kind)
    if program is not None:
        run.program = program
    return run


def _span(calls, device_ms, host_ms=0.0):
    return {"calls": calls, "host_ms": host_ms, "device_ms": device_ms}


@pytest.mark.parametrize("name,want", [
    ("backbone_ms.eval", 25.0),
    ("epipolar_ms.eval", 17.0),
    ("refine_ms.eval", 37.0),
    ("settings_ms.eval", 20.0),  # host ms: (30 + 6 + 4) / 2
    ("bin_ms.eval", 10.0),  # (36 + 24) / 6 views
    ("composite_ms.eval", 5.0),
    ("host_syncs.eval", 63.0),
    ("encode_graphed.eval", 50.0),  # 1 of the 2 traced scenes
])
def test_metric_readers_on_a_hand_built_run(name, want):
    program = {
        "spans": {
            "encoder.backbone": _span(2, 50.0), "encoder.epipolar": _span(2, 34.0),
            "encoder.refine": _span(2, 74.0), "settings.project": _span(2, 9.0, host_ms=30.0),
            "settings.occupancy": _span(4, 2.0, host_ms=6.0), "settings.read": _span(6, 1.0, host_ms=4.0),
            "render.project": _span(6, 36.0), "render.bin": _span(6, 24.0), "render.composite": _span(6, 30.0),
        },
        "counters": {"host_syncs": 126, "encoder_graph_scenes": 40, "encoder_graph_scenes.traced": 1},
    }
    read = _reader(name)
    assert read(_run(program)) == pytest.approx(want)
    assert read(_run(program, kind="train")) is None
    assert read(_run({"spans": {}, "counters": {}})) is None  # the program recorded nothing


def test_encode_graphed_reads_nothing_without_the_counter():
    read = _reader("encode_graphed.eval")
    program = {"spans": {"encoder.backbone": _span(4, 40.0)}, "counters": {"host_syncs": 12}}
    assert read(_run(program)) is None  # a program without graphs
    program["counters"].update({"encoder_graph_scenes": 300, "encoder_graph_scenes.traced": 4})
    assert read(_run(program)) == 100.0


def test_metric_readers_read_the_program_tracer_after_a_profiled_window(tiny_scene):
    scene, views = tiny_scene
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        scene()
    run = _run()
    values = {name: _reader(name)(run) for name in NEW_METRICS}
    assert all(v is not None and v >= 0 for v in values.values()), values
    assert values["host_syncs.eval"] == tracing.read()["counters"]["host_syncs"]


def test_idle_by_span_splits_gaps_at_the_innermost_spans_ends():
    from benchmark.idle_by_span import OUTSIDE, idle_by_span

    events = [
        {"ph": "X", "cat": "user_annotation", "name": "traced_window", "ts": 0.0, "dur": 100.0},
        {"ph": "X", "cat": "user_annotation", "name": "encode", "ts": 10.0, "dur": 60.0},
        {"ph": "X", "cat": "user_annotation", "name": "encoder.backbone", "ts": 10.0, "dur": 20.0},
        {"ph": "X", "cat": "user_annotation", "name": "upload.phases", "ts": 40.0, "dur": 10.0},
        {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 15.0, "dur": 10.0},
        {"ph": "X", "cat": "kernel", "name": "conv", "ts": 45.0, "dur": 50.0},
    ]
    idle = idle_by_span(events)
    # Idle [0, 15) and [25, 45): 0-10 outside, 10-15 and 25-30 backbone,
    # 30-40 encode, 40-45 upload.phases; [95, 100) outside.
    assert idle == pytest.approx({OUTSIDE: 15e-6, "encoder.backbone": 10e-6, "encode": 10e-6,
                                  "upload.phases": 5e-6})


# On the card.


@pytest.fixture
def card_scene():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from benchmark import generator, port, spec
    from pixelsplat_tpu_torch.training.model_wrapper import batch_to

    cell = spec.load_cell("re10k.eval")
    port.set_precision(cell.config)
    wrapper = port.build(cell.config, 2**31 + 3, "cuda")
    units = generator.make_units({**cell.traffic, "pool": 2}, cell.config, 2**31 + 3, "cuda")
    encode, decode = wrapper.make_eval_encode(pack_soa=True), wrapper.make_eval_decode()
    h, w = cell.config["image_shape"]
    arrays = [batch_to(u.batch, "cuda") for u in units]
    torch.cuda.synchronize()

    def scene(k):
        unit = units[k]
        gaussians = encode(arrays[k], False, 0, u=unit.u, view_order=unit.view_order)
        cams = arrays[k]["target"]
        settings = wrapper.choose_eval_settings(gaussians, cams["extrinsics"], cams["intrinsics"], cams["near"], (h, w))
        return decode(gaussians, cams["extrinsics"], cams["intrinsics"], cams["near"], cams["far"], (h, w), settings)

    scene(0)  # builds the kernels and warms every shape
    torch.cuda.synchronize()
    return scene


@pytest.mark.cuda
def test_every_sync_of_a_scene_is_a_declared_sync_point(card_scene):
    color_off, _ = card_scene(1)
    tracing.enable(True)
    torch.cuda.set_sync_debug_mode("error")
    try:
        color_on, overflow = card_scene(1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
        tracing.enable(False)
    torch.cuda.synchronize()
    assert torch.equal(color_on, color_off) and int(overflow) == 0
    got = tracing.read()
    print(tracing.table(got))
    assert got["counters"]["host_syncs"] > 0


@pytest.mark.cuda
def test_every_k1_kernel_lies_inside_a_k1_range(card_scene, tmp_path):
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        card_scene(1)
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    k1 = [e for e in events if e.get("cat") == "kernel" and "composite_fwd_kernel" in e.get("name", "")]
    ranges = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
              if e.get("cat") == "gpu_user_annotation" and e.get("name") == "kernel.k1"]
    assert k1 and len(ranges) == len(k1) == tracing.read()["spans"]["kernel.k1"]["calls"]
    for e in k1:
        start, end = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        assert any(lo <= start and end <= hi for lo, hi in ranges), e["name"]
