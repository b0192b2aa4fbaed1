"""The measured window of each kind of traffic, and what set-up and the
check after it need.

`eval`: a closed loop of one client sending one scene per call, as the
evaluation protocol (`Trainer.test`) does: the host batch is moved to the
device, encoded (`make_eval_encode(pack_soa=True)`), the render settings
are chosen from the scene (`choose_eval_settings`), and the target views
are rendered in chunks (`make_eval_decode()`); a scene ends when its last
render has finished on the device.
"""

from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field
from typing import Optional

import torch

from . import check, generator, port, profiling


@dataclass
class Run:
    """What a run measured, for the metric readers and the check."""

    kind: str
    views: int = 0  # target views per scene
    setup_s: float = 0.0
    window_s: float = 0.0
    done: int = 0  # scenes completed in the window
    failed: int = 0
    latencies_s: list = field(default_factory=list)
    peak_window_bytes: int = 0
    peak_bytes: int = 0
    spans_ms: dict = field(default_factory=dict)  # span name -> ms per scene
    trace: Optional[profiling.Trace] = None
    traced: list = field(default_factory=list)  # pool indices of the traced scenes
    after_trace_s: float = 0.0  # the window after the traced part
    after_trace_done: int = 0
    outputs: dict = field(default_factory=dict)  # what the check compares
    work: dict = field(default_factory=dict)  # filled by the check: counts of the traced units


class EventSpans:
    """CUDA-event spans by name (host-clock spans on the CPU), read after
    the window."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.events: dict[str, list] = {}

    def __call__(self, name: str):
        return _EventSpan(self, name) if self.enabled else profiling.span(name, False)

    def read(self) -> dict:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        out = {}
        for name, pairs in self.events.items():
            out[name] = [a.elapsed_time(b) if hasattr(a, "elapsed_time") else (b - a) * 1e3 for a, b in pairs]
        return out


class _EventSpan:
    def __init__(self, owner: EventSpans, name: str):
        self.owner, self.name = owner, name
        self.annotation = profiling.span(name, True)

    def _mark(self):
        if torch.cuda.is_available():
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            return event
        return time.perf_counter()

    def __enter__(self):
        self.annotation.__enter__()
        self.start = self._mark()

    def __exit__(self, *exc):
        self.owner.events.setdefault(self.name, []).append((self.start, self._mark()))
        self.annotation.__exit__(*exc)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _reset_peak(device) -> int:
    """The peak so far, then a fresh one."""
    if torch.device(device).type != "cuda":
        return 0
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    return peak


def _peak(device) -> int:
    return torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0


def _print_setup(t_process: float, marks: list) -> None:
    names = ("imports", "model and weights", "traffic", "warm-up", "the reference's settling (not counted)")
    parts = zip(names, [t_process] + marks[:-1], marks)
    print("setup: " + ", ".join(f"{name} {b - a:.2f} s" for name, a, b in parts), flush=True)


def run_eval(cell, seed: int, seconds: float, trace: bool, device, t_process: float, out_dir, faults=None) -> Run:
    from pixelsplat_tpu_torch.training.model_wrapper import batch_to

    cfg, traffic = cell.config, cell.traffic
    h, w = cfg["image_shape"]
    marks = [time.perf_counter()]
    wrapper = port.build(cfg, seed, device)
    marks.append(time.perf_counter())
    units = generator.make_units(traffic, cfg, seed, device)
    order = generator.window_order(traffic, seed)
    n_check, n_trace = traffic["check_scenes"], traffic["trace_scenes"] if trace else 0
    marks.append(time.perf_counter())
    encode = wrapper.make_eval_encode(pack_soa=True)
    decode = wrapper.make_eval_decode()
    chunk = traffic["render_chunk"]
    spans = EventSpans(trace)

    def scene(unit):
        arrays = batch_to(unit.batch, device)
        with spans("encode"):
            gaussians = encode(arrays, False, 0, u=unit.u, view_order=unit.view_order)
        cams = arrays["target"]
        with spans("settings"):
            settings = wrapper.choose_eval_settings(
                gaussians, cams["extrinsics"], cams["intrinsics"], cams["near"], (h, w)
            )
        colors, overflow = [], 0
        with spans("render"):
            for lo in range(0, cams["extrinsics"].shape[1], chunk):
                color, dropped = decode(
                    gaussians, cams["extrinsics"][:, lo:lo + chunk], cams["intrinsics"][:, lo:lo + chunk],
                    cams["near"][:, lo:lo + chunk], cams["far"][:, lo:lo + chunk], (h, w), settings,
                )
                colors.append(color)
                overflow = overflow + dropped
        color = torch.cat(colors, dim=1)
        if faults and "alter_answer" in faults:
            color = faults["alter_answer"](color)
        return color, overflow

    # Set-up: every shape the traffic uses, at the scenes whose targets lie
    # nearest and farthest along the rig.
    by_place = sorted(range(len(units)), key=lambda i: float(units[i].batch["target"]["extrinsics"][0, :, 0, 3].mean()))
    for i in (by_place[0], by_place[-1]):
        scene(units[i])
    spans.events.clear()
    run = Run(kind="eval", views=units[0].batch["target"]["extrinsics"].shape[1])
    run.peak_bytes = _reset_peak(device)
    marks.append(time.perf_counter())

    # The checked scenes' depth draws, settled by the reference: neither its
    # seconds nor its memory are the program's set-up. The allocator's cache
    # is kept, as the warm-up left it for the window.
    checked = [order[k % len(order)] for k in range(n_check)]
    for i, unit in zip(checked, check.settle_depth_draws([units[i] for i in checked], cfg, seed, device)):
        units[i] = unit
    gc.collect()
    _reset_peak(device)
    marks.append(time.perf_counter())
    run.setup_s = marks[-2] - t_process
    _print_setup(t_process, marks)

    failed = torch.zeros((), dtype=torch.int64, device=device)
    traces: list = []
    k = 0
    t0 = time.perf_counter()

    def one(k):
        nonlocal failed
        unit = units[order[k % len(order)]]
        t = time.perf_counter()
        color, overflow = scene(unit)
        _sync(device)
        run.latencies_s.append(time.perf_counter() - t)
        failed = failed + (overflow > 0)
        if k < n_check:
            run.outputs.setdefault("scenes", []).append(
                {"unit": order[k % len(order)], "color": color.clone(), "overflow": overflow}
            )

    if n_trace:
        with profiling.traced(out_dir, traces):
            while k < n_trace:
                one(k)
                k += 1
        run.trace = traces[0]
        run.traced = [order[i % len(order)] for i in range(n_trace)]
    t_after, k_after = time.perf_counter(), k
    while k < n_check or time.perf_counter() - t0 < seconds:
        one(k)
        k += 1
    _sync(device)
    t_end = time.perf_counter()
    run.window_s, run.done = t_end - t0, k
    run.after_trace_s, run.after_trace_done = t_end - t_after, k - k_after
    run.failed = int(failed)
    run.peak_window_bytes = _peak(device)
    run.peak_bytes = max(run.peak_bytes, run.peak_window_bytes)
    run.spans_ms = spans.read()
    run.outputs["units"] = units
    del wrapper, encode, decode
    return run


LOOPS = {"eval": run_eval}
