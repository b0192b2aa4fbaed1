"""A traced sub-window: `torch.profiler` over a few scenes, read
back from its Chrome trace into device-busy time (the union of the
device's kernel, copy and set intervals), device time by kernel name, and
idle gaps named by the benchmark's host span that was open at the time."""

from __future__ import annotations

import json
import re
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from pathlib import Path

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "traced_window"
SPANS = ("encode", "settings", "render")


@dataclass
class Trace:
    window_s: float = 0.0
    busy_s: float = 0.0
    device: list = field(default_factory=list)  # (name, start_us, end_us)
    host: list = field(default_factory=list)  # (span name, start_us, end_us)
    start: float = 0.0  # the traced window, microseconds
    end: float = 0.0

    def kernel_seconds(self, pattern: str) -> float:
        rx = re.compile(pattern)
        return sum(e - s for n, s, e in self.device if rx.search(n)) / 1e6

    def breakdown(self) -> dict:
        by_name: dict[str, float] = {}
        for n, s, e in self.device:
            by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e6
        gaps: dict[str, float] = {}
        for s, e in idle_gaps(self.device, self.start, self.end):
            mid = 0.5 * (s + e)
            covering = [h for h in self.host if h[1] <= mid <= h[2]]
            name = min(covering, key=lambda h: h[2] - h[1])[0] if covering else "between_spans"
            gaps[name] = gaps.get(name, 0.0) + (e - s) / 1e6
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
        return {"device_ops": top(by_name), "idle_gaps": top(gaps)}


def union_seconds(intervals, start: float, end: float) -> float:
    total, cursor = 0.0, start
    for s, e in sorted((max(s, start), min(e, end)) for _, s, e in intervals):
        if e <= cursor:
            continue
        total += e - max(s, cursor)
        cursor = e
    return total / 1e6


def idle_gaps(intervals, start: float, end: float):
    cursor = start
    for s, e in sorted((max(s, start), min(e, end)) for _, s, e in intervals):
        if s > cursor:
            yield cursor, s
        cursor = max(cursor, e)
    if cursor < end:
        yield cursor, end


def parse(events: list) -> Trace:
    """A Trace from Chrome-trace events (complete events, microseconds)."""
    window = next(e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation")
    start, end = float(window["ts"]), float(window["ts"]) + float(window["dur"])
    device = [
        (e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
        for e in events
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS and float(e["ts"]) < end and float(e["ts"]) + float(e["dur"]) > start
    ]
    host = [
        (e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
        for e in events
        if e.get("cat") == "user_annotation" and e.get("name") in SPANS
    ]
    return Trace(window_s=(end - start) / 1e6, busy_s=union_seconds(device, start, end), device=device, host=host,
                 start=start, end=end)


@contextmanager
def traced(out_dir: Path, sink: list):
    """Profile the block; appends its Trace to `sink` once it has closed.
    The block is synchronised at both ends."""
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "trace.json"
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    with torch.profiler.profile(activities=activities) as prof:
        sync()
        with torch.profiler.record_function(WINDOW):
            yield
            sync()
    prof.export_chrome_trace(str(path))
    try:
        with open(path) as f:
            sink.append(parse(json.load(f)["traceEvents"]))
    finally:
        path.unlink()


def span(name: str, enabled: bool):
    """A host span the trace names idle gaps by (a no-op when not tracing)."""
    return torch.profiler.record_function(name) if enabled else nullcontext()
