"""The port's tracer: named spans and counters inside the program.

Tracing is on after `enable(True)`, and also while a `torch.profiler`
session records, so that any profile of an entry point carries the
program's spans. Off, `span` and `sync_point` cost a flag check and return
a shared no-op context, and `count` and `count_device` return at once.

On, a span

* opens `torch.profiler.record_function(name)` while a profiler records, so
  that it lands in the profiler's Chrome trace on the clock of the device's
  kernel records (and as an NVTX range under
  `torch.autograd.profiler.emit_nvtx`); with no profiler there is nothing to
  land in, and the range (about 12 us of host time) is left out;
* records a CUDA event pair on the current stream for its device time
  (where CUDA is initialised; else the host clock), resolved only by
  `read`, which synchronises once;
* records its host time with `perf_counter`.

`sync_point(name)` is a span around a place where the host waits for the
device; it adds one to the `host_syncs` counter and the block's host time to
`sync_wait_ms`, and inside it a `torch.cuda.set_sync_debug_mode` check is
lifted, so that under "error" every sync the program does not declare
raises. `count(name, n)` adds a host number, `count_device(name, x)` the sum
of a device tensor (without a sync, resolved by `read`). `count_launch` is
the launch counter of the port's hand-written kernels, which counts whether
or not tracing is on; a launch counter named `<name>.traced` counts only
while tracing is on, replays included, so that it covers the same scenes as
a trace (`linear_split_flops.traced`, the work of K10's launches).

`count_always(name)` counts whether or not tracing is on too, and while it is
on also under `<name>.traced`, so that a reader of a traced window can tell
the window's share from the process's total.

`held()` is for CUDA graph capture (`model/encoder/graphs.py`): within it
the thread records no span, sync point or count (an event recorded into a
graph has no time), and each launch count goes to the dict it yields, which
the graph's replays hand back through `count_launches`. So a launch inside
a replayed graph counts as it did eagerly.

`read()` returns `{"spans": {name: {"calls", "host_ms", "device_ms"}},
"counters": {name: number}}`, totals since the last `reset()`.

Spans are named `<layer>.<stage>`: `encoder.backbone`, `encoder.epipolar`,
`encoder.refine` and `encoder.heads` (the epipolar encoder);
`encoder.backbone`, `encoder.mv_transformer`, `encoder.costvolume`,
`encoder.cv_refine`, `encoder.depth_refine` and `encoder.heads` (the
cost-volume encoder, which also counts `costvolume_taps`);
`encoder.backbone`, `encoder.transformer` and `encoder.heads` (the GS-LRM
encoder, which also counts `gslrm_tokens`); `settings.project`,
`settings.occupancy` and the sync point `settings.read` (the render-settings
probe); `render.project`, `render.bin` and `render.composite` (one view of
the rasterizer); `kernel.k1` and `kernel.k2` (each compositing launch);
`setup.kernel_build` (an nvcc run).
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from time import perf_counter
from typing import Callable, Iterator, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

_on = False
_lock = threading.Lock()  # counters are added to from kernel-build threads too
_thread = threading.local()  # `held`: the launch counts of a capture on this thread, else None


def active() -> bool:
    """Whether spans and counters record now."""
    return _on or _autograd_profiler._is_profiler_enabled


def enable(on: bool = True) -> None:
    global _on
    _on = bool(on)


class _Store:
    def __init__(self):
        self.pending: list = []  # (name, start, end, host_s), device times unresolved
        self.spans: dict[str, list] = {}  # name -> [calls, host_ms, device_ms]
        self.counters: dict[str, float] = {}
        self.device_counters: dict[str, torch.Tensor] = {}

    def add_span(self, name, start, end, host_s) -> None:
        self.pending.append((name, start, end, host_s))

    def resolve(self) -> None:
        if any(not isinstance(start, float) for _, start, _, _ in self.pending):
            torch.cuda.synchronize()
        for name, start, end, host_s in self.pending:
            device_ms = (end - start) * 1e3 if isinstance(start, float) else start.elapsed_time(end)
            entry = self.spans.setdefault(name, [0, 0.0, 0.0])
            entry[0] += 1
            entry[1] += host_s * 1e3
            entry[2] += device_ms
        self.pending = []
        for name, total in self.device_counters.items():
            self.counters[name] = self.counters.get(name, 0) + int(total)
        self.device_counters = {}


_store = _Store()


def _mark(cuda: bool):
    if cuda:
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event
    return perf_counter()


class Span:
    """A named block: a `record_function` range while a profiler records, a
    device-time mark pair (CUDA events when `cuda`, else the host clock) and
    its host time, handed to `sink(name, start, end, host_s)` at its end.
    `Benchmarker.time_device` and the tracer's spans share it."""

    __slots__ = ("name", "sink", "cuda", "annotation", "start", "t0")

    def __init__(self, name: str, sink: Callable, cuda: bool):
        self.name, self.sink, self.cuda = name, sink, cuda

    def __enter__(self):
        self.annotation = None
        if _autograd_profiler._is_profiler_enabled:
            self.annotation = torch.profiler.record_function(self.name)
            self.annotation.__enter__()
        self.t0 = perf_counter()
        self.start = _mark(self.cuda)
        return self

    def __exit__(self, *exc):
        end = _mark(self.cuda)
        self.sink(self.name, self.start, end, perf_counter() - self.t0)
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        return False


class _SyncPoint(Span):
    __slots__ = ("debug_mode",)

    def __enter__(self):
        super().__enter__()
        self.debug_mode = torch.cuda.get_sync_debug_mode() if self.cuda else 0
        if self.debug_mode:
            torch.cuda.set_sync_debug_mode(0)
        return self

    def __exit__(self, *exc):
        if self.debug_mode:
            torch.cuda.set_sync_debug_mode(self.debug_mode)
        _add("host_syncs", 1)
        _add("sync_wait_ms", (perf_counter() - self.t0) * 1e3)
        return super().__exit__(*exc)


class _NoOp:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoOp()


def _held() -> Optional[dict]:
    return getattr(_thread, "launches", None)


def span(name: str):
    """A span named `name` while tracing is on, else a shared no-op."""
    if not (_on or _autograd_profiler._is_profiler_enabled) or _held() is not None:
        return _NOOP
    return Span(name, _store.add_span, torch.cuda.is_initialized())


def sync_point(name: str):
    """A span around a block in which the host waits for the device."""
    if not (_on or _autograd_profiler._is_profiler_enabled) or _held() is not None:
        return _NOOP
    return _SyncPoint(name, _store.add_span, torch.cuda.is_initialized())


def _add(name: str, n: float) -> None:
    with _lock:
        _store.counters[name] = _store.counters.get(name, 0) + n


def count(name: str, n: float = 1) -> None:
    """Add a host number to counter `name` while tracing is on."""
    if (_on or _autograd_profiler._is_profiler_enabled) and _held() is None:
        _add(name, n)


def count_device(name: str, x: torch.Tensor) -> None:
    """Add the sum of device tensor `x` to counter `name` while tracing is
    on: queued on the device, read by `read`."""
    if (_on or _autograd_profiler._is_profiler_enabled) and _held() is None:
        total = x.sum(dtype=torch.int64)
        previous = _store.device_counters.get(name)
        _store.device_counters[name] = total if previous is None else previous + total


def _add_launch(name: str, n: float) -> None:
    if not name.endswith(".traced") or _on or _autograd_profiler._is_profiler_enabled:
        _add(name, n)


def count_launch(name: str, n: float = 1) -> None:
    """Add `n` to launch counter `name` (one launch of a hand-written
    kernel, or its work), whether or not tracing is on unless the name ends
    in `.traced` (inside `held`, into the capture's own counts)."""
    launches = _held()
    if launches is not None:
        launches[name] = launches.get(name, 0) + n
    else:
        _add_launch(name, n)


def count_launches(launches: dict) -> None:
    """Add a captured graph's launch counts (`held`), once a replay."""
    for name, n in launches.items():
        _add_launch(name, n)


def count_always(name: str, n: float = 1) -> None:
    """Add `n` to counter `name` whether or not tracing is on; while it is
    on, to `<name>.traced` as well."""
    _add(name, n)
    if _on or _autograd_profiler._is_profiler_enabled:
        _add(f"{name}.traced", n)


@contextmanager
def held() -> Iterator[dict]:
    """Within the block this thread records no span, sync point or count;
    its launch counts go to the dict yielded."""
    previous = _held()
    _thread.launches = launches = {}
    try:
        yield launches
    finally:
        _thread.launches = previous


def counter(name: str) -> float:
    """Counter `name`'s host total (device counts are added by `read`)."""
    return _store.counters.get(name, 0)


def reset() -> None:
    """Forget every span and counter."""
    global _store
    _store = _Store()


def read() -> dict:
    """Totals since the last `reset`; synchronises once where device times
    or counts are pending."""
    _store.resolve()
    spans = {
        name: {"calls": calls, "host_ms": host_ms, "device_ms": device_ms}
        for name, (calls, host_ms, device_ms) in _store.spans.items()
    }
    return {"spans": spans, "counters": dict(_store.counters)}


def table(result: Optional[dict] = None) -> str:
    """`read()` (or `result`) as aligned text lines: spans, then counters."""
    result = read() if result is None else result
    lines = [f"{'span':<22} {'calls':>6} {'host ms':>11} {'device ms':>11}"]
    for name, s in sorted(result["spans"].items()):
        lines.append(f"{name:<22} {s['calls']:>6} {s['host_ms']:>11.3f} {s['device_ms']:>11.3f}")
    lines.append(f"{'counter':<22} {'total':>6}")
    for name, value in sorted(result["counters"].items()):
        lines.append(f"{name:<22} {value:>6.6g}" if isinstance(value, float) else f"{name:<22} {value:>6}")
    return "\n".join(lines)
