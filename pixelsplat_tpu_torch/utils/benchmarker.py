"""Wall-clock benchmarker with a JSON dump, and the device's memory stats.

Port of `pixelsplat_tpu/utils/benchmarker.py`. `sync` waits for the device
the benchmarker was made for (`torch.cuda.synchronize`; nothing on the
CPU), so a timed block that ends in it times the device's work.
`time_device` times the work a block queues on the card with CUDA events,
without a sync: the events are read when the times are (`dump`,
`summarize`); on the CPU it is `time`. Its blocks are the tracer's spans
(`utils/tracing.py::Span`), so each also lands in a `torch.profiler`
trace under its tag.
`dump_memory` writes `torch.cuda.memory_stats` as ints, with the two keys
that `paper/generate_benchmark_table.py` reads, `peak_bytes_in_use` and
`bytes_in_use`; on the CPU it writes `{}`.
"""

from __future__ import annotations

import json
from collections import defaultdict
from contextlib import contextmanager
from pathlib import Path
from time import perf_counter
from typing import Iterator, Union

import numpy as np
import torch

from .tracing import Span


class Benchmarker:
    def __init__(self, device: Union[str, torch.device] = "cpu"):
        self.device = torch.device(device)
        self.execution_times: dict[str, list[float]] = defaultdict(list)
        # (tag, start, end) CUDA events of `time_device` blocks not read yet.
        self._events: list = []

    @contextmanager
    def time(self, tag: str, num_calls: int = 1) -> Iterator[None]:
        """Record the block's seconds under `tag`, split evenly over
        `num_calls` entries."""
        start_time = perf_counter()
        try:
            yield
        finally:
            elapsed = perf_counter() - start_time
            self.execution_times[tag].extend([elapsed / num_calls] * num_calls)

    @contextmanager
    def time_device(self, tag: str) -> Iterator[None]:
        """Record, under `tag`, the seconds between the device reaching the
        block's start and its end (the host clock off the card)."""
        if self.device.type != "cuda":
            with self.time(tag):
                yield
            return
        with Span(tag, lambda name, start, end, _host_s: self._events.append((name, start, end)), cuda=True):
            yield

    def _read_events(self) -> None:
        if self._events:
            self.sync()
            for tag, start, end in self._events:
                self.execution_times[tag].append(start.elapsed_time(end) / 1e3)
            self._events = []

    def sync(self) -> None:
        """Wait for the device's queued work."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def dump(self, path: Path) -> None:
        self._read_events()
        path = Path(path)
        path.parent.mkdir(exist_ok=True, parents=True)
        with path.open("w") as f:
            json.dump(dict(self.execution_times), f)

    def memory_stats(self) -> dict[str, int]:
        if self.device.type != "cuda":
            return {}
        stats = {k: int(v) for k, v in torch.cuda.memory_stats(self.device).items()}
        stats["peak_bytes_in_use"] = int(torch.cuda.max_memory_allocated(self.device))
        stats["bytes_in_use"] = int(torch.cuda.memory_allocated(self.device))
        return stats

    def dump_memory(self, path: Path) -> None:
        path = Path(path)
        path.parent.mkdir(exist_ok=True, parents=True)
        with path.open("w") as f:
            json.dump(self.memory_stats(), f)

    def summarize(self) -> dict[str, float]:
        self._read_events()
        return {tag: float(np.mean(times)) for tag, times in self.execution_times.items()}

    def clear_history(self) -> None:
        self.execution_times = defaultdict(list)
        self._events = []
