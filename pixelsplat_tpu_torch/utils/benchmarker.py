"""Wall-clock benchmarker with a JSON dump, and the device's memory stats.

Port of `pixelsplat_tpu/utils/benchmarker.py`. `sync` waits for the device
the benchmarker was made for (`torch.cuda.synchronize`; nothing on the
CPU), so a timed block that ends in it times the device's work.
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


class Benchmarker:
    def __init__(self, device: Union[str, torch.device] = "cpu"):
        self.device = torch.device(device)
        self.execution_times: dict[str, list[float]] = defaultdict(list)

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

    def sync(self) -> None:
        """Wait for the device's queued work."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def dump(self, path: Path) -> None:
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
        return {tag: float(np.mean(times)) for tag, times in self.execution_times.items()}

    def clear_history(self) -> None:
        self.execution_times = defaultdict(list)
