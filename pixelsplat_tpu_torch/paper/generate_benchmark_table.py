"""Build the runtime/memory benchmark LaTeX table.

Port of `pixelsplat_tpu/paper/generate_benchmark_table.py`:
consumes each method's benchmark.json (per-tag timing lists from the
Benchmarker) and peak_memory.json, producing a LaTeX table of encoder /
render time and peak memory.

Usage:
  python -m pixelsplat_tpu_torch.paper.generate_benchmark_table \
      name1=path/to/method1 name2=path/to/method2 [out.tex]
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

from .table import Metric, make_latex_table


def load_method(path: Path) -> dict[str, float]:
    out: dict[str, float] = {}
    bench = path / "benchmark.json"
    if bench.exists():
        data = json.loads(bench.read_text())
        for tag, times in data.items():
            out[f"{tag}_ms"] = 1e3 * float(np.mean(times))
    mem = path / "peak_memory.json"
    if mem.exists():
        data = json.loads(mem.read_text())
        peak = data.get("peak_bytes_in_use") or data.get("bytes_in_use")
        if peak:
            out["peak_gb"] = float(peak) / 1e9
    return out


def main(argv: list[str]) -> None:
    pairs = [a for a in argv if "=" in a]
    rest = [a for a in argv if "=" not in a]
    methods = []
    keys: set[str] = set()
    for pair in pairs:
        name, _, path = pair.partition("=")
        values = load_method(Path(path))
        keys.update(values)
        methods.append((name, values))
    metrics = [
        Metric(k.replace("_ms", " (ms)").replace("_gb", " (GB)"), k, "lower", 1)
        for k in sorted(keys)
    ]
    table = make_latex_table(methods, metrics)
    print(table)
    if rest:
        Path(rest[0]).write_text(table)
        print(f"Wrote {rest[0]}")


if __name__ == "__main__":
    main(sys.argv[1:])
