"""Where the harness finds a cell's pieces by name: `BENCHMARK.json` at the
root of the checkout, `configs/<config>.json`, `traffic/<traffic>.json`,
`limits/<workload>.json`, `metrics/<metric>.py` and the configuration's
reference model `reference/<module>.py`, all beside this file."""

from __future__ import annotations

import hashlib
import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    metrics_e2e: list  # BENCHMARK.json entries of the end-to-end metrics this cell reports
    metrics_layer: list  # ... of its per-layer metrics


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, bench_path: Path = ROOT / "BENCHMARK.json", base: Path = HERE) -> Cell:
    bench = load_json(bench_path)
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise SystemExit(f"no workload {workload!r} in {bench_path}")
    return Cell(
        name=workload,
        config=load_json(base / "configs" / f"{entry['config']}.json"),
        traffic=load_json(base / "traffic" / f"{entry['traffic']}.json"),
        limits=load_json(base / "limits" / f"{workload}.json"),
        metrics_e2e=[m for m in bench["end_to_end"] if _applies(m, workload)],
        metrics_layer=[m for m in bench["per_layer"] if _applies(m, workload)],
    )


def metric_reader(name: str, base: Path = HERE):
    """The `read(run)` function of `metrics/<name>.py`."""
    path = base / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def reference_module(config: dict):
    """The module `reference/<name>.py` that holds the configuration's plain
    reference model, `name` being the file's `"reference"`, or `encoder`
    where it has none; its contract is `reference/__init__.py`'s."""
    name = config.get("reference", "encoder")
    if not isinstance(name, str) or not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", name):
        raise ValueError(f"configuration {config.get('name')!r}: reference {name!r} is not a module name")
    module = importlib.import_module(f"{__package__}.reference.{name}")
    missing = [attr for attr in ("Encoder", "apply_shims") if not hasattr(module, attr)]
    if missing:
        raise ValueError(f"configuration {config.get('name')!r}: reference/{name}.py lacks {missing}")
    return module


def sub_seed(seed: int, tag: str) -> int:
    """An independent 63-bit seed for one use of the run's seed."""
    return int(hashlib.sha256(f"{seed}:{tag}".encode()).hexdigest()[:15], 16)
