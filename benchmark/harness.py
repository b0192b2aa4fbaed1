"""One run of one cell: set-up, the measured window, the check against the
plain reference, the cell's metrics, and the result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

With `--trace 0` the result carries the cell's end-to-end metrics; with
`--trace 1` its per-layer metrics, read from a profiled sub-window of a few
scenes at the window's start, from CUDA-event spans and from the work the
reference counted. The card's name, power limit and clocks are printed
before and after the window; the numbers the check compared, each beside
its limit, are the last lines on standard error and the last key of the
result, which is the last line on standard output.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time

import torch

from . import check, loops, port, spec, work
from .spec import ROOT

# Top-level module names the process must not hold once the window closes:
# the JAX package is the port's reference, never its dependency.
FORBIDDEN = ("jax", "jaxlib", "flax", "pixelsplat_tpu")
OUT_DIR = ROOT / "build" / "benchmark"


def card_state() -> str:
    query = "name,power.limit,power.draw,clocks.sm,clocks.max.sm,clocks.mem,temperature.gpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError) as err:
        return f"nvidia-smi unavailable: {err}"
    return f"{query}: {out.strip().splitlines()[0]}"


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t_process: float, faults=None) -> dict:
    """The result of one run, as the result line holds it."""
    port.set_precision(cell.config)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        print(f"card before the window | {card_state()}", flush=True)
    run = loops.LOOPS[cell.traffic["kind"]](cell, seed, seconds, trace, device, t_process, OUT_DIR, faults)
    if on_card:
        print(f"card after the window | {card_state()}", flush=True)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    values, works, detail = check.CHECKS[run.kind](cell, run, seed, device)
    print(f"check: {time.perf_counter() - t_check:.1f} s after the window; {detail}", flush=True)
    run.work["flops"] = work.flops_of(cell.config["name"])
    run.work["views"] = [w for unit in run.traced for w in works.get(unit, [])]
    metrics = {}
    for entry in cell.metrics_layer if trace else cell.metrics_e2e:
        value = spec.metric_reader(entry["name"])(run)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    device_info = {
        "platform": "gpu" if on_card else torch.device(device).type,
        "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
        "count": 1,
        "memory_peak_bytes": run.peak_bytes,
    }
    result = {"correct": False, "attempted": run.done, "failed": run.failed, "metrics": metrics, "device": device_info}
    if trace and run.trace is not None:
        device_info["busy_s"] = run.trace.busy_s
        device_info["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
    checks = check.verdict(values, cell.limits)
    result["correct"] = check.passed(checks)
    result["checks"] = checks
    return result


def main(argv: list[str], t_process: float) -> int:
    parser = argparse.ArgumentParser(description="Run one benchmark cell once on this machine's GPU.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    bench = spec.load_json(ROOT / "BENCHMARK.json")
    chips = next(w["chips"] for w in bench["workloads"] if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: the cell needs {chips} CUDA device(s), this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_process)
    found = forbidden_modules()
    if found:
        print(f"no result: the process holds {found} after the window", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
