"""Idle device time of a traced run, named by the innermost span open on the
host at each instant: the program's own spans
(`pixelsplat_tpu_torch/utils/tracing.py`, which record while the profiler
does) as well as the benchmark's `encode`, `settings` and `render`.

    python3 -m benchmark.idle_by_span --workload <name> --seed <n> --seconds <s>

from the root of a checkout. It runs the cell as `run.py --trace 1` does,
with `run.py`'s process settings, prints the result line as `run.py` does,
then, on standard error, the table: for each span, the idle milliseconds a
traced scene while it was the innermost one open, and its share of all idle
time in the traced window. Unlike the result's `breakdown.idle_gaps`, which
names a whole gap by the span open at its mid-point, a gap that outlasts a
span is split at the span's ends.
"""

from __future__ import annotations

import bisect
import sys

OUTSIDE = "outside_spans"


def idle_by_span(events: list) -> dict:
    """Idle seconds of the traced window by innermost open span, from the
    Chrome trace's events."""
    from . import profiling

    trace = profiling.parse(events)
    spans = sorted(
        (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
        for e in events
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e.get("name") != profiling.WINDOW
        and float(e["ts"]) < trace.end and float(e["ts"]) + float(e["dur"]) > trace.start
    )
    starts = [s for s, _, _ in spans]
    idle: dict[str, float] = {}
    for gap_start, gap_end in profiling.idle_gaps(trace.device, trace.start, trace.end):
        near = [sp for sp in spans[:bisect.bisect_left(starts, gap_end)] if sp[1] > gap_start]
        cuts = sorted({gap_start, gap_end, *(t for s, e, _ in near for t in (s, e) if gap_start < t < gap_end)})
        for a, b in zip(cuts, cuts[1:]):
            mid = 0.5 * (a + b)
            covering = [sp for sp in near if sp[0] <= mid <= sp[1]]
            name = min(covering, key=lambda sp: sp[1] - sp[0])[2] if covering else OUTSIDE
            idle[name] = idle.get(name, 0.0) + (b - a) / 1e6
    return idle


def scenes_of(events: list) -> int:
    return sum(1 for e in events if e.get("cat") == "user_annotation" and e.get("name") == "encode")


def format_table(idle: dict, scenes: int) -> str:
    total = sum(idle.values()) or 1.0
    lines = [f"idle device time by innermost open span, over {scenes} traced scene(s):",
             f"{'span':<24} {'ms a scene':>11} {'share':>7}"]
    for name, seconds in sorted(idle.items(), key=lambda kv: -kv[1]):
        lines.append(f"{name:<24} {1e3 * seconds / max(scenes, 1):>11.3f} {seconds / total:>7.1%}")
    return "\n".join(lines)


def main(argv: list[str], main_of_run, t_process: float) -> int:
    """`main_of_run(argv, t_process)` (the harness's) with `--trace 1`, then
    the table of each trace it parsed."""
    from . import profiling

    traces: list = []
    parse = profiling.parse

    def keep(events):
        traces.append(events)
        return parse(events)

    profiling.parse = keep
    try:
        code = main_of_run([*argv, "--trace", "1"], t_process)
    finally:
        profiling.parse = parse
    for events in traces:
        print(format_table(idle_by_span(events), scenes_of(events)), file=sys.stderr, flush=True)
    return code


if __name__ == "__main__":
    from benchmark import run  # the entry point's process settings, then its harness

    sys.exit(main(sys.argv[1:], run.main, run.T_PROCESS))
