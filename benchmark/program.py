"""The program's own spans and counters over a traced run, for the
per-layer metrics that read them.

The port's tracer (`pixelsplat_tpu_torch/utils/tracing.py`) records while a
`torch.profiler` session does, so after a `--trace 1` run it holds the
traced scenes' spans and counters: `read(run)` returns its `read()`, or the
run's own `program` where a loop stored one. It returns None where the
checkout's program has no tracer or recorded nothing, so that the metrics
that read it are left out of the result line.

A scene is one call of the span `encoder.backbone`, a view one call of
`render.composite`.
"""

from __future__ import annotations


def read(run):
    if run.kind != "eval":
        return None
    found = getattr(run, "program", None)
    if found is None:
        try:
            from pixelsplat_tpu_torch.utils import tracing
        except ImportError:
            return None
        found = tracing.read()
    spans = found.get("spans", {})
    if not spans.get("encoder.backbone", {}).get("calls"):
        return None
    return found


def calls(found: dict, name: str) -> int:
    return found["spans"].get(name, {}).get("calls", 0)


def per_scene(run, names: tuple, clock: str = "device_ms"):
    """The spans' summed milliseconds on `clock` per scene."""
    found = read(run)
    if found is None:
        return None
    return sum(found["spans"].get(n, {}).get(clock, 0.0) for n in names) / calls(found, "encoder.backbone")


def per_view(run, names: tuple):
    """The spans' summed device milliseconds per rendered view."""
    found = read(run)
    if found is None or not calls(found, "render.composite"):
        return None
    return sum(found["spans"].get(n, {}).get("device_ms", 0.0) for n in names) / calls(found, "render.composite")
