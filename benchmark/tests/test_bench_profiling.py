"""The trace reader: busy time is the union of device intervals inside the
traced window, and idle gaps are named by the host span open at the time."""

from __future__ import annotations

import pytest

from benchmark import profiling


def _events():
    return [
        {"ph": "X", "cat": "user_annotation", "name": "traced_window", "ts": 100.0, "dur": 100.0},
        {"ph": "X", "cat": "user_annotation", "name": "encode", "ts": 100.0, "dur": 50.0},
        {"ph": "X", "cat": "user_annotation", "name": "render", "ts": 150.0, "dur": 50.0},
        {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 110.0, "dur": 20.0},
        {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 120.0, "dur": 20.0},  # overlaps the first
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 90.0, "dur": 15.0},  # starts before
        {"ph": "X", "cat": "kernel", "name": "composite_fwd_kernel", "ts": 170.0, "dur": 10.0},
        {"ph": "X", "cat": "kernel", "name": "late", "ts": 250.0, "dur": 10.0},  # after the window
        {"ph": "X", "cat": "gpu_user_annotation", "name": "encode", "ts": 100.0, "dur": 90.0},
    ]


def test_busy_is_the_union_inside_the_window():
    trace = profiling.parse(_events())
    assert trace.window_s == pytest.approx(100e-6)
    # [100, 105) + [110, 140) + [170, 180) = 45 us
    assert trace.busy_s == pytest.approx(45e-6)
    assert trace.kernel_seconds(r"composite_fwd_kernel") == pytest.approx(10e-6)


def test_idle_gaps_are_named_by_the_open_span():
    gaps = dict(profiling.parse(_events()).breakdown()["idle_gaps"])
    # Gaps [105, 110) (mid-point in encode), [140, 170) and [180, 200)
    # (mid-points in render).
    assert gaps["encode"] == pytest.approx(5e-6)
    assert gaps["render"] == pytest.approx(50e-6)
