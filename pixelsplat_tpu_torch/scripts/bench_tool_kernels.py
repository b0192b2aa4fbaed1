"""Timings of the two tool kernels that a single PyTorch call can stand in
for: the row-major copy (`copy_rows`, against `clone`) and y = 2 x
(`smoke_scale`, against `torch.mul`), on the GPU.

    python -m pixelsplat_tpu_torch.scripts.bench_tool_kernels

`copy_rows` runs on the five layouts of `copy_layouts` (the segment-sum
bench's (820,224, 24) 16-bit table contiguous and transposed, its two f32
column-major tables `d_rows` and `csum`, and one view with padded rows,
which takes the general route), `smoke_scale` on a (256, 256) f32 array.
Each output is first held bit for bit against the plain version; the
`edge_layouts` (8-byte elements, one column, row counts that are no
multiple of a tile, inputs off a 16-byte boundary, a table wide enough to
be cut into column groups) are held the same way and not timed. Columns:

  ms, lib ms      median over `rounds` alternating rounds (kernel first in
                  even rounds, the library call first in odd ones) of the
                  mean ms per call from CUDA events around `iters` calls
  dev ms          device-only time per call from `torch.profiler`: the
                  CUDA activity (kernels and copies) of `iters` further
                  calls, summed by name and divided by the calls
  host us         host microseconds per call: `time.perf_counter` around
                  1,000 calls of the wrapper with no synchronisation, on
                  the first 4,096 rows of the same layout (same strides
                  and route, so the device never holds the host back)
  bound           bytes read once and written once over 3.35 TB/s
  route           the copy kernel's route for the layout

The card's name and power limit (nvidia-smi) are printed first and last.
Compare numbers only within one run: host-bound times drift between runs.
"""

from __future__ import annotations

import argparse
import statistics
import time
from typing import Callable, Optional

import torch

from .. import kernel_build
from ..ops import kernel_tools
from . import bench_segment_sum
from .eval_scene import card_line, cuda_ms

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA's data sheet
HOST_CALLS = 1000
HOST_ROWS = 4096


# ---------------------------------------------------------------------------
# Inputs


def copy_layouts(device, n: int = bench_segment_sum.N, f: int = bench_segment_sum.F) -> dict[str, torch.Tensor]:
    """The five timed layouts, from the segment-sum bench's rows (n a
    multiple of 128): label -> (rows, columns) tensor."""
    d_rows, _ = bench_segment_sum.bench_inputs(device, n=n, f=f)  # (n, f) f32, strides (1, n)
    contiguous, transposed = bench_segment_sum.u16_table(d_rows)
    # `segment_sum_sorted`'s prefix table: (f, n + 1) contiguous, transposed.
    csum = torch.cat([torch.zeros_like(d_rows[:1].t()), d_rows.t()], dim=1).t()
    return {
        f"int16 ({n}, {2 * f}) contiguous": contiguous,
        f"int16 ({n}, {2 * f}) transposed": transposed,
        f"d_rows f32 ({n}, {f}) column-major": d_rows,
        f"csum f32 ({n + 1}, {f}) column-major": csum,
        f"f32 ({n}, {f - 1}) padded rows of {f}": d_rows.contiguous()[:, : f - 1],
    }


def edge_layouts(device, seed: int = 0) -> dict[str, torch.Tensor]:
    """Small layouts at the routes' edges, with seeded random values."""
    g = torch.Generator(device=device).manual_seed(seed)

    def normal(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=device, dtype=dtype)

    bits = torch.randint(-(2**15), 2**15, (24, 1002), generator=g, device=device, dtype=torch.int16)
    return {
        "f64 (1001, 5) contiguous": normal(1001, 5, dtype=torch.float64),
        "f64 (1001, 5) transposed": normal(5, 1001, dtype=torch.float64).t(),
        "f32 (777, 1) contiguous": normal(777, 1),
        "f32 (777, 1) column view": normal(1, 777).t(),
        "int16 (1001, 24) row-major, 2 bytes off a 16-byte boundary": bits.reshape(-1)[1 : 1 + 1001 * 24].view(1001, 24),
        "int16 (1001, 24) column-major, 2 bytes off": bits[:, 1:].t(),
        "f32 (300, 200) transposed, in column groups": normal(200, 300).t(),
        "f32 (5, 3) column-major": normal(3, 5).t(),
    }


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal shapes, types and bits (so -0.0 differs from 0.0)."""
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a.view(ints), b.view(ints))


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


# ---------------------------------------------------------------------------
# Measurements


def raw_stream_matches() -> bool:
    """The launch path's stream handle equals PyTorch's on a side stream."""
    index = torch.cuda.current_device()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        ok = kernel_build.current_raw_stream(index) == torch.cuda.current_stream().cuda_stream
    return ok and side.cuda_stream != torch.cuda.default_stream(index).cuda_stream


def alternating_ms(kernel: Callable, library: Callable, rounds: int, iters: int) -> tuple[float, float]:
    """Median ms per call of each over `rounds` rounds, the order swapped
    every round."""
    kernel_ms, library_ms = [], []
    for r in range(rounds):
        pair = ((kernel, kernel_ms), (library, library_ms))
        for fn, out in pair if r % 2 == 0 else pair[::-1]:
            out.append(cuda_ms(fn, iters=iters))
    return statistics.median(kernel_ms), statistics.median(library_ms)


def device_ms(fn: Callable, calls: int) -> tuple[Optional[float], dict[str, float]]:
    """(device-only ms per call, ms per call by kernel name) from the CUDA
    activity `torch.profiler` records over `calls` calls; (None, {}) where
    it records none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_name: dict[str, float] = {}
    for event in prof.events():
        if event.device_type == DeviceType.CUDA:
            by_name[event.name] = by_name.get(event.name, 0.0) + event.time_range.elapsed_us()
    if not by_name:
        return None, {}
    return sum(by_name.values()) / calls / 1e3, {k: v / calls / 1e3 for k, v in by_name.items()}


def host_us(fn: Callable, calls: int = HOST_CALLS) -> float:
    """Host microseconds per call over `calls` calls, no synchronisation
    inside the timed loop."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / calls * 1e6


def check_edges(layouts: dict[str, torch.Tensor]) -> list[dict]:
    """Per edge layout: its route and whether the kernel's copy has the
    plain version's bits."""
    rows = []
    for label, x in layouts.items():
        out = kernel_tools.copy_rows(x)
        route = kernel_tools.copy_rows_route(
            tuple(x.shape), x.stride(), x.element_size(), x.data_ptr(), out.data_ptr()
        )
        torch.cuda.synchronize()
        rows.append(dict(label=label, route=route, equal=same_bits(out, kernel_tools.copy_rows_plain(x))))
    return rows


def bench_tools(layouts: dict[str, torch.Tensor], seed: int = 0, rounds: int = 7) -> tuple[list[dict], dict]:
    """(one row per copy layout, one row for smoke_scale on a (256, 256)
    f32 array): the bit-for-bit check against the plain version (`clone`,
    `x * 2`), the copy's route and the times of the module docstring,
    beside the library call (`clone`, `torch.mul`). The profiler runs
    last: in one process, host work after a profiled run was slower (on an
    H100's host), so every CUDA-event and host timing comes first."""
    x = torch.randn((256, 256), device="cuda", generator=torch.Generator(device="cuda").manual_seed(seed))
    cases = [dict(
        row=dict(label="f32 (256, 256)"), x=x, kernel=kernel_tools.smoke_scale, plain=kernel_tools.smoke_scale_plain,
        library=lambda x: torch.mul(x, 2.0), head=x, iters=200,
    )]
    for label, t in layouts.items():
        out = kernel_tools.copy_rows(t)
        route = kernel_tools.copy_rows_route(tuple(t.shape), t.stride(), t.element_size(), t.data_ptr(), out.data_ptr())
        cases.append(dict(
            row=dict(label=label, shape=tuple(t.shape), strides=t.stride(), route=route), x=t,
            kernel=kernel_tools.copy_rows, plain=kernel_tools.copy_rows_plain, library=kernel_tools.copy_rows_plain,
            head=t[:HOST_ROWS], iters=20,
        ))
    for case in cases:
        row, t, kernel, library = case["row"], case["x"], case["kernel"], case["library"]
        out, plain = kernel(t), case["plain"](t)
        torch.cuda.synchronize()
        row.update(equal=same_bits(out, plain) and out.is_contiguous(), max_abs_err=max_abs_err(out, plain),
                   bound_ms=2 * t.numel() * t.element_size() / PEAK_BYTES_PER_S * 1e3)
        del out, plain
        row["ms"], row["library_ms"] = alternating_ms(lambda: kernel(t), lambda: library(t), rounds, case["iters"])
        head = case["head"]
        row["host_us"] = host_us(lambda: kernel(head))
    smoke = cases[0]["row"]
    smoke["plain_ms"] = cuda_ms(lambda: kernel_tools.smoke_scale_plain(x), iters=200)
    for case in cases:
        row, t, kernel, library = case["row"], case["x"], case["kernel"], case["library"]
        row["device_ms"], names = device_ms(lambda: kernel(t), case["iters"])
        row["library_device_ms"], library_names = device_ms(lambda: library(t), case["iters"])
        row.update(device_kernels=sorted(names), library_kernels=sorted(library_names))
    return [case["row"] for case in cases[1:]], smoke


def _ms(value: Optional[float]) -> str:
    return "not measured" if value is None else f"{value:.5f}"


def format_row(name: str, row: dict) -> str:
    route = f" route {row['route']}," if "route" in row else ""
    return (f"{name} {row['label']}:{route} same bits {row['equal']} | ms {row['ms']:.5f} lib {row['library_ms']:.5f} "
            f"| dev ms {_ms(row['device_ms'])} lib {_ms(row['library_device_ms'])} "
            f"| host us {row['host_us']:.2f} | bound {row['bound_ms']:.5f} ms (bytes)")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rounds", type=int, default=7)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_tool_kernels needs a CUDA device")
    card = card_line()
    print(f"card: {card}", flush=True)
    if not raw_stream_matches():
        raise SystemExit("FAIL: the raw stream handle differs from torch.cuda.current_stream() on a side stream")
    failed = []
    for row in check_edges(edge_layouts("cuda")):
        print(f"copy_rows edge {row['label']}: route {row['route']}, same bits {row['equal']}", flush=True)
        failed += [row["label"]] if not row["equal"] else []
    copy_rows, smoke = bench_tools(copy_layouts("cuda"), rounds=args.rounds)
    for row in copy_rows:
        print(format_row("copy_rows", row), flush=True)
        print(f"    kernels: {row['device_kernels']} | library: {row['library_kernels']}", flush=True)
    print(format_row("smoke_scale", smoke) + f" | x * 2 {smoke['plain_ms']:.5f} ms", flush=True)
    failed += [row["label"] for row in copy_rows + [smoke] if not row["equal"]]
    print(f"card: {card}", flush=True)
    if failed:
        raise SystemExit(f"FAIL: a kernel differs from its plain version on {failed}")


if __name__ == "__main__":
    main()
