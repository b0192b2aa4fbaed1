"""Timings of the per-Gaussian gradient sum, four ways, on the GPU (the
row-major copy kernel alone: `bench_tool_kernels.py`).

    python -m pixelsplat_tpu_torch.scripts.bench_segment_sum

The port's counterpart of `tools/bench_segment_sum.py`, at that bench's
size: N = 820,224 list slots of F = 12 gradient columns summed into
ROWS = 393,218 table rows, ids and rows from `default_rng(0)`. The ways,
each held against the first (the atomic ones to 1e-5 of the largest entry,
the sorted ones to 2e-4: see `SORTED_RTOL`):

  (a) index_add     `Tensor.index_add_`
  (b) sorted        the JAX package's algorithm in plain PyTorch: sort the
                    ids, permute the rows, prefix-sum, differences at the
                    segment bounds (the tool's `variant_current`). The rows
                    are read as the column-major table the backward's
                    blocks give (the tool's transposed view), and the
                    prefix table is column-major too (the scan runs along
                    the contiguous axis)
  (c) sorted+copy   (b) with both gathered tables passed through the
                    `copy_rows` kernel first (the tool's
                    `variant_forced_layout`, without its u16 split, which
                    is a TPU gather trick)
  (d) atomic        one atomicAdd per (slot, column), which is what the
                    backward compositing kernel does inside itself

The tool's other variants reorder work for the TPU's sort and gather
units and have no counterpart here. Times are CUDA events over `iters`
calls after a warm-up, printed as `name ms` with the card's name and
power limit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.kernel_tools import copy_rows, segment_sum_atomic, segment_sum_index_add, segment_sum_sorted
from .eval_scene import card_line, cuda_ms

N, F, ROWS = 820224, 12, 393218
# Each way against (a), relative to the largest entry (the TPU tool's
# measure and, for the atomic ways, its tolerance): f32 sums of a few terms
# per row in another order.
RTOL = 1e-5
# The sorted ways difference two f32 prefix sums of up to N unit normals.
# Those prefixes wander to ~2 sqrt(N), about 2,000 at the bench's N, where
# one f32 ulp is 1.2e-4, so merely storing them costs up to 2.4e-4 per
# difference against entries of ~6: 5e-5 of the largest was measured on an
# H100 at N = 820,224. Held to 2e-4; at a few thousand slots they meet 1e-5.
SORTED_RTOL = 2e-4
TOLERANCE = {"index_add": RTOL, "atomic": RTOL, "sorted": SORTED_RTOL, "sorted+copy_rows": SORTED_RTOL}


def bench_inputs(device, n: int = N, f: int = F, rows: int = ROWS) -> tuple[torch.Tensor, torch.Tensor]:
    """(d_rows (n, f) f32 as a column-major view, ids (n,) int32), the
    tool's arrays: ids first, then blocks (n / 128, f, 128) of normals
    whose transpose gives the rows."""
    rng = np.random.default_rng(0)
    ids = rng.integers(0, rows, n).astype(np.int32)
    blocks = rng.normal(size=(n // 128, f, 128)).astype(np.float32)
    columns = torch.as_tensor(blocks.transpose(1, 0, 2).reshape(f, n).copy(), device=device)  # (f, n)
    return columns.t(), torch.as_tensor(ids, device=device)


def variants(d_rows: torch.Tensor, ids: torch.Tensor, rows: int) -> dict:
    """name -> a call that computes the (rows, f) sums."""
    contiguous = d_rows.contiguous()
    return {
        "index_add": lambda: segment_sum_index_add(contiguous, ids, rows),
        "sorted": lambda: segment_sum_sorted(d_rows, ids, rows),
        "sorted+copy_rows": lambda: segment_sum_sorted(d_rows, ids, rows, anchor=copy_rows),
        "atomic": lambda: segment_sum_atomic(contiguous, ids, rows),
    }


def check_variants(calls: dict) -> dict[str, float]:
    """Each way's largest error against index_add, relative to the largest entry."""
    ref = calls["index_add"]()
    scale = float(ref.abs().max()) + 1e-9
    return {name: float((fn() - ref).abs().max()) / scale for name, fn in calls.items()}


def u16_table(d_rows: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The rows' bits as the tool's (n, 2f) 16-bit table, once contiguous
    and once as a transposed (column-major) view of the same values."""
    table = d_rows.contiguous().view(torch.int16)
    return table, table.t().contiguous().t()


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("bench_segment_sum needs a CUDA device")
    card = card_line()
    print(f"card: {card}", flush=True)
    d_rows, ids = bench_inputs("cuda")
    calls = variants(d_rows, ids, ROWS)
    for name, err in check_variants(calls).items():
        print(f"{name:20s} max err / max entry vs index_add {err:.3g}", flush=True)
        if not err <= TOLERANCE[name]:
            raise SystemExit(f"FAIL: {name} disagrees with index_add: {err:.3g} > {TOLERANCE[name]}")
    for name, fn in calls.items():
        print(f"{name:20s} {cuda_ms(fn, iters=10):8.3f} ms", flush=True)
    print(f"card: {card}", flush=True)


if __name__ == "__main__":
    main()
