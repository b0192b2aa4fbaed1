"""The tool kernels' wrappers and plain versions: the toolchain smoke test,
the row-major copy, and the segment sums that the bench compares.

`smoke_scale` replaces the Pallas kernel `k` of `tools/pallas_smoke.py`
(`y = 2 x`); `copy_rows` replaces `tools/bench_segment_sum.py::
_force_row_major_u16` (a row-major copy of a 2-D table of any strides).
On a CUDA tensor each launches its kernel (`csrc/smoke_scale.cu`,
`csrc/copy_rows.cu`) or raises; on a CPU tensor it runs its plain version
(`smoke_scale_plain`, `copy_rows_plain`). `smoke_scale.launches` and
`copy_rows.launches` count kernel launches.

The `segment_sum_*` functions are the four ways `scripts/
bench_segment_sum.py` times the per-Gaussian gradient sum (rows (n, f) f32
summed into (num_rows, f) by id).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import kernel_build


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _require_cuda_or_cpu(x: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; anything else raises."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on CUDA or CPU tensors, not {x.device}")
    return x.device.type == "cuda"


# ---------------------------------------------------------------------------
# y = 2 x


def smoke_scale_plain(x: torch.Tensor) -> torch.Tensor:
    return x * 2


@functools.cache
def _smoke_entry_point():
    fn = kernel_build.load("smoke_scale").smoke_scale
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def smoke_scale(x: torch.Tensor) -> torch.Tensor:
    """2 * x for a contiguous float32 tensor of any shape."""
    if not _require_cuda_or_cpu(x, "smoke_scale"):
        return smoke_scale_plain(x)
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"smoke_scale takes a contiguous float32 tensor, got {x.dtype}, strides {x.stride()}")
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _smoke_entry_point()(x.data_ptr(), y.data_ptr(), x.numel(), _stream(x.device))
    if err != 0:
        raise RuntimeError(f"smoke_scale launch failed: cudaError {err}")
    smoke_scale.launches += 1
    return y


smoke_scale.launches = 0


# ---------------------------------------------------------------------------
# Row-major copy


def copy_rows_plain(x: torch.Tensor) -> torch.Tensor:
    return x.clone(memory_format=torch.contiguous_format)


@functools.cache
def _copy_rows_library():
    lib = kernel_build.load("copy_rows")
    lib.copy_rows.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 4 + [ctypes.c_int, ctypes.c_void_p]
    )
    lib.copy_rows.restype = ctypes.c_int
    lib.segment_sum_atomic.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    lib.segment_sum_atomic.restype = ctypes.c_int
    return lib


def copy_rows(x: torch.Tensor) -> torch.Tensor:
    """A fresh contiguous row-major tensor with `x`'s values, for a 2-D
    `x` of any strides whose elements take 2, 4 or 8 bytes."""
    if x.ndim != 2:
        raise ValueError(f"copy_rows takes a 2-D tensor, got shape {tuple(x.shape)}")
    if x.element_size() not in (2, 4, 8):
        raise ValueError(f"copy_rows takes elements of 2, 4 or 8 bytes, got {x.dtype}")
    if not _require_cuda_or_cpu(x, "copy_rows"):
        return copy_rows_plain(x)
    n, m = x.shape
    out = torch.empty((n, m), dtype=x.dtype, device=x.device)
    if out.data_ptr() % 16:
        raise RuntimeError("copy_rows: the output is not 16-byte aligned")
    with torch.cuda.device(x.device):
        err = _copy_rows_library().copy_rows(
            x.data_ptr(), out.data_ptr(), n, m, x.stride(0), x.stride(1), x.element_size(), _stream(x.device)
        )
    if err != 0:
        raise RuntimeError(f"copy_rows launch failed: cudaError {err}")
    copy_rows.launches += 1
    return out


copy_rows.launches = 0


# ---------------------------------------------------------------------------
# Segment sums


def segment_sum_index_add(rows: torch.Tensor, ids: torch.Tensor, num_rows: int) -> torch.Tensor:
    """(a) PyTorch's scatter-add."""
    out = torch.zeros((num_rows, rows.shape[1]), dtype=rows.dtype, device=rows.device)
    return out.index_add_(0, ids.long(), rows)


def segment_sum_sorted(rows: torch.Tensor, ids: torch.Tensor, num_rows: int, anchor=None) -> torch.Tensor:
    """(b) The JAX package's algorithm (`tile_gather.py::segment_sum_rows`)
    in plain PyTorch: sort the ids, permute the rows, prefix-sum them, and
    take differences at the segment bounds. The prefix sum runs along the
    contiguous axis of an (f, n) array, so its table comes out column-major,
    as `rows` may come in. (PyTorch's scan along the outer axis of the tall
    (n, f) array took 250 ms at n = 820,224, f = 12 on an H100.) With
    `anchor` (c), both gathered tables pass through it first (`copy_rows`:
    a table whose rows are contiguous, whatever layout it came in)."""
    anchor = anchor or (lambda table: table)
    sorted_ids, perm = torch.sort(ids)
    sorted_rows = anchor(rows)[perm]  # (n, f)
    prefix = torch.cumsum(sorted_rows.t().contiguous(), dim=1)  # (f, n)
    csum = torch.cat([torch.zeros_like(prefix[:, :1]), prefix], dim=1).t()  # (n + 1, f), column-major
    probes = torch.arange(num_rows + 1, dtype=sorted_ids.dtype, device=ids.device)
    bounds = torch.searchsorted(sorted_ids, probes)  # bounds[i] = #ids < i
    at_bounds = anchor(csum)[bounds]
    return at_bounds[1:] - at_bounds[:-1]


def segment_sum_atomic(rows: torch.Tensor, ids: torch.Tensor, num_rows: int) -> torch.Tensor:
    """(d) One atomicAdd per (slot, column), as the backward compositing
    kernel sums inside itself. `rows` (n, f) contiguous float32, `ids`
    (n,) int32 in [0, num_rows). On the CPU this is `index_add_`."""
    if not _require_cuda_or_cpu(rows, "segment_sum_atomic"):
        return segment_sum_index_add(rows, ids, num_rows)
    if rows.dtype != torch.float32 or rows.ndim != 2 or not rows.is_contiguous():
        raise ValueError("segment_sum_atomic takes contiguous (n, f) float32 rows")
    if ids.dtype != torch.int32 or ids.shape != rows.shape[:1] or not ids.is_contiguous() or ids.device != rows.device:
        raise ValueError("segment_sum_atomic takes contiguous (n,) int32 ids on the rows' device")
    n, f = rows.shape
    out = torch.zeros((num_rows, f), dtype=torch.float32, device=rows.device)
    with torch.cuda.device(rows.device):
        err = _copy_rows_library().segment_sum_atomic(
            rows.data_ptr(), ids.data_ptr(), out.data_ptr(), n, f, _stream(rows.device)
        )
    if err != 0:
        raise RuntimeError(f"segment_sum_atomic launch failed: cudaError {err}")
    return out
