"""The tool kernels' wrappers and plain versions: the toolchain smoke test,
the row-major copy, and the segment sums that the bench compares.

`smoke_scale` replaces the Pallas kernel `k` of `tools/pallas_smoke.py`
(`y = 2 x`); `copy_rows` replaces `tools/bench_segment_sum.py::
_force_row_major_u16` (a row-major copy of a 2-D table of any strides).
On a CUDA tensor each launches its kernel (`csrc/smoke_scale.cu`,
`csrc/copy_rows.cu`) or raises; on a CPU tensor it runs its plain version
(`smoke_scale_plain`, `copy_rows_plain`). `smoke_scale.launches` and
`copy_rows.launches` count kernel launches. `copy_rows_route` picks the
copy kernel's route from the input's layout. Every wrapper launches through
`_launch`, whose per-call host work is the checks, one allocation and the
ctypes call: both kernels are so short that a call's time is the host's.

The `segment_sum_*` functions are the four ways `scripts/
bench_segment_sum.py` times the per-Gaussian gradient sum (rows (n, f) f32
summed into (num_rows, f) by id).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import kernel_build


def _require_cuda_or_cpu(x: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; anything else raises."""
    if x.is_cuda:
        return True
    if x.is_cpu:
        return False
    raise ValueError(f"{name} runs on CUDA or CPU tensors, not {x.device}")


# Bound once, since the launch path reads them on every call (None where
# PyTorch was built without CUDA, so no tensor can reach them).
_cuda_get_device = getattr(torch._C, "_cuda_getDevice", None)
_cuda_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def current_raw_stream(index: int) -> int:
    """The raw handle of the current stream of CUDA device `index`, read
    without building a `torch.cuda.Stream` (the call Triton's launcher
    makes); equal to `torch.cuda.current_stream(index).cuda_stream`."""
    return _cuda_raw_stream(index)


def _launch(name: str, entry, index: int, *args) -> None:
    """The launch path the wrappers share: calls a kernel's C entry point
    `entry(*args, stream)` on the current stream of CUDA device `index`,
    entering a device guard only when that is not the current device, and
    raises if the launch was refused (the entry point returns the launch's
    error code). It builds no `torch.cuda.Stream` and the entry points'
    ctypes types are bound once, when the library is loaded."""
    if index == _cuda_get_device():
        err = entry(*args, _cuda_raw_stream(index))
    else:
        with torch.cuda.device(index):
            err = entry(*args, _cuda_raw_stream(index))
    if err:
        raise RuntimeError(f"{name} launch failed: error {err}")


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
    if not x.is_cuda:
        if x.is_cpu:
            return smoke_scale_plain(x)
        raise ValueError(f"smoke_scale runs on CUDA or CPU tensors, not {x.device}")
    if x.dtype is not torch.float32 or not x.is_contiguous():
        raise ValueError(f"smoke_scale takes a contiguous float32 tensor, got {x.dtype}, strides {x.stride()}")
    y = torch.empty_like(x)
    index = x.get_device()
    if index == _cuda_get_device():
        # `_launch`'s fast path written out: this call's time is all host
        # work, and on an H100's host the helper's call was a measurable
        # share of it.
        if err := _smoke_entry_point()(x.data_ptr(), y.data_ptr(), x.numel(), _cuda_raw_stream(index)):
            raise RuntimeError(f"smoke_scale launch failed: error {err}")
    else:
        _launch("smoke_scale", _smoke_entry_point(), index, x.data_ptr(), y.data_ptr(), x.numel())
    smoke_scale.launches += 1
    return y


smoke_scale.launches = 0


# ---------------------------------------------------------------------------
# Row-major copy


def copy_rows_plain(x: torch.Tensor) -> torch.Tensor:
    return x.clone(memory_format=torch.contiguous_format)


# The kernel's routes; a route's index here is its code in csrc/copy_rows.cu.
COPY_ROUTES = ("general", "flat", "column_major")


def copy_rows_route(
    shape: tuple[int, int], strides: tuple[int, int], itemsize: int, in_ptr: int, out_ptr: int
) -> str:
    """The `copy_rows` kernel's route for an (n, m) input of these strides
    (in elements), element size and addresses, chosen by layout alone:
    "flat" for a row-major input at a 16-byte boundary (a streaming copy),
    "column_major" where each column is a contiguous run (stride0 == 1,
    stride1 >= n: a tile of rows is staged through shared memory), and
    "general" for anything else (each element read through both strides).
    The output of every route is row-major from a 16-byte boundary."""
    (n, m), (stride0, stride1) = shape, strides
    if out_ptr % 16:
        return "general"
    if stride1 == 1 and stride0 == m and in_ptr % 16 == 0:
        return "flat"
    if stride0 == 1 and stride1 >= n:
        return "column_major"
    return "general"


@functools.cache
def _copy_rows_library():
    lib = kernel_build.load("copy_rows")
    lib.copy_rows.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
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
    itemsize = x.element_size()
    if itemsize not in (2, 4, 8):
        raise ValueError(f"copy_rows takes elements of 2, 4 or 8 bytes, got {x.dtype}")
    if not _require_cuda_or_cpu(x, "copy_rows"):
        return copy_rows_plain(x)
    shape, strides = x.shape, x.stride()
    # Cheaper on the host than torch.empty from shape, dtype and device.
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    in_ptr, out_ptr = x.data_ptr(), out.data_ptr()
    if out_ptr % 16:
        raise RuntimeError("copy_rows: the output is not 16-byte aligned")
    route = COPY_ROUTES.index(copy_rows_route(shape, strides, itemsize, in_ptr, out_ptr))
    _launch("copy_rows", _copy_rows_library().copy_rows, x.get_device(), in_ptr, out_ptr, *shape, *strides, itemsize, route)
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
    _launch("segment_sum_atomic", _copy_rows_library().segment_sum_atomic, rows.get_device(),
            rows.data_ptr(), ids.data_ptr(), out.data_ptr(), n, f)
    return out
