"""Projection, binning and the probe's occupancy count as CUDA kernels: the
wrappers of `csrc/project_bin.cu`.

`project` projects a scene's Gaussians into one or more views; `bin_lists`
bins one view's projected Gaussians into tile lists around one
`torch.sort` of the pair keys; `occupancy` and `occupancy_stats` count the
settings probe's bounding boxes per tile. Each takes CUDA float32 tensors
of any strides along the Gaussian and view axes, launches on the current
stream without waiting for the device, and raises on what the kernels do
not take. Their plain versions are `projection.py::
project_gaussians_soa_plain`, `binning.py::bin_gaussians_plain`,
`count_big` and `tile_occupancy`.

`takes` decides, from the tensors, which version a call runs: the kernels
for CUDA tensors of which none needs a gradient, the plain code for CPU
tensors and for the autograd path (training's renders). The tracer's
counters `project_launches`, `bin_launches` and `occupancy_launches` count
the calls that launch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import torch

from ... import kernel_build
from ...utils import tracing
from .composite_kernel import MAX_COLOURS

ROWS = 8  # mean x, y, conic a, b, c, depth, radius x, y; then the colours

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


class _Plane(ctypes.Structure):
    _fields_ = [("p", _P), ("gs", _L), ("vs", _L)]


class _Scene(ctypes.Structure):
    _fields_ = [("m", _Plane * 3), ("cov", _Plane * 6), ("op", _Plane)]


class _Colour(ctypes.Structure):
    _fields_ = [("p", _P), ("ch", _I), ("d_sh", _I), ("sc", _L), ("sd", _L), ("sv", _L), ("sr", _L),
                ("per_view", _L), ("rays", _L)]


class _Proj(ctypes.Structure):
    _fields_ = [(name, _Plane) for name in ("mx", "my", "ca", "cb", "cc", "op", "rx", "ry", "depth")] + [
        ("valid", _P), ("valid_gs", _L), ("valid_vs", _L)]


class _Bins(ctypes.Structure):
    _fields_ = [("g", _L)] + [(name, _I) for name in (
        "tile_size", "tiles_x", "tiles_y", "num_tiles", "span", "depth_bits", "wide", "big_capacity")]


def takes(*tensors: Optional[torch.Tensor]) -> bool:
    """Whether a call on these tensors runs the kernels: they lie on a CUDA
    device and none of them needs a gradient."""
    first = next(t for t in tensors if t is not None)
    if first.device.type != "cuda":
        return False
    return not (torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors))


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library, its C signatures declared."""
    return kernel_build.declare(kernel_build.load("project_bin"), (
        ("project", [_P] * 4 + [_I] * 3 + [_L] + [_P] * 4),
        ("bin_keys", [_P] * 7),
        ("big_pairs", [_P] * 8),
        ("bin_lists", [_P] * 3 + [_L, _P] + [_I] * 3 + [_P] * 9),
        ("occupancy", [_P, _P, _I, _P, _P, _P]),
        ("occupancy_stats", [_P, _P] + [_I] * 4 + [_P] * 2),
    ))


def _plane(t: torch.Tensor, g: int, views: int, device, what: str, dtype=torch.float32) -> tuple:
    """(data pointer, Gaussian stride, view stride) of a (g,) or (views, g)
    tensor; a (g,) tensor serves every view."""
    if t.dtype != dtype or t.device != device:
        raise ValueError(f"{what} must be {dtype} on {device}, got {t.dtype} on {t.device}")
    if t.ndim == 1 and t.shape[0] == g:
        return t.data_ptr(), t.stride(0), 0
    if t.ndim == 2 and tuple(t.shape) == (views, g):
        return t.data_ptr(), t.stride(1), t.stride(0)
    raise ValueError(f"{what} must be ({g},) or ({views}, {g}), got {tuple(t.shape)}")


def _cameras(extrinsics, intrinsics, near, views: int, device) -> tuple:
    """The cameras as the kernels read them: contiguous float32 on `device`
    (a copy of a few floats where they are strided)."""
    out = []
    for name, t, size in (("extrinsics", extrinsics, 16), ("intrinsics", intrinsics, 9), ("near", near, 1)):
        if t is not None and (t.dtype != torch.float32 or t.device != device or t.numel() != views * size):
            raise ValueError(f"{name} must hold {views} float32 camera(s) on {device}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
        out.append(None if t is None else t.contiguous())
    return tuple(out)


def project(
    extrinsics: torch.Tensor,  # (views, 4, 4) or (4, 4)
    intrinsics: torch.Tensor,  # (views, 3, 3) or (3, 3)
    near: Optional[torch.Tensor],  # (views,) or (): rescale the world by 1 / near
    planes: Sequence[torch.Tensor],  # mean x, y, z, cov s00 s01 s02 s11 s12 s22, opacity
    image_shape: tuple[int, int],
    harmonics: Optional[torch.Tensor] = None,  # (ch, d_sh, g) or (ch, d_sh, V, 1, R), one view
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (rows (8 + ch, views, g) f32: mean x, y, conic a, b, c,
    depth, radius x, y, then the SH colours; valid (views, g) bool)."""
    views = extrinsics.shape[0] if extrinsics.ndim == 3 else 1
    device = extrinsics.device
    g = planes[0].shape[-1]
    extrinsics, intrinsics, near = _cameras(extrinsics, intrinsics, near, views, device)
    p = [_Plane(*_plane(t, g, views, device, f"plane {i}")) for i, t in enumerate(planes)]
    scene = _Scene((_Plane * 3)(*p[:3]), (_Plane * 6)(*p[3:9]), p[9])
    colour = _Colour()
    ch = 0
    if harmonics is not None:
        if views != 1:
            raise ValueError("harmonics are projected one view at a time")
        if harmonics.dtype != torch.float32 or harmonics.device != device:
            raise ValueError(f"harmonics must be float32 on {device}")
        ch, d_sh = harmonics.shape[:2]
        if ch > MAX_COLOURS or d_sh not in (1, 4, 9, 16, 25):
            raise ValueError(f"the projection kernel takes at most {MAX_COLOURS} channels of 1, 4, 9, 16 or 25 "
                             f"SH coefficients, got {tuple(harmonics.shape[:2])}")
        st = harmonics.stride()
        if harmonics.ndim == 3 and harmonics.shape[2] == g:
            colour = _Colour(harmonics.data_ptr(), ch, d_sh, st[0], st[1], 0, st[2], g, g)
        elif harmonics.ndim == 5 and harmonics.shape[3] == 1 and g % (harmonics.shape[2] * harmonics.shape[4]) == 0:
            rays = harmonics.shape[4]
            colour = _Colour(harmonics.data_ptr(), ch, d_sh, st[0], st[1], st[2], st[4], g // harmonics.shape[2], rays)
        else:
            raise ValueError(f"harmonics must be (ch, d_sh, {g}) or (ch, d_sh, V, 1, R), got {tuple(harmonics.shape)}")
    rows = torch.empty((ROWS + ch, views, g), dtype=torch.float32, device=device)
    valid = torch.empty((views, g), dtype=torch.bool, device=device)
    kernel_build.launch(
        "project", _lib().project, rows.get_device(), ctypes.byref(scene), extrinsics.data_ptr(), intrinsics.data_ptr(),
        None if near is None else near.data_ptr(), views, image_shape[0], image_shape[1], g,
        ctypes.byref(colour), rows.data_ptr(), valid.data_ptr(),
    )
    tracing.count_launch("project_launches")
    return rows, valid


def _proj(projected, g: int, views: int, device) -> _Proj:
    """The kernels' view of projected Gaussians: fields (g,) or (views, g)."""
    fields = ("mean_x", "mean_y", "conic_a", "conic_b", "conic_c", "opacity", "radius_x", "radius_y", "depth")
    planes = [_Plane(*_plane(getattr(projected, f), g, views, device, f)) for f in fields]
    valid = _plane(projected.valid, g, views, device, "valid", dtype=torch.bool)
    return _Proj(*planes, *valid)


def _bins(g, shape, tile_size, span) -> _Bins:
    return _Bins(g, tile_size, shape.tiles_x, shape.tiles_y, shape.num_tiles, span, shape.depth_bits,
                 int(shape.wide_keys), shape.big_capacity)


def bin_lists(projected, shape, tile_size: int, span: int, chunk: int):
    """One view's tile lists from its projected Gaussians (fields (g,)):
    (flat, block_start, counts, overflow), those of `bin_gaussians_plain`
    at the sizes `shape` (`binning.BinShape`)."""
    device = projected.depth.device
    g = projected.depth.shape[0]
    proj, bins = _proj(projected, g, 1, device), _bins(g, shape, tile_size, span)
    t, bc, nb = shape.num_tiles, shape.big_capacity, shape.pair_budget // chunk
    n = span * span * g + t * bc
    keys = torch.empty((n,), dtype=torch.int64 if shape.wide_keys else torch.int32, device=device)
    big_dq = torch.empty((g if bc else 0,), dtype=torch.int32, device=device)
    # The big list's overflow, each tile's first sorted pair, each flat
    # block's tile.
    work = torch.empty((1 + t + nb,), dtype=torch.int32, device=device)
    ovf_big, starts, block_map = work[:1], work[1:1 + t], work[1 + t:]
    lists = torch.empty((shape.pair_budget + 2 * t + 1,), dtype=torch.int32, device=device)
    flat, block_start = lists[:shape.pair_budget], lists[shape.pair_budget:shape.pair_budget + t]
    counts, overflow = lists[shape.pair_budget + t:-1], lists[-1]
    k32, k64 = (None, keys.data_ptr()) if shape.wide_keys else (keys.data_ptr(), None)
    lib, index = _lib(), keys.get_device()
    big_ids = None
    kernel_build.launch("bin_keys", lib.bin_keys, index, ctypes.byref(proj), ctypes.byref(bins), k32, k64,
                        big_dq.data_ptr() if bc else None, ovf_big.data_ptr())
    if bc:
        # The plain code's stable sort of the big-list keys: the nearest
        # big Gaussians first, ties by id.
        big_dq, big_ids = torch.sort(big_dq, stable=True)
        kernel_build.launch("big_pairs", lib.big_pairs, index, ctypes.byref(proj), ctypes.byref(bins),
                            big_dq.data_ptr(), big_ids.data_ptr(), ovf_big.data_ptr(), k32, k64)
    # One stable sort by (tile, depth key); ties keep the order of the
    # positions the keys were written at, as in the plain code's `cat`.
    sorted_keys, order = torch.sort(keys, stable=True)
    s32, s64 = (None, sorted_keys.data_ptr()) if shape.wide_keys else (sorted_keys.data_ptr(), None)
    kernel_build.launch("bin_lists", lib.bin_lists, index, s32, s64, order.data_ptr(), n, ctypes.byref(bins),
                        shape.capacity, chunk, nb, ovf_big.data_ptr(), None if big_ids is None else big_ids.data_ptr(),
                        block_start.data_ptr(), counts.data_ptr(), starts.data_ptr(), block_map.data_ptr(),
                        overflow.data_ptr(), flat.data_ptr())
    tracing.count_launch("bin_launches")
    return flat, block_start, counts, overflow


def occupancy(projected, views: int, image_shape: tuple[int, int], tile_size: int, span: int):
    """Per view, each tile's count of small Gaussians' bounding boxes and
    the count of big Gaussians: (hist (views, T) int32, n_big (views,)
    int32), what `tile_occupancy` and `count_big` count."""
    device = projected.depth.device
    g = projected.depth.shape[-1]
    tiles_x, tiles_y = -(-image_shape[1] // tile_size), -(-image_shape[0] // tile_size)
    num_tiles = tiles_x * tiles_y
    proj, bins = _proj(projected, g, views, device), _Bins(g, tile_size, tiles_x, tiles_y, num_tiles, span, 0, 0, 0)
    counts = torch.empty((views * (num_tiles + 1),), dtype=torch.int32, device=device)
    hist, n_big = counts[: views * num_tiles].view(views, num_tiles), counts[views * num_tiles:]
    kernel_build.launch("occupancy", _lib().occupancy, counts.get_device(), ctypes.byref(proj), ctypes.byref(bins),
                        views, hist.data_ptr(), n_big.data_ptr())
    tracing.count_launch("occupancy_launches")
    return hist, n_big


def occupancy_stats(hist: torch.Tensor, n_big: torch.Tensor, big_capacity: int, chunk: int) -> torch.Tensor:
    """(max_count, needed_budget) over the views, one (2,) int64 tensor:
    `tile_occupancy`'s two numbers at this big-list capacity."""
    views, num_tiles = hist.shape
    out = torch.empty((2,), dtype=torch.int64, device=hist.device)
    kernel_build.launch("occupancy_stats", _lib().occupancy_stats, out.get_device(), hist.data_ptr(), n_big.data_ptr(),
                        views, num_tiles, big_capacity, chunk, out.data_ptr())
    return out
