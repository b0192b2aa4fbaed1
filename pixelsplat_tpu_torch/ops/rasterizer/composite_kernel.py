"""Tile compositing, forward and backward: the CUDA kernels' wrappers and
their plain versions.

`composite_core` replaces `pixelsplat_tpu/ops/rasterizer/
pallas_composite.py::pallas_composite_core` and the row gather in front of
it. It takes the (rows, 12) f32 parameter table of `composite.pack_columns`
and the flat tile lists of `binning.TileLists`, and returns the contract
of `pallas_composite_core`: `acc (T, 8, P)` with colours in channels 0-5
(channels 6-7 zero), `trans (T, P)` and `n_proc (T,)` int32, the number of
`chunk`-slot chunks each tile composited before its exit.

`composite_bwd` replaces `pixelsplat_tpu/ops/rasterizer/pallas_backward.py::
pallas_composite_bwd` and the per-Gaussian sum behind it
(`composite.py::_composite_packed_bwd`): from the forward's inputs, its
`n_proc` and final `trans`, and the cotangents of `acc` and `trans`, it
returns `d_table (rows, 12)`, the gradient of the parameter table.

On a CUDA tensor each wrapper launches its kernel (`csrc/composite_fwd.cu`,
`csrc/composite_bwd.cu`) or raises; on a CPU tensor it runs its plain
version (`composite_core_plain`, `composite_bwd_plain`).
The tracer's counters `k1_launches` and `k2_launches` count calls that
launch, each inside a `kernel.k1` or `kernel.k2` span: one call of
`composite_bwd` enqueues the backward's four device kernels (chunk map,
per-chunk sums, scan, per-chunk gradients), whose block-to-tile map has
`chunk_block_map_plain` as its plain twin.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ... import kernel_build
from ...utils import tracing

CH_PAD = 8  # output channels: <= 6 colours, then two zero channels
MAX_COLOURS = 6
ROW = 12  # table columns: mx, my, conic a/b/c, opacity, 6 colours
TRANS_EPS = 1e-4
MAX_ALPHA = 0.99
MIN_ALPHA = 1.0 / 255.0
# The backward rebuilds T from log(max(T_end, MIN_TRANS)).
MIN_TRANS = 1e-30
KERNEL_TILE = 16
KERNEL_MAX_CHUNK = 128


def _pixel_centres(num_tiles: int, tiles_x: int, tile_size: int, like: torch.Tensor):
    """(T, P) x and y of every tile's pixels, in `like`'s dtype and device."""
    tile_ids = torch.arange(num_tiles, device=like.device)
    within = torch.arange(tile_size * tile_size, device=like.device)
    pix_x = (tile_ids % tiles_x)[:, None] * tile_size + (within % tile_size)[None]
    pix_y = (tile_ids // tiles_x)[:, None] * tile_size + (within // tile_size)[None]
    return pix_x.to(like.dtype), pix_y.to(like.dtype)


def composite_core_plain(
    table: torch.Tensor,  # (rows, 12) f32, last row the zero sentinel
    flat: torch.Tensor,  # (pair_budget,) int32
    block_start: torch.Tensor,  # (T,) int32
    counts: torch.Tensor,  # (T,) int32
    tiles_x: int,
    chunk: int = 128,
    tile_size: int = 16,
    early_exit: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, vectorised over tiles.

    Loops over chunks with a per-tile active mask under the kernel's exit
    rule; transmittance is a running product along each chunk. With
    `early_exit=False` every tile walks all of its chunks, as the stage
    ablation's `full` variant does.
    """
    device = table.device
    num_tiles = counts.shape[0]
    p = tile_size * tile_size
    pix_x, pix_y = _pixel_centres(num_tiles, tiles_x, tile_size, table)

    n_chunks = (counts.long() + chunk - 1) // chunk
    trans = torch.ones((num_tiles, p), dtype=table.dtype, device=device)
    acc = torch.zeros((num_tiles, CH_PAD, p), dtype=table.dtype, device=device)
    n_proc = torch.zeros((num_tiles,), dtype=torch.int32, device=device)
    active = n_chunks > 0
    slots = torch.arange(chunk, device=device)
    base = block_start.long() * chunk
    for i in range(int(n_chunks.max()) if num_tiles else 0):
        if early_exit and not bool(active.any()):
            break
        idx = torch.where(active, base + i * chunk, 0)[:, None] + slots[None]
        rows = table[flat[idx.clamp(max=flat.numel() - 1)].long()]  # (T, C, 12)
        mx, my, ca, cb, cc, op = (rows[..., k, None] for k in range(6))
        dx = pix_x[:, None, :] - mx  # (T, C, P)
        dy = pix_y[:, None, :] - my
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        alpha = torch.clamp(op * torch.exp(power), max=MAX_ALPHA)
        keep = (power <= 0) & (alpha >= MIN_ALPHA) & active[:, None, None]
        alpha = torch.where(keep, alpha, 0.0)
        cum = torch.cumprod(1.0 - alpha, dim=1)
        t_before = trans[:, None, :] * torch.cat([torch.ones_like(cum[:, :1]), cum[:, :-1]], dim=1)
        weight = alpha * t_before
        acc[:, :MAX_COLOURS] += torch.einsum("tcp,tcx->txp", weight, rows[..., 6:])
        trans = trans * cum[:, -1]
        n_proc += active.to(torch.int32)
        active = active & (i + 1 < n_chunks)
        if early_exit:
            active = active & (trans.amax(dim=1) >= TRANS_EPS)
    return acc, trans, n_proc


FWD_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4
BWD_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 4


@functools.cache
def _entry_point():
    """`composite_fwd` of the built library, its C signature declared."""
    return kernel_build.declare(kernel_build.load("composite_fwd"), (("composite_fwd", FWD_ARGTYPES),)).composite_fwd


def _check_lists(table, flat, block_start, counts, chunk):
    """Raise unless the tensors are what the kernels take."""
    if table.dtype != torch.float32 or table.ndim != 2 or table.shape[1] != ROW:
        raise ValueError(f"table must be (rows, {ROW}) float32, got {tuple(table.shape)} {table.dtype}")
    for name, t in (("flat", flat), ("block_start", block_start), ("counts", counts)):
        if t.dtype != torch.int32 or t.ndim != 1:
            raise ValueError(f"{name} must be a 1-D int32 tensor")
    if block_start.shape != counts.shape:
        raise ValueError("block_start and counts must have one entry per tile")
    tensors = (table, flat, block_start, counts)
    if any(t.device != table.device for t in tensors):
        raise ValueError("all inputs must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("inputs must be contiguous")
    if table.data_ptr() % 16:
        raise ValueError("table must be 16-byte aligned")
    if not 1 <= chunk <= KERNEL_MAX_CHUNK:
        raise ValueError(f"the kernel takes chunks of 1..{KERNEL_MAX_CHUNK} slots, got {chunk}")


def _launch(table, flat, block_start, counts, tiles_x, chunk):
    _check_lists(table, flat, block_start, counts, chunk)
    fn = _entry_point()
    num_tiles = counts.shape[0]
    p = KERNEL_TILE * KERNEL_TILE
    acc = torch.empty((num_tiles, CH_PAD, p), dtype=torch.float32, device=table.device)
    trans = torch.empty((num_tiles, p), dtype=torch.float32, device=table.device)
    n_proc = torch.empty((num_tiles,), dtype=torch.int32, device=table.device)
    with tracing.span("kernel.k1"):
        kernel_build.launch(
            "composite_fwd", fn, table.get_device(),
            table.data_ptr(), flat.data_ptr(), block_start.data_ptr(), counts.data_ptr(),
            num_tiles, tiles_x, chunk,
            acc.data_ptr(), trans.data_ptr(), n_proc.data_ptr(),
        )
    tracing.count_launch("k1_launches")
    return acc, trans, n_proc


def composite_core(
    table: torch.Tensor,
    flat: torch.Tensor,
    block_start: torch.Tensor,
    counts: torch.Tensor,
    tiles_x: int,
    chunk: int = 128,
    tile_size: int = 16,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (acc (T, 8, P), trans (T, P), n_proc (T,) int32)."""
    if table.device.type == "cpu":
        return composite_core_plain(table, flat, block_start, counts, tiles_x, chunk, tile_size)
    if table.device.type != "cuda":
        raise ValueError(f"composite_core runs on CUDA or CPU tensors, not {table.device}")
    if tile_size != KERNEL_TILE:
        raise NotImplementedError(f"the CUDA compositor takes {KERNEL_TILE}x{KERNEL_TILE} tiles")
    return _launch(table, flat, block_start, counts, tiles_x, chunk)


def composite_bwd_plain(
    table: torch.Tensor,  # (rows, 12), last row the zero sentinel
    flat: torch.Tensor,  # (pair_budget,) int32
    block_start: torch.Tensor,  # (T,) int32
    counts: torch.Tensor,  # (T,) int32
    n_proc: torch.Tensor,  # (T,) int32, chunks the forward composited
    trans: torch.Tensor,  # (T, P), the forward's final transmittance
    g_acc: torch.Tensor,  # (T, 8, P) cotangent of acc (channels 0-5 read)
    g_trans: torch.Tensor,  # (T, P) cotangent of trans
    tiles_x: int,
    chunk: int = 128,
    tile_size: int = 16,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The backward kernel's function in plain PyTorch, vectorised over tiles.

    Returns (d_slots (n_blocks * chunk, 12), d_table (rows, 12)): the
    gradient per list slot as the Pallas kernel writes it (zeros for chunks
    the forward did not composite), and its sum per Gaussian, the sentinel
    row left at zero. Walks the chunks back to front with a per-tile active
    mask; the suffix sums along a chunk are flipped cumulative sums.
    """
    device, dtype = table.device, table.dtype
    num_tiles = counts.shape[0]
    rows = table.shape[0]
    pix_x, pix_y = _pixel_centres(num_tiles, tiles_x, tile_size, table)

    n_slots = flat.numel() // chunk * chunk
    d_slots = torch.zeros((n_slots, ROW), dtype=dtype, device=device)
    n_chunks = torch.minimum(n_proc.long(), (counts.long() + chunk - 1) // chunk)
    base = block_start.long() * chunk
    slots = torch.arange(chunk, device=device)
    g = g_acc[:, :MAX_COLOURS, :]  # (T, 6, P)
    log_t_end = torch.log(torch.clamp(trans, min=MIN_TRANS))  # (T, P)
    s_run = g_trans * trans  # (T, P)

    def suffix_inclusive(x):  # along the slot axis
        return torch.flip(torch.cumsum(torch.flip(x, dims=(1,)), dim=1), dims=(1,))

    for k in range(int(n_chunks.max()) if num_tiles else 0):
        active = k < n_chunks  # (T,)
        i = torch.where(active, n_chunks - 1 - k, 0)
        idx = (base + i * chunk)[:, None] + slots[None]  # (T, C)
        idx = torch.where(active[:, None], idx, 0).clamp(max=flat.numel() - 1)
        r = table[flat[idx].long()]  # (T, C, 12)
        mx, my, ca, cb, cc, op = (r[..., j, None] for j in range(6))
        dx = pix_x[:, None, :] - mx  # (T, C, P)
        dy = pix_y[:, None, :] - my
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        expp = torch.exp(power)
        raw = op * expp
        live = (power <= 0) & (raw >= MIN_ALPHA) & active[:, None, None]
        alpha = torch.where(live, torch.clamp(raw, max=MAX_ALPHA), 0.0)
        passes = live & (raw < MAX_ALPHA)

        la = torch.log1p(-alpha)
        t_i = torch.exp(log_t_end[:, None, :] - suffix_inclusive(la))
        w = alpha * t_i
        cg = torch.einsum("tcx,txp->tcp", r[..., 6:], g)
        u = w * cg
        s_i = s_run[:, None, :] + suffix_inclusive(u) - u
        # Selects, so an overflowed exp(power) of a masked slot gives 0.
        d_alpha = torch.where(passes, t_i * cg - s_i / (1.0 - alpha), 0.0)
        d_power = torch.where(passes, d_alpha * raw, 0.0)
        d_chunk = torch.stack(
            [
                ((ca * dx + cb * dy) * d_power).sum(-1),
                ((cc * dy + cb * dx) * d_power).sum(-1),
                (-0.5 * dx * dx * d_power).sum(-1),
                (-dx * dy * d_power).sum(-1),
                (-0.5 * dy * dy * d_power).sum(-1),
                torch.where(passes, d_alpha * expp, 0.0).sum(-1),
                *torch.einsum("txp,tcp->xtc", g, w),
            ],
            dim=-1,
        )  # (T, C, 12)
        d_slots[idx[active]] = d_chunk[active]
        log_t_end = log_t_end - la.sum(dim=1)
        s_run = s_run + u.sum(dim=1)

    ids = flat[:n_slots].long()
    real = ids < rows - 1
    d_table = torch.zeros((rows, ROW), dtype=dtype, device=device)
    d_table.index_add_(0, ids[real], d_slots[real])
    return d_slots, d_table


def near_threshold_pairs(
    table: torch.Tensor,
    flat: torch.Tensor,
    block_start: torch.Tensor,
    counts: torch.Tensor,
    n_proc: torch.Tensor,
    tiles_x: int,
    chunk: int = 128,
    tile_size: int = 16,
    margin: float = 1e-6,
) -> torch.Tensor:
    """Per tile, how many composited (slot, pixel) pairs lie within a
    relative `margin` of a threshold where the gradient jumps: power = 0
    (relative to the size of the quadratic form's terms, which cancel for
    a pixel on a thin Gaussian's long axis), raw = 1/255 or raw = 0.99.
    Two evaluations that round differently may fall on opposite sides
    there. Returns (T,) int64."""
    device = table.device
    num_tiles = counts.shape[0]
    pix_x, pix_y = _pixel_centres(num_tiles, tiles_x, tile_size, table)
    n_chunks = torch.minimum(n_proc.long(), (counts.long() + chunk - 1) // chunk)
    base = block_start.long() * chunk
    slots = torch.arange(chunk, device=device)
    near = torch.zeros(num_tiles, dtype=torch.int64, device=device)
    for i in range(int(n_chunks.max()) if num_tiles else 0):
        active = i < n_chunks
        idx = torch.where(active, base + i * chunk, 0)[:, None] + slots[None]
        r = table[flat[idx.clamp(max=flat.numel() - 1)].long()]
        mx, my, ca, cb, cc, op = (r[..., j, None] for j in range(6))
        real = active[:, None, None] & (op > 0)  # pad slots have opacity 0
        dx = pix_x[:, None, :] - mx
        dy = pix_y[:, None, :] - my
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        size = 0.5 * (ca * dx * dx).abs() + 0.5 * (cc * dy * dy).abs() + (cb * dx * dy).abs()
        raw = op * torch.exp(power)
        close = (
            ((power.abs() <= margin * size) & (op >= MIN_ALPHA))
            | ((raw - MIN_ALPHA).abs() <= margin * MIN_ALPHA)
            | ((raw - MAX_ALPHA).abs() <= margin * MAX_ALPHA)
        )
        near += (close & real).sum(dim=(1, 2))
    return near


def chunk_block_map_plain(
    block_start: torch.Tensor,  # (T,) int32
    counts: torch.Tensor,  # (T,) int32
    n_proc: torch.Tensor,  # (T,) int32
    n_blocks: int,
    chunk: int = 128,
) -> torch.Tensor:
    """The backward kernel's map from flat chunk blocks to tiles, in plain
    PyTorch: (n_blocks,) int32, the tile whose chunk `b - block_start[tile]`
    block `b` holds when the forward composited that chunk, else -1. Tile t
    owns blocks block_start[t] + c for c < min(n_proc, ceil(counts / chunk));
    a budget-dropped tile (counts 0, block_start past the end) owns none."""
    device = block_start.device
    n = torch.minimum(n_proc.long(), (counts.long() + chunk - 1) // chunk).clamp(min=0)
    tile = torch.repeat_interleave(torch.arange(n.numel(), device=device), n)
    first = torch.cumsum(n, 0) - n  # each tile's first entry in `tile`
    block = block_start.long()[tile] + torch.arange(tile.numel(), device=device) - first[tile]
    inside = (block >= 0) & (block < n_blocks)
    block_map = torch.full((n_blocks,), -1, dtype=torch.int32, device=device)
    block_map[block[inside]] = tile[inside].to(torch.int32)
    return block_map


@functools.cache
def _bwd_entry_point():
    """`composite_bwd` of the built library, its C signature declared."""
    return kernel_build.declare(kernel_build.load("composite_bwd"), (("composite_bwd", BWD_ARGTYPES),)).composite_bwd


def _launch_bwd(table, flat, block_start, counts, n_proc, trans, g_acc, g_trans, tiles_x, chunk):
    _check_lists(table, flat, block_start, counts, chunk)
    num_tiles = counts.shape[0]
    p = KERNEL_TILE * KERNEL_TILE
    if n_proc.dtype != torch.int32 or n_proc.shape != counts.shape:
        raise ValueError("n_proc must be int32 with one entry per tile")
    for name, t, shape in (
        ("trans", trans, (num_tiles, p)),
        ("g_acc", g_acc, (num_tiles, CH_PAD, p)),
        ("g_trans", g_trans, (num_tiles, p)),
    ):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape} float32, got {tuple(t.shape)} {t.dtype}")
    tensors = (n_proc, trans, g_acc, g_trans)
    if any(t.device != table.device for t in tensors):
        raise ValueError("all inputs must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("inputs must be contiguous")

    fn = _bwd_entry_point()
    n_blocks = flat.numel() // chunk
    d_table = torch.zeros_like(table)  # the kernel adds into it
    # Scratch: per (flat block, pixel) (L, U) of pass A, then the scan's
    # seeds (log T, S); per flat block its tile or -1.
    sums = torch.empty((n_blocks, p, 2), dtype=torch.float32, device=table.device)
    block_map = torch.empty((n_blocks,), dtype=torch.int32, device=table.device)
    with tracing.span("kernel.k2"):
        kernel_build.launch(
            "composite_bwd", fn, table.get_device(),
            table.data_ptr(), flat.data_ptr(), block_start.data_ptr(), counts.data_ptr(),
            n_proc.data_ptr(), trans.data_ptr(), g_acc.data_ptr(), g_trans.data_ptr(),
            num_tiles, tiles_x, chunk, table.shape[0], n_blocks,
            sums.data_ptr(), block_map.data_ptr(), d_table.data_ptr(),
        )
    tracing.count_launch("k2_launches")
    return d_table


def composite_bwd(
    table: torch.Tensor,
    flat: torch.Tensor,
    block_start: torch.Tensor,
    counts: torch.Tensor,
    n_proc: torch.Tensor,
    trans: torch.Tensor,
    g_acc: torch.Tensor,
    g_trans: torch.Tensor,
    tiles_x: int,
    chunk: int = 128,
    tile_size: int = 16,
) -> torch.Tensor:
    """Returns d_table (rows, 12), the gradient of `composite_core`'s table."""
    if table.device.type == "cpu":
        return composite_bwd_plain(
            table, flat, block_start, counts, n_proc, trans, g_acc, g_trans, tiles_x, chunk, tile_size
        )[1]
    if table.device.type != "cuda":
        raise ValueError(f"composite_bwd runs on CUDA or CPU tensors, not {table.device}")
    if tile_size != KERNEL_TILE:
        raise NotImplementedError(f"the CUDA compositor takes {KERNEL_TILE}x{KERNEL_TILE} tiles")
    return _launch_bwd(table, flat, block_start, counts, n_proc, trans, g_acc, g_trans, tiles_x, chunk)
