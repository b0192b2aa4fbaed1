"""Forward tile compositing: the CUDA kernel's wrapper and its plain version.

`composite_core` replaces `pixelsplat_tpu/ops/rasterizer/
pallas_composite.py::pallas_composite_core` and the row gather in front of
it. It takes the (rows, 12) f32 parameter table of `composite.pack_columns`
and the flat tile lists of `binning.TileLists`, and returns the contract
of `pallas_composite_core`: `acc (T, 8, P)` with colours in channels 0-5
(channels 6-7 zero), `trans (T, P)` and `n_proc (T,)` int32, the number of
`chunk`-slot chunks each tile composited before its exit.

On a CUDA tensor it launches `csrc/composite_fwd.cu` or raises; on a CPU
tensor it runs `composite_core_plain`. `composite_core.launches` counts
kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ... import kernel_build

CH_PAD = 8  # output channels: <= 6 colours, then two zero channels
MAX_COLOURS = 6
ROW = 12  # table columns: mx, my, conic a/b/c, opacity, 6 colours
TRANS_EPS = 1e-4
MAX_ALPHA = 0.99
MIN_ALPHA = 1.0 / 255.0
KERNEL_TILE = 16
KERNEL_MAX_CHUNK = 128


def composite_core_plain(
    table: torch.Tensor,  # (rows, 12) f32, last row the zero sentinel
    flat: torch.Tensor,  # (pair_budget,) int32
    block_start: torch.Tensor,  # (T,) int32
    counts: torch.Tensor,  # (T,) int32
    tiles_x: int,
    chunk: int = 128,
    tile_size: int = 16,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, vectorised over tiles.

    Loops over chunks with a per-tile active mask under the kernel's exit
    rule; transmittance is a running product along each chunk.
    """
    device = table.device
    num_tiles = counts.shape[0]
    p = tile_size * tile_size
    tile_ids = torch.arange(num_tiles, device=device)
    within = torch.arange(p, device=device)
    pix_x = ((tile_ids % tiles_x)[:, None] * tile_size + (within % tile_size)[None]).to(table.dtype)
    pix_y = ((tile_ids // tiles_x)[:, None] * tile_size + (within // tile_size)[None]).to(table.dtype)

    n_chunks = (counts.long() + chunk - 1) // chunk
    trans = torch.ones((num_tiles, p), dtype=table.dtype, device=device)
    acc = torch.zeros((num_tiles, CH_PAD, p), dtype=table.dtype, device=device)
    n_proc = torch.zeros((num_tiles,), dtype=torch.int32, device=device)
    active = n_chunks > 0
    slots = torch.arange(chunk, device=device)
    base = block_start.long() * chunk
    for i in range(int(n_chunks.max()) if num_tiles else 0):
        if not bool(active.any()):
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
        active = active & (i + 1 < n_chunks) & (trans.amax(dim=1) >= TRANS_EPS)
    return acc, trans, n_proc


@functools.cache
def _entry_point():
    """`composite_fwd` of the built library, its C signature declared."""
    fn = kernel_build.load("composite_fwd").composite_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    return fn


def _launch(table, flat, block_start, counts, tiles_x, chunk):
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

    fn = _entry_point()
    num_tiles = counts.shape[0]
    p = KERNEL_TILE * KERNEL_TILE
    acc = torch.empty((num_tiles, CH_PAD, p), dtype=torch.float32, device=table.device)
    trans = torch.empty((num_tiles, p), dtype=torch.float32, device=table.device)
    n_proc = torch.empty((num_tiles,), dtype=torch.int32, device=table.device)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            table.data_ptr(), flat.data_ptr(), block_start.data_ptr(), counts.data_ptr(),
            num_tiles, tiles_x, chunk,
            acc.data_ptr(), trans.data_ptr(), n_proc.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"composite_fwd launch failed: cudaError {err}")
    composite_core.launches += 1
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


composite_core.launches = 0
