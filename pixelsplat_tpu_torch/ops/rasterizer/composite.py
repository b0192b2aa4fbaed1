"""Front-to-back alpha compositing of binned Gaussians.

Port of `pixelsplat_tpu/ops/rasterizer/composite.py`. The projected
Gaussians are packed once into a (g+1, 12) parameter table whose last row
is the zero sentinel, and `CompositePacked` composites every tile's list
from that table and the flat tile lists: `composite_kernel.composite_core`
forward, `composite_kernel.composite_bwd` backward, on either device. The
backward walks the chunks the forward composited, so its gradient is that
of the early-exiting forward, not of an exact compositor.

The compositor stops a tile once every pixel's transmittance is below
1e-4 (checked after each chunk), where the CUDA 3DGS rasterizer stops each
pixel on its own. A pixel that falls below 1e-4 before the rest of its
tile composites on here, so behind dense opaque Gaussians the two differ by
up to 1e-2 of a colour (PERF.md, section 6).
"""

from __future__ import annotations

import torch

from ...utils import tracing
from .binning import TileLists
from .composite_kernel import MAX_COLOURS, ROW, composite_bwd, composite_core
from .projection import ProjectedGaussians


def pack_columns(projected: ProjectedGaussians) -> torch.Tensor:
    """Per-Gaussian parameter columns as one (g+1, 12) f32 table.

    Columns: mx, my, conic a, b, c, opacity (0 where not valid), then up
    to six colours; the last row is the zero sentinel that pad slots of
    the tile lists point at.
    """
    ch = projected.color.shape[0]
    if ch > MAX_COLOURS:
        raise ValueError(f"at most {MAX_COLOURS} colour channels, got {ch}")
    op = torch.where(projected.valid, projected.opacity, 0.0)
    cols = [
        projected.mean_x,
        projected.mean_y,
        projected.conic_a,
        projected.conic_b,
        projected.conic_c,
        op,
        *projected.color,
    ]
    packed = torch.stack(cols, dim=-1)  # (g, 6 + ch)
    return torch.nn.functional.pad(packed, (0, ROW - packed.shape[-1], 0, 1))


class CompositePacked(torch.autograd.Function):
    """(table, flat, block_start, counts, tiles_x, chunk, tile_size) ->
    (acc (T, 8, P), trans (T, P), n_proc (T,) int32), differentiable in
    `table`. Counterpart of `_composite_packed` and its custom VJP."""

    @staticmethod
    def forward(ctx, table, flat, block_start, counts, tiles_x, chunk, tile_size):
        acc, trans, n_proc = composite_core(table, flat, block_start, counts, tiles_x, chunk, tile_size)
        ctx.save_for_backward(table, flat, block_start, counts, n_proc, trans)
        ctx.static = (tiles_x, chunk, tile_size)
        ctx.mark_non_differentiable(n_proc)
        return acc, trans, n_proc

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_acc, g_trans, _g_n_proc):
        table, flat, block_start, counts, n_proc, trans = ctx.saved_tensors
        # Autograd hands zeros for an output the loss does not reach.
        d_table = composite_bwd(
            table, flat, block_start, counts, n_proc, trans,
            g_acc.contiguous(), g_trans.contiguous(), *ctx.static,
        )
        return d_table, None, None, None, None, None, None


def assemble_image(
    acc: torch.Tensor,  # (T, 8, P)
    trans: torch.Tensor,  # (T, P)
    background: torch.Tensor,  # (channels,)
    image_shape: tuple[int, int],
    tile_size: int = 16,
) -> torch.Tensor:
    """The (channels, h, w) image from the compositor's per-tile outputs:
    colours plus the background seen through what transmittance is left."""
    h, w = image_shape
    tiles_x = -(-w // tile_size)
    tiles_y = -(-h // tile_size)
    channels = background.shape[0]
    image = acc[:, :channels, :] + trans[:, None, :] * background[None, :, None]
    image = image.reshape(tiles_y, tiles_x, channels, tile_size, tile_size)
    image = image.permute(2, 0, 3, 1, 4).reshape(
        channels, tiles_y * tile_size, tiles_x * tile_size
    )
    return image[:, :h, :w]


def composite_tiles(
    projected: ProjectedGaussians,
    tiles: TileLists,
    image_shape: tuple[int, int],
    background: torch.Tensor,  # (channels,)
    tile_size: int = 16,
    chunk: int = 128,
) -> torch.Tensor:
    """Returns the (channels, h, w) composited image, differentiable in the
    projected Gaussians' means, conics, opacities and colours."""
    tiles_x = -(-image_shape[1] // tile_size)
    with tracing.span("render.composite"):
        table = pack_columns(projected).contiguous()
        acc, trans, _ = CompositePacked.apply(
            table, tiles.flat, tiles.block_start, tiles.counts, tiles_x, chunk, tile_size
        )  # acc: (T, 8, P)
        return assemble_image(acc, trans, background, image_shape, tile_size)
