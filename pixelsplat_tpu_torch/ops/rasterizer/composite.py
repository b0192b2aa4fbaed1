"""Front-to-back alpha compositing of binned Gaussians (forward).

Port of `pixelsplat_tpu/ops/rasterizer/composite.py`. The projected
Gaussians are packed once into a (g+1, 12) parameter table whose last row
is the zero sentinel, and `composite_kernel.composite_core` composites
every tile's list from that table and the flat tile lists.

The compositor stops a tile once every pixel's transmittance is below
1e-4 (checked after each chunk), where the CUDA 3DGS rasterizer stops each
pixel on its own: the two differ by at most 1e-4 times a colour.
"""

from __future__ import annotations

import torch

from .binning import TileLists
from .composite_kernel import MAX_COLOURS, ROW, composite_core
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


def composite_tiles(
    projected: ProjectedGaussians,
    tiles: TileLists,
    image_shape: tuple[int, int],
    background: torch.Tensor,  # (channels,)
    tile_size: int = 16,
    chunk: int = 128,
) -> torch.Tensor:
    """Returns the (channels, h, w) composited image."""
    h, w = image_shape
    tiles_x = -(-w // tile_size)
    tiles_y = -(-h // tile_size)
    channels = projected.color.shape[0]
    table = pack_columns(projected).contiguous()
    acc, trans, _ = composite_core(
        table, tiles.flat, tiles.block_start, tiles.counts, tiles_x, chunk, tile_size
    )  # acc: (T, 8, P)
    image = acc[:, :channels, :] + trans[:, None, :] * background[None, :, None]
    image = image.reshape(tiles_y, tiles_x, channels, tile_size, tile_size)
    image = image.permute(2, 0, 3, 1, 4).reshape(
        channels, tiles_y * tile_size, tiles_x * tile_size
    )
    return image[:, :h, :w]
