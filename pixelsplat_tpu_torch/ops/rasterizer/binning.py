"""Tile binning for the splatting rasterizer: sort-based, fixed-size lists.

Port of `pixelsplat_tpu/ops/rasterizer/binning.py`:

1. each Gaussian whose tile bounding box spans at most `span` x `span`
   tiles emits one (tile, depth) pair key per overlapped tile that passes
   the precise ellipse-vs-tile test. The key packs `tile_id` in the high
   bits and the top bits of the positive-f32 depth pattern in the low
   bits, so one int32 sort orders pairs by tile, then depth;
2. the nearest `big_capacity` larger ("big") Gaussians emit one key per
   tile they reach, and join the same sort;
3. each tile's run of the sorted payload is written at a chunk-aligned
   offset of one flat, budgeted id array (sentinel id `g` elsewhere),
   with the farthest pairs dropped where a tile exceeds `capacity` and
   whole tiles dropped where the pair budget runs out. Every dropped pair
   is counted in `overflow`.

Sorts are `torch.sort` on the same int32 keys; pairs with equal keys
(depths that agree in their top bits, ~2^-15 relative) may come out in
another order than the JAX package's unstable sort gives.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .projection import MIN_ALPHA, ProjectedGaussians

_F32_EPS = float(torch.finfo(torch.float32).eps)


class TileLists(NamedTuple):
    # Gaussian ids of every tile's front-to-back list in one flat array:
    # tile t's list occupies `chunk`-aligned slots from block_start[t] *
    # chunk with counts[t] real entries; every other slot holds `g`.
    flat: torch.Tensor  # (pair_budget,) int32
    block_start: torch.Tensor  # (num_tiles,) int32, chunk index of tile t
    counts: torch.Tensor  # (num_tiles,) int32, list length (<= capacity)
    # Pairs dropped at capacity or budget.
    overflow: torch.Tensor  # () int32


def _tile_bounds(projected: ProjectedGaussians, tile_size: int, tiles_x: int, tiles_y: int):
    def cell(v, hi):
        return torch.clamp(torch.floor(v / tile_size), 0, hi - 1).to(torch.int32)

    x0 = cell(projected.mean_x - projected.radius_x, tiles_x)
    x1 = cell(projected.mean_x + projected.radius_x, tiles_x)
    y0 = cell(projected.mean_y - projected.radius_y, tiles_y)
    y1 = cell(projected.mean_y + projected.radius_y, tiles_y)
    return x0, x1, y0, y1


def bin_gaussians(
    projected: ProjectedGaussians,
    image_shape: tuple[int, int],
    tile_size: int = 16,
    capacity: int = 2048,
    span: int = 3,
    big_capacity: int = 128,
    chunk: int = 128,
    pair_budget: int | None = None,
    force_wide_keys: bool = False,
) -> TileLists:
    h, w = image_shape
    tiles_x = -(-w // tile_size)
    tiles_y = -(-h // tile_size)
    num_tiles = tiles_x * tiles_y
    g = projected.depth.shape[0]
    device = projected.depth.device
    big_capacity = min(big_capacity, g)
    capacity = min(capacity, g * span * span)
    i32 = torch.int32

    iota = torch.arange(g, dtype=i32, device=device)
    mean_x, mean_y = projected.mean_x, projected.mean_y
    valid = projected.valid

    # Precise ellipse-vs-tile test: the minimum over the tile rectangle of
    # q = a dx^2 + 2 b dx dy + c dy^2 lies at the mean (if inside) or on
    # one of the 4 edges; a pair whose tile never reaches alpha >=
    # MIN_ALPHA is dropped (every compositor zeroes it anyway).
    conic_a = torch.clamp(projected.conic_a, min=1e-12)
    conic_c = torch.clamp(projected.conic_c, min=1e-12)
    conic_b = projected.conic_b
    t_cut = 2.0 * torch.log(torch.clamp(projected.opacity, min=MIN_ALPHA) / MIN_ALPHA)

    def tile_reaches_alpha(tx, ty, gid=None):
        if gid is None:
            mx, my, ca, cb, cc, t = mean_x, mean_y, conic_a, conic_b, conic_c, t_cut
        else:
            # Out-of-range ids (g) read row 0; callers mask them out.
            safe = torch.where(gid < g, gid, torch.zeros_like(gid)).long()
            mx, my, ca, cb, cc, t = (
                v[safe] for v in (mean_x, mean_y, conic_a, conic_b, conic_c, t_cut)
            )
        dx0 = tx.to(torch.float32) * tile_size - mx
        dx1 = dx0 + (tile_size - 1)
        dy0 = ty.to(torch.float32) * tile_size - my
        dy1 = dy0 + (tile_size - 1)
        inside = (dx0 <= 0) & (0 <= dx1) & (dy0 <= 0) & (0 <= dy1)

        def q_at(dx, dy):
            # Lower q by a multiple of its rounding error so that rounding
            # can only keep a borderline pair, never cull one.
            q = (ca * dx + 2.0 * cb * dy) * dx + cc * dy * dy
            mag = ca * dx * dx + cc * dy * dy
            return q - (32.0 * _F32_EPS) * mag

        def q_edge_x(dx):
            return q_at(dx, torch.clamp(-cb * dx / cc, dy0, dy1))

        def q_edge_y(dy):
            return q_at(torch.clamp(-cb * dy / ca, dx0, dx1), dy)

        q_min = torch.minimum(
            torch.minimum(q_edge_x(dx0), q_edge_x(dx1)),
            torch.minimum(q_edge_y(dy0), q_edge_y(dy1)),
        )
        return inside | (q_min <= t)

    x0, x1, y0, y1 = _tile_bounds(projected, tile_size, tiles_x, tiles_y)
    span_x = x1 - x0 + 1
    span_y = y1 - y0 + 1
    small = valid & (span_x <= span) & (span_y <= span)
    big = valid & ~small

    # Pair keys: tile id in the high bits, the top `depth_bits` of the
    # positive-f32 depth pattern (monotone in depth) in the low bits. When
    # the tile count leaves fewer than 12 depth bits, sort (tile, exact
    # depth pattern) pairs as one int64 key instead.
    depth_bits = 31 - max((num_tiles + 1).bit_length(), 1)
    wide_keys = force_wide_keys or depth_bits < 12
    depth_pattern = torch.clamp(projected.depth, min=0.0).to(torch.float32).view(i32)
    dq = depth_pattern if wide_keys else depth_pattern >> (31 - depth_bits)
    tile_shift = 1 << max(depth_bits, 0)
    keys, tile_keys = [], []
    for slot in range(span * span):
        dx, dy = slot % span, slot // span
        tx = x0 + dx
        ty = y0 + dy
        slot_ok = small & (dx < span_x) & (dy < span_y) & tile_reaches_alpha(tx, ty)
        tile_id = ty * tiles_x + tx
        if wide_keys:
            tile_keys.append(torch.where(slot_ok, tile_id, num_tiles))
            keys.append(dq)
        else:
            sentinel = torch.full_like(tile_id, num_tiles * tile_shift)
            keys.append(torch.where(slot_ok, tile_id * tile_shift + dq, sentinel))
    keys = torch.cat(keys)
    if wide_keys:
        tile_keys = torch.cat(tile_keys)
    payload = iota.repeat(span * span)

    overflow = torch.zeros((), dtype=i32, device=device)
    if big_capacity > 0:
        # The nearest big_capacity big Gaussians, each joining the pair
        # sort once per tile it reaches.
        big_inf = 2**31 - 1
        big_dq = torch.where(big, dq, torch.full_like(dq, big_inf))
        big_sorted, order = torch.sort(big_dq, stable=True)
        big_gid_sorted = iota[order]
        big_dqs = big_sorted[:big_capacity]
        big_valid = big_dqs < big_inf
        big_gids = torch.where(
            big_valid, big_gid_sorted[:big_capacity], torch.full_like(big_dqs, g)
        )
        overflow = overflow + torch.clamp(big.sum() - big_capacity, min=0).to(i32)

        all_tiles = torch.arange(num_tiles, dtype=i32, device=device)
        big_tx = (all_tiles % tiles_x)[:, None]
        big_ty = (all_tiles // tiles_x)[:, None]

        def take(v, fill):
            # jnp.take(..., fill_value=fill) at ids that may equal g.
            padded = torch.cat([v, torch.full((1,), fill, dtype=v.dtype, device=device)])
            return padded[big_gids.long()][None, :]

        in_bbox = (
            (big_tx >= take(x0, 1))
            & (big_tx <= take(x1, -1))
            & (big_ty >= take(y0, 1))
            & (big_ty <= take(y1, -1))
        )
        big_ok = (
            big_valid[None, :]
            & in_bbox
            & tile_reaches_alpha(big_tx, big_ty, gid=big_gids[None, :])
        )
        if wide_keys:
            big_tiles = torch.where(big_ok, all_tiles[:, None], num_tiles)
            tile_keys = torch.cat([tile_keys, big_tiles.reshape(-1)])
            keys = torch.cat([keys, big_dqs[None, :].expand(num_tiles, big_capacity).reshape(-1)])
        else:
            big_keys = torch.where(
                big_ok,
                all_tiles[:, None] * tile_shift + big_dqs[None, :],
                torch.full_like(big_ok, num_tiles * tile_shift, dtype=i32),
            )
            keys = torch.cat([keys, big_keys.reshape(-1)])
        payload = torch.cat(
            [payload, big_gids[None, :].expand(num_tiles, big_capacity).reshape(-1)]
        )

    if wide_keys:
        sort_keys = (tile_keys.to(torch.int64) << 31) | keys.to(torch.int64)
        _, order = torch.sort(sort_keys, stable=True)
        seg_keys = tile_keys[order]
        seg_step = 1
    else:
        seg_keys, order = torch.sort(keys, stable=True)
        seg_step = tile_shift
    payload = payload[order]

    # Per-tile segments of the sorted pairs.
    bounds = torch.searchsorted(
        seg_keys,
        torch.arange(num_tiles + 1, dtype=i32, device=device) * seg_step,
    ).to(i32)
    starts = bounds[:-1]
    raw_counts = bounds[1:] - starts
    counts = torch.clamp(raw_counts, max=capacity)
    overflow = overflow + (raw_counts - counts).sum().to(i32)

    if pair_budget is None:
        # The exact worst case when small, else twice the Gaussian count
        # plus one chunk of alignment padding per tile.
        worst = span * span * g + num_tiles * (big_capacity + chunk)
        floor = max(2 * g + num_tiles * chunk, 65536)
        pair_budget = min(worst, floor)
    pair_budget = -(-pair_budget // chunk) * chunk
    nb = pair_budget // chunk

    blocks = -(-counts // chunk)
    astart = torch.cumsum(blocks, 0).to(i32) - blocks
    fits = (astart + blocks) <= nb
    overflow = overflow + torch.where(fits, 0, counts).sum().to(i32)
    counts = torch.where(fits, counts, 0)
    # Budget-dropped tiles point at the end of the array with no entries.
    astart = torch.where(fits, astart, nb)

    # One scatter places every kept pair at block_start * chunk + its rank
    # in the tile.
    n_pairs = seg_keys.shape[0]
    tile_of = torch.clamp(seg_keys // seg_step, max=num_tiles).long()
    tile_safe = torch.clamp(tile_of, max=num_tiles - 1)
    rank = torch.arange(n_pairs, dtype=i32, device=device) - starts[tile_safe]
    keep = (tile_of < num_tiles) & (rank < counts[tile_safe])
    # Dropped pairs all land in one spare slot past the end, so the scatter
    # needs no data-dependent shape (and no host sync).
    dest = torch.where(keep, astart[tile_safe].long() * chunk + rank.long(), pair_budget)
    flat = torch.full((pair_budget + 1,), g, dtype=i32, device=device)
    flat[dest] = payload
    flat = flat[:pair_budget]

    return TileLists(flat=flat, block_start=astart, counts=counts, overflow=overflow)


def count_big(projected: ProjectedGaussians, image_shape: tuple[int, int], tile_size: int = 16,
              span: int = 2) -> torch.Tensor:
    """How many valid Gaussians span more than `span` tiles on an axis: the
    ones `bin_gaussians` puts on its global list of `big_capacity` slots."""
    h, w = image_shape
    x0, x1, y0, y1 = _tile_bounds(projected, tile_size, -(-w // tile_size), -(-h // tile_size))
    return (projected.valid & ((x1 - x0 + 1 > span) | (y1 - y0 + 1 > span))).sum()


def tile_occupancy(
    projected: ProjectedGaussians,
    image_shape: tuple[int, int],
    tile_size: int = 16,
    span: int = 2,
    big_capacity: int = 256,
    chunk: int = 128,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Conservative per-tile occupancy of this scene, from bounding boxes.

    Returns `(max_count, needed_budget)`: upper bounds on the longest tile
    list and on the flat pair-array size `bin_gaussians` needs, so binning
    at `capacity >= max_count` and `pair_budget >= needed_budget` drops
    nothing.
    """
    h, w = image_shape
    tiles_x = -(-w // tile_size)
    tiles_y = -(-h // tile_size)
    num_tiles = tiles_x * tiles_y
    device = projected.depth.device

    x0, x1, y0, y1 = _tile_bounds(projected, tile_size, tiles_x, tiles_y)
    span_x = x1 - x0 + 1
    span_y = y1 - y0 + 1
    small = projected.valid & (span_x <= span) & (span_y <= span)
    n_big = (projected.valid & ~small).sum()

    keys = []
    for slot in range(span * span):
        dx, dy = slot % span, slot // span
        slot_ok = small & (dx < span_x) & (dy < span_y)
        tile_id = (y0 + dy) * tiles_x + (x0 + dx)
        keys.append(torch.where(slot_ok, tile_id, num_tiles))
    sorted_ids, _ = torch.sort(torch.cat(keys))
    bounds = torch.searchsorted(
        sorted_ids, torch.arange(num_tiles + 1, dtype=torch.int32, device=device)
    )
    counts = bounds[1:] - bounds[:-1] + torch.clamp(n_big, max=big_capacity)
    needed_budget = (-(-counts // chunk) * chunk).sum()
    return counts.max(), needed_budget
