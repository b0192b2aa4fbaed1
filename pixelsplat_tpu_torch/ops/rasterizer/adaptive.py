"""Occupancy-adaptive render settings: one probe and two rules.

Port of `pixelsplat_tpu/ops/rasterizer/adaptive.py` (`_occupancy_stats`,
`choose_settings`). `probe` is a cheap bounding-box pre-pass over a
scene's views: it measures the largest per-tile list, the flat pair demand
and the big-list capacity that holds every big Gaussian, and reads them
back to the host in two `settings.read` sync points, so it runs once per
scene. The rules are host arithmetic on its `Occupancy`:
`choose_settings` picks the smallest sufficient capacity and pair budget
(evaluation), `sufficient_settings` grows given settings only where they
do not hold (the figures' renders). Either way no pair is dropped, because
the pre-pass bounds what binning (which also culls by the exact ellipse)
produces. On CUDA tensors that need no gradient the pre-pass is one
projection launch for all the views and the occupancy kernel
(`project_bin_kernel`), which count what the plain `count_big` and
`tile_occupancy` count.
"""

from __future__ import annotations

from dataclasses import replace
from typing import NamedTuple

import torch

from ...utils import tracing
from . import project_bin_kernel
from .binning import count_big, default_pair_budget, tile_occupancy
from .projection import GaussiansSoA, ProjectedGaussians, project_gaussians_soa_plain, rescaled
from .render import DEFAULT_SETTINGS, RenderSettings


class Occupancy(NamedTuple):
    """What a scene's views need of the tile lists, over all the views."""

    max_count: int  # the largest per-tile list of small Gaussians
    pair_demand: int  # the flat pairs binning writes at `big_capacity`
    big_capacity: int  # holds every view's big Gaussians (at least the settings')


def probe(
    extrinsics: torch.Tensor,  # (b, 4, 4) cameras of the scene's views
    intrinsics: torch.Tensor,  # (b, 3, 3)
    near: torch.Tensor,  # (b,)
    planes: tuple,  # the projection's ten (b, g) planes (`soa_planes`, `aos_planes`), or (g,) ones every view shares
    image_shape: tuple[int, int],
    settings: RenderSettings = DEFAULT_SETTINGS,
    scale_invariant: bool = True,
) -> Occupancy:
    """The occupancy of the b views at `settings`' tile size, span and
    chunk. `scale_invariant` as in `render`. Two reads back from the device:
    the big-list count, then the max count and the demand together."""
    b = extrinsics.shape[0]
    tile_size, span, chunk = settings.tile_size, settings.span, settings.chunk
    big_capacity = settings.big_capacity
    if project_bin_kernel.takes(*planes, extrinsics, intrinsics, near):
        with tracing.span("settings.project"):
            rows, valid = project_bin_kernel.project(
                extrinsics, intrinsics, near if scale_invariant else None, planes, image_shape
            )
        projected = ProjectedGaussians(*rows, color=None, opacity=planes[9], valid=valid)
        with tracing.span("settings.occupancy"):
            hist, n_big_views = project_bin_kernel.occupancy(projected, b, image_shape, tile_size, span)
        with tracing.sync_point("settings.read"):
            n_big = max(n_big_views.tolist())
        if n_big > big_capacity:
            big_capacity = -(-n_big // chunk) * chunk
        with tracing.span("settings.occupancy"):
            stats = project_bin_kernel.occupancy_stats(hist, n_big_views, big_capacity, chunk)
        with tracing.sync_point("settings.read"):
            max_count, demand = stats.tolist()
        return Occupancy(max_count, demand, big_capacity)

    projected = []
    with tracing.span("settings.project"):
        for v in range(b):
            mx, my, mz, *cov, o = (p[v] if p.ndim == 2 else p for p in planes)
            soa = GaussiansSoA(mean_x=mx, mean_y=my, mean_z=mz, cov=torch.stack(cov), opacity=o,
                               colors=torch.zeros((1, mx.shape[0]), dtype=mx.dtype, device=mx.device))
            e = extrinsics[v]
            if scale_invariant:
                e, soa = rescaled(e, soa, near[v])
            projected.append(project_gaussians_soa_plain(e, intrinsics[v], image_shape, soa))
    with tracing.span("settings.occupancy"):
        n_big = torch.stack([count_big(p, image_shape, tile_size, span) for p in projected]).max()
    with tracing.sync_point("settings.read"):
        n_big = int(n_big)
    if n_big > big_capacity:
        big_capacity = -(-n_big // chunk) * chunk
    with tracing.span("settings.occupancy"):
        stats = torch.stack([
            torch.stack(tile_occupancy(p, image_shape, tile_size, span, big_capacity, chunk)) for p in projected
        ]).amax(dim=0)
    with tracing.sync_point("settings.read"):
        max_count, demand = stats.tolist()
    return Occupancy(max_count, demand, big_capacity)


def _num_tiles(image_shape: tuple[int, int], tile_size: int) -> int:
    h, w = image_shape
    return (-(-w // tile_size)) * (-(-h // tile_size))


def choose_settings(
    occupancy: Occupancy,
    settings: RenderSettings,
    g: int,  # Gaussians per view
    image_shape: tuple[int, int],
    capacities: tuple[int, ...] = (512, 1024, 2048),
) -> RenderSettings:
    """The smallest candidate capacity that holds the largest list (at most
    `settings.capacity`), the pair demand rounded up to whole chunks (at
    least 65,536 pairs, at most the worst case), and the probe's big-list
    capacity."""
    chosen = replace(settings, big_capacity=occupancy.big_capacity)
    for c in sorted(capacities):
        if occupancy.max_count <= c <= settings.capacity:
            chosen = replace(chosen, capacity=c)
            break
    chunk = settings.chunk
    worst = settings.span**2 * g + _num_tiles(image_shape, settings.tile_size) * (occupancy.big_capacity + chunk)
    pair_budget = -(-max(min(occupancy.pair_demand, worst), 65536) // chunk) * chunk
    tracing.count("capacity", chosen.capacity)
    tracing.count("pair_budget", pair_budget)
    tracing.count("big_capacity", occupancy.big_capacity)
    return replace(chosen, pair_budget=pair_budget)


def sufficient_settings(
    occupancy: Occupancy,
    settings: RenderSettings,
    g: int,  # Gaussians per view
    image_shape: tuple[int, int],
) -> RenderSettings:
    """`settings` itself where they hold the probed views' lists, else with
    the tile capacity, the big list and the pair budget each grown (in
    whole chunks) to what the views need, so that no pair is dropped."""
    chunk = settings.chunk
    chosen = settings
    if occupancy.max_count > settings.capacity:
        chosen = replace(chosen, capacity=-(-occupancy.max_count // chunk) * chunk)
    if occupancy.big_capacity > settings.big_capacity:
        chosen = replace(chosen, big_capacity=occupancy.big_capacity)
    pair_budget = settings.pair_budget
    if pair_budget is None:
        num_tiles = _num_tiles(image_shape, settings.tile_size)
        pair_budget = default_pair_budget(g, num_tiles, chosen.big_capacity, settings.span, chunk)
    if occupancy.pair_demand > pair_budget:
        chosen = replace(chosen, pair_budget=-(-occupancy.pair_demand // chunk) * chunk)
    return chosen
