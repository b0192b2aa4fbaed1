"""Occupancy-adaptive render settings for evaluation.

Port of `pixelsplat_tpu/ops/rasterizer/adaptive.py` (`_occupancy_stats`,
`choose_settings`, `render_adaptive`). A cheap bounding-box pre-pass
measures the scene's largest per-tile list and its flat pair demand; the
smallest sufficient capacity and pair budget then render without dropping
a pair, because the pre-pass bounds what binning (which also culls by the
exact ellipse) produces. Choosing reads three numbers back from the device
(the `settings.read` sync points), so it runs once per scene. On CUDA
tensors that need no gradient the pre-pass is one projection launch for
all the views and the occupancy kernel (`project_bin_kernel`), which count
what the plain `count_big` and `tile_occupancy` count.
"""

from __future__ import annotations

from dataclasses import replace

import torch

from ...utils import tracing
from . import project_bin_kernel
from .binning import count_big, default_pair_budget, tile_occupancy
from .projection import GaussiansSoA, ProjectedGaussians, aos_planes, project_gaussians_soa_plain
from .render import DEFAULT_SETTINGS, RenderSettings, render


def _occupancy_stats(
    extrinsics: torch.Tensor,  # (b, 4, 4)
    intrinsics: torch.Tensor,  # (b, 3, 3)
    near: torch.Tensor,  # (b,)
    planes: tuple,  # the projection's ten (b, g) planes (`soa_planes`), or (g,) ones that every view shares
    image_shape: tuple[int, int],
    tile_size: int,
    span: int,
    big_capacity: int,
    chunk: int,
    scale_invariant: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Max per-tile count and max flat-budget demand over the b views, and
    the big-list capacity that holds every view's big Gaussians (at least
    `big_capacity`). `scale_invariant` as in `render`. On CUDA tensors that
    need no gradient, one projection kernel launch for the b views, the
    occupancy kernel and its reduction; else the plain code, view by view."""
    b = extrinsics.shape[0]
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
            max_count, budget = project_bin_kernel.occupancy_stats(hist, n_big_views, big_capacity, chunk)
        return max_count, budget, big_capacity

    projected = []
    with tracing.span("settings.project"):
        for v in range(b):
            scale = 1.0 / near[v] if scale_invariant else torch.ones_like(near[v])
            e = extrinsics[v].clone()
            e[:3, 3] = e[:3, 3] * scale
            mx, my, mz, *cov, o = (p[v] if p.ndim == 2 else p for p in planes)
            soa = GaussiansSoA(
                mean_x=mx * scale, mean_y=my * scale, mean_z=mz * scale, cov=torch.stack(cov) * scale**2, opacity=o,
                colors=torch.zeros((1, mx.shape[0]), dtype=mx.dtype, device=mx.device),
            )
            projected.append(project_gaussians_soa_plain(e, intrinsics[v], image_shape, soa))
    with tracing.span("settings.occupancy"):
        n_big = torch.stack([count_big(p, image_shape, tile_size, span) for p in projected]).max()
    with tracing.sync_point("settings.read"):
        n_big = int(n_big)
    if n_big > big_capacity:
        big_capacity = -(-n_big // chunk) * chunk
    with tracing.span("settings.occupancy"):
        stats = [
            tile_occupancy(p, image_shape, tile_size=tile_size, span=span, big_capacity=big_capacity, chunk=chunk)
            for p in projected
        ]
        max_counts, budgets = zip(*stats)
        return torch.stack(max_counts).max(), torch.stack(budgets).max(), big_capacity


def choose_settings(
    extrinsics: torch.Tensor,  # (b, 4, 4) cameras of the scene's views
    intrinsics: torch.Tensor,
    near: torch.Tensor,
    gaussian_means: torch.Tensor,
    gaussian_covariances: torch.Tensor,
    gaussian_opacities: torch.Tensor,
    image_shape: tuple[int, int],
    settings: RenderSettings = DEFAULT_SETTINGS,
    capacities: tuple[int, ...] = (512, 1024, 2048),
    margin: float = 1.0,
) -> RenderSettings:
    """The smallest sufficient capacity and pair budget for this scene, and
    a big-list capacity that holds its big Gaussians.

    `margin` scales both statistics, for callers whose render cameras only
    approximate the probed ones.
    """
    return choose_settings_planes(
        extrinsics, intrinsics, near, aos_planes(gaussian_means, gaussian_covariances, gaussian_opacities),
        image_shape, settings, capacities, margin,
    )


def choose_settings_planes(
    extrinsics: torch.Tensor,  # (b, 4, 4) cameras of the scene's views
    intrinsics: torch.Tensor,
    near: torch.Tensor,
    planes: tuple,  # the projection's ten (b, g) planes, or (g,) ones that every view shares
    image_shape: tuple[int, int],
    settings: RenderSettings = DEFAULT_SETTINGS,
    capacities: tuple[int, ...] = (512, 1024, 2048),
    margin: float = 1.0,
) -> RenderSettings:
    """`choose_settings` from the Gaussians' planes (`soa_planes`,
    `aos_planes`)."""
    max_count, budget, big_capacity = _occupancy_stats(
        extrinsics, intrinsics, near, planes, image_shape, settings.tile_size, settings.span,
        settings.big_capacity, settings.chunk,
    )
    with tracing.sync_point("settings.read"):
        max_count = int(max_count.item() * margin)
    h, w = image_shape
    num_tiles = (-(-w // settings.tile_size)) * (-(-h // settings.tile_size))
    with tracing.sync_point("settings.read"):
        budget = int(budget.item() * margin) + (num_tiles * settings.chunk if margin > 1 else 0)

    chosen = replace(settings, big_capacity=big_capacity)
    for c in sorted(capacities):
        if max_count <= c and c <= settings.capacity:
            chosen = replace(chosen, capacity=c)
            break
    g = planes[0].shape[-1]
    worst = settings.span**2 * g + num_tiles * (big_capacity + settings.chunk)
    pair_budget = -(-max(min(budget, worst), 65536) // settings.chunk) * settings.chunk
    tracing.count("capacity", chosen.capacity)
    tracing.count("pair_budget", pair_budget)
    tracing.count("big_capacity", big_capacity)
    return replace(chosen, pair_budget=pair_budget)


def sufficient_settings(
    extrinsics: torch.Tensor,  # (b, 4, 4)
    intrinsics: torch.Tensor,  # (b, 3, 3)
    near: torch.Tensor,  # (b,)
    gaussian_means: torch.Tensor,  # (b, g, 3)
    gaussian_covariances: torch.Tensor,  # (b, g, 3, 3)
    gaussian_opacities: torch.Tensor,  # (b, g)
    image_shape: tuple[int, int],
    settings: RenderSettings = DEFAULT_SETTINGS,
    scale_invariant: bool = True,
) -> RenderSettings:
    """`settings` where they hold these views' lists, else with the tile
    capacity, the big list and the pair budget each grown (in whole chunks)
    to what the views need, so that no pair is dropped. Three reads back from the device."""
    max_count, budget, big_capacity = _occupancy_stats(
        extrinsics, intrinsics, near, aos_planes(gaussian_means, gaussian_covariances, gaussian_opacities),
        image_shape, settings.tile_size, settings.span, settings.big_capacity, settings.chunk, scale_invariant,
    )
    chunk = settings.chunk
    with tracing.sync_point("settings.read"):
        max_count = int(max_count)
    with tracing.sync_point("settings.read"):
        budget = int(budget)
    chosen = settings
    if max_count > settings.capacity:
        chosen = replace(chosen, capacity=-(-max_count // chunk) * chunk)
    if big_capacity > settings.big_capacity:
        chosen = replace(chosen, big_capacity=big_capacity)
    pair_budget = settings.pair_budget
    if pair_budget is None:
        h, w = image_shape
        num_tiles = (-(-w // settings.tile_size)) * (-(-h // settings.tile_size))
        pair_budget = default_pair_budget(gaussian_means.shape[1], num_tiles, chosen.big_capacity, settings.span, chunk)
    if budget > pair_budget:
        chosen = replace(chosen, pair_budget=-(-budget // chunk) * chunk)
    return chosen


def render_adaptive(
    extrinsics: torch.Tensor,  # (b, 4, 4)
    intrinsics: torch.Tensor,  # (b, 3, 3)
    near: torch.Tensor,  # (b,)
    far: torch.Tensor,  # (b,)
    image_shape: tuple[int, int],
    background_color: torch.Tensor,  # (b, c)
    gaussian_means: torch.Tensor,  # (b, g, 3)
    gaussian_covariances: torch.Tensor,  # (b, g, 3, 3)
    gaussian_sh_coefficients: torch.Tensor,  # (b, g, 3, d_sh) or (b, g, c)
    gaussian_opacities: torch.Tensor,  # (b, g)
    use_sh: bool = True,
    settings: RenderSettings = DEFAULT_SETTINGS,
    capacities: tuple[int, ...] = (512, 1024, 2048),
) -> torch.Tensor:
    """`render(..., scale_invariant=True)` at the smallest sufficient
    capacity and pair budget for these views (`settings.capacity` when the
    scene exceeds every candidate): the same image, since no list is cut."""
    chosen = choose_settings(
        extrinsics, intrinsics, near, gaussian_means, gaussian_covariances, gaussian_opacities,
        image_shape, settings=settings, capacities=capacities,
    )
    return render(
        extrinsics, intrinsics, near, far, image_shape, background_color, gaussian_means,
        gaussian_covariances, gaussian_sh_coefficients, gaussian_opacities,
        scale_invariant=True, use_sh=use_sh, settings=chosen,
    )
