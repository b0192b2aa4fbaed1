"""Occupancy-adaptive render settings for evaluation.

Port of `pixelsplat_tpu/ops/rasterizer/adaptive.py` (`_occupancy_stats`,
`choose_settings`, `render_adaptive`). A cheap bounding-box pre-pass
measures the scene's largest per-tile list and its flat pair demand; the
smallest sufficient capacity and pair budget then render without dropping
a pair, because the pre-pass bounds what binning (which also culls by the
exact ellipse) produces. Choosing costs one host sync, so it runs once per
scene.
"""

from __future__ import annotations

from dataclasses import replace

import torch

from .binning import tile_occupancy
from .projection import project_gaussians
from .render import DEFAULT_SETTINGS, RenderSettings, render


def _occupancy_stats(
    extrinsics: torch.Tensor,  # (b, 4, 4)
    intrinsics: torch.Tensor,  # (b, 3, 3)
    near: torch.Tensor,  # (b,)
    means: torch.Tensor,  # (b, g, 3)
    covariances: torch.Tensor,  # (b, g, 3, 3)
    opacities: torch.Tensor,  # (b, g)
    image_shape: tuple[int, int],
    tile_size: int,
    span: int,
    big_capacity: int,
    chunk: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Max per-tile count and max flat-budget demand over the b views."""
    max_counts, budgets = [], []
    for e, k, n, m, c, o in zip(extrinsics, intrinsics, near, means, covariances, opacities):
        scale = 1.0 / n
        e = e.clone()
        e[:3, 3] = e[:3, 3] * scale
        proj = project_gaussians(
            e, k, image_shape, m * scale, c * scale**2, o,
            colors_precomp=torch.zeros((m.shape[0], 1), dtype=m.dtype, device=m.device),
        )
        max_count, budget = tile_occupancy(
            proj, image_shape, tile_size=tile_size, span=span,
            big_capacity=big_capacity, chunk=chunk,
        )
        max_counts.append(max_count)
        budgets.append(budget)
    return torch.stack(max_counts).max(), torch.stack(budgets).max()


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
    """The smallest sufficient capacity and pair budget for this scene.

    `margin` scales both statistics, for callers whose render cameras only
    approximate the probed ones.
    """
    max_count, budget = _occupancy_stats(
        extrinsics, intrinsics, near, gaussian_means, gaussian_covariances,
        gaussian_opacities, image_shape, settings.tile_size, settings.span,
        settings.big_capacity, settings.chunk,
    )
    max_count = int(max_count.item() * margin)
    h, w = image_shape
    num_tiles = (-(-w // settings.tile_size)) * (-(-h // settings.tile_size))
    budget = int(budget.item() * margin) + (num_tiles * settings.chunk if margin > 1 else 0)

    chosen = settings
    for c in sorted(capacities):
        if max_count <= c and c <= settings.capacity:
            chosen = replace(settings, capacity=c)
            break
    g = gaussian_means.shape[1]
    worst = settings.span**2 * g + num_tiles * (settings.big_capacity + settings.chunk)
    pair_budget = -(-max(min(budget, worst), 65536) // settings.chunk) * settings.chunk
    return replace(chosen, pair_budget=pair_budget)


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
