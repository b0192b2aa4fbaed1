"""Public rendering API: Gaussian splatting of one or more views.

Port of `pixelsplat_tpu/ops/rasterizer/render.py` (`RenderSettings`,
`render_view_soa`, `render`): project, bin into 16x16 tiles, composite.
`render` matches the reference's `render_cuda`, including the 1/near
world rescale that keeps geometry clear of the rasterizer's near plane.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from .binning import TileLists, bin_gaussians
from .composite import composite_tiles
from .projection import (
    GaussiansSoA,
    ProjectedGaussians,
    pack_gaussians_soa,
    project_gaussians_soa,
)


@dataclass(frozen=True)
class RenderSettings:
    """Static configuration of the tiled rasterizer."""

    tile_size: int = 16
    # Per-tile list capacity; overfull tiles drop their farthest Gaussians.
    capacity: int = 4096
    # Max tile span (per axis) binned per Gaussian; larger footprints go to
    # the global big list.
    span: int = 2
    big_capacity: int = 256
    # Slots per compositing chunk.
    chunk: int = 128
    # Total (gaussian, tile) pair slots across all tiles (None: 2x the
    # Gaussian count plus one chunk per tile).
    pair_budget: Optional[int] = None
    # Force the two-word (tile, exact depth) sort keys.
    force_wide_keys: bool = False
    # Kept for config parity with the JAX package; the port has one
    # compositor, chosen by the tensors' device.
    backend: str = "auto"


DEFAULT_SETTINGS = RenderSettings()


def project_and_bin(
    extrinsics: torch.Tensor,  # (4, 4)
    intrinsics: torch.Tensor,  # (3, 3) normalized
    near: torch.Tensor,  # ()
    soa: GaussiansSoA,
    *,
    image_shape: tuple[int, int],
    scale_invariant: bool = True,
    settings: RenderSettings = DEFAULT_SETTINGS,
) -> tuple[ProjectedGaussians, TileLists]:
    """One view's projected Gaussians and tile lists: the compositor's inputs."""
    if scale_invariant:
        # Rescale the world by 1/near so the 0.2 near clip in the projector
        # never bites real geometry.
        scale = 1.0 / near
        extrinsics = extrinsics.clone()
        extrinsics[:3, 3] = extrinsics[:3, 3] * scale
        soa = soa._replace(
            mean_x=soa.mean_x * scale,
            mean_y=soa.mean_y * scale,
            mean_z=soa.mean_z * scale,
            cov=soa.cov * scale**2,
        )
    projected = project_gaussians_soa(extrinsics, intrinsics, image_shape, soa)
    tiles = bin_gaussians(
        projected,
        image_shape,
        tile_size=settings.tile_size,
        capacity=settings.capacity,
        span=settings.span,
        big_capacity=settings.big_capacity,
        chunk=settings.chunk,
        pair_budget=settings.pair_budget,
        force_wide_keys=settings.force_wide_keys,
    )
    return projected, tiles


def render_view_soa(
    extrinsics: torch.Tensor,  # (4, 4)
    intrinsics: torch.Tensor,  # (3, 3) normalized
    near: torch.Tensor,  # ()
    far: torch.Tensor,  # ()
    background: torch.Tensor,  # (c,)
    soa: GaussiansSoA,
    *,
    image_shape: tuple[int, int],
    scale_invariant: bool = True,
    settings: RenderSettings = DEFAULT_SETTINGS,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Render one view of a packed scene: ((c, h, w) image, overflow)."""
    projected, tiles = project_and_bin(
        extrinsics, intrinsics, near, soa,
        image_shape=image_shape, scale_invariant=scale_invariant, settings=settings,
    )
    image = composite_tiles(
        projected, tiles, image_shape, background, tile_size=settings.tile_size, chunk=settings.chunk
    )
    return image, tiles.overflow


def render(
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
    scale_invariant: bool = True,
    use_sh: bool = True,
    settings: RenderSettings = DEFAULT_SETTINGS,
    return_overflow: bool = False,
):
    """Render each batch element's Gaussians from its camera: (b, c, h, w).

    With `return_overflow`, also returns the (b,) count of (gaussian,
    tile) pairs the binner dropped.
    """
    images, overflows = [], []
    for i in range(extrinsics.shape[0]):
        sh_or_colors = gaussian_sh_coefficients[i]
        soa = pack_gaussians_soa(
            gaussian_means[i],
            gaussian_covariances[i],
            gaussian_opacities[i],
            harmonics=sh_or_colors if use_sh else None,
            colors_precomp=None if use_sh else sh_or_colors,
        )
        image, overflow = render_view_soa(
            extrinsics[i],
            intrinsics[i],
            near[i],
            far[i],
            background_color[i],
            soa,
            image_shape=image_shape,
            scale_invariant=scale_invariant,
            settings=settings,
        )
        images.append(image)
        overflows.append(overflow)
    images = torch.stack(images)
    if return_overflow:
        return images, torch.stack(overflows)
    return images
