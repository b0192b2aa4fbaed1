"""Public rendering API: Gaussian splatting of one or more views.

Port of `pixelsplat_tpu/ops/rasterizer/render.py`: project, bin into
16x16 tiles, composite. `render` matches the reference's `render_cuda`,
including the 1/near world rescale that keeps geometry clear of the
rasterizer's near plane; `render_depth` renders camera-space depth in one
of four modes as a single colour channel; `render_orthographic` emulates
an orthographic camera with a narrow frustum pushed back along its axis.
All of them composite through the same kernels.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Literal, Optional

import torch

from ...geometry.projection import inverse_se3
from ...utils import tracing
from ...utils.shape_checks import check_cameras, check_gaussians
from .binning import TileLists, bin_gaussians
from .composite import composite_tiles
from .projection import (
    GaussiansSoA,
    ProjectedGaussians,
    pack_gaussians_soa,
    project_gaussians_soa,
)

DepthRenderingMode = Literal["depth", "disparity", "relative_disparity", "log"]


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
    with tracing.span("render.project"):
        # Rescale the world by 1/near so the 0.2 near clip in the projector
        # never bites real geometry.
        projected = project_gaussians_soa(extrinsics, intrinsics, image_shape, soa, near if scale_invariant else None)
    with tracing.span("render.bin"):
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
    tracing.count_device("pairs_binned", tiles.counts)
    tracing.count_device("pairs_dropped", tiles.overflow)
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
    check_cameras(extrinsics, intrinsics, near, far, batch_dims=1)
    if use_sh:
        check_gaussians(gaussian_means, gaussian_covariances, gaussian_sh_coefficients, gaussian_opacities)
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


def depth_to_relative_disparity(
    depth: torch.Tensor, near: torch.Tensor, far: torch.Tensor, eps: float = 1e-10
) -> torch.Tensor:
    """0 at near, 1 at far."""
    disp_near = 1.0 / (near + eps)
    disp_far = 1.0 / (far + eps)
    disp = 1.0 / (depth + eps)
    return 1.0 - (disp - disp_far) / (disp_near - disp_far + eps)


def depth_colors(
    extrinsics: torch.Tensor,  # (b, 4, 4)
    near: torch.Tensor,  # (b,)
    far: torch.Tensor,  # (b,)
    gaussian_means: torch.Tensor,  # (b, g, 3)
    mode: DepthRenderingMode = "depth",
) -> torch.Tensor:
    """Each Gaussian's camera-space depth in `mode`: the (b, g) colour that
    `render_depth` composites."""
    cam_z = torch.einsum(
        "bij,bgj->bgi",
        inverse_se3(extrinsics),
        torch.cat([gaussian_means, torch.ones_like(gaussian_means[..., :1])], dim=-1),
    )[..., 2]
    if mode == "depth":
        return cam_z
    if mode == "disparity":
        return 1.0 / cam_z
    if mode == "relative_disparity":
        return depth_to_relative_disparity(cam_z, near[:, None], far[:, None])
    if mode == "log":
        # The reference chains minimum(near) then maximum(far), which gives a
        # constant; this is the clamp to [near, far] it means.
        return torch.log(torch.clamp(cam_z, near[:, None], far[:, None]))
    raise ValueError(f"unknown depth rendering mode {mode!r}")


def render_depth(
    extrinsics: torch.Tensor,  # (b, 4, 4)
    intrinsics: torch.Tensor,  # (b, 3, 3)
    near: torch.Tensor,  # (b,)
    far: torch.Tensor,  # (b,)
    image_shape: tuple[int, int],
    gaussian_means: torch.Tensor,  # (b, g, 3)
    gaussian_covariances: torch.Tensor,  # (b, g, 3, 3)
    gaussian_opacities: torch.Tensor,  # (b, g)
    scale_invariant: bool = True,
    mode: DepthRenderingMode = "depth",
    settings: RenderSettings = DEFAULT_SETTINGS,
) -> torch.Tensor:
    """Camera-space depth composited as a one-channel colour: (b, h, w)."""
    fake_color = depth_colors(extrinsics, near, far, gaussian_means, mode)
    result = render(
        extrinsics,
        intrinsics,
        near,
        far,
        image_shape,
        fake_color.new_zeros((fake_color.shape[0], 1)),
        gaussian_means,
        gaussian_covariances,
        fake_color[..., None],  # (b, g, 1)
        gaussian_opacities,
        scale_invariant=scale_invariant,
        use_sh=False,
        settings=settings,
    )
    return result[:, 0]


def orthographic_frustum(
    extrinsics: torch.Tensor,  # (b, 4, 4)
    width: torch.Tensor,  # (b,)
    height: torch.Tensor,  # (b,)
    near: torch.Tensor,  # (b,)
    far: torch.Tensor,  # (b,)
    fov_degrees: float = 0.1,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(extrinsics, normalized intrinsics, near, far) of the narrow
    perspective frustum that emulates an orthographic camera of the given
    width and height: the camera moves back along its axis until the
    frustum is that wide at the old near plane."""
    tan_fov_x = torch.tan(0.5 * torch.deg2rad(torch.tensor(fov_degrees, dtype=extrinsics.dtype)))
    tan_fov_x = tan_fov_x.to(extrinsics.device)
    distance_to_near = (0.5 * width) / tan_fov_x
    tan_fov_y = 0.5 * height / distance_to_near
    near = near + distance_to_near
    far = far + distance_to_near
    b = extrinsics.shape[0]
    move_back = torch.eye(4, dtype=extrinsics.dtype, device=extrinsics.device).repeat(b, 1, 1)
    move_back[:, 2, 3] = -distance_to_near
    extrinsics = torch.einsum("bij,bjk->bik", extrinsics, move_back)

    intrinsics = torch.zeros((b, 3, 3), dtype=extrinsics.dtype, device=extrinsics.device)
    intrinsics[:, 0, 0] = 1.0 / (2.0 * tan_fov_x)
    intrinsics[:, 1, 1] = 1.0 / (2.0 * tan_fov_y)
    intrinsics[:, 0, 2] = 0.5
    intrinsics[:, 1, 2] = 0.5
    intrinsics[:, 2, 2] = 1.0
    return extrinsics, intrinsics, near, far


def render_orthographic(
    extrinsics: torch.Tensor,  # (b, 4, 4)
    width: torch.Tensor,  # (b,)
    height: torch.Tensor,  # (b,)
    near: torch.Tensor,  # (b,)
    far: torch.Tensor,  # (b,)
    image_shape: tuple[int, int],
    background_color: torch.Tensor,  # (b, c)
    gaussian_means: torch.Tensor,  # (b, g, 3)
    gaussian_covariances: torch.Tensor,  # (b, g, 3, 3)
    gaussian_sh_coefficients: torch.Tensor,  # (b, g, 3, d_sh) or (b, g, c)
    gaussian_opacities: torch.Tensor,  # (b, g)
    fov_degrees: float = 0.1,
    use_sh: bool = True,
    settings: RenderSettings = DEFAULT_SETTINGS,
    return_overflow: bool = False,
):
    """An orthographic view (b, c, h, w): `render` through
    `orthographic_frustum`, without the 1/near rescale. With
    `return_overflow`, also the (b,) dropped (gaussian, tile) pairs."""
    extrinsics, intrinsics, near, far = orthographic_frustum(
        extrinsics, width, height, near, far, fov_degrees
    )
    return render(
        extrinsics,
        intrinsics,
        near,
        far,
        image_shape,
        background_color,
        gaussian_means,
        gaussian_covariances,
        gaussian_sh_coefficients,
        gaussian_opacities,
        scale_invariant=False,
        use_sh=use_sh,
        settings=settings,
        return_overflow=return_overflow,
    )
