"""Validation-time 3D views: orthographic Gaussian projections and cameras.

Port of `pixelsplat_tpu/visualization/validation_in_3d.py`.
`render_projections` renders the Gaussians from three orthographic cameras
outside the scene (looking along +z, +x and +y) through the rasterizer:
one forward compositing launch per batch element and view.
`render_cameras` draws the batch's camera frusta with the line primitives.

The JAX package renders the projections at fixed settings
(`PROJECTION_SETTINGS`) and drops whatever (gaussian, tile) pairs they
cannot hold. The port keeps those settings where a bounding-box pre-pass
shows they hold each view's lists, and otherwise grows the lists to what
the view needs (`ops/rasterizer/adaptive.py::sufficient_settings`), so no
pair is dropped. It returns the pairs it dropped (zero) and the settings
it used.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..model.types import Gaussians
from ..ops.rasterizer.adaptive import sufficient_settings
from ..ops.rasterizer.render import RenderSettings, orthographic_frustum, render_orthographic
from .drawing.cameras import compute_equal_aabb_with_margin, draw_cameras

# The JAX package's settings for the projections.
PROJECTION_SETTINGS = RenderSettings(capacity=2048, big_capacity=128)

# The three views: the camera-to-world rotation and the world axis along
# which the camera looks (and is moved back), for XY, ZY and XZ.
_VIEWS = (
    (((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0)), 2),
    (((0.0, 0.0, -1.0), (0.0, 1.0, 0.0), (1.0, 0.0, 0.0)), 0),
    (((1.0, 0.0, 0.0), (0.0, 0.0, -1.0), (0.0, 1.0, 0.0)), 1),
)


class OrthographicCamera(NamedTuple):
    """One projection's camera for each batch element."""

    extrinsics: torch.Tensor  # (b, 4, 4) camera-to-world
    width: torch.Tensor  # (b,) the square view's side in world units
    near: torch.Tensor  # (b,)
    far: torch.Tensor  # (b,)


class Projections(NamedTuple):
    images: torch.Tensor  # (b, 3, 3, resolution, resolution): XY, ZY, XZ
    overflow: torch.Tensor  # (b, 3) int32 pairs dropped
    settings: tuple[RenderSettings, RenderSettings, RenderSettings]


def projection_cameras(means: torch.Tensor, margin: float = 0.1) -> list[OrthographicCamera]:
    """The three orthographic cameras of the scenes `means` (b, g, 3): each
    outside its scene's equal-sided bounding box, looking at its centre."""
    b = means.shape[0]
    minima, maxima = compute_equal_aabb_with_margin(means.amin(dim=1), means.amax(dim=1), margin)
    span = (maxima - minima).amax(dim=-1)  # (b,)
    center = 0.5 * (minima + maxima)
    # The bounding box already carries the margin; the JAX package adds it
    # to the view's width once more.
    width = span * (1 + margin)
    cameras = []
    for rotation, look_axis in _VIEWS:
        extrinsics = torch.eye(4, dtype=means.dtype, device=means.device).repeat(b, 1, 1)
        extrinsics[:, :3, :3] = torch.tensor(rotation, dtype=means.dtype, device=means.device)
        offset = torch.zeros_like(center)
        offset[:, look_axis] = -span
        extrinsics[:, :3, 3] = center + offset
        cameras.append(OrthographicCamera(extrinsics, width, torch.zeros_like(span), 2.0 * span))
    return cameras


def render_projections(
    gaussians: Gaussians,
    resolution: int,
    margin: float = 0.1,
    settings: RenderSettings = PROJECTION_SETTINGS,
) -> Projections:
    """The XY / ZY / XZ orthographic views of each batch element's
    Gaussians, at `settings` where they hold the view's lists and at lists
    grown to fit otherwise."""
    b = gaussians.means.shape[0]
    background = gaussians.means.new_zeros((b, 3))
    images, overflows, chosen = [], [], []
    for camera in projection_cameras(gaussians.means, margin):
        extrinsics, intrinsics, near, _ = orthographic_frustum(
            camera.extrinsics, camera.width, camera.width, camera.near, camera.far
        )
        fitted = sufficient_settings(
            extrinsics, intrinsics, near, gaussians.means, gaussians.covariances, gaussians.opacities,
            (resolution, resolution), settings=settings, scale_invariant=False,
        )
        image, overflow = render_orthographic(
            camera.extrinsics, camera.width, camera.width, camera.near, camera.far, (resolution, resolution),
            background, gaussians.means, gaussians.covariances, gaussians.harmonics, gaussians.opacities,
            settings=fitted, return_overflow=True,
        )
        images.append(image)
        overflows.append(overflow)
        chosen.append(fitted)
    return Projections(torch.stack(images, dim=1), torch.stack(overflows, dim=1), tuple(chosen))


def render_cameras(batch: dict, resolution: int) -> torch.Tensor:
    """The context (blue) and target (red) frusta of the first batch
    element, drawn in their mean colour: (3, 3, resolution, resolution)."""
    context = batch["context"]
    target = batch["target"]
    cv = context["extrinsics"].shape[1]
    tv = target["extrinsics"].shape[1]
    extrinsics = torch.cat([context["extrinsics"][0], target["extrinsics"][0]], dim=0)
    intrinsics = torch.cat([context["intrinsics"][0], target["intrinsics"][0]], dim=0)
    device = extrinsics.device
    color = torch.cat(
        [
            torch.tensor([0.2, 0.6, 1.0], device=device).expand(cv, 3),
            torch.tensor([1.0, 0.3, 0.2], device=device).expand(tv, 3),
        ],
        dim=0,
    )
    near = torch.cat([context["near"][0], target["near"][0]])
    far = torch.cat([context["far"][0], target["far"][0]])
    return draw_cameras(resolution, extrinsics, intrinsics, color, near, far)
