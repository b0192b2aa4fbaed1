"""Camera frustum diagrams: frusta drawn in three axis-aligned projections.

Port of `pixelsplat_tpu/visualization/drawing/cameras.py`: each camera
contributes its frustum's edges (origin to the four corners and the corner
ring, and its near and far rectangles when given), drawn in the XY, ZY and
XZ orthographic projections of one shared, equal-sided bounding box.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...geometry.projection import get_world_rays
from .lines import draw_lines


def unproject_frustum_corners(
    extrinsics: torch.Tensor,  # (b, 4, 4)
    intrinsics: torch.Tensor,  # (b, 3, 3)
    depth: torch.Tensor,  # (b,)
) -> torch.Tensor:
    """World-space frustum corner points at the given depth; (b, 4, 3)."""
    corners = torch.tensor(
        [[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]], dtype=extrinsics.dtype, device=extrinsics.device
    )
    origins, directions = get_world_rays(corners[None], extrinsics[:, None], intrinsics[:, None])  # (b, 4, 3)
    # Scaled so the frustum's face sits at `depth` along the look vector.
    look = extrinsics[:, None, :3, 2]
    scale = depth[:, None] / (directions * look).sum(-1)
    return origins + directions * scale[..., None]


def compute_equal_aabb_with_margin(
    minima: torch.Tensor, maxima: torch.Tensor, margin: float = 0.1
) -> tuple[torch.Tensor, torch.Tensor]:
    """A cube around the box, its side the box's longest side plus `margin`."""
    midpoint = 0.5 * (maxima + minima)
    span = (maxima - minima).amax(dim=-1, keepdim=True) * (1 + margin)
    return midpoint - 0.5 * span, midpoint + 0.5 * span


def draw_cameras(
    resolution: int,
    extrinsics: torch.Tensor,  # (b, 4, 4)
    intrinsics: torch.Tensor,  # (b, 3, 3)
    color: torch.Tensor,  # (b, 3)
    near: Optional[torch.Tensor] = None,  # (b,)
    far: Optional[torch.Tensor] = None,  # (b,)
    margin: float = 0.1,
    frustum_scale: float = 0.05,
) -> torch.Tensor:
    """Returns (3, 3, resolution, resolution): the XY, ZY and XZ projections,
    drawn in the cameras' mean colour."""
    b = extrinsics.shape[0]
    origins = extrinsics[:, :3, 3]
    corner_depth = torch.full((b,), frustum_scale, dtype=extrinsics.dtype, device=extrinsics.device)
    corners = unproject_frustum_corners(extrinsics, intrinsics, corner_depth)

    # The points that define the diagram's bounds, and the frustum's edges:
    # origin -> corner (x4) and the corner ring (x4), then the near and far
    # rectangles.
    points = [origins, corners.reshape(-1, 3)]
    segs_a = [origins.repeat_interleave(4, dim=0), corners.reshape(-1, 3)]
    segs_b = [corners.reshape(-1, 3), torch.roll(corners, 1, dims=1).reshape(-1, 3)]
    for plane in (near, far):
        if plane is not None:
            ring = unproject_frustum_corners(extrinsics, intrinsics, plane)
            points.append(ring.reshape(-1, 3))
            segs_a.append(ring.reshape(-1, 3))
            segs_b.append(torch.roll(ring, 1, dims=1).reshape(-1, 3))
    points = torch.cat(points, dim=0)
    minima, maxima = compute_equal_aabb_with_margin(points.amin(dim=0), points.amax(dim=0), margin)
    span = maxima - minima
    start3d = torch.cat(segs_a, dim=0)
    end3d = torch.cat(segs_b, dim=0)
    mean_color = color.mean(dim=0) if color.ndim == 2 else color

    projections = []
    for dims in ((0, 1), (2, 1), (0, 2)):
        dims = list(dims)

        def to_px(p: torch.Tensor) -> torch.Tensor:
            return (p[:, dims] - minima[dims]) / span[dims] * resolution

        canvas = torch.ones((3, resolution, resolution), dtype=torch.float32, device=extrinsics.device)
        projections.append(draw_lines(canvas, to_px(start3d), to_px(end3d), mean_color, width=2.0, cap="round"))
    return torch.stack(projections)
