"""Epipolar line projection in PyTorch.

Port of `pixelsplat_tpu/geometry/epipolar_lines.py`: for a bundle of
world-space rays and a second camera, the visible segment of each ray's
projection into the second camera's image plane. The case analysis runs
on inf and NaN on purpose (a border the ray never meets divides by zero)
and is resolved by `torch.where` chains with static shapes.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from .projection import (
    get_world_rays,
    homogenize_points,
    homogenize_vectors,
    intersect_rays,
    inverse_se3,
    project_camera_space,
    transform_rigid,
)


class PointProjection(NamedTuple):
    t: torch.Tensor  # ray parameter, xyz = origin + t * direction
    xy: torch.Tensor  # image-space xy (normalized 0..1)
    valid: torch.Tensor  # in front of the camera, inside the frame and t >= 0


class RaySegmentProjection(NamedTuple):
    t_min: torch.Tensor
    t_max: torch.Tensor
    xy_min: torch.Tensor
    xy_max: torch.Tensor
    # Whether the segment overlaps the image at all. If not, the other
    # fields are meaningless.
    overlaps_image: torch.Tensor


def _is_in_bounds(xy: torch.Tensor, epsilon: float = 1e-6) -> torch.Tensor:
    return ((xy >= -epsilon) & (xy <= 1 + epsilon)).all(dim=-1)


def _is_in_front_of_camera(xyz: torch.Tensor, epsilon: float = 1e-6) -> torch.Tensor:
    return xyz[..., -1] > -epsilon


def _is_positive_t(t: torch.Tensor, epsilon: float = 1e-6) -> torch.Tensor:
    return t > -epsilon


def _intersect_image_coordinate(
    intrinsics: torch.Tensor,
    origins: torch.Tensor,
    directions: torch.Tensor,
    dimension: str,
    coordinate_value: float,
) -> PointProjection:
    """Intersect a camera-space ray's projection with one image border line.

    `dimension` selects x (vertical borders) or y (horizontal borders);
    `coordinate_value` is 0.0 or 1.0. Division by zero yields inf or NaN,
    which the validity masks reject.
    """
    dim = "xy".index(dimension)
    other_dim = 1 - dim
    focal_sel = intrinsics[..., dim, dim]
    focal_other = intrinsics[..., other_dim, other_dim]
    center_sel = intrinsics[..., dim, 2]
    center_other = intrinsics[..., other_dim, 2]
    origin_sel = origins[..., dim]
    origin_other = origins[..., other_dim]
    origin_z = origins[..., 2]
    dir_sel = directions[..., dim]
    dir_other = directions[..., other_dim]
    dir_z = directions[..., 2]
    # The border position on the camera plane (before the intrinsics):
    # solving project(o + t d)[dim] == coordinate_value for t.
    border_cam = (coordinate_value - center_sel) / focal_sel

    t = (border_cam * origin_z - origin_sel) / (dir_sel - border_cam * dir_z)

    coordinate_other = center_other + (
        focal_other
        * (
            origin_other * (border_cam * dir_z - dir_sel)
            + dir_other * (origin_sel - border_cam * origin_z)
        )
    ) / (dir_z * origin_sel - dir_sel * origin_z)
    coordinate_same = torch.full_like(coordinate_other, coordinate_value)
    if other_dim == 0:
        xy = torch.stack([coordinate_other, coordinate_same], dim=-1)
    else:
        xy = torch.stack([coordinate_same, coordinate_other], dim=-1)
    xyz = origins + t[..., None] * directions

    valid = _is_in_bounds(xy) & _is_in_front_of_camera(xyz) & _is_positive_t(t)
    valid = valid & torch.isfinite(t)
    return PointProjection(t=t, xy=xy, valid=valid)


def _compare_projections(intersections: list[PointProjection], reduction: str) -> PointProjection:
    """Pick, per ray, the valid border intersection of least or greatest t.

    Where several tie (all four invalid, say), the first wins, as
    `jnp.argmin` / `jnp.argmax` pick it; `torch.argmin` promises no order
    among ties, so the first is chosen explicitly.
    """
    t = torch.stack([i.t for i in intersections], dim=0)
    xy = torch.stack([i.xy for i in intersections], dim=0)
    valid = torch.stack([i.valid for i in intersections], dim=0)

    lowest_priority = {"min": math.inf, "max": -math.inf}[reduction]
    t = torch.where(valid, t, torch.full_like(t, lowest_priority))
    t = torch.nan_to_num(t, nan=lowest_priority, posinf=math.inf, neginf=-math.inf)

    reduced = t.amin(dim=0) if reduction == "min" else t.amax(dim=0)
    n = t.shape[0]
    order = torch.arange(n, device=t.device).reshape(n, *([1] * (t.ndim - 1)))
    selector = torch.where(t == reduced[None], order, n).amin(dim=0)  # first of the ties

    xy_sel = torch.take_along_dim(xy, selector[None, ..., None], dim=0)[0]
    valid_sel = torch.take_along_dim(valid, selector[None], dim=0)[0]
    return PointProjection(t=reduced, xy=xy_sel, valid=valid_sel)


def _compute_point_projection(
    xyz: torch.Tensor, t: torch.Tensor, intrinsics: torch.Tensor
) -> PointProjection:
    xy = project_camera_space(xyz, intrinsics)
    valid = _is_in_bounds(xy) & _is_in_front_of_camera(xyz) & _is_positive_t(t)
    return PointProjection(t=t, xy=xy, valid=valid)


def project_rays(
    origins: torch.Tensor,
    directions: torch.Tensor,
    extrinsics: torch.Tensor,
    intrinsics: torch.Tensor,
    near: Optional[torch.Tensor] = None,
    far: Optional[torch.Tensor] = None,
    epsilon: float = 1e-6,
) -> RaySegmentProjection:
    """Project world-space rays into another camera: the visible segment
    [xy_min, xy_max] of each epipolar line. All inputs broadcast against
    one another over leading batch dimensions."""
    world_to_cam = inverse_se3(extrinsics)
    origins_cam = transform_rigid(homogenize_points(origins), world_to_cam)[..., :3]
    directions_cam = transform_rigid(homogenize_vectors(directions), world_to_cam)[..., :3]

    batch_shape = torch.broadcast_shapes(
        origins_cam.shape[:-1], directions_cam.shape[:-1], intrinsics.shape[:-2]
    )
    origins_cam = origins_cam.expand(*batch_shape, 3)
    directions_cam = directions_cam.expand(*batch_shape, 3)
    intrinsics_b = intrinsics.expand(*batch_shape, 3, 3)
    dtype, device = origins_cam.dtype, origins_cam.device

    frame_intersections = [
        _intersect_image_coordinate(intrinsics_b, origins_cam, directions_cam, "x", 0.0),
        _intersect_image_coordinate(intrinsics_b, origins_cam, directions_cam, "x", 1.0),
        _intersect_image_coordinate(intrinsics_b, origins_cam, directions_cam, "y", 0.0),
        _intersect_image_coordinate(intrinsics_b, origins_cam, directions_cam, "y", 1.0),
    ]
    frame_min = _compare_projections(frame_intersections, "min")
    frame_max = _compare_projections(frame_intersections, "max")

    if near is None:
        # Project the ray at t = 0 (the origin). If the origin sits at the
        # camera itself, use the direction instead; if it merely lies on
        # the zero-depth plane, mark it invalid.
        mask_depth_zero = origins_cam[..., -1] < epsilon
        mask_at_camera = torch.linalg.vector_norm(origins_cam, dim=-1) < epsilon
        origins_for_projection = torch.where(mask_at_camera[..., None], directions_cam, origins_cam)
        projection_at_zero = _compute_point_projection(
            origins_for_projection, torch.zeros(batch_shape, dtype=dtype, device=device), intrinsics_b
        )
        valid0 = projection_at_zero.valid & ~(mask_depth_zero & ~mask_at_camera)
        projection_at_zero = projection_at_zero._replace(valid=valid0)
    else:
        t_near = torch.as_tensor(near, dtype=dtype, device=device).expand(batch_shape)
        projection_at_zero = _compute_point_projection(
            origins_cam + t_near[..., None] * directions_cam, t_near, intrinsics_b
        )

    if far is None:
        # Projecting the direction is projecting the ray's point at infinity.
        projection_at_infinity = _compute_point_projection(
            directions_cam, torch.full(batch_shape, math.inf, dtype=dtype, device=device), intrinsics_b
        )
    else:
        t_far = torch.as_tensor(far, dtype=dtype, device=device).expand(batch_shape)
        projection_at_infinity = _compute_point_projection(
            origins_cam + t_far[..., None] * directions_cam, t_far, intrinsics_b
        )

    # Use an endpoint's projection where it is valid (inside the frame),
    # otherwise the frame-border intersection.
    p0, pinf = projection_at_zero, projection_at_infinity
    t_min = torch.where(p0.valid, p0.t, frame_min.t)
    xy_min = torch.where(p0.valid[..., None], p0.xy, frame_min.xy)
    t_max = torch.where(pinf.valid, pinf.t, frame_max.t)
    xy_max = torch.where(pinf.valid[..., None], pinf.xy, frame_max.xy)
    overlaps = (p0.valid | frame_min.valid) & (pinf.valid | frame_max.valid)

    return RaySegmentProjection(
        t_min=t_min, t_max=t_max, xy_min=xy_min, xy_max=xy_max, overlaps_image=overlaps
    )


def lift_to_3d(
    origins: torch.Tensor,
    directions: torch.Tensor,
    xy: torch.Tensor,
    extrinsics: torch.Tensor,
    intrinsics: torch.Tensor,
) -> torch.Tensor:
    """3D positions of 2D points on epipolar lines; the extrinsics and
    intrinsics belong to the camera the 2D points lie on."""
    xy_origins, xy_directions = get_world_rays(xy, extrinsics, intrinsics)
    return intersect_rays(origins, directions, xy_origins, xy_directions)


def get_depth(
    origins: torch.Tensor,
    directions: torch.Tensor,
    xy: torch.Tensor,
    extrinsics: torch.Tensor,
    intrinsics: torch.Tensor,
) -> torch.Tensor:
    """Depths (distance along the primary ray) of epipolar-line samples."""
    xyz = lift_to_3d(origins, directions, xy, extrinsics, intrinsics)
    return torch.linalg.vector_norm(xyz - origins, dim=-1)
