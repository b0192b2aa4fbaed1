"""Camera projection math in PyTorch.

Port of `pixelsplat_tpu/geometry/projection.py`, limited to what the
evaluation scene calls. Conventions are the reference's: extrinsics are
OpenCV-style camera-to-world 4x4 matrices, intrinsics are 3x3 and
normalized (row 0 divided by the image width, row 1 by its height).

Every function broadcasts over leading batch dimensions.
"""

from __future__ import annotations

import torch


def homogenize_points(points: torch.Tensor) -> torch.Tensor:
    """(..., d) points -> (..., d + 1) with a trailing 1."""
    return torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)


def homogenize_vectors(vectors: torch.Tensor) -> torch.Tensor:
    """(..., d) vectors -> (..., d + 1) with a trailing 0."""
    return torch.cat([vectors, torch.zeros_like(vectors[..., :1])], dim=-1)


def transform_rigid(homogeneous: torch.Tensor, transformation: torch.Tensor) -> torch.Tensor:
    """(..., d) by (..., d, d), broadcasting the batch dimensions."""
    return (transformation @ homogeneous[..., None])[..., 0]


def transform_cam2world(homogeneous: torch.Tensor, extrinsics: torch.Tensor) -> torch.Tensor:
    return transform_rigid(homogeneous, extrinsics)


def inverse_se3(extrinsics: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a batch of rigid-body 4x4 matrices."""
    r = extrinsics[..., :3, :3]
    t = extrinsics[..., :3, 3]
    r_inv = r.transpose(-1, -2)
    t_inv = -(r_inv @ t[..., None])
    bottom = torch.zeros_like(extrinsics[..., 3:, :])
    bottom[..., 0, 3] = 1.0
    top = torch.cat([r_inv, t_inv], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def inverse_intrinsics(intrinsics: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a batch of upper-triangular 3x3 intrinsics."""
    fx = intrinsics[..., 0, 0]
    fy = intrinsics[..., 1, 1]
    s = intrinsics[..., 0, 1]
    cx = intrinsics[..., 0, 2]
    cy = intrinsics[..., 1, 2]
    zero = torch.zeros_like(fx)
    one = torch.ones_like(fx)
    row0 = torch.stack([1.0 / fx, -s / (fx * fy), (s * cy - cx * fy) / (fx * fy)], dim=-1)
    row1 = torch.stack([zero, 1.0 / fy, -cy / fy], dim=-1)
    row2 = torch.stack([zero, zero, one], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def unproject(coordinates: torch.Tensor, z: torch.Tensor, intrinsics: torch.Tensor) -> torch.Tensor:
    """Unproject normalized 2D camera coordinates at depths `z`."""
    coordinates = homogenize_points(coordinates)
    ray_directions = transform_rigid(coordinates, inverse_intrinsics(intrinsics))
    return ray_directions * z[..., None]


def get_world_rays(
    coordinates: torch.Tensor,  # (*#batch, 2)
    extrinsics: torch.Tensor,  # (*#batch, 4, 4)
    intrinsics: torch.Tensor,  # (*#batch, 3, 3)
) -> tuple[torch.Tensor, torch.Tensor]:
    """World-space rays through normalized image coordinates.

    Returns (origins, unit directions), each (*batch, 3).
    """
    directions = unproject(coordinates, torch.ones_like(coordinates[..., 0]), intrinsics)
    directions = directions / torch.linalg.vector_norm(directions, dim=-1, keepdim=True)
    directions = homogenize_vectors(directions)
    directions = transform_cam2world(directions, extrinsics)[..., :-1]
    origins = extrinsics[..., :-1, -1].expand(directions.shape)
    return origins, directions


def sample_image_grid(
    shape: tuple[int, int],
    device: torch.device | str,
    dtype: torch.dtype = torch.float32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Normalized (0..1) pixel-center coordinates and integer indices.

    Returns (coordinates in xy order, (*shape, 2); indices in ij order,
    (*shape, 2)).
    """
    indices = [torch.arange(length, device=device) for length in shape]
    stacked_indices = torch.stack(torch.meshgrid(*indices, indexing="ij"), dim=-1)
    coordinates = [
        (idx.to(dtype) + 0.5) / length for idx, length in zip(indices, shape)
    ]
    coordinates = list(reversed(coordinates))
    coordinates = torch.stack(torch.meshgrid(*coordinates, indexing="xy"), dim=-1)
    return coordinates, stacked_indices


def get_fov(intrinsics: torch.Tensor) -> torch.Tensor:
    """(..., 2) horizontal and vertical field of view in radians."""
    intrinsics_inv = inverse_intrinsics(intrinsics)

    def process(vector):
        vector = torch.tensor(vector, dtype=intrinsics.dtype, device=intrinsics.device)
        vector = intrinsics_inv @ vector
        return vector / torch.linalg.vector_norm(vector, dim=-1, keepdim=True)

    left = process([0.0, 0.5, 1.0])
    right = process([1.0, 0.5, 1.0])
    top = process([0.5, 0.0, 1.0])
    bottom = process([0.5, 1.0, 1.0])
    fov_x = torch.arccos(torch.clamp((left * right).sum(-1), -1.0, 1.0))
    fov_y = torch.arccos(torch.clamp((top * bottom).sum(-1), -1.0, 1.0))
    return torch.stack((fov_x, fov_y), dim=-1)
