"""Camera projection math in PyTorch.

Port of `pixelsplat_tpu/geometry/projection.py` (all but
`sample_training_rays`). Conventions are the reference's: extrinsics are
OpenCV-style camera-to-world 4x4 matrices, intrinsics are 3x3 and
normalized (row 0 divided by the image width, row 1 by its height).

Every function broadcasts over leading batch dimensions.
"""

from __future__ import annotations

import torch

_F32_EPS = float(torch.finfo(torch.float32).eps)


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


def transform_world2cam(homogeneous: torch.Tensor, extrinsics: torch.Tensor) -> torch.Tensor:
    return transform_rigid(homogeneous, inverse_se3(extrinsics))


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


def project_camera_space(
    points: torch.Tensor,
    intrinsics: torch.Tensor,
    epsilon: float = _F32_EPS,
    infinity: float = 1e8,
) -> torch.Tensor:
    """Perspective-divide camera-space points and apply the intrinsics."""
    points = points / (points[..., -1:] + epsilon)
    points = torch.nan_to_num(points, nan=0.0, posinf=infinity, neginf=-infinity)
    return transform_rigid(points, intrinsics)[..., :-1]


def project(
    points: torch.Tensor,
    extrinsics: torch.Tensor,
    intrinsics: torch.Tensor,
    epsilon: float = _F32_EPS,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Project world points into a camera: (xy in [0, 1]^2, in-front mask)."""
    points = homogenize_points(points)
    points = transform_world2cam(points, extrinsics)[..., :-1]
    in_front_of_camera = points[..., -1] >= 0
    return project_camera_space(points, intrinsics, epsilon=epsilon), in_front_of_camera


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


def intersect_rays(
    origins_x: torch.Tensor,
    directions_x: torch.Tensor,
    origins_y: torch.Tensor,
    directions_y: torch.Tensor,
    eps: float = 1e-5,
    inf: float = 1e10,
) -> torch.Tensor:
    """Least-squares intersection point of two ray bundles.

    Solves sum_i (n_i n_i^T - I) p = sum_i (n_i n_i^T - I) o_i. Parallel
    pairs get all-`inf` results, through a mask so shapes stay static.
    """
    origins_x, directions_x, origins_y, directions_y = torch.broadcast_tensors(
        origins_x, directions_x, origins_y, directions_y
    )
    parallel = (directions_x * directions_y).sum(-1) > 1 - eps

    eye = torch.eye(3, dtype=origins_x.dtype, device=origins_x.device)
    n_x = directions_x[..., :, None] * directions_x[..., None, :] - eye
    n_y = directions_y[..., :, None] * directions_y[..., None, :] - eye
    lhs = n_x + n_y
    rhs = transform_rigid(origins_x, n_x) + transform_rigid(origins_y, n_y)

    # Regularize so near-singular systems stay finite; those entries are
    # overwritten by the parallel mask anyway.
    lhs = lhs + parallel.to(lhs.dtype)[..., None, None] * eye
    result = _solve3x3(lhs, rhs)
    return torch.where(parallel[..., None], torch.full_like(result, inf), result)


def _solve3x3(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """Closed-form 3x3 solve by the adjugate (Cramer's rule)."""
    a00, a01, a02 = a[..., 0, 0], a[..., 0, 1], a[..., 0, 2]
    a10, a11, a12 = a[..., 1, 0], a[..., 1, 1], a[..., 1, 2]
    a20, a21, a22 = a[..., 2, 0], a[..., 2, 1], a[..., 2, 2]

    c00 = a11 * a22 - a12 * a21
    c01 = a12 * a20 - a10 * a22
    c02 = a10 * a21 - a11 * a20
    det = a00 * c00 + a01 * c01 + a02 * c02
    inv_det = 1.0 / torch.where(det.abs() < eps, torch.full_like(det, eps), det)

    c10 = a02 * a21 - a01 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a01 * a20 - a00 * a21
    c20 = a01 * a12 - a02 * a11
    c21 = a02 * a10 - a00 * a12
    c22 = a00 * a11 - a01 * a10

    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    x0 = (c00 * b0 + c10 * b1 + c20 * b2) * inv_det
    x1 = (c01 * b0 + c11 * b1 + c21 * b2) * inv_det
    x2 = (c02 * b0 + c12 * b1 + c22 * b2) * inv_det
    return torch.stack([x0, x1, x2], dim=-1)


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
