"""Extrinsic interpolation about the cameras' focus point (host-side numpy).

The port's own copy of
`pixelsplat_tpu/visualization/camera_trajectory/interpolation.py`: extrinsics
are converted to a 5-DoF "pivot parametrization" (3 translation offsets
from the pivot point in a look-adapted frame + in-plane angle + twist),
interpolated (angles circularly), and converted back. The pivot is the
least-squares intersection of the two look rays (midpoint if parallel).
Computed in float64.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial.transform import Rotation as R


def _normalize(a: np.ndarray) -> np.ndarray:
    return a / np.linalg.norm(a, axis=-1, keepdims=True)


def intersect_rays(
    a_origins: np.ndarray,
    a_directions: np.ndarray,
    b_origins: np.ndarray,
    b_directions: np.ndarray,
) -> np.ndarray:
    """Least-squares intersection of two ray bundles."""
    a_origins, a_directions, b_origins, b_directions = np.broadcast_arrays(
        a_origins, a_directions, b_origins, b_directions
    )
    origins = np.stack((a_origins, b_origins), axis=-2)
    directions = np.stack((a_directions, b_directions), axis=-2)
    n = directions[..., :, None] * directions[..., None, :]
    n = n - np.eye(3, dtype=origins.dtype)
    lhs = n.sum(axis=-3)
    rhs = np.einsum("...nij,...nj->...ni", n, origins).sum(axis=-2)
    return np.linalg.lstsq(lhs, rhs[..., None], rcond=None)[0][..., 0]


def generate_coordinate_frame(y: np.ndarray, z: np.ndarray) -> np.ndarray:
    """Frame with the given perpendicular unit Y and Z; X = Y x Z."""
    y, z = np.broadcast_arrays(y, z)
    return np.stack([np.cross(y, z), y, z], axis=-1)


def generate_rotation_coordinate_frame(
    a: np.ndarray, b: np.ndarray, eps: float = 1e-4
) -> np.ndarray:
    """Frame whose Y is normal to the plane of unit vectors a and b."""
    b = np.array(b, copy=True)
    parallel = np.abs(np.abs((a * b).sum(-1)) - 1) < eps
    b[parallel] = np.asarray([0.0, 0.0, 1.0], b.dtype)
    parallel = np.abs(np.abs((a * b).sum(-1)) - 1) < eps
    b[parallel] = np.asarray([0.0, 1.0, 0.0], b.dtype)
    return generate_coordinate_frame(_normalize(np.cross(a, b)), a)


def _matrix_to_euler(rotations: np.ndarray, pattern: str) -> np.ndarray:
    batch = rotations.shape[:-2]
    angles = R.from_matrix(rotations.reshape(-1, 3, 3)).as_euler(pattern)
    return angles.reshape(*batch, 3)


def _euler_to_matrix(angles: np.ndarray, pattern: str) -> np.ndarray:
    batch = angles.shape[:-1]
    m = R.from_euler(pattern, angles.reshape(-1, 3)).as_matrix()
    return m.reshape(*batch, 3, 3)


def extrinsics_to_pivot_parameters(
    extrinsics: np.ndarray,
    pivot_coordinate_frame: np.ndarray,
    pivot_point: np.ndarray,
) -> np.ndarray:
    """5 DoF: offsets from the pivot in a look-adapted frame + (angle, twist)."""
    pivot_axis = pivot_coordinate_frame[..., :, 1]
    translation_frame = generate_coordinate_frame(pivot_axis, extrinsics[..., :3, 2])
    origin = extrinsics[..., :3, 3]
    delta = pivot_point - origin
    translation = np.einsum("...ij,...i->...j", translation_frame, delta)

    inverted = np.swapaxes(pivot_coordinate_frame, -1, -2) @ extrinsics[..., :3, :3]
    euler = _matrix_to_euler(inverted, "YXZ")
    y, z = euler[..., 0], euler[..., 2]
    return np.concatenate([translation, y[..., None], z[..., None]], axis=-1)


def pivot_parameters_to_extrinsics(
    parameters: np.ndarray,
    pivot_coordinate_frame: np.ndarray,
    pivot_point: np.ndarray,
) -> np.ndarray:
    translation = parameters[..., :3]
    y = parameters[..., 3:4]
    z = parameters[..., 4:5]
    euler = np.concatenate((y, np.zeros_like(y), z), axis=-1)
    rotation = pivot_coordinate_frame @ _euler_to_matrix(euler, "YXZ")

    pivot_axis = pivot_coordinate_frame[..., :, 1]
    translation_frame = generate_coordinate_frame(pivot_axis, rotation[..., :3, 2])
    delta = np.einsum("...ij,...j->...i", translation_frame, translation)
    origin = pivot_point - delta

    batch = origin.shape[:-1]
    extrinsics = np.broadcast_to(np.eye(4, dtype=parameters.dtype), (*batch, 4, 4)).copy()
    extrinsics[..., :3, :3] = rotation
    extrinsics[..., :3, 3] = origin
    return extrinsics


def interpolate_circular(a: np.ndarray, b: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Lerp of angles along the shorter arc."""
    a, b, t = np.broadcast_arrays(a, b, t)
    tau = 2 * np.pi
    a = a % tau
    b = b % tau
    d = np.abs(b - a)
    a_left = a - tau
    d_left = np.abs(b - a_left)
    a_right = a + tau
    d_right = np.abs(b - a_right)
    use_d = (d < d_left) & (d < d_right)
    use_left = (d_left < d_right) & ~use_d
    result = np.where(
        use_d,
        a + (b - a) * t,
        np.where(use_left, a_left + (b - a_left) * t, a_right + (b - a_right) * t),
    )
    return result


def interpolate_pivot_parameters(
    initial: np.ndarray, final: np.ndarray, t: np.ndarray
) -> np.ndarray:
    initial = initial[..., None, :]
    final = final[..., None, :]
    t = np.asarray(t)[:, None]
    ti, ri = initial[..., :3], initial[..., 3:]
    tf, rf = final[..., :3], final[..., 3:]
    t_lerp = ti + (tf - ti) * t
    r_lerp = interpolate_circular(ri, rf, t)
    return np.concatenate((t_lerp, r_lerp), axis=-1)


def interpolate_intrinsics(
    initial: np.ndarray, final: np.ndarray, t: np.ndarray
) -> np.ndarray:
    initial = np.asarray(initial)[..., None, :, :]
    final = np.asarray(final)[..., None, :, :]
    t = np.asarray(t)[:, None, None]
    return initial + (final - initial) * t


def interpolate_extrinsics(
    initial: np.ndarray,  # (*batch, 4, 4)
    final: np.ndarray,  # (*batch, 4, 4)
    t: np.ndarray,  # (time,)
    eps: float = 1e-4,
) -> np.ndarray:
    """Rotate cameras about the focus point of their look rays."""
    initial = np.asarray(initial, np.float64)
    final = np.asarray(final, np.float64)
    t = np.asarray(t, np.float64)

    initial_look = initial[..., :3, 2]
    final_look = final[..., :3, 2]
    dots = (initial_look * final_look).sum(-1)
    parallel = np.abs(np.abs(dots) - 1) < eps

    initial_origin = initial[..., :3, 3]
    final_origin = final[..., :3, 3]
    pivot_point = 0.5 * (initial_origin + final_origin)
    if np.any(~parallel):
        pivot_point = np.where(
            parallel[..., None],
            pivot_point,
            intersect_rays(initial_origin, initial_look, final_origin, final_look),
        )

    pivot_frame = generate_rotation_coordinate_frame(initial_look, final_look, eps=eps)
    initial_params = extrinsics_to_pivot_parameters(initial, pivot_frame, pivot_point)
    final_params = extrinsics_to_pivot_parameters(final, pivot_frame, pivot_point)
    interpolated = interpolate_pivot_parameters(initial_params, final_params, t)
    return pivot_parameters_to_extrinsics(
        interpolated.astype(np.float32),
        pivot_frame[..., None, :, :].astype(np.float32),
        pivot_point[..., None, :].astype(np.float32),
    ).astype(np.float32)
