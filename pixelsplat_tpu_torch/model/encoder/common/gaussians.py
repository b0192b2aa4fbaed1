"""Quaternion -> rotation and world covariance construction.

Port of `pixelsplat_tpu/model/encoder/common/gaussians.py` (xyzw quaternion
order, covariance R S S^T R^T).
"""

from __future__ import annotations

import torch


def _quaternion_matrix_components(quaternions: torch.Tensor, eps: float = 1e-8):
    """The nine rotation-matrix entries of (..., 4) xyzw quaternions."""
    i, j, k, r = quaternions.unbind(-1)
    two_s = 2.0 / ((quaternions * quaternions).sum(-1) + eps)
    return (
        1 - two_s * (j * j + k * k),
        two_s * (i * j - k * r),
        two_s * (i * k + j * r),
        two_s * (i * j + k * r),
        1 - two_s * (i * i + k * k),
        two_s * (j * k - i * r),
        two_s * (i * k - j * r),
        two_s * (j * k + i * r),
        1 - two_s * (i * i + j * j),
    )


def quaternion_to_matrix(quaternions: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """(..., 4) xyzw quaternions -> (..., 3, 3) rotation matrices."""
    o = torch.stack(_quaternion_matrix_components(quaternions, eps), dim=-1)
    return o.reshape(*o.shape[:-1], 3, 3)


def build_world_covariance(
    scale: torch.Tensor,  # (..., 3)
    rotation_xyzw: torch.Tensor,  # (..., 4)
    c2w_rotation: torch.Tensor,  # (*#batch, 3, 3), broadcastable to (...)
) -> torch.Tensor:
    """World-space covariance (W R) diag(s)^2 (W R)^T, entry by entry.

    Every intermediate is a broadcastable plain array; only the final
    (..., 3, 3) output is assembled.
    """
    rc = _quaternion_matrix_components(rotation_xyzw)
    w = [[c2w_rotation[..., a, b] for b in range(3)] for a in range(3)]
    m = [
        [w[a][0] * rc[0 + b] + w[a][1] * rc[3 + b] + w[a][2] * rc[6 + b] for b in range(3)]
        for a in range(3)
    ]
    s2 = [scale[..., c] ** 2 for c in range(3)]

    def cov(a, b):
        return m[a][0] * (s2[0] * m[b][0]) + m[a][1] * (s2[1] * m[b][1]) + m[a][2] * (
            s2[2] * m[b][2]
        )

    c00, c01, c02 = cov(0, 0), cov(0, 1), cov(0, 2)
    c11, c12, c22 = cov(1, 1), cov(1, 2), cov(2, 2)
    rows = torch.stack([c00, c01, c02, c01, c11, c12, c02, c12, c22], dim=-1)
    return rows.reshape(*rows.shape[:-1], 3, 3)
