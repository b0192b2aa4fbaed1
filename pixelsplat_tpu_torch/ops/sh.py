"""Real spherical harmonics: evaluation and rotation, in PyTorch.

Port of `pixelsplat_tpu/ops/sh.py`. The basis convention is the 3DGS
rasterizer's (per degree l the coefficients run m = -l..l, and odd |m|
terms carry a flipped sign against the standard real SH tables).

A degree-l rotation matrix is M_l(R) = B_l(R D) @ pinv(B_l(D)) for a
fixed, well-spread direction set D, whose pseudo-inverse is a float64
numpy constant computed exactly as the JAX package computes it. Every
contraction here runs in float32; callers that compare against the JAX
package turn TF32 off (a low-precision pass puts ~1e-2 error into the
rotation matrices).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

MAX_DEGREE = 4


def sh_basis_components(x, y, z, degree: int) -> list:
    """Real SH basis values, one array per coefficient.

    Works on torch tensors and on numpy arrays alike (the pseudo-inverse
    constant below is built from float64 numpy directions).
    """
    one = torch.ones_like(x) if isinstance(x, torch.Tensor) else np.ones_like(x)
    out = [0.28209479177387814 * one]
    if degree >= 1:
        out += [
            -0.4886025119029199 * y,
            0.4886025119029199 * z,
            -0.4886025119029199 * x,
        ]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [
            1.0925484305920792 * xy,
            -1.0925484305920792 * yz,
            0.31539156525252005 * (2.0 * zz - xx - yy),
            -1.0925484305920792 * xz,
            0.5462742152960396 * (xx - yy),
        ]
    if degree >= 3:
        out += [
            -0.5900435899266435 * y * (3.0 * xx - yy),
            2.890611442640554 * xy * z,
            -0.4570457994644658 * y * (4.0 * zz - xx - yy),
            0.3731763325901154 * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            -0.4570457994644658 * x * (4.0 * zz - xx - yy),
            1.445305721320277 * z * (xx - yy),
            -0.5900435899266435 * x * (xx - 3.0 * yy),
        ]
    if degree >= 4:
        out += [
            2.5033429417967046 * xy * (xx - yy),
            -1.7701307697799304 * yz * (3.0 * xx - yy),
            0.9461746957575601 * xy * (7.0 * zz - 1.0),
            -0.6690465435572892 * yz * (7.0 * zz - 3.0),
            0.10578554691520431 * (35.0 * zz * zz - 30.0 * zz + 3.0),
            -0.6690465435572892 * xz * (7.0 * zz - 3.0),
            0.47308734787878004 * (xx - yy) * (7.0 * zz - 1.0),
            -1.7701307697799304 * xz * (xx - 3.0 * yy),
            0.6258357354491761 * (xx * xx - 6.0 * xx * yy + yy * yy),
        ]
    return out


@lru_cache(maxsize=None)
def _fixed_directions_and_pinv(degree: int) -> tuple[np.ndarray, np.ndarray]:
    """Fibonacci-sphere directions D (N = 2(2l+1)) and pinv(B_l(D)), float64."""
    n_coef = 2 * degree + 1
    n_dirs = 2 * n_coef
    i = np.arange(n_dirs, dtype=np.float64) + 0.5
    phi = np.arccos(1 - 2 * i / n_dirs)
    golden = np.pi * (1 + 5**0.5)
    theta = golden * i
    dirs = np.stack(
        [np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta), np.cos(phi)],
        axis=-1,
    )
    basis_full = np.stack(
        sh_basis_components(dirs[:, 0], dirs[:, 1], dirs[:, 2], degree), axis=-1
    )
    b_l = basis_full[:, degree**2 : (degree + 1) ** 2]  # (N, 2l+1)
    return dirs, np.linalg.pinv(b_l)  # pinv: (2l+1, N)


def sh_rotation_matrix(rotations: torch.Tensor, degree: int) -> torch.Tensor:
    """(..., 3, 3) rotations -> (..., 2l+1, 2l+1) degree-l SH rotations.

    Satisfies basis_l(R d) == M_l(R) @ basis_l(d) for unit d.
    """
    if degree == 0:
        return torch.ones(
            (*rotations.shape[:-2], 1, 1), dtype=rotations.dtype, device=rotations.device
        )
    dirs, pinv = _fixed_directions_and_pinv(degree)
    dirs = torch.as_tensor(dirs, dtype=rotations.dtype, device=rotations.device)
    pinv = torch.as_tensor(pinv, dtype=rotations.dtype, device=rotations.device)
    rotated = dirs @ rotations.transpose(-1, -2)  # (..., N, 3)
    basis_rot = torch.stack(
        sh_basis_components(rotated[..., 0], rotated[..., 1], rotated[..., 2], degree)[
            degree**2 :
        ],
        dim=-1,
    )  # (..., N, 2l+1)
    return basis_rot.transpose(-1, -2) @ pinv.T  # (..., 2l+1, 2l+1)


def full_sh_rotation_matrix(rotations: torch.Tensor, degree: int) -> torch.Tensor:
    """Block-diagonal rotation over degrees 0..degree: (..., n, n)."""
    n = (degree + 1) ** 2
    m = torch.zeros(
        (*rotations.shape[:-2], n, n), dtype=rotations.dtype, device=rotations.device
    )
    for l in range(degree + 1):
        m[..., l**2 : (l + 1) ** 2, l**2 : (l + 1) ** 2] = sh_rotation_matrix(rotations, l)
    return m


def apply_sh_rotation(sh_coefficients: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """out[..., i] = sum_j m[..., i, j] * sh[..., j], broadcasting batch dims.

    The trailing batch axes over which `m` is broadcast (one rotation per
    camera, shared by every ray, sample and channel) fold into the row
    dimension of one batched (rows, n) @ (n, n)^T product, so neither
    operand is ever expanded to the full batch.
    """
    n = sh_coefficients.shape[-1]
    rank = max(m.ndim - 2, sh_coefficients.ndim - 1)
    rb = (1,) * (rank - (m.ndim - 2)) + tuple(m.shape[:-2])
    sb = (1,) * (rank - (sh_coefficients.ndim - 1)) + tuple(sh_coefficients.shape[:-1])
    k = rank
    while k > 0 and rb[k - 1] == 1:
        k -= 1
    lead = tuple(max(a, b) for a, b in zip(rb[:k], sb[:k]))
    tail = sb[k:]
    rows = int(np.prod(tail, dtype=np.int64)) if tail else 1
    m = m.reshape(rb[:k] + (n, n)).expand(lead + (n, n))
    sh = sh_coefficients.reshape(sb + (n,)).expand(lead + tail + (n,))
    out = sh.reshape(lead + (rows, n)) @ m.transpose(-1, -2)
    return out.reshape(lead + tail + (n,))
