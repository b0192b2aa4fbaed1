"""Gaussian projection: 3D world Gaussians -> screen-space splats.

Port of `pixelsplat_tpu/ops/rasterizer/projection.py`: EWA splatting of
each 3x3 covariance to a 2D conic (with the 0.3 low-pass dilation), the
near-plane and screen-bounds culls, the opacity-aware per-axis radius and
SH colour (+0.5, clamped at 0), as in the 3DGS CUDA rasterizer's
preprocess stage. Every per-Gaussian output is a plain (g,) vector
(colours (channels, g)), which is the layout binning and the compositing
table read.

On CUDA tensors that need no gradient the projection kernel runs
(`project_bin_kernel.project`, `csrc/project_bin.cu`): one launch a view,
with the camera's inverse and field of view computed on the device, so no
host sync. `project_gaussians_soa_plain` is its plain version, which CPU
tensors and the autograd path (training's renders) take.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ...geometry.projection import get_fov, inverse_se3
from ...utils import tracing
from ..sh import sh_basis_components
from . import project_bin_kernel


class GaussiansSoA(NamedTuple):
    """Scene Gaussians in structure-of-arrays form (g minor everywhere)."""

    mean_x: torch.Tensor  # (g,) world x
    mean_y: torch.Tensor  # (g,)
    mean_z: torch.Tensor  # (g,)
    cov: torch.Tensor  # (6, g) rows s00, s01, s02, s11, s12, s22
    opacity: torch.Tensor  # (g,)
    # Either dense (ch, d_sh, g), or sample-shared (ch, d_sh, V, 1, R) with
    # g = V * S * R in (V, S, R) order: the size-1 axis broadcasts over the
    # S depth samples that share one coefficient set per pixel.
    harmonics: Optional[torch.Tensor] = None
    colors: Optional[torch.Tensor] = None  # (ch, g)


def pack_gaussians_soa(
    means: torch.Tensor,  # (g, 3)
    covariances: torch.Tensor,  # (g, 3, 3)
    opacities: torch.Tensor,  # (g,)
    harmonics: Optional[torch.Tensor] = None,  # (g, 3, d_sh)
    colors_precomp: Optional[torch.Tensor] = None,  # (g, c)
) -> GaussiansSoA:
    """One relayout pass from the public AoS layout to SoA."""
    if (harmonics is None) == (colors_precomp is None):
        raise ValueError("Provide exactly one of harmonics / colors_precomp.")
    g = means.shape[0]
    means_t = means.T
    cov_t = covariances.reshape(g, 9).T
    cov6 = torch.stack([cov_t[0], cov_t[1], cov_t[2], cov_t[4], cov_t[5], cov_t[8]])
    return GaussiansSoA(
        mean_x=means_t[0],
        mean_y=means_t[1],
        mean_z=means_t[2],
        cov=cov6,
        opacity=opacities,
        harmonics=None if harmonics is None else harmonics.permute(1, 2, 0),
        colors=None if colors_precomp is None else colors_precomp.T,
    )


class ProjectedGaussians(NamedTuple):
    mean_x: torch.Tensor  # (g,) pixel x (pixel centres at integers)
    mean_y: torch.Tensor  # (g,) pixel y
    conic_a: torch.Tensor  # (g,) inverse 2D covariance, upper triangle
    conic_b: torch.Tensor  # (g,)
    conic_c: torch.Tensor  # (g,)
    depth: torch.Tensor  # (g,) camera-space z
    # Per-axis half-extents (pixels) of the region where alpha can reach
    # MIN_ALPHA: sqrt(t * cov2d_diag) with t = 2 ln(255 * opacity).
    radius_x: torch.Tensor  # (g,)
    radius_y: torch.Tensor  # (g,)
    color: torch.Tensor  # (channels, g)
    opacity: torch.Tensor  # (g,)
    valid: torch.Tensor  # (g,) bool


# The reference rasterizer culls Gaussians closer than this camera-space
# depth; the 1/near rescale in render_view_soa keeps real geometry clear.
NEAR_CLIP = 0.2

# Low-pass dilation added to the 2D covariance diagonal.
COV2D_DILATION = 0.3

MIN_ALPHA = 1.0 / 255.0


def project_gaussians(
    extrinsics: torch.Tensor,  # (4, 4) camera-to-world
    intrinsics: torch.Tensor,  # (3, 3) normalized
    image_shape: tuple[int, int],
    means: torch.Tensor,  # (g, 3)
    covariances: torch.Tensor,  # (g, 3, 3)
    opacities: torch.Tensor,  # (g,)
    harmonics: Optional[torch.Tensor] = None,  # (g, 3, d_sh)
    colors_precomp: Optional[torch.Tensor] = None,  # (g, c)
) -> ProjectedGaussians:
    """Project one view's AoS Gaussians (packs them to SoA first)."""
    soa = pack_gaussians_soa(means, covariances, opacities, harmonics, colors_precomp)
    return project_gaussians_soa(extrinsics, intrinsics, image_shape, soa)


def soa_planes(soa: GaussiansSoA) -> tuple:
    """The ten per-Gaussian planes the projection reads: mean x, y, z, the
    covariance's s00, s01, s02, s11, s12, s22, and opacity."""
    return (soa.mean_x, soa.mean_y, soa.mean_z, *soa.cov, soa.opacity)


def aos_planes(means: torch.Tensor, covariances: torch.Tensor, opacities: torch.Tensor) -> tuple:
    """`soa_planes` of (..., g, 3) means, (..., g, 3, 3) covariances and
    (..., g) opacities, as views (no copies)."""
    c = covariances
    return (means[..., 0], means[..., 1], means[..., 2], c[..., 0, 0], c[..., 0, 1], c[..., 0, 2],
            c[..., 1, 1], c[..., 1, 2], c[..., 2, 2], opacities)


def project_gaussians_soa(
    extrinsics: torch.Tensor,  # (4, 4) camera-to-world
    intrinsics: torch.Tensor,  # (3, 3) normalized
    image_shape: tuple[int, int],
    soa: GaussiansSoA,
    near: Optional[torch.Tensor] = None,  # ()
) -> ProjectedGaussians:
    """Project one view's SoA Gaussians, the world first rescaled by 1 /
    near where `near` is given (the render's scale invariance): the kernel
    on CUDA tensors that need no gradient, else the plain version."""
    colour = soa.harmonics if soa.harmonics is not None else soa.colors
    if project_bin_kernel.takes(*soa_planes(soa), colour, extrinsics, intrinsics, near):
        if soa.colors is not None and soa.colors.shape[0] > project_bin_kernel.MAX_COLOURS:
            raise ValueError(f"at most {project_bin_kernel.MAX_COLOURS} colour channels, got {soa.colors.shape[0]}")
        rows, valid = project_bin_kernel.project(
            extrinsics, intrinsics, near, soa_planes(soa), image_shape, harmonics=soa.harmonics
        )
        rows = rows[:, 0]
        return ProjectedGaussians(
            *rows[:8],
            color=rows[8:] if soa.harmonics is not None else soa.colors.to(torch.float32),
            opacity=soa.opacity,
            valid=valid[0],
        )
    if near is not None:
        extrinsics, soa = rescaled(extrinsics, soa, near)
    return project_gaussians_soa_plain(extrinsics, intrinsics, image_shape, soa)


def rescaled(extrinsics: torch.Tensor, soa: GaussiansSoA, near: torch.Tensor) -> tuple[torch.Tensor, GaussiansSoA]:
    """The camera and the scene with the world scaled by 1 / near."""
    scale = 1.0 / near
    extrinsics = extrinsics.clone()
    extrinsics[:3, 3] = extrinsics[:3, 3] * scale
    return extrinsics, soa._replace(
        mean_x=soa.mean_x * scale,
        mean_y=soa.mean_y * scale,
        mean_z=soa.mean_z * scale,
        cov=soa.cov * scale**2,
    )


def project_gaussians_soa_plain(
    extrinsics: torch.Tensor,  # (4, 4) camera-to-world
    intrinsics: torch.Tensor,  # (3, 3) normalized
    image_shape: tuple[int, int],
    soa: GaussiansSoA,
) -> ProjectedGaussians:
    """The projection in plain PyTorch, differentiable."""
    h, w = image_shape
    dtype = soa.mean_x.dtype

    # On a CUDA tensor the write of the inverse's constant row waits for the device.
    with tracing.sync_point("upload.inverse_se3"):
        w2c = inverse_se3(extrinsics)
    rot = w2c[:3, :3]
    cam_pos = extrinsics[:3, 3]

    mx, my, mz = soa.mean_x, soa.mean_y, soa.mean_z
    opacities = soa.opacity

    tx = rot[0, 0] * mx + rot[0, 1] * my + rot[0, 2] * mz + w2c[0, 3]
    ty = rot[1, 0] * mx + rot[1, 1] * my + rot[1, 2] * mz + w2c[1, 3]
    tz = rot[2, 0] * mx + rot[2, 1] * my + rot[2, 2] * mz + w2c[2, 3]
    depth = tz

    fx = intrinsics[0, 0] * w
    fy = intrinsics[1, 1] * h
    cx = intrinsics[0, 2] * w
    cy = intrinsics[1, 2] * h

    fov = get_fov(intrinsics[None])[0]
    tan_fov_x = torch.tan(0.5 * fov[0])
    tan_fov_y = torch.tan(0.5 * fov[1])

    safe_tz = torch.where(tz.abs() < 1e-6, torch.full_like(tz, 1e-6), tz)
    inv_z = 1.0 / safe_tz
    mean_x = fx * tx * inv_z + cx - 0.5
    mean_y = fy * ty * inv_z + cy - 0.5

    # EWA: J W Sigma W^T J^T, with the frustum clamp the CUDA kernel
    # applies to the Jacobian's input point, expanded over the 6 unique
    # Sigma entries.
    lim_x = 1.3 * tan_fov_x
    lim_y = 1.3 * tan_fov_y
    txz = torch.clamp(tx * inv_z, -lim_x, lim_x) * tz
    tyz = torch.clamp(ty * inv_z, -lim_y, lim_y) * tz
    inv_z2 = inv_z * inv_z
    j00 = fx * inv_z
    j02 = -fx * txz * inv_z2
    j11 = fy * inv_z
    j12 = -fy * tyz * inv_z2

    u0 = j00 * rot[0, 0] + j02 * rot[2, 0]
    u1 = j00 * rot[0, 1] + j02 * rot[2, 1]
    u2 = j00 * rot[0, 2] + j02 * rot[2, 2]
    v0 = j11 * rot[1, 0] + j12 * rot[2, 0]
    v1 = j11 * rot[1, 1] + j12 * rot[2, 1]
    v2 = j11 * rot[1, 2] + j12 * rot[2, 2]

    s00, s01, s02, s11, s12, s22 = soa.cov

    su0 = s00 * u0 + s01 * u1 + s02 * u2
    su1 = s01 * u0 + s11 * u1 + s12 * u2
    su2 = s02 * u0 + s12 * u1 + s22 * u2
    sv0 = s00 * v0 + s01 * v1 + s02 * v2
    sv1 = s01 * v0 + s11 * v1 + s12 * v2
    sv2 = s02 * v0 + s12 * v1 + s22 * v2
    a = u0 * su0 + u1 * su1 + u2 * su2 + COV2D_DILATION
    b = v0 * su0 + v1 * su1 + v2 * su2
    c = v0 * sv0 + v1 * sv1 + v2 * sv2 + COV2D_DILATION

    det = a * c - b * b
    safe_det = torch.where(det <= 0, torch.ones_like(det), det)
    conic_a = c / safe_det
    conic_b = -b / safe_det
    conic_c = a / safe_det

    # alpha(p) = op * exp(-q(p)/2) >= MIN_ALPHA iff q(p) <= t; the ellipse
    # q <= t spans +-sqrt(t * cov_xx) in x and +-sqrt(t * cov_yy) in y.
    t_cut = 2.0 * torch.log(torch.clamp(opacities, min=MIN_ALPHA) / MIN_ALPHA)
    radius_x = torch.ceil(torch.sqrt(torch.clamp(t_cut * a, min=0.0)))
    radius_y = torch.ceil(torch.sqrt(torch.clamp(t_cut * c, min=0.0)))

    on_screen = (
        (mean_x + radius_x > 0)
        & (mean_x - radius_x < w)
        & (mean_y + radius_y > 0)
        & (mean_y - radius_y < h)
    )
    valid = (depth > NEAR_CLIP) & (det > 0) & on_screen & (opacities > MIN_ALPHA)

    if soa.harmonics is not None:
        dx = mx - cam_pos[0]
        dy = my - cam_pos[1]
        dz = mz - cam_pos[2]
        inv_n = torch.rsqrt(dx * dx + dy * dy + dz * dz + 1e-24)
        harm = soa.harmonics  # (ch, d_sh, g) or (ch, d_sh, V, 1, R)
        channels, d_sh = harm.shape[0], harm.shape[1]
        g = mx.shape[0]
        basis = torch.stack(
            sh_basis_components(dx * inv_n, dy * inv_n, dz * inv_n, int(np.sqrt(d_sh)) - 1)
        )  # (d_sh, g)
        if harm.ndim == 5:
            # Sample-shared coefficients broadcast over the S sample axis.
            v_sh, _, r_sh = harm.shape[2:]
            s_sh = g // (v_sh * r_sh)
            basis_r = basis.reshape(d_sh, v_sh, s_sh, r_sh)
            color = (harm * basis_r[None]).sum(dim=1).reshape(channels, g)
        else:
            color = (harm * basis[None]).sum(dim=1)  # (ch, g)
        # 3DGS convention: +0.5 offset, clamped at zero.
        color = torch.clamp(color + 0.5, min=0.0)
    else:
        color = soa.colors

    zero = torch.zeros_like(radius_x)
    return ProjectedGaussians(
        mean_x=mean_x.to(dtype),
        mean_y=mean_y.to(dtype),
        conic_a=conic_a.to(dtype),
        conic_b=conic_b.to(dtype),
        conic_c=conic_c.to(dtype),
        depth=depth,
        radius_x=torch.where(valid, radius_x, zero),
        radius_y=torch.where(valid, radius_y, zero),
        color=color.to(dtype),
        opacity=opacities,
        valid=valid,
    )
