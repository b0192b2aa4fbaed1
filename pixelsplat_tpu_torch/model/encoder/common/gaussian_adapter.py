"""Gaussian adapter: raw per-pixel features -> world-space 3D Gaussians.

Port of `pixelsplat_tpu/model/encoder/common/gaussian_adapter.py`: scales
sigmoid-mapped into [scale_min, scale_max] and modulated by depth x pixel
size, normalized xyzw quaternions, covariances rotated into world space by
the camera rotation, means unprojected along pixel rays, and SH rotated to
world space by one rotation matrix per camera, with the per-degree damping
folded into that matrix.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from ....geometry.projection import get_world_rays
from ....ops.sh import apply_sh_rotation, full_sh_rotation_matrix
from ....utils.device_constants import on_device
from .gaussians import build_world_covariance


@dataclass(frozen=True)
class GaussianAdapterCfg:
    gaussian_scale_min: float = 0.5
    gaussian_scale_max: float = 15.0
    sh_degree: int = 4


class AdaptedGaussians(NamedTuple):
    means: torch.Tensor  # (..., 3)
    covariances: torch.Tensor  # (..., 3, 3)
    scales: torch.Tensor  # (..., 3)
    rotations: torch.Tensor  # (..., 4)
    # World-frame SH, broadcastable against (*opacities.shape, 3, d_sh) but
    # shared across the per-pixel sample axis (not repeated).
    harmonics: torch.Tensor
    opacities: torch.Tensor  # (...)


def sh_mask(sh_degree: int) -> torch.Tensor:
    """The per-degree damping of the SH coefficients, (d_sh,) on the CPU."""
    mask = torch.ones((sh_degree + 1) ** 2)
    for degree in range(1, sh_degree + 1):
        mask[degree**2 : (degree + 1) ** 2] = 0.1 * 0.25**degree
    return mask


def _pixel_size(h: int, w: int) -> list:
    return [1.0 / w, 1.0 / h]


def pixel_size(image_shape: tuple[int, int], device, dtype: torch.dtype) -> torch.Tensor:
    """(1 / w, 1 / h) of an image of `image_shape` (h, w), kept on `device`."""
    return on_device("pixel_size", _pixel_size, *image_shape, device=device, dtype=dtype)


class GaussianAdapter:
    """Stateless (no learnable parameters)."""

    def __init__(self, cfg: GaussianAdapterCfg):
        self.cfg = cfg

    @property
    def d_sh(self) -> int:
        return (self.cfg.sh_degree + 1) ** 2

    @property
    def d_in(self) -> int:
        return 7 + 3 * self.d_sh

    def __call__(
        self,
        extrinsics: torch.Tensor,  # (*#batch, 4, 4)
        intrinsics: torch.Tensor,  # (*#batch, 3, 3)
        coordinates: torch.Tensor,  # (*#batch, 2)
        depths: torch.Tensor,  # (*#batch)
        opacities: torch.Tensor,  # (*#batch)
        raw_gaussians: torch.Tensor,  # (*#batch, d_in)
        image_shape: tuple[int, int],
        eps: float = 1e-8,
    ) -> AdaptedGaussians:
        cfg = self.cfg
        scales, rotations, sh = torch.split(raw_gaussians, [3, 4, 3 * self.d_sh], dim=-1)

        scales = cfg.gaussian_scale_min + (
            cfg.gaussian_scale_max - cfg.gaussian_scale_min
        ) * torch.sigmoid(scales)
        multiplier = self.get_scale_multiplier(intrinsics, pixel_size(image_shape, scales.device, scales.dtype))
        scales = scales * depths[..., None] * multiplier[..., None]

        rotations = rotations / (torch.linalg.vector_norm(rotations, dim=-1, keepdim=True) + eps)
        sh = sh.reshape(*sh.shape[:-1], 3, self.d_sh)

        c2w_rotations = extrinsics[..., :3, :3]
        covariances = build_world_covariance(scales, rotations, c2w_rotations)

        sh_m = full_sh_rotation_matrix(c2w_rotations, cfg.sh_degree)
        sh_m = sh_m * on_device("sh_mask", sh_mask, cfg.sh_degree, device=sh_m.device)  # rotate(mask * sh)
        harmonics = apply_sh_rotation(sh, sh_m[..., None, :, :])

        origins, directions = get_world_rays(coordinates, extrinsics, intrinsics)
        means = origins + directions * depths[..., None]

        return AdaptedGaussians(
            means=means,
            covariances=covariances,
            harmonics=harmonics,
            opacities=opacities,
            scales=scales,
            rotations=rotations.expand(*scales.shape[:-1], 4),
        )

    def get_scale_multiplier(
        self,
        intrinsics: torch.Tensor,
        pixel_size: torch.Tensor,
        multiplier: float = 0.1,
    ) -> torch.Tensor:
        # Closed-form inverse of the 2x2 focal block, applied to pixel_size.
        a = intrinsics[..., 0, 0]
        b = intrinsics[..., 0, 1]
        c = intrinsics[..., 1, 0]
        d = intrinsics[..., 1, 1]
        det = a * d - b * c
        x = (d / det) * pixel_size[0] + (-b / det) * pixel_size[1]
        y = (-c / det) * pixel_size[0] + (a / det) * pixel_size[1]
        return multiplier * x + multiplier * y
