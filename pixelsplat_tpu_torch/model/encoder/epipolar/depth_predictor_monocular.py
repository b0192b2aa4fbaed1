"""Monocular depth predictor: depth-bucket pdf plus intra-bucket offsets.

Port of `pixelsplat_tpu/model/encoder/epipolar/depth_predictor_monocular.py`.
Per-pixel features give a categorical distribution over `num_samples`
disparity buckets and a sigmoid offset within each; depths are sampled by
inverse CDF (or taken top-k when deterministic). The opacity is the
sampled bucket's probability or, with `use_transmittance` (the
`re10k_ablation_no_probabilistic_sampling` experiment), that probability
over the mass left in front of the bucket, pdf / (1 - exclusive cumsum
of pdf + 1e-10), so that a front-to-back composite of the buckets gives
back the pdf.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ....utils.distributions import (
    gather_discrete_topk,
    onehot_gather,
    sample_discrete_distribution,
)
from .conversions import relative_disparity_to_depth


def transmittance_opacity(pdf: torch.Tensor) -> torch.Tensor:
    """pdf / (1 - exclusive cumsum(pdf) + 1e-10) along the bucket axis."""
    partial = torch.cumsum(pdf, dim=-1)
    partial = torch.cat([torch.zeros_like(partial[..., :1]), partial[..., :-1]], dim=-1)
    return pdf / (1.0 - partial + 1e-10)


class DepthPredictorMonocular(nn.Module):
    def __init__(self, d_in: int, num_samples: int, num_surfaces: int, use_transmittance: bool = False):
        super().__init__()
        self.num_samples = num_samples
        self.num_surfaces = num_surfaces
        self.use_transmittance = use_transmittance
        self.projection = nn.Sequential(
            nn.ReLU(), nn.Linear(d_in, 2 * num_samples * num_surfaces)
        )

    def forward(
        self,
        features: torch.Tensor,  # (b, v, ray, channel)
        near: torch.Tensor,  # (b, v)
        far: torch.Tensor,  # (b, v)
        deterministic: bool,
        gaussians_per_pixel: int,
        u: Optional[torch.Tensor] = None,  # (b, v, ray, surface, sample)
        generator: Optional[torch.Generator] = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Returns (depths, densities), each (b, v, ray, surface, sample)."""
        s = self.num_samples
        x = self.projection(features)
        # Split "... (dpt srf c) -> c ... srf dpt", c fastest-varying.
        x = x.reshape(*x.shape[:-1], s, self.num_surfaces, 2)
        pdf = torch.softmax(x[..., 0].transpose(-1, -2), dim=-1)  # (b, v, r, srf, dpt)
        offset = torch.sigmoid(x[..., 1].transpose(-1, -2))

        if deterministic:
            index, pdf_i = gather_discrete_topk(pdf, gaussians_per_pixel)
        else:
            index, pdf_i = sample_discrete_distribution(
                pdf, gaussians_per_pixel, u=u, generator=generator
            )
        offset_i = onehot_gather(offset, index)

        relative_disparity = (index.to(offset.dtype) + offset_i) / s
        depth = relative_disparity_to_depth(
            relative_disparity, near[:, :, None, None, None], far[:, :, None, None, None]
        )
        if self.use_transmittance:
            return depth, onehot_gather(transmittance_opacity(pdf), index)
        return depth, pdf_i
