"""Generalized pdf-input depth predictor and its sampler.

Port of `pixelsplat_tpu/model/encoder/common/depth_predictor.py`: variants
that take a pdf from outside (the encoder uses `DepthPredictorMonocular`;
no config calls these, which are kept for the reference's inventory).
Depths are the bucket centres of the sampled indices; opacities are the
sampled densities or, with `use_transmittance`, the pdf over the mass left
in front of the bucket.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ....utils.distributions import gather_discrete_topk, sample_discrete_distribution
from ..epipolar.conversions import relative_disparity_to_depth
from ..epipolar.depth_predictor_monocular import transmittance_opacity


class Sampler:
    """Sample bucket indices from a pdf; deterministic -> top-k."""

    def __call__(
        self,
        pdf: torch.Tensor,  # (*batch, bucket)
        num_samples: int,
        deterministic: bool,
        u: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        if deterministic:
            return gather_discrete_topk(pdf, num_samples)
        if u is None and generator is None:
            raise ValueError("stochastic sampling requires uniforms `u` or a generator")
        return sample_discrete_distribution(pdf, num_samples, u=u, generator=generator)

    def gather(self, index: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        return torch.gather(target, -1, index.long())


class DepthPredictor(nn.Module):
    """pdf -> depths at the bucket centres, and opacities."""

    def __init__(self, num_samples: int, use_transmittance: bool = False):
        super().__init__()
        self.num_samples = num_samples
        self.use_transmittance = use_transmittance

    def forward(
        self,
        pdf: torch.Tensor,  # (*batch, bucket)
        near: torch.Tensor,  # (*batch,)
        far: torch.Tensor,  # (*batch,)
        deterministic: bool,
        gaussians_per_pixel: int,
        u: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        sampler = Sampler()
        index, pdf_i = sampler(pdf, gaussians_per_pixel, deterministic, u=u, generator=generator)
        relative_disparity = (index.to(pdf.dtype) + 0.5) / pdf.shape[-1]
        depth = relative_disparity_to_depth(relative_disparity, near[..., None], far[..., None])
        if self.use_transmittance:
            return depth, sampler.gather(index, transmittance_opacity(pdf))
        return depth, pdf_i
