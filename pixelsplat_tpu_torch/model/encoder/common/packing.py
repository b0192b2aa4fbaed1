"""The encoders' adapted Gaussians as the scene the decoder takes: AoS
`Gaussians`, or the rasterizer's `GaussiansSoA` planes."""

from __future__ import annotations

from typing import Union

import torch

from ....ops.rasterizer.projection import GaussiansSoA
from ...types import Gaussians
from .gaussian_adapter import AdaptedGaussians


def pack(gaussians: AdaptedGaussians, opacities: torch.Tensor, pack_soa: bool) -> Union[Gaussians, GaussiansSoA]:
    """`gaussians` of shape (b, v, r, srf, spp) (means (..., 3), harmonics
    sample-shared, (b, v, r, srf, 1, 3, d_sh)) with `opacities`
    broadcastable to it. With `pack_soa`, `GaussiansSoA` planes with a
    leading batch axis in (v, srf, spp, r) Gaussian order, the harmonics
    sample-shared (b, 3, d_sh, v*srf, 1, r); otherwise AoS `Gaussians` in
    (v, r, srf, spp) order."""
    b, v, r, srf, spp = gaussians.means.shape[:-1]
    d_sh = gaussians.harmonics.shape[-1]
    g = v * r * srf * spp
    if pack_soa:
        # SoA g-order (v, srf, spp, r): the sample axis is second
        # outermost, so the per-ray harmonics factor as (V, 1, R).

        def plane(x):  # (b, v, r, srf, spp) -> (b, g)
            x = x.expand(b, v, r, srf, spp)
            return x.permute(0, 1, 3, 4, 2).reshape(b, g)

        means = gaussians.means
        cov = gaussians.covariances
        cov6 = torch.stack(
            [plane(cov[..., i, j]) for i, j in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))],
            dim=1,
        )  # (b, 6, g)
        harm = gaussians.harmonics.permute(0, 5, 6, 1, 3, 4, 2)
        harm = harm.reshape(b, 3, d_sh, v * srf, 1, r)
        return GaussiansSoA(
            mean_x=plane(means[..., 0]),
            mean_y=plane(means[..., 1]),
            mean_z=plane(means[..., 2]),
            cov=cov6,
            opacity=plane(opacities),
            harmonics=harm,
        )
    harmonics = gaussians.harmonics.expand(b, v, r, srf, spp, 3, d_sh)
    return Gaussians(
        means=gaussians.means.reshape(b, g, 3),
        covariances=gaussians.covariances.reshape(b, g, 3, 3),
        harmonics=harmonics.reshape(b, g, 3, d_sh),
        opacities=opacities.expand(b, v, r, srf, spp).reshape(b, g),
    )
