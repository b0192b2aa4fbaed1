"""Discrete distribution sampling (inverse CDF / top-k).

Port of `pixelsplat_tpu/utils/distributions.py`. Sampling takes its
uniforms `u` as an argument, or draws them from an explicit
`torch.Generator`, so a caller can hand the JAX package's draws to both
sides.
"""

from __future__ import annotations

from typing import Optional

import torch

_EPS = float(torch.finfo(torch.float32).eps)


def onehot_gather(values: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """values: (*batch, bucket); index: (*batch, sample) -> (*batch, sample)."""
    return torch.gather(values, -1, index.long())


def sample_discrete_distribution(
    pdf: torch.Tensor,  # (*batch, bucket)
    num_samples: int,
    u: Optional[torch.Tensor] = None,  # (*batch, sample) uniforms in [0, 1)
    generator: Optional[torch.Generator] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Inverse-CDF sampling. Returns (indices, densities), (*batch, sample)."""
    *batch, bucket = pdf.shape
    normalized = pdf / (_EPS + pdf.sum(dim=-1, keepdim=True))
    cdf = torch.cumsum(normalized, dim=-1)
    if u is None:
        u = torch.rand(
            (*batch, num_samples), generator=generator, dtype=pdf.dtype, device=pdf.device
        )
    # index = #{j : cdf[j] <= u}, i.e. searchsorted(cdf, u, side="right").
    index = (cdf[..., :, None] <= u[..., None, :]).sum(dim=-2)
    index = torch.clamp(index, 0, bucket - 1)
    return index, onehot_gather(normalized, index)


def gather_discrete_topk(
    pdf: torch.Tensor,
    num_samples: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Deterministic top-k by iterated masked argmax (ties: first index)."""
    normalized = pdf / (_EPS + pdf.sum(dim=-1, keepdim=True))
    work = pdf
    indices = []
    for _ in range(num_samples):
        best = torch.argmax(work, dim=-1)
        indices.append(best)
        work = work.scatter(-1, best[..., None], float("-inf"))
    index = torch.stack(indices, dim=-1)
    return index, onehot_gather(normalized, index)
