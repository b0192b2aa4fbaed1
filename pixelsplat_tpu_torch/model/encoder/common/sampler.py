"""Generalized discrete-pdf sampler: bucket sampling and a broadcast gather.

Port of `pixelsplat_tpu/model/encoder/common/sampler.py`, the generalized
variant of the monocular depth predictor's sampler. No config calls it; it
is part of the encoder's public API. Stochastic sampling takes its
uniforms `u` or a `torch.Generator`, where the JAX function takes a key.
"""

from __future__ import annotations

from typing import Optional

import torch

from ....utils.distributions import gather_discrete_topk, sample_discrete_distribution


def sample(
    probabilities: torch.Tensor,  # (*batch, bucket)
    num_samples: int,
    deterministic: bool,
    u: Optional[torch.Tensor] = None,  # (*batch, num_samples) uniforms in [0, 1)
    generator: Optional[torch.Generator] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (index, density), each (*batch, num_samples)."""
    if deterministic:
        return gather_discrete_topk(probabilities, num_samples)
    if u is None and generator is None:
        raise ValueError("stochastic sampling requires uniforms `u` or a generator")
    return sample_discrete_distribution(probabilities, num_samples, u=u, generator=generator)


def gather(index: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Gather along the bucket axis with trailing broadcast dims.

    index: (*batch, sample); target: (*batch, bucket, *shape) ->
    (*batch, sample, *shape).
    """
    batch_ndim = index.ndim - 1
    trailing = target.ndim - batch_ndim - 1
    idx = index.reshape(index.shape + (1,) * trailing)
    idx = idx.expand(index.shape + target.shape[batch_ndim + 1:])
    return torch.gather(target, batch_ndim, idx.long())
