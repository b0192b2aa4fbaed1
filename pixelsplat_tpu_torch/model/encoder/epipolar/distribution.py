"""Tiny q/k attention that gives a discrete pdf.

Port of `pixelsplat_tpu/model/encoder/epipolar/distribution.py` (no config
calls it; kept for the reference's inventory): one query from the first
sample and one key per sample, whose scaled dot products, softmaxed over
the samples, form a probability distribution. `force_last_token` puts all
the mass on the last sample where it is set.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn


class Distribution(nn.Module):
    def __init__(self, d_in: int, dim: int):
        super().__init__()
        self.dim = dim
        self.to_q = nn.Linear(d_in, dim)
        self.to_k = nn.Linear(d_in, dim)

    def forward(
        self,
        features: torch.Tensor,  # (..., sample, channel)
        force_last_token: Optional[torch.Tensor] = None,  # (...,) bool
    ) -> torch.Tensor:
        q = self.to_q(features[..., :1, :])  # (..., 1, d)
        k = self.to_k(features)  # (..., s, d)
        logits = torch.einsum("...id,...sd->...s", q, k) / math.sqrt(self.dim)
        if force_last_token is not None:
            last_only = torch.full_like(logits, -1e9)
            last_only[..., -1] = 0.0
            logits = torch.where(force_last_token[..., None], last_only, logits)
        return torch.softmax(logits, dim=-1)
