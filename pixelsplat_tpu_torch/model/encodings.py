"""Sinusoidal positional encoding for [0, 1]-ranged inputs.

Port of `pixelsplat_tpu/model/encodings.py`: per octave o the frequency is
2*pi*2^o, with phases (0, pi/2), i.e. (sin, cos). The output layout is
(dim, octave, phase) flattened, d_out = 2 * octaves * dim.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def positional_encoding(samples: torch.Tensor, num_octaves: int) -> torch.Tensor:
    """samples (..., d) -> (..., d * num_octaves * 2)."""
    octaves = torch.arange(num_octaves, dtype=samples.dtype, device=samples.device)
    frequencies = 2.0 * math.pi * 2.0**octaves  # (f,)
    phases = torch.tensor([0.0, 0.5 * math.pi], dtype=samples.dtype, device=samples.device)  # (p,)
    scaled = samples[..., None, None] * frequencies[:, None] + phases  # (..., d, f, p)
    return torch.sin(scaled).reshape(*samples.shape[:-1], -1)


def positional_encoding_d_out(dimensionality: int, num_octaves: int) -> int:
    return 2 * num_octaves * dimensionality


class PositionalEncoding(nn.Module):
    """`positional_encoding` as a parameter-free module, so that it can
    stand first in a `Sequential` in front of its projection."""

    def __init__(self, num_octaves: int):
        super().__init__()
        self.num_octaves = num_octaves

    def forward(self, samples: torch.Tensor) -> torch.Tensor:
        return positional_encoding(samples, self.num_octaves)

    def d_out(self, dimensionality: int) -> int:
        return positional_encoding_d_out(dimensionality, self.num_octaves)
