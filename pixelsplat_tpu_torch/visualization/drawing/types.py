"""Input sanitizers for the drawing primitives.

Port of `pixelsplat_tpu/visualization/drawing/types.py`: scalars, tuples,
arrays and tensors become batched float32 tensors on the given device.
"""

from __future__ import annotations

from typing import Iterable, Union

import numpy as np
import torch

Vector = Union[tuple[float, float], torch.Tensor, np.ndarray, Iterable[float]]
Scalar = Union[float, int, torch.Tensor, np.ndarray]
Color = Union[float, Iterable[float], torch.Tensor, np.ndarray]


def as_float_tensor(x, device: torch.device | str | None = None) -> torch.Tensor:
    """Any array-like -> float32 tensor (on `device` when given)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device if device is not None else x.device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def sanitize_vector(vector: Vector, dimensions: int = 2, device=None) -> torch.Tensor:
    """-> (batch, dimensions) float tensor."""
    v = as_float_tensor(vector, device)
    if v.ndim == 1:
        v = v[None]
    assert v.shape[-1] == dimensions
    return v


def sanitize_scalar(scalar: Scalar, batch: int = 1, device=None) -> torch.Tensor:
    """-> (batch,) float tensor."""
    s = as_float_tensor(scalar, device)
    if s.ndim == 0:
        s = s.expand(batch)
    return s


def sanitize_color(color: Color, device=None) -> torch.Tensor:
    """-> (3,) float tensor (grey from scalars)."""
    c = as_float_tensor(color, device)
    if c.ndim == 0:
        c = c.expand(3)
    return c
