"""Normalized image <-> pixel coordinate converters for drawing overlays.

Port of `pixelsplat_tpu/visualization/drawing/coordinate_conversion.py`.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class PixelSpace(NamedTuple):
    """Maps normalized image coordinates to pixel coordinates and back."""

    to_pixel: Callable[[torch.Tensor], torch.Tensor]
    from_pixel: Callable[[torch.Tensor], torch.Tensor]


def generate_conversions(image_shape: tuple[int, int]) -> PixelSpace:
    h, w = image_shape

    def scale(xy: torch.Tensor) -> torch.Tensor:
        return torch.tensor([w, h], dtype=torch.float32, device=xy.device)

    def to_pixel(xy: torch.Tensor) -> torch.Tensor:
        return xy * scale(xy)

    def from_pixel(xy: torch.Tensor) -> torch.Tensor:
        return xy / scale(xy)

    return PixelSpace(to_pixel=to_pixel, from_pixel=from_pixel)
