"""Antialiased points and rings.

Port of `pixelsplat_tpu/visualization/drawing/points.py`.
"""

from __future__ import annotations

import torch

from .rendering import render_colored_primitives_over_image, render_primitives_over_image
from .types import as_float_tensor


def draw_points(
    image: torch.Tensor,  # (3, h, w)
    points,  # (n, 2) pixel coordinates (xy)
    color,  # (3,), a scalar grey, or (n, 3) per point
    radius: float,
    inner_radius: float = 0.0,
) -> torch.Tensor:
    """Filled discs, or rings when inner_radius > 0."""
    image = as_float_tensor(image)
    points = as_float_tensor(points, image.device)

    def per_point(coords: torch.Tensor) -> torch.Tensor:  # (h, w, 2) -> (h, w, n)
        d = torch.linalg.vector_norm(coords[:, :, None, :] - points[None, None], dim=-1)
        if inner_radius > 0:
            # Ring: distance from the annulus.
            mid = 0.5 * (radius + inner_radius)
            half = 0.5 * (radius - inner_radius)
            return torch.abs(d - mid) - half
        return d - radius

    color = as_float_tensor(color, image.device)
    if color.ndim == 2:  # per-point colours
        return render_colored_primitives_over_image(image, per_point, color)
    return render_primitives_over_image(image, lambda coords: per_point(coords).amin(dim=-1), color)
