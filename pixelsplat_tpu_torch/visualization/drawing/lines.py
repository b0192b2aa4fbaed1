"""Antialiased line segments with butt, round or square caps.

Port of `pixelsplat_tpu/visualization/drawing/lines.py`, through the
distance from each pixel centre to each segment.
"""

from __future__ import annotations

import torch

from .rendering import render_colored_primitives_over_image, render_primitives_over_image
from .types import as_float_tensor


def _segment_distance(
    coords: torch.Tensor,  # (h, w, 2)
    start: torch.Tensor,  # (n, 2)
    end: torch.Tensor,  # (n, 2)
    cap: str,
) -> torch.Tensor:
    """Distance from each pixel to each segment; (h, w, n)."""
    p = coords[:, :, None, :]  # (h, w, 1, 2)
    a = start[None, None]  # (1, 1, n, 2)
    b = end[None, None]
    ab = b - a
    denom = (ab * ab).sum(-1) + 1e-12
    t = ((p - a) * ab).sum(-1) / denom
    if cap in ("butt", "round"):
        t_clamped = torch.clamp(t, 0.0, 1.0)
    elif cap == "square":
        # Extended by half a pixel along the line.
        ext = 0.5 / torch.sqrt(denom)
        t_clamped = torch.clamp(t, -ext, 1.0 + ext)
    else:
        raise ValueError(f"unknown cap {cap!r}")
    closest = a + t_clamped[..., None] * ab
    return torch.linalg.vector_norm(p - closest, dim=-1)


def draw_lines(
    image: torch.Tensor,  # (3, h, w)
    start,  # (n, 2) pixel coordinates (xy)
    end,  # (n, 2)
    color,  # (3,), a scalar grey, or (n, 3) per segment
    width: float,
    cap: str = "round",
) -> torch.Tensor:
    image = as_float_tensor(image)
    start = as_float_tensor(start, image.device)
    end = as_float_tensor(end, image.device)
    color = as_float_tensor(color, image.device)
    if color.ndim == 2:  # per-segment colours
        return render_colored_primitives_over_image(
            image, lambda coords: _segment_distance(coords, start, end, cap) - width / 2.0, color
        )
    return render_primitives_over_image(
        image, lambda coords: (_segment_distance(coords, start, end, cap) - width / 2.0).amin(dim=-1), color
    )
