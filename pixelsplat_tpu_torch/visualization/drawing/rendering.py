"""Vector-graphics rasterization onto image tensors.

Port of `pixelsplat_tpu/visualization/drawing/rendering.py`: a primitive
reports the signed distance (pixels, negative inside) from each pixel
centre to its boundary, and the coverage is computed analytically from
that distance, on the image's device.
"""

from __future__ import annotations

from typing import Callable

import torch

from .types import as_float_tensor

# Maps pixel coordinates (h, w, 2) to distances (h, w) or, per primitive,
# (h, w, n) from the primitive's boundary (negative inside).
DistanceFunction = Callable[[torch.Tensor], torch.Tensor]


def coverage_from_distance(distance: torch.Tensor, feather: float = 1.0) -> torch.Tensor:
    """Antialiased coverage in [0, 1] from a signed distance in pixels."""
    return torch.clamp(0.5 - distance / feather, 0.0, 1.0)


def pixel_centres(h: int, w: int, device) -> torch.Tensor:
    """(h, w, 2) xy coordinates of the pixel centres."""
    ys = torch.arange(h, dtype=torch.float32, device=device) + 0.5
    xs = torch.arange(w, dtype=torch.float32, device=device) + 0.5
    return torch.stack(torch.meshgrid(xs, ys, indexing="xy"), dim=-1)


def render_primitives_over_image(
    image: torch.Tensor,  # (3, h, w)
    distance_fn: DistanceFunction,
    color,  # (3,) or a scalar grey
) -> torch.Tensor:
    """Alpha-over composite an antialiased primitive onto the image."""
    _, h, w = image.shape
    alpha = coverage_from_distance(distance_fn(pixel_centres(h, w, image.device)))  # (h, w)
    color = as_float_tensor(color, image.device).to(image.dtype)
    color = (color.reshape(-1, 1, 1) if color.ndim else color).expand(3, 1, 1)
    return image * (1 - alpha)[None] + color * alpha[None]


def render_colored_primitives_over_image(
    image: torch.Tensor,  # (3, h, w)
    distances_fn: DistanceFunction,  # coords (h, w, 2) -> (h, w, n)
    colors,  # (n, 3) per-primitive colours
) -> torch.Tensor:
    """Composite n primitives, each with its own colour: every pixel takes
    the nearest primitive's colour (the first one where several tie)."""
    _, h, w = image.shape
    d = distances_fn(pixel_centres(h, w, image.device))  # (h, w, n)
    idx = torch.argmin(d, dim=-1)
    nearest = torch.gather(d, -1, idx[..., None])[..., 0]
    alpha = coverage_from_distance(nearest)  # (h, w)
    col = as_float_tensor(colors, image.device).to(image.dtype)[idx]  # (h, w, 3)
    return image * (1 - alpha)[None] + col.permute(2, 0, 1) * alpha[None]
