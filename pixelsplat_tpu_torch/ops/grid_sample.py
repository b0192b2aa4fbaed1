"""Bilinear grid sampling of channels-last image stacks.

Port of `pixelsplat_tpu/ops/grid_sample.py::grid_sample_nhwc_flat`, which
spells out `torch.nn.functional.grid_sample(mode="bilinear",
padding_mode="zeros", align_corners=False)` as four row gathers and a
lerp. Here it is that call. (`_tap_u16` there is a TPU gather layout and
is not carried over.)
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample_nhwc_flat(images: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Sample a stack of images (n, h, w, c) at per-image coords
    (n, ..., 2) in [-1, 1] (xy order). Returns (n, ..., c); taps outside
    the image contribute zero."""
    n, _, _, c = images.shape
    grid = coords.reshape(n, -1, 1, 2)
    out = F.grid_sample(
        images.permute(0, 3, 1, 2), grid, mode="bilinear", padding_mode="zeros", align_corners=False
    )  # (n, c, q, 1)
    return out[..., 0].permute(0, 2, 1).reshape(*coords.shape[:-1], c)
