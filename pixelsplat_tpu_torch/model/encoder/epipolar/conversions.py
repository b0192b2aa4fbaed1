"""Depth <-> relative disparity (linear in disparity).

Port of `pixelsplat_tpu/model/encoder/epipolar/conversions.py`.
"""

from __future__ import annotations

import torch


def relative_disparity_to_depth(
    relative_disparity: torch.Tensor,
    near: torch.Tensor,
    far: torch.Tensor,
    eps: float = 1e-10,
) -> torch.Tensor:
    """0 maps to near, 1 maps to far."""
    disp_near = 1.0 / (near + eps)
    disp_far = 1.0 / (far + eps)
    return 1.0 / ((1.0 - relative_disparity) * (disp_near - disp_far) + disp_far + eps)


def depth_to_relative_disparity(
    depth: torch.Tensor,
    near: torch.Tensor,
    far: torch.Tensor,
    eps: float = 1e-10,
) -> torch.Tensor:
    """near maps to 0, far maps to 1."""
    disp_near = 1.0 / (near + eps)
    disp_far = 1.0 / (far + eps)
    disp = 1.0 / (depth + eps)
    return 1.0 - (disp - disp_far) / (disp_near - disp_far + eps)
