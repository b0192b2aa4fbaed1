"""Bounds shim: near/far planes from a disparity-at-baseline heuristic.

Port of `pixelsplat_tpu/dataset/shims/bounds_shim.py`.
"""

from __future__ import annotations

import torch


def compute_depth_for_disparity(
    extrinsics: torch.Tensor,  # (b, v, 4, 4)
    intrinsics: torch.Tensor,  # (b, v, 3, 3)
    image_shape: tuple[int, int],
    disparity: float,
    delta_min: float = 1e-6,
) -> torch.Tensor:
    """Depth at which the widest camera baseline gives `disparity` pixels."""
    origins = extrinsics[..., :3, 3]
    deltas = torch.linalg.vector_norm(origins[:, None] - origins[:, :, None], dim=-1)
    baselines = torch.clamp(deltas, min=delta_min).amax(dim=(1, 2))  # (b,)
    h, w = image_shape
    pix = torch.stack(
        [(1.0 / w) / intrinsics[..., 0, 0], (1.0 / h) / intrinsics[..., 1, 1]], dim=-1
    )  # (b, v, 2)
    return baselines / (disparity * pix.mean(dim=(1, 2)))


def apply_bounds_shim(batch: dict, near_disparity: float, far_disparity: float) -> dict:
    context = batch["context"]
    _, cv, _, h, w = context["image"].shape
    near = compute_depth_for_disparity(context["extrinsics"], context["intrinsics"], (h, w), near_disparity)
    far = compute_depth_for_disparity(context["extrinsics"], context["intrinsics"], (h, w), far_disparity)
    target = batch["target"]
    tv = target["image"].shape[1]
    b = near.shape[0]
    return {
        **batch,
        "context": {**context, "near": near[:, None].expand(b, cv), "far": far[:, None].expand(b, cv)},
        "target": {**target, "near": near[:, None].expand(b, tv), "far": far[:, None].expand(b, tv)},
    }
