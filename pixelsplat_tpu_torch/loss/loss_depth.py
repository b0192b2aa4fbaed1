"""Edge-aware depth smoothness loss. Port of `pixelsplat_tpu/loss/loss_depth.py`.

Penalizes the second moment of the spatial differences of 1/depth
(optionally of the second derivative), optionally weighted by bilateral
weights from the target image's gradients. A function of
`prediction.depth`, which the decoder renders only with a `depth_mode`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class LossDepthCfg:
    name: str = "depth"
    weight: float = 0.25
    sigma_image: Optional[float] = None
    use_second_derivative: bool = False


class LossDepth:
    name = "depth"

    def __init__(self, cfg: LossDepthCfg):
        self.cfg = cfg

    def __call__(self, prediction, batch, gaussians, global_step) -> torch.Tensor:
        if prediction.depth is None:
            raise ValueError("the depth loss requires a depth_mode")
        # Scale-invariant: operate on disparity.
        disp = 1.0 / prediction.depth  # (b, v, h, w)

        dx = disp[..., :, 1:] - disp[..., :, :-1]
        dy = disp[..., 1:, :] - disp[..., :-1, :]
        if self.cfg.use_second_derivative:
            dx = dx[..., :, 1:] - dx[..., :, :-1]
            dy = dy[..., 1:, :] - dy[..., :-1, :]

        if self.cfg.sigma_image is not None:
            image = batch["target"]["image"]  # (b, v, 3, h, w)
            gx = (image[..., :, 1:] - image[..., :, :-1]).mean(dim=2)
            gy = (image[..., 1:, :] - image[..., :-1, :]).mean(dim=2)
            if self.cfg.use_second_derivative:
                gx = gx[..., :, 1:]
                gy = gy[..., 1:, :]
            dx = dx * torch.exp(-(gx**2) / (2 * self.cfg.sigma_image**2))
            dy = dy * torch.exp(-(gy**2) / (2 * self.cfg.sigma_image**2))

        return self.cfg.weight * ((dx**2).mean() + (dy**2).mean())
