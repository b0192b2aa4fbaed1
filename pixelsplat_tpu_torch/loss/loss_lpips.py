"""LPIPS perceptual loss, off before `apply_after_step`.

Port of `pixelsplat_tpu/loss/loss_lpips.py`. Before the activation step the
VGG forward and backward do not run at all (a Python branch on the step,
which is what the JAX package's `lax.cond` does at run time). The LPIPS
network is frozen: its weights take no gradient.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Union

import torch

from ..evaluation.lpips import get_lpips


@dataclass(frozen=True)
class LossLpipsCfg:
    name: str = "lpips"
    weight: float = 0.05
    apply_after_step: int = 150_000
    # Test and smoke-run escape hatch: permit architecture-correct random
    # VGG weights when the exported .npz is absent. Never set in a real
    # training config.
    allow_random_weights: bool = False


class LossLpips:
    name = "lpips"

    def __init__(self, cfg: LossLpipsCfg, device: Union[str, torch.device] = "cuda"):
        self.cfg = cfg
        # Fails hard without the published weights: a training run would
        # otherwise optimize a random-VGG distance from `apply_after_step` on.
        self.lpips, self.pretrained = get_lpips(allow_random=cfg.allow_random_weights)
        self.lpips.to(device)
        if not self.pretrained:
            print(
                "WARNING: LossLpips running with RANDOM VGG weights "
                "(allow_random_weights=True); not a parity-capable run."
            )

    def __call__(self, prediction, batch, gaussians, global_step) -> torch.Tensor:
        image = batch["target"]["image"]  # (b, v, 3, h, w)
        b, v, c, h, w = image.shape
        pred = prediction.color.reshape(b * v, c, h, w)
        if int(global_step) < self.cfg.apply_after_step:
            return self.cfg.weight * pred.new_zeros(())
        return self.cfg.weight * self.lpips(pred, image.reshape(b * v, c, h, w)).mean()
