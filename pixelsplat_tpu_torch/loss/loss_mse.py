"""Mean-squared colour error. Port of `pixelsplat_tpu/loss/loss_mse.py`."""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class LossMseCfg:
    name: str = "mse"
    weight: float = 1.0


class LossMse:
    name = "mse"

    def __init__(self, cfg: LossMseCfg):
        self.cfg = cfg

    def __call__(self, prediction, batch, gaussians, global_step) -> torch.Tensor:
        delta = prediction.color - batch["target"]["image"]
        return self.cfg.weight * (delta * delta).mean()
