"""Optimizer: Adam + linear LR warm-up + global-norm gradient clipping.

Port of `pixelsplat_tpu/training/optimizer.py` (optax `clip_by_global_norm`
chained before `adam` with a schedule): Adam at `cfg.lr` with the rate
ramping linearly from 1/warm_up_steps to 1x over `warm_up_steps`, and a
global-norm clip of 0.5 applied to the gradients before Adam sees them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable

import torch


@dataclass(frozen=True)
class OptimizerCfg:
    lr: float = 1.5e-4
    warm_up_steps: int = 2000


def learning_rate(cfg: OptimizerCfg, step: int) -> float:
    """The rate of the update that takes the model from `step` to `step + 1`
    (optax counts from 0 and increments before it reads the schedule)."""
    return cfg.lr * min(1.0, (step + 1) / max(cfg.warm_up_steps, 1))


def clip_by_global_norm(grads: Iterable[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale `grads` in place by max_norm / max(norm, max_norm), optax's
    rule (`torch.nn.utils.clip_grad_norm_` divides by norm + 1e-6 instead).
    Returns the norm before clipping."""
    grads = list(grads)
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = max_norm / torch.clamp(norm, min=max_norm)
    torch._foreach_mul_(grads, scale)
    return norm


class Optimizer:
    """Clip, then Adam at the scheduled rate (what the JAX package's
    `build_optimizer` chains). `step(step_index)` consumes the parameters'
    `.grad`s."""

    def __init__(
        self,
        params: Iterable[torch.nn.Parameter],
        cfg: OptimizerCfg,
        gradient_clip_val: float = 0.5,
    ):
        self.cfg = cfg
        self.gradient_clip_val = gradient_clip_val
        self.params = list(params)
        self.adam = torch.optim.Adam(self.params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)

    def step(self, step: int) -> None:
        if self.gradient_clip_val and self.gradient_clip_val > 0:
            clip_by_global_norm((p.grad for p in self.params), self.gradient_clip_val)
        for group in self.adam.param_groups:
            group["lr"] = learning_rate(self.cfg, step)
        self.adam.step()

    def state_dict(self) -> dict:
        return self.adam.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.adam.load_state_dict(state)

