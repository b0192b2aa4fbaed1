"""The warm-up-scheduled mapping of a depth density to an opacity, shared by
the encoders (pixelSplat's `map_pdf_to_opacity`)."""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class OpacityMappingCfg:
    initial: float = 0.0
    final: float = 0.0
    warm_up: int = 1


def opacity_exponent(cfg: OpacityMappingCfg, global_step: int) -> float:
    """The exponent at `global_step`: 2 ** (initial -> final over warm_up steps)."""
    frac = min(global_step / cfg.warm_up, 1.0)
    return 2.0 ** (cfg.initial + frac * (cfg.final - cfg.initial))


def map_pdf_to_opacity(pdf: torch.Tensor, exponent: float) -> torch.Tensor:
    return 0.5 * (1.0 - (1.0 - pdf) ** exponent + pdf ** (1.0 / exponent))
