"""Loss framework. Port of `pixelsplat_tpu/loss/loss.py`.

Each loss is keyed by its cfg's `name`; `get_losses` builds the configured
set. A loss is a callable (prediction, batch, gaussians, global_step) ->
scalar tensor.
"""

from __future__ import annotations

from typing import Any, Protocol, Union

import torch


class Loss(Protocol):
    cfg: Any
    name: str

    def __call__(
        self,
        prediction,  # DecoderOutput
        batch: dict,
        gaussians,
        global_step: int,
    ) -> torch.Tensor: ...


def get_losses(cfgs: list, device: Union[str, torch.device] = "cuda") -> list[Loss]:
    """The configured losses; `device` is where a loss's own network
    (LPIPS's VGG) lives."""
    from .loss_depth import LossDepth
    from .loss_lpips import LossLpips
    from .loss_mse import LossMse

    by_name = {"mse": LossMse, "lpips": LossLpips, "depth": LossDepth}
    losses = []
    for cfg in cfgs:
        cls = by_name[cfg.name]
        losses.append(cls(cfg, device=device) if cls is LossLpips else cls(cfg))
    return losses
