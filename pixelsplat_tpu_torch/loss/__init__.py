"""Port of `pixelsplat_tpu/loss`."""

from .loss import Loss, get_losses
from .loss_depth import LossDepth, LossDepthCfg
from .loss_lpips import LossLpips, LossLpipsCfg
from .loss_mse import LossMse, LossMseCfg

__all__ = [
    "Loss",
    "get_losses",
    "LossDepth",
    "LossDepthCfg",
    "LossLpips",
    "LossLpipsCfg",
    "LossMse",
    "LossMseCfg",
]
