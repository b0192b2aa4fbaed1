"""Inter-layer types. Port of `pixelsplat_tpu/model/types.py`."""

from __future__ import annotations

from typing import NamedTuple

import torch


class Gaussians(NamedTuple):
    """The encoder->decoder contract: a flat set of Gaussians per batch element."""

    means: torch.Tensor  # (batch, gaussian, 3)
    covariances: torch.Tensor  # (batch, gaussian, 3, 3)
    harmonics: torch.Tensor  # (batch, gaussian, 3, d_sh)
    opacities: torch.Tensor  # (batch, gaussian)
