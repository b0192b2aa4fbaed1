"""Common dataset configuration.

Port of `pixelsplat_tpu/dataset/dataset.py`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from .view_sampler import ViewSamplerBoundedCfg, ViewSamplerCfg


@dataclass(frozen=True)
class DatasetCfgCommon:
    image_shape: tuple[int, int] = (180, 320)
    background_color: tuple[float, float, float] = (0.0, 0.0, 0.0)
    cameras_are_circular: bool = False
    overfit_to_scene: Optional[str] = None
    view_sampler: ViewSamplerCfg = field(default_factory=ViewSamplerBoundedCfg)
