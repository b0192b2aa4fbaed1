"""All-frames view sampler (every frame is both context and target).

Port of `pixelsplat_tpu/dataset/view_sampler/view_sampler_all.py`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Literal

import numpy as np

from .view_sampler import ViewSampler


@dataclass(frozen=True)
class ViewSamplerAllCfg:
    name: Literal["all"] = "all"


class ViewSamplerAll(ViewSampler[ViewSamplerAllCfg]):
    def sample(
        self,
        scene: str,
        extrinsics: np.ndarray,
        intrinsics: np.ndarray,
        rng: np.random.Generator,
    ) -> tuple[np.ndarray, np.ndarray]:
        all_frames = np.arange(extrinsics.shape[0], dtype=np.int64)
        return all_frames, all_frames

    @property
    def num_context_views(self) -> int:
        return 0

    @property
    def num_target_views(self) -> int:
        return 0
