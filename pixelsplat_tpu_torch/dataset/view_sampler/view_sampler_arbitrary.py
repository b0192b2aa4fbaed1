"""Arbitrary (random or pinned) view sampler.

Port of `pixelsplat_tpu/dataset/view_sampler/view_sampler_arbitrary.py`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Literal, Optional

import numpy as np

from .view_sampler import ViewSampler
from .view_sampler_evaluation import add_third_context_index


@dataclass(frozen=True)
class ViewSamplerArbitraryCfg:
    name: Literal["arbitrary"] = "arbitrary"
    num_context_views: int = 2
    num_target_views: int = 1
    context_views: Optional[list[int]] = None
    target_views: Optional[list[int]] = None


class ViewSamplerArbitrary(ViewSampler[ViewSamplerArbitraryCfg]):
    def __init__(self, cfg: ViewSamplerArbitraryCfg, *args) -> None:
        super().__init__(cfg, *args)
        # Checked here, not in `sample`: the dataset skips an example whose
        # sampling raises ValueError, and a config that disagrees with
        # itself must fail the run instead.
        pinned = cfg.context_views
        if pinned is not None and len(pinned) != cfg.num_context_views and not (
            cfg.num_context_views == 3 and len(pinned) == 2
        ):
            raise ValueError(f"context_views {pinned} do not give {cfg.num_context_views} context views")
        if cfg.target_views is not None and len(cfg.target_views) != cfg.num_target_views:
            raise ValueError(f"target_views {cfg.target_views} do not give {cfg.num_target_views} target views")

    def sample(
        self,
        scene: str,
        extrinsics: np.ndarray,
        intrinsics: np.ndarray,
        rng: np.random.Generator,
    ) -> tuple[np.ndarray, np.ndarray]:
        num_views = extrinsics.shape[0]
        index_context = rng.integers(0, num_views, size=(self.cfg.num_context_views,))
        if self.cfg.context_views is not None:
            index_context = np.asarray(self.cfg.context_views, dtype=np.int64)
            if self.cfg.num_context_views == 3 and len(self.cfg.context_views) == 2:
                index_context = add_third_context_index(index_context)
        index_target = rng.integers(0, num_views, size=(self.cfg.num_target_views,))
        if self.cfg.target_views is not None:
            index_target = np.asarray(self.cfg.target_views, dtype=np.int64)
        return index_context, index_target

    @property
    def num_context_views(self) -> int:
        return self.cfg.num_context_views

    @property
    def num_target_views(self) -> int:
        return self.cfg.num_target_views
