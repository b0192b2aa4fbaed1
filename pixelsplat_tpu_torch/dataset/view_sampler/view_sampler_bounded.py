"""Bounded view sampler with a curriculum-scheduled context gap.

Port of `pixelsplat_tpu/dataset/view_sampler/view_sampler_bounded.py`: the
gap between the two context frames widens linearly with the global step;
targets are drawn uniformly inside the gap; the test stage pins the full gap
and returns every frame between the context views as a target.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Literal

import numpy as np

from .view_sampler import ViewSampler


@dataclass(frozen=True)
class ViewSamplerBoundedCfg:
    name: Literal["bounded"] = "bounded"
    num_context_views: int = 2
    num_target_views: int = 1
    min_distance_between_context_views: int = 2
    max_distance_between_context_views: int = 6
    min_distance_to_context_views: int = 0
    warm_up_steps: int = 0
    initial_min_distance_between_context_views: int = 2
    initial_max_distance_between_context_views: int = 6


class ViewSamplerBounded(ViewSampler[ViewSamplerBoundedCfg]):
    def schedule(self, initial: int, final: int) -> int:
        fraction = self.global_step / self.cfg.warm_up_steps
        return min(initial + int((final - initial) * fraction), final)

    def sample(
        self,
        scene: str,
        extrinsics: np.ndarray,
        intrinsics: np.ndarray,
        rng: np.random.Generator,
    ) -> tuple[np.ndarray, np.ndarray]:
        num_views = extrinsics.shape[0]
        cfg = self.cfg

        if self.stage == "test":
            max_gap = cfg.max_distance_between_context_views
            min_gap = cfg.max_distance_between_context_views
        elif cfg.warm_up_steps > 0:
            max_gap = self.schedule(
                cfg.initial_max_distance_between_context_views,
                cfg.max_distance_between_context_views,
            )
            min_gap = self.schedule(
                cfg.initial_min_distance_between_context_views,
                cfg.min_distance_between_context_views,
            )
        else:
            max_gap = cfg.max_distance_between_context_views
            min_gap = cfg.min_distance_between_context_views

        if not self.cameras_are_circular:
            max_gap = min(num_views - 1, max_gap)
        min_gap = max(2 * cfg.min_distance_to_context_views, min_gap)
        if max_gap < min_gap:
            raise ValueError("Example does not have enough frames!")
        context_gap = int(rng.integers(min_gap, max_gap + 1))

        index_context_left = int(
            rng.integers(num_views if self.cameras_are_circular else num_views - context_gap)
        )
        if self.stage == "test":
            index_context_left = 0
        index_context_right = index_context_left + context_gap

        if self.is_overfitting:
            index_context_left = 0
            index_context_right = max_gap

        if self.stage == "test":
            index_target = np.arange(index_context_left, index_context_right + 1)
        else:
            index_target = rng.integers(
                index_context_left + cfg.min_distance_to_context_views,
                index_context_right + 1 - cfg.min_distance_to_context_views,
                size=(cfg.num_target_views,),
            )

        if self.cameras_are_circular:
            index_target = index_target % num_views
            index_context_right = index_context_right % num_views

        if cfg.num_context_views > 2:
            num_extra = cfg.num_context_views - 2
            extra_views: list[int] = []
            while len(set(extra_views)) != num_extra:
                extra_views = rng.integers(
                    index_context_left + 1, index_context_right, size=(num_extra,)
                ).tolist()
        else:
            extra_views = []

        return (
            np.asarray([index_context_left, *extra_views, index_context_right]),
            np.asarray(index_target),
        )

    @property
    def num_context_views(self) -> int:
        return self.cfg.num_context_views

    @property
    def num_target_views(self) -> int:
        return self.cfg.num_target_views
