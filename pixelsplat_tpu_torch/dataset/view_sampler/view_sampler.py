"""View sampler base.

Port of `pixelsplat_tpu/dataset/view_sampler/view_sampler.py`. Samplers run
on the host (numpy) inside the input pipeline: given a scene's cameras they
pick context and target frame indices, drawing from the dataset's
`np.random.Generator`. The training curriculum reads the trainer's global
step through a StepTracker.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Generic, Optional, TypeVar

import numpy as np

from ...utils.step_tracker import StepTracker
from ..types import Stage

T = TypeVar("T")


class ViewSampler(ABC, Generic[T]):
    def __init__(
        self,
        cfg: T,
        stage: Stage,
        is_overfitting: bool,
        cameras_are_circular: bool,
        step_tracker: Optional[StepTracker],
    ) -> None:
        self.cfg = cfg
        self.stage = stage
        self.is_overfitting = is_overfitting
        self.cameras_are_circular = cameras_are_circular
        self.step_tracker = step_tracker

    @abstractmethod
    def sample(
        self,
        scene: str,
        extrinsics: np.ndarray,  # (view, 4, 4)
        intrinsics: np.ndarray,  # (view, 3, 3)
        rng: np.random.Generator,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Returns (context_indices, target_indices)."""

    @property
    @abstractmethod
    def num_target_views(self) -> int: ...

    @property
    @abstractmethod
    def num_context_views(self) -> int: ...

    @property
    def global_step(self) -> int:
        return 0 if self.step_tracker is None else self.step_tracker.get_step()
