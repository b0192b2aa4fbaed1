"""Evaluation view sampler: frame indices from a published JSON index.

Port of `pixelsplat_tpu/dataset/view_sampler/view_sampler_evaluation.py`
(format: {scene: {"context": [l, r], "target": [...]} | null}). With a
2-view index and num_context_views == 3, the midpoint frame is inserted as
the third context view.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Literal, Optional

import numpy as np

from ...utils.step_tracker import StepTracker
from ..types import Stage
from .view_sampler import ViewSampler


@dataclass(frozen=True)
class ViewSamplerEvaluationCfg:
    name: Literal["evaluation"] = "evaluation"
    index_path: Path = Path("assets/evaluation_index_re10k.json")
    num_context_views: int = 2


def add_third_context_index(indices: np.ndarray) -> np.ndarray:
    left, right = indices[..., 0], indices[..., 1]
    return np.stack((left, (left + right) // 2, right), axis=-1)


class ViewSamplerEvaluation(ViewSampler[ViewSamplerEvaluationCfg]):
    def __init__(
        self,
        cfg: ViewSamplerEvaluationCfg,
        stage: Stage,
        is_overfitting: bool,
        cameras_are_circular: bool,
        step_tracker: Optional[StepTracker],
    ) -> None:
        super().__init__(cfg, stage, is_overfitting, cameras_are_circular, step_tracker)
        with Path(cfg.index_path).open("r") as f:
            self.index = json.load(f)

    def sample(
        self,
        scene: str,
        extrinsics: np.ndarray,
        intrinsics: np.ndarray,
        rng: np.random.Generator,
    ) -> tuple[np.ndarray, np.ndarray]:
        entry = self.index.get(scene)
        if entry is None:
            raise ValueError(f"No indices available for scene {scene}.")
        context_indices = np.asarray(entry["context"], dtype=np.int64)
        target_indices = np.asarray(entry["target"], dtype=np.int64)

        v = self.cfg.num_context_views
        if v > len(context_indices) and v == 3:
            context_indices = add_third_context_index(context_indices)
        return context_indices, target_indices

    @property
    def num_context_views(self) -> int:
        return 0

    @property
    def num_target_views(self) -> int:
        return 0
