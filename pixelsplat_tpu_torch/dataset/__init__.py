"""Port of `pixelsplat_tpu/dataset`: the dataset registry."""

from typing import Optional

from ..utils.step_tracker import StepTracker
from .dataset import DatasetCfgCommon
from .dataset_re10k import DatasetRE10k, DatasetRE10kCfg
from .types import Stage
from .view_sampler import get_view_sampler

DATASETS = {"re10k": DatasetRE10k}

DatasetCfg = DatasetRE10kCfg


def get_dataset(
    cfg: DatasetCfg,
    stage: Stage,
    step_tracker: Optional[StepTracker],
    seed: int = 0,
    worker_id: int = 0,
    num_workers: int = 1,
) -> DatasetRE10k:
    view_sampler = get_view_sampler(
        cfg.view_sampler,
        stage,
        cfg.overfit_to_scene is not None,
        cfg.cameras_are_circular,
        step_tracker,
    )
    return DATASETS[cfg.name](
        cfg, stage, view_sampler, seed=seed, worker_id=worker_id, num_workers=num_workers
    )


__all__ = ["DATASETS", "DatasetCfg", "DatasetCfgCommon", "DatasetRE10k", "DatasetRE10kCfg", "get_dataset"]
