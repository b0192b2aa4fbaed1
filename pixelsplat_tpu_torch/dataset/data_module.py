"""Data module: a `DataLoader` per stage over the chunked dataset.

Port of `pixelsplat_tpu/dataset/data_module.py` in PyTorch's own idiom: each
stage is a `torch.utils.data.IterableDataset` (`StageDataset`) under a
`DataLoader`. With `num_workers` > 0 the loader forks that many worker
processes; each builds its share of the dataset from `get_worker_info()` in
the global (rank x worker) id space, so the test stage's chunks are sharded
across hosts as well as workers. Workers touch only numpy, PIL and
`torch.load` on the CPU, never CUDA, so they may be forked after the parent
initialised the card. A worker that raises fails the loader.

Seeds follow the JAX package: the stage's seed (0 when unset) plus the
global rank, and each worker's generator adds its global worker id.
Batches are `collate`d numpy arrays, with the scene names as a list; an
incomplete last batch is dropped.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, Optional

import numpy as np
from torch.utils.data import DataLoader, IterableDataset, get_worker_info

from ..utils.step_tracker import StepTracker
from . import DatasetCfg, get_dataset
from .types import Stage
from .validation_wrapper import ValidationWrapper


@dataclass(frozen=True)
class DataLoaderStageCfg:
    batch_size: int = 1
    num_workers: int = 0
    persistent_workers: bool = False
    seed: Optional[int] = None


@dataclass(frozen=True)
class DataLoaderCfg:
    train: DataLoaderStageCfg = field(default_factory=DataLoaderStageCfg)
    test: DataLoaderStageCfg = field(default_factory=DataLoaderStageCfg)
    val: DataLoaderStageCfg = field(default_factory=DataLoaderStageCfg)


def collate(examples: list[dict]) -> dict:
    """Stack a list of nested dict examples into batched numpy arrays;
    leaves that are not arrays (scene names) become lists."""
    out: dict = {}
    for key, value in examples[0].items():
        if isinstance(value, dict):
            out[key] = collate([e[key] for e in examples])
        elif isinstance(value, np.ndarray):
            out[key] = np.stack([e[key] for e in examples])
        else:
            out[key] = [e[key] for e in examples]
    return out


class StageDataset(IterableDataset):
    """One stage's example stream. In a loader's worker process it yields
    that worker's share; `repeat` cycles the stream for as long as it
    yields anything."""

    def __init__(
        self,
        cfg: DatasetCfg,
        stage: Stage,
        step_tracker: Optional[StepTracker],
        seed: int,
        global_rank: int,
        world_size: int,
        repeat: bool,
    ):
        self.cfg = cfg
        self.stage = stage
        self.step_tracker = step_tracker
        self.seed = seed
        self.global_rank = global_rank
        self.world_size = world_size
        self.repeat = repeat

    def __iter__(self) -> Iterator[dict]:
        info = get_worker_info()
        worker_id, num_workers = (0, 1) if info is None else (info.id, info.num_workers)
        dataset = get_dataset(
            self.cfg,
            self.stage,
            self.step_tracker,
            seed=self.seed,
            worker_id=self.global_rank * num_workers + worker_id,
            num_workers=self.world_size * num_workers,
        )
        while True:
            produced = False
            for example in dataset:
                produced = True
                yield example
            if not self.repeat or not produced:
                return


class DataModule:
    def __init__(
        self,
        dataset_cfg: DatasetCfg,
        data_loader_cfg: DataLoaderCfg,
        step_tracker: Optional[StepTracker] = None,
        global_rank: int = 0,
        world_size: int = 1,
    ) -> None:
        self.dataset_cfg = dataset_cfg
        self.data_loader_cfg = data_loader_cfg
        self.step_tracker = step_tracker
        self.global_rank = global_rank
        self.world_size = world_size

    def _loader(self, stage: Stage, stage_cfg: DataLoaderStageCfg, repeat: bool) -> DataLoader:
        seed = (stage_cfg.seed if stage_cfg.seed is not None else 0) + self.global_rank
        dataset = StageDataset(
            self.dataset_cfg, stage, self.step_tracker, seed, self.global_rank, self.world_size, repeat
        )
        return DataLoader(
            dataset,
            batch_size=stage_cfg.batch_size,
            num_workers=stage_cfg.num_workers,
            collate_fn=collate,
            drop_last=True,
            persistent_workers=stage_cfg.persistent_workers and stage_cfg.num_workers > 0,
        )

    def train_dataloader(self) -> DataLoader:
        return self._loader("train", self.data_loader_cfg.train, repeat=True)

    def val_dataloader(self) -> Iterator[dict]:
        """One batch per validation pass, from a stream kept across passes."""
        cfg = self.data_loader_cfg.val
        return iter(ValidationWrapper(lambda: self._loader("val", cfg, repeat=True), 1))

    def test_dataloader(self) -> DataLoader:
        return self._loader("test", self.data_loader_cfg.test, repeat=False)
