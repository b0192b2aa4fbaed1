"""Offline evaluation configuration.

Port of `pixelsplat_tpu/evaluation/evaluation_cfg.py`: the methods whose
rendered PNGs `MetricComputer` scores, where to write side-by-side
comparisons, and the highlighted scenes.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Optional


@dataclass(frozen=True)
class MethodCfg:
    name: str
    key: str
    path: Path


@dataclass(frozen=True)
class SceneCfg:
    scene: str
    target_index: int


@dataclass(frozen=True)
class EvaluationCfg:
    methods: tuple[MethodCfg, ...] = ()
    side_by_side_path: Optional[Path] = None
    animate_side_by_side: bool = False
    highlighted: tuple[SceneCfg, ...] = ()
