"""Evaluation index generator: pick context pairs by a walk over ray overlap.

Port of `pixelsplat_tpu/evaluation/evaluation_index_generator.py`: from a
random anchor frame, walk outward in both directions until the mutual
epipolar ray overlap falls into [min_overlap, max_overlap] and the frame
distance into [min_distance, max_distance]; pick a random valid partner
and `num_target_views` distinct random targets between the pair.

Each overlap is one batched `project_rays` over the frame's pixel rays on
the generator's device. The generator draws from
`np.random.default_rng(cfg.seed)` the same numbers in the same order as
the JAX package's, so both give the same index for the same scenes.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch

from ..geometry.epipolar_lines import project_rays
from ..geometry.projection import get_world_rays, sample_image_grid


@dataclass(frozen=True)
class EvaluationIndexGeneratorCfg:
    num_target_views: int = 3
    min_distance: int = 45
    max_distance: int = 135
    min_overlap: float = 0.6
    max_overlap: float = 1.0
    output_path: Path = Path("outputs/evaluation_index")
    save_previews: bool = False
    seed: int = 123


@dataclass(frozen=True)
class IndexEntry:
    context: tuple[int, int]
    target: tuple[int, ...]


def _overlap(extr_a, intr_a, extr_b, intr_b, grid) -> float:
    """Fraction of A's rays whose epipolar segments land inside B."""
    origins, directions = get_world_rays(grid, extr_a, intr_a)
    return float(project_rays(origins, directions, extr_b, intr_b).overlaps_image.float().mean())


class EvaluationIndexGenerator:
    def __init__(self, cfg: EvaluationIndexGeneratorCfg, device: Union[str, torch.device] = "cpu"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.rng = np.random.default_rng(cfg.seed)
        self.index: dict[str, Optional[IndexEntry]] = {}

    def process_scene(
        self,
        scene: str,
        extrinsics: np.ndarray,  # (v, 4, 4)
        intrinsics: np.ndarray,  # (v, 3, 3)
        image_shape: tuple[int, int],
    ) -> None:
        cfg = self.cfg
        v = extrinsics.shape[0]
        grid, _ = sample_image_grid(tuple(image_shape), self.device)
        grid = grid.reshape(-1, 2)
        extrinsics = torch.as_tensor(np.asarray(extrinsics, np.float32), device=self.device)
        intrinsics = torch.as_tensor(np.asarray(intrinsics, np.float32), device=self.device)

        for context_index in self.rng.permutation(v):
            context_index = int(context_index)
            valid: list[tuple[int, float, float]] = []
            for step in (1, -1):
                current = context_index + step * cfg.min_distance
                while 0 <= current < v:
                    overlap_a = _overlap(
                        extrinsics[current], intrinsics[current], extrinsics[context_index],
                        intrinsics[context_index], grid,
                    )
                    overlap_b = _overlap(
                        extrinsics[context_index], intrinsics[context_index], extrinsics[current],
                        intrinsics[current], grid,
                    )
                    overlap = min(overlap_a, overlap_b)
                    delta = abs(current - context_index)
                    if cfg.min_overlap <= overlap <= cfg.max_overlap:
                        valid.append((current, overlap_a, overlap_b))
                    if overlap < cfg.min_overlap or delta > cfg.max_distance:
                        break
                    current += step

            if valid:
                chosen, _, _ = valid[int(self.rng.integers(len(valid)))]
                left, right = min(chosen, context_index), max(chosen, context_index)
                # Distinct random targets between the context frames.
                while True:
                    targets = self.rng.integers(left, right + 1, size=cfg.num_target_views)
                    if len(set(targets.tolist())) == cfg.num_target_views:
                        break
                self.index[scene] = IndexEntry(context=(left, right), target=tuple(sorted(targets.tolist())))
                return
        self.index[scene] = None

    def save_index(self) -> Path:
        out = Path(self.cfg.output_path)
        out.mkdir(exist_ok=True, parents=True)
        path = out / "evaluation_index.json"
        with path.open("w") as f:
            json.dump({k: None if v is None else asdict(v) for k, v in self.index.items()}, f)
        return path


def expand_to_video_index(index_path: Path, output_path: Path) -> None:
    """The index with every frame between the two context views as a target."""
    with Path(index_path).open("r") as f:
        index_input = json.load(f)
    out = {}
    for scene, entry in index_input.items():
        if entry is None:
            out[scene] = None
            continue
        a, b = entry["context"]
        out[scene] = {"context": [a, b], "target": list(range(a, b + 1))}
    with Path(output_path).open("w") as f:
        json.dump(out, f)
