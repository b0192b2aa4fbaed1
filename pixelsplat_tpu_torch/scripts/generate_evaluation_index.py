"""Evaluation index of a dataset: overlap-valid context pairs and targets.

    python -m pixelsplat_tpu_torch.scripts.generate_evaluation_index [overrides ...]

Port of `pixelsplat_tpu/scripts/generate_evaluation_index.py`: composes
`config/generate_evaluation_index.yaml` (the all-frames view sampler over
the test split; `index_generator.*` sets the walk) with the overrides, runs
`EvaluationIndexGenerator` over every scene and writes
`<index_generator.output_path>/evaluation_index.json`. Runs on the card
unless `main` is called with `device="cpu"`.
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Union

import numpy as np
import torch

from ..config import _convert, compose_config, load_typed_root_config
from ..dataset.data_module import DataModule
from ..evaluation.evaluation_index_generator import EvaluationIndexGenerator, EvaluationIndexGeneratorCfg
from ..training.model_wrapper import resolve_device

# The repo's fixture (`tests/fixtures/re10k`) holds scenes of 8 frames, too
# short for the configured gap of 45-135 frames: cut to 2-6.
FIXTURE_OVERRIDES = ["index_generator.min_distance=2", "index_generator.max_distance=6"]


def main(argv: list[str], device: Union[str, torch.device] = "cuda") -> Path:
    """Write the index; returns its path."""
    device = resolve_device(device)
    cfg_dict = compose_config(argv, main_name="generate_evaluation_index")
    generator_cfg = _convert(cfg_dict.pop("index_generator", {}), EvaluationIndexGeneratorCfg)
    root = load_typed_root_config(cfg_dict)

    data_module = DataModule(root.dataset, root.data_loader)
    generator = EvaluationIndexGenerator(generator_cfg, device=device)
    h, w = root.dataset.image_shape
    for i, batch in enumerate(data_module.test_dataloader()):
        generator.process_scene(
            batch["scene"][0],
            np.asarray(batch["target"]["extrinsics"][0]),
            np.asarray(batch["target"]["intrinsics"][0]),
            (h, w),
        )
        if (i + 1) % 25 == 0:
            print(f"{i + 1} scenes processed")
    path = generator.save_index()
    print(f"Wrote {path}")
    return path


if __name__ == "__main__":
    main(sys.argv[1:])
