"""Offline metrics of rendered PNGs against the ground truth.

    python -m pixelsplat_tpu_torch.scripts.compute_metrics +evaluation=re10k [overrides ...]

Port of `pixelsplat_tpu/scripts/compute_metrics.py`: composes
`config/compute_metrics.yaml` (the evaluation view sampler over the test
split) with the overrides, `+evaluation=<name>` loading
`config/evaluation/<name>.yaml` (the methods and their PNG directories) on
top, and scores every method's frames of every scene with
`MetricComputer`; writes the means to `output_metrics_path`
(`metrics.json` by default). Runs on the card unless `main` is called with
`device="cpu"`. LPIPS is scored only with its exported weights on disk.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path
from typing import Union

import numpy as np
import torch

from ..config import CONFIG_ROOT, _convert, _deep_merge, _load_yaml, compose_config, load_typed_root_config
from ..dataset.data_module import DataModule
from ..evaluation.evaluation_cfg import EvaluationCfg
from ..evaluation.metric_computer import MetricComputer
from ..training.model_wrapper import resolve_device


def main(argv: list[str], device: Union[str, torch.device] = "cuda") -> MetricComputer:
    """Score the configured methods and write their means; returns the
    computer, which holds every view's scores in the loader's order."""
    device = resolve_device(device)
    overlays = [a for a in argv if a.startswith("+evaluation=")]
    rest = [a for a in argv if not a.startswith("+evaluation=")]
    cfg_dict = compose_config(rest, main_name="compute_metrics")
    for overlay in overlays:
        data, _ = _load_yaml(CONFIG_ROOT / "evaluation" / f"{overlay.split('=', 1)[1]}.yaml")
        data.pop("defaults", None)
        cfg_dict = _deep_merge(cfg_dict, data)

    evaluation_cfg = _convert(cfg_dict.pop("evaluation", {}), EvaluationCfg)
    output_metrics_path = Path(cfg_dict.pop("output_metrics_path", "metrics.json"))
    root = load_typed_root_config({k: v for k, v in cfg_dict.items() if k != "index_generator"})

    data_module = DataModule(root.dataset, root.data_loader)
    computer = MetricComputer(evaluation_cfg, device=device)
    if not computer.lpips_pretrained:
        print("WARNING: LPIPS weights not found; the metrics carry no LPIPS.")

    for batch in data_module.test_dataloader():
        computer.process_scene(
            batch["scene"][0],
            np.asarray(batch["target"]["image"][0]),
            np.asarray(batch["target"]["index"][0]).tolist(),
        )
        computer.print_preview()

    summary = computer.summary()
    output_metrics_path.parent.mkdir(exist_ok=True, parents=True)
    with output_metrics_path.open("w") as f:
        json.dump(summary, f)
    print(f"Wrote {output_metrics_path}")
    return computer


if __name__ == "__main__":
    main(sys.argv[1:])
