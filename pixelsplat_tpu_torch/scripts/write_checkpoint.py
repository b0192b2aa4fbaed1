"""Write a checkpoint of an experiment's model with seeded random weights.

    python -m pixelsplat_tpu_torch.scripts.write_checkpoint --out DIR [--model re10k] [--seed 0]

The weights come from `eval_scene.init_random_weights` with a seeded
`torch.Generator` on the card; the file (`DIR/step_0`, what
`training/checkpoint.py::save_checkpoint` writes) is what
`python -m pixelsplat_tpu_torch.main ... mode=test checkpointing.load=DIR/step_0`
reads. No trained weights exist for the port; this is what the evaluation
protocol runs on until they do.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch

from ..config import EXPERIMENTS
from ..training.checkpoint import save_checkpoint
from ..training.model_wrapper import ModelWrapper
from .eval_scene import init_random_weights


def write_checkpoint(out: Path, model: str = "re10k", seed: int = 0, device: str = "cuda") -> Path:
    encoder_cfg, decoder_cfg = EXPERIMENTS[model][0]()
    wrapper = ModelWrapper(encoder_cfg, decoder_cfg, device=device)
    init_random_weights(wrapper.encoder, torch.Generator(device=wrapper.device).manual_seed(seed))
    return save_checkpoint(Path(out), 0, wrapper.state_dict(wrapper.init_state()))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", type=Path, required=True)
    parser.add_argument("--model", default="re10k", choices=sorted(EXPERIMENTS))
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    print(write_checkpoint(args.out, args.model, args.seed))


if __name__ == "__main__":
    main()
