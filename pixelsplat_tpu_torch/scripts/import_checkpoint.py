"""Convert a published pixelSplat Lightning checkpoint into a checkpoint of
the port.

    python -m pixelsplat_tpu_torch.scripts.import_checkpoint re10k.ckpt outputs/imported/re10k \\
        [--device cuda] [+experiment=re10k overrides ...]

Port of `tools/import_checkpoint.py`: the encoder's weights are loaded from
the `.ckpt` (`interop/torch_import.py`), wrapped in a fresh train state
(Adam's moments empty, the step taken from the checkpoint's
`global_step`) and written with `training/checkpoint.py::save_checkpoint`
to `<out>/step_<global_step>`, which
`python -m pixelsplat_tpu_torch.main ... checkpointing.load=<that path>`
tests or resumes from. Runs on the card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from ..config import load_config
from ..interop.torch_import import load_lightning_checkpoint
from ..training.checkpoint import save_checkpoint
from ..training.model_wrapper import ModelWrapper


def main(argv: list[str]) -> Path:
    """Import the `.ckpt` into the output directory under the config the
    overrides compose; returns the checkpoint's path."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("ckpt", type=Path)
    parser.add_argument("out", type=Path)
    parser.add_argument("--device", default="cuda")
    args, overrides = parser.parse_known_args(argv)
    cfg = load_config(overrides)
    wrapper = ModelWrapper(
        cfg.model.encoder,
        cfg.model.decoder,
        device=args.device,
        optimizer_cfg=cfg.optimizer,
        train_cfg=cfg.train,
        gradient_clip_val=cfg.trainer.gradient_clip_val,
        test_cfg=cfg.test,
    )
    # The fresh state first: `init_state` grafts pretrained trunks where
    # their weights are on disk, and the checkpoint's weights replace them.
    state = wrapper.init_state()
    state.step = load_lightning_checkpoint(args.ckpt, wrapper.encoder)
    path = save_checkpoint(args.out, state.step, wrapper.state_dict(state))
    print(f"Imported {args.ckpt} (step {state.step}) -> {path}")
    return path


if __name__ == "__main__":
    main(sys.argv[1:])
