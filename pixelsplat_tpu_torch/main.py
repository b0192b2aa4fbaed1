"""CLI entry point: `python -m pixelsplat_tpu_torch.main [+experiment=re10k] [k=v ...]`.

Port of `pixelsplat_tpu/main.py`: composes the config from the YAML files
under `config/` with the overrides, builds the data module, the model
wrapper and the trainer, and runs `mode`. `mode=test` loads the
checkpoint that `checkpointing.load` names (a `torch.save` checkpoint of
this package, `training/checkpoint.py`) and runs the evaluation protocol
(`Trainer.test`). The evaluation on the card, on the repo's fixture:

    python -m pixelsplat_tpu_torch.main +experiment=re10k mode=test \\
        dataset.roots=[tests/fixtures/re10k] dataset/view_sampler=evaluation \\
        dataset.view_sampler.index_path=tests/fixtures/evaluation_index_fixture.json \\
        checkpointing.load=<checkpoint> test.output_path=<dir>

The CLI always runs on the card and raises where there is none; callers
in Python may pass `device="cpu"` to `main`.
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Optional, Union

import torch

from .config import RootCfg, load_config
from .dataset.data_module import DataModule
from .training.checkpoint import load_checkpoint
from .training.model_wrapper import ModelWrapper, resolve_device
from .training.trainer import Trainer
from .utils.step_tracker import StepTracker
from .utils.wandb_tools import select_logger, update_checkpoint_path


def cyan(text: str) -> str:
    return f"\033[36m{text}\033[0m"


def build_everything(cfg: RootCfg, device: Union[str, torch.device] = "cuda") -> Trainer:
    """The trainer over the data module and the model wrapper, for one
    process on one device."""
    step_tracker = StepTracker()
    data_module = DataModule(cfg.dataset, cfg.data_loader, step_tracker=step_tracker)
    wrapper = ModelWrapper(
        cfg.model.encoder,
        cfg.model.decoder,
        device=device,
        optimizer_cfg=cfg.optimizer,
        train_cfg=cfg.train,
        # Only training uses the losses. Built for `mode=test`, the LPIPS
        # loss would demand the pretrained VGG weights, which the test
        # protocol does without (it then reports lpips as null).
        loss_cfgs=cfg.loss if cfg.mode == "train" else (),
        gradient_clip_val=cfg.trainer.gradient_clip_val,
        test_cfg=cfg.test,
    )
    output_dir = Path(cfg.output_dir)
    return Trainer(
        cfg.trainer,
        wrapper,
        data_module,
        cfg.checkpointing,
        output_dir,
        step_tracker=step_tracker,
        logger=select_logger(cfg.wandb, output_dir),
        seed=cfg.seed,
    )


def main(argv: list[str], device: Union[str, torch.device] = "cuda") -> Optional[dict]:
    """Run the configured mode; `mode=test` returns `Trainer.test`'s summary."""
    cfg = load_config(argv)
    device = resolve_device(device)
    print(cyan(f"mode={cfg.mode} device={device}"))
    if cfg.mode == "train":
        raise NotImplementedError(
            "mode=train: Trainer.fit (training with validation and checkpoints) is not "
            "ported yet; it is ROADMAP.md queue 1, item 1"
        )
    if cfg.mode != "test":
        raise ValueError(f"Unknown mode {cfg.mode!r}")
    if cfg.checkpointing.load is None:
        raise ValueError("mode=test needs checkpointing.load")

    payload = load_checkpoint(update_checkpoint_path(cfg.checkpointing.load, cfg.wandb))
    trainer = build_everything(cfg, device)
    trainer.wrapper.encoder.load_state_dict(payload["params"], strict=True)
    return trainer.test()


if __name__ == "__main__":
    main(sys.argv[1:])
