"""CLI entry point: `python -m pixelsplat_tpu_torch.main [+experiment=re10k] [k=v ...]`.

Port of `pixelsplat_tpu/main.py`: composes the config from the YAML files
under `config/` with the overrides, builds the data module, the model
wrapper and the trainer, and runs `mode`.

`mode=train` (the default) trains with `Trainer.fit`: from
`checkpointing.load` when it is set, else from the latest checkpoint under
`output_dir/checkpoints` when there is one, else from fresh weights. It
writes `checkpoints/step_<n>` (a `torch.save` checkpoint of parameters,
Adam's state and the step), `local/metrics.jsonl` and the validation grids
`local/comparison/<step>.png` under `output_dir`. The losses, LPIPS's
among them, are built only for training; the LPIPS loss demands the
exported VGG weights unless `loss.lpips.allow_random_weights=true`.

    python -m pixelsplat_tpu_torch.main +experiment=re10k \\
        dataset.roots=[<re10k root>] output_dir=<dir>

`mode=test` loads the checkpoint that `checkpointing.load` names and runs
the evaluation protocol (`Trainer.test`). The evaluation on the card, on
the repo's fixture:

    python -m pixelsplat_tpu_torch.main +experiment=re10k mode=test \\
        dataset.roots=[tests/fixtures/re10k] dataset/view_sampler=evaluation \\
        dataset.view_sampler.index_path=tests/fixtures/evaluation_index_fixture.json \\
        checkpointing.load=<checkpoint> test.output_path=<dir>

The CLI always runs on the card and raises where there is none; callers
in Python may pass `device="cpu"` to `main`.

Several GPUs: one process per card, launched by torchrun (or with the JAX
package's `PIXELSPLAT_*` variables, or under SLURM with
`PIXELSPLAT_DISTRIBUTED=1`: `parallel/distributed.py`):

    torchrun --nproc_per_node=8 -m pixelsplat_tpu_torch.main +experiment=re10k \\
        dataset.roots=[<re10k root>] output_dir=<dir>

Each process trains on `cuda:LOCAL_RANK` over NCCL with its own share of
the data; the global batch is the configured batch times the number of
processes. Rank 0 logs, validates and saves.
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Union

import torch

from .config import RootCfg, load_config
from .dataset.data_module import DataModule
from .parallel import distributed
from .training.checkpoint import latest_checkpoint, load_checkpoint
from .training.model_wrapper import ModelWrapper, TrainState, resolve_device
from .training.trainer import Trainer
from .utils.step_tracker import StepTracker
from .utils.wandb_tools import select_logger, update_checkpoint_path


def cyan(text: str) -> str:
    return f"\033[36m{text}\033[0m"


def build_everything(
    cfg: RootCfg, device: Union[str, torch.device] = "cuda", global_rank: int = 0, world_size: int = 1
) -> Trainer:
    """The trainer over the data module (rank `global_rank` of `world_size`'s
    share of the data) and the model wrapper on `device`. The encoder's
    fresh weights come from `cfg.seed`, as the JAX `init_state`'s do."""
    step_tracker = StepTracker()
    data_module = DataModule(
        cfg.dataset, cfg.data_loader, step_tracker=step_tracker, global_rank=global_rank, world_size=world_size
    )
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.seed)
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
        # One wandb run per training: the other ranks log nothing.
        logger=select_logger(cfg.wandb if global_rank == 0 else None, output_dir),
        seed=cfg.seed,
    )


def main(argv: list[str], device: Union[str, torch.device] = "cuda") -> Union[TrainState, dict]:
    """Run the configured mode: `mode=train` returns the final `TrainState`,
    `mode=test` `Trainer.test`'s summary (of this rank's scenes).

    The process joins the group its environment names first
    (`parallel.distributed.maybe_initialize`: NCCL on the card, gloo on the
    CPU), runs on `cuda:LOCAL_RANK`, and leaves the group at the end."""
    device = resolve_device(device)
    created = not torch.distributed.is_initialized()
    rank, world = distributed.maybe_initialize(device)
    try:
        device = distributed.local_device(device)
        cfg = load_config(argv)
        print(cyan(f"mode={cfg.mode} rank={rank}/{world} device={device}"))
        if cfg.mode == "train":
            resume = update_checkpoint_path(cfg.checkpointing.load, cfg.wandb)
            if resume is None:
                resume = latest_checkpoint(Path(cfg.output_dir) / "checkpoints")
            return build_everything(cfg, device, rank, world).fit(resume_from=resume)
        if cfg.mode != "test":
            raise ValueError(f"Unknown mode {cfg.mode!r}")
        if cfg.checkpointing.load is None:
            raise ValueError("mode=test needs checkpointing.load")

        payload = load_checkpoint(update_checkpoint_path(cfg.checkpointing.load, cfg.wandb))
        trainer = build_everything(cfg, device, rank, world)
        trainer.wrapper.encoder.load_state_dict(payload["params"], strict=True)
        return trainer.test()
    finally:
        if created:
            distributed.destroy()


if __name__ == "__main__":
    main(sys.argv[1:])
