"""wandb integration, used when the `wandb` package imports.

Port of `pixelsplat_tpu/utils/wandb_tools.py`: `select_logger` returns a
`WandbLogger` (scalars, images, videos and checkpoint artifacts through wandb,
everything also written by the wrapped `LocalLogger`) when wandb imports
and `wandb.mode` is not `disabled`, else the `LocalLogger`.
`update_checkpoint_path` passes plain paths through and refuses the JAX
package's `wandb://run_id[:version]` checkpoint URIs, whose artifacts are
orbax directories the port does not read.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Union

from .local_logger import LocalLogger

try:  # an optional dependency
    import wandb  # type: ignore

    WANDB_AVAILABLE = True
except ImportError:
    wandb = None
    WANDB_AVAILABLE = False


def update_checkpoint_path(path: Optional[Union[str, Path]], wandb_cfg=None) -> Optional[Path]:
    """Plain paths pass through; `wandb://` URIs are refused (download the
    checkpoint and pass its path)."""
    if path is None:
        return None
    path = str(path)
    if path.startswith("wandb://"):
        raise ValueError(f"{path}: wandb:// checkpoint URIs are not resolved; download the checkpoint and pass its path")
    return Path(path)


class WandbLogger:
    """`LocalLogger`'s interface through wandb: scalars, images, videos and
    checkpoint artifacts (the reference's `log_model="all"`). The wrapped
    LocalLogger writes everything too, so a dropped connection loses no
    local copy."""

    def __init__(self, cfg, output_dir: Path, config_dict: Optional[dict] = None):
        self.local = LocalLogger(Path(output_dir) / "local")
        self.run = None
        if WANDB_AVAILABLE and getattr(cfg, "mode", "disabled") != "disabled":
            self.run = wandb.init(
                project=cfg.project,
                entity=cfg.entity or None,
                name=cfg.name,
                mode=cfg.mode,
                tags=list(getattr(cfg, "tags", ()) or ()),
                dir=str(output_dir),
                config=config_dict,
            )

    @property
    def path(self) -> Path:
        return self.local.path

    def log_metrics(self, metrics: dict, step=None) -> None:
        self.local.log_metrics(metrics, step=step)
        if self.run is not None:
            wandb.log(metrics, step=step)

    def log_image(self, key: str, image, step=None) -> None:
        self.local.log_image(key, image, step=step)
        if self.run is not None:
            wandb.log({key: wandb.Image(str(self.local.path / key / f"{step or 0:0>6}.png"))}, step=step)

    def log_video(self, key: str, frames, step=None, fps: int = 30) -> Path:
        path = self.local.log_video(key, frames, step=step, fps=fps)
        if self.run is not None:
            # wandb.Video reads the encoded file, an MP4 or the GIF.
            wandb.log({key: wandb.Video(str(path), fps=fps)}, step=step)
        return path

    def log_model(self, checkpoint_path, step=None) -> None:
        """Upload a checkpoint file as a model artifact."""
        if self.run is None:
            return
        artifact = wandb.Artifact(f"model-{self.run.id}", type="model")
        artifact.add_file(str(checkpoint_path))
        self.run.log_artifact(artifact, aliases=[f"step-{step}"] if step else None)

    def finish(self) -> None:
        if self.run is not None:
            self.run.finish()


def select_logger(wandb_cfg, output_dir: Path, config_dict: Optional[dict] = None):
    """A `WandbLogger` when wandb imports and `wandb_cfg.mode` asks for it,
    else the `LocalLogger` under `output_dir/local`."""
    if WANDB_AVAILABLE and getattr(wandb_cfg, "mode", "disabled") != "disabled":
        return WandbLogger(wandb_cfg, Path(output_dir), config_dict)
    return LocalLogger(Path(output_dir) / "local")
