"""wandb integration, used when the `wandb` package imports.

Port of `pixelsplat_tpu/utils/wandb_tools.py`: `select_logger` returns a
`WandbLogger` (scalars, images, videos and checkpoint artifacts through wandb,
everything also written by the wrapped `LocalLogger`) when wandb imports
and `wandb.mode` is not `disabled`, else the `LocalLogger`.
`update_checkpoint_path` passes plain paths through and resolves
`wandb://run_id[:version]` to the checkpoint file of the run's newest (or
the named) `model` artifact, downloaded under `checkpoints/`.
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


def version_to_int(artifact) -> int:
    """A wandb version string such as 'v12' as 12."""
    return int(artifact.version[1:])


def download_checkpoint(run_id: str, download_dir: Path, version: Optional[str]) -> Path:
    """Download the run's `model` artifact of `version` (None: the newest)
    into `download_dir/<run>/<version>` and return the one file it holds:
    `step_<n>` for the artifacts `WandbLogger.log_model` uploads. The JAX
    package's artifacts are orbax directories of many files and raise."""
    if not WANDB_AVAILABLE:
        raise RuntimeError("wandb:// checkpoint URIs require the wandb package")
    chosen = None
    for artifact in wandb.Api().run(run_id).logged_artifacts():
        if artifact.type != "model":
            continue
        if version is None:
            if chosen is None or version_to_int(artifact) > version_to_int(chosen):
                chosen = artifact
        elif artifact.version == version:
            chosen = artifact
    if chosen is None:
        raise ValueError(f"No matching checkpoint artifact for {run_id}:{version}")
    root = Path(download_dir) / run_id.replace("/", "_") / chosen.version
    root.mkdir(parents=True, exist_ok=True)
    files = sorted(p for p in Path(chosen.download(root=str(root))).rglob("*") if p.is_file())
    if len(files) != 1:
        raise ValueError(
            f"artifact {run_id}:{chosen.version} holds {len(files)} files, not one checkpoint file of this package"
        )
    return files[0]


def update_checkpoint_path(path: Optional[Union[str, Path]], wandb_cfg=None) -> Optional[Path]:
    """Plain paths pass through; `wandb://run_id[:version]` resolves, in the
    entity and project of `wandb_cfg`, to the checkpoint file of that run's
    `model` artifact (`download_checkpoint`, under `checkpoints/`)."""
    if path is None:
        return None
    path = str(path)
    if not path.startswith("wandb://"):
        return Path(path)
    run_id, *rest = path[len("wandb://") :].split(":")
    version = rest[0] if rest else None
    project = getattr(wandb_cfg, "project", "pixelsplat_tpu")
    entity = getattr(wandb_cfg, "entity", "")
    full_run = f"{entity}/{project}/{run_id}" if entity else f"{project}/{run_id}"
    return download_checkpoint(full_run, Path("checkpoints"), version)


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
