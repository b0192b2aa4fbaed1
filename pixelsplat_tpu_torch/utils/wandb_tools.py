"""The part of `pixelsplat_tpu/utils/wandb_tools.py` that `main` calls.

wandb is not part of the port's environment: `select_logger` returns the
`LocalLogger`, and `update_checkpoint_path` passes plain paths through and
refuses `wandb://` URIs.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Union

from .local_logger import LocalLogger


def update_checkpoint_path(path: Optional[Union[str, Path]], wandb_cfg=None) -> Optional[Path]:
    if path is None:
        return None
    path = str(path)
    if path.startswith("wandb://"):
        raise ValueError(
            f"{path}: wandb:// checkpoint URIs need wandb, which the port does not use; "
            "download the checkpoint and pass its path"
        )
    return Path(path)


def select_logger(wandb_cfg, output_dir: Path) -> LocalLogger:
    """The LocalLogger under `output_dir/local`, whatever `wandb.mode` says."""
    return LocalLogger(Path(output_dir) / "local")
