"""Checkpointing of the full train state with `torch.save`.

Port of `pixelsplat_tpu/training/checkpoint.py`: a checkpoint carries the
parameters, the optimizer state and the step, under `step_{n}` in the
checkpoint directory; all are kept.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Optional

import torch


def save_checkpoint(directory: Path, step: int, state: dict) -> Path:
    """Write `state` (nested dicts of tensors and numbers, as
    `ModelWrapper.state_dict` gives) to `directory/step_{step}`."""
    directory = Path(directory).resolve()
    directory.mkdir(parents=True, exist_ok=True)
    path = directory / f"step_{step}"
    torch.save(state, path)
    return path


def load_checkpoint(path: Path, map_location: Any = "cpu") -> dict:
    path = Path(path).resolve()
    if path.is_dir():
        # The JAX package's orbax checkpoints are directories, and reading
        # one needs JAX.
        raise ValueError(
            f"{path} is a directory, not a checkpoint of this package (one torch.save file): "
            "an orbax checkpoint of the JAX package cannot be read without JAX. Convert its "
            "parameters in a process that has both packages with "
            "pixelsplat_tpu_torch/interop/from_jax.py::load_from_jax, then save_checkpoint"
        )
    return torch.load(path, map_location=map_location, weights_only=True)


def latest_checkpoint(directory: Path) -> Optional[Path]:
    directory = Path(directory)
    if not directory.exists():
        return None
    candidates = sorted(
        (p for p in directory.iterdir() if p.name.startswith("step_")),
        key=lambda p: int(p.name.split("_")[1]),
    )
    return candidates[-1] if candidates else None
