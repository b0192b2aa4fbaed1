"""Reference checkpoints: a published pixelSplat Lightning `.ckpt` loaded
into the port's encoder.

Port of `pixelsplat_tpu/interop/torch_import.py::load_lightning_checkpoint`.
The port keeps the reference's parameter names, so the encoder's entries
of the checkpoint's `state_dict` load with a strict `load_state_dict`; the
JAX package instead converts them onto its Flax tree (`convert_encoder`).

The one difference in layout is BatchNorm's step counter: the reference's
torchvision BatchNorm layers carry `num_batches_tracked` buffers, while the
port's frozen BatchNorm holds its statistics as parameters and has no
counter (`model/encoder/backbone/resnet.py::FrozenBatchNorm2d`). Those
entries are dropped by name; any other key the encoder lacks, or any
parameter the checkpoint lacks, still fails the load.

`load_params` is the one place that decides which files name a model's
weights: a Lightning `.ckpt`, a checkpoint of the port (`step_<n>`), or a
directory of them.
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Mapping, Union

import torch

from ..training.checkpoint import latest_checkpoint, load_checkpoint

ENCODER_PREFIX = "encoder."
BATCH_COUNTER = "num_batches_tracked"


def read_lightning_checkpoint(path: Union[str, Path]) -> dict:
    """The checkpoint's top-level dict, its tensors on the CPU."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        # Lightning pickles arbitrary Python objects beside the weights
        # (`hyper_parameters` holds the training config's objects, `loops`
        # and `callbacks` their state), which the restricted unpickler
        # refuses. The file is one the user names as the model to load,
        # and the reference itself reads it with the full unpickler.
        return torch.load(path, map_location="cpu", weights_only=False)


def encoder_state_dict(checkpoint: Mapping) -> dict[str, torch.Tensor]:
    """The encoder's entries of a Lightning checkpoint's `state_dict`,
    the `encoder.` prefix stripped and BatchNorm's `num_batches_tracked`
    counters dropped."""
    sd = checkpoint.get("state_dict", checkpoint)
    return {
        k[len(ENCODER_PREFIX):]: v
        for k, v in sd.items()
        if k.startswith(ENCODER_PREFIX) and k.rsplit(".", 1)[-1] != BATCH_COUNTER
    }


def load_lightning_checkpoint(path: Union[str, Path], encoder: torch.nn.Module) -> int:
    """Load a reference `.ckpt`'s encoder weights into `encoder` (copied to
    the encoder's device) with a strict `load_state_dict`; returns the
    checkpoint's `global_step`."""
    checkpoint = read_lightning_checkpoint(path)
    encoder.load_state_dict(encoder_state_dict(checkpoint), strict=True)
    return int(checkpoint.get("global_step", 0))


def load_params(ckpt: Union[str, Path], encoder: torch.nn.Module) -> None:
    """Load `ckpt` into `encoder`: a Lightning `.ckpt`, a checkpoint of the
    port (`step_<n>`), or a directory of them (the latest is read)."""
    ckpt = Path(ckpt)
    if ckpt.suffix == ".ckpt":
        load_lightning_checkpoint(ckpt, encoder)
        return
    if ckpt.is_dir():
        found = latest_checkpoint(ckpt)
        if found is None:
            raise FileNotFoundError(f"no step_<n> checkpoint in {ckpt}")
        ckpt = found
    encoder.load_state_dict(load_checkpoint(ckpt)["params"], strict=True)
