"""The system under test, `pixelsplat_tpu_torch`, built from a
configuration file: its `ModelWrapper` with the file's encoder settings
over the named experiment's, and the seed's weights.
The rasterizer keeps the program's own settings: they are how the program
renders, not what the model is."""

from __future__ import annotations

import dataclasses

import torch

from . import weights as wts


def overlay(cfg, values: dict, complete: bool):
    """`cfg` (a frozen dataclass) with `values`' entries, nested
    dataclasses entry by entry. With `complete`, every field must be given,
    so that the file alone says what runs."""
    names = {f.name for f in dataclasses.fields(cfg)}
    unknown = set(values) - names
    if unknown:
        raise KeyError(f"{type(cfg).__name__} has no field {sorted(unknown)}")
    if complete and names - set(values):
        raise KeyError(f"{type(cfg).__name__}: the configuration leaves out {sorted(names - set(values))}")
    changes = {}
    for key, value in values.items():
        current = getattr(cfg, key)
        if dataclasses.is_dataclass(current):
            changes[key] = overlay(current, value, complete)
        elif isinstance(current, tuple):
            changes[key] = tuple(value)
        else:
            changes[key] = value
    return dataclasses.replace(cfg, **changes)


def model_cfgs(config: dict):
    from pixelsplat_tpu_torch.config import EXPERIMENTS

    encoder, decoder = EXPERIMENTS[config["experiment"]][0]()
    encoder = overlay(encoder, config["encoder"], complete=True)
    decoder = overlay(decoder, config["decoder"], complete=False)
    return encoder, decoder


def build(config: dict, seed: int, device):
    """The wrapper with the seed's weights loaded."""
    from pixelsplat_tpu_torch.training.model_wrapper import ModelWrapper

    encoder_cfg, decoder_cfg = model_cfgs(config)
    wrapper = ModelWrapper(encoder_cfg, decoder_cfg, device=device)
    wrapper.encoder.load_state_dict(wts.encoder_weights(wts.shapes_of(wrapper.encoder), seed, device), strict=True)
    return wrapper


def set_precision(config: dict) -> None:
    """The configuration's precision: float32 with TF32 off or on."""
    if config["precision"]["dtype"] != "float32":
        raise ValueError("the benchmark's configurations compute in float32")
    allow = bool(config["precision"]["allow_tf32"])
    torch.backends.cuda.matmul.allow_tf32 = allow
    torch.backends.cudnn.allow_tf32 = allow
