"""Encoder data shims: batch transforms run on device before encoding, one
for each encoder.

Port of `pixelsplat_tpu/model/encoder/data_shim.py`, with MVSplat's and
GS-LRM's shims beside pixelSplat's.
"""

from __future__ import annotations

from typing import Callable, Union

from ...dataset.shims.bounds_shim import apply_bounds_shim
from ...dataset.shims.patch_shim import apply_patch_shim
from .encoder_costvolume import EncoderCostVolumeCfg
from .encoder_epipolar import EncoderEpipolarCfg
from .encoder_gslrm import EncoderGslrmCfg

DataShim = Callable[[dict], dict]


def get_data_shim(cfg: Union[EncoderEpipolarCfg, EncoderCostVolumeCfg, EncoderGslrmCfg]) -> DataShim:
    """The shim of the encoder `cfg` configures. pixelSplat's: a centre crop
    to the epipolar transformer's patch multiple and, unless disabled, near
    and far from the context baseline. MVSplat's: a centre crop to a
    multiple of `shim_patch_size * downscale_factor`, the dataset's bounds
    kept. GS-LRM's: a centre crop to a multiple of its patch, the dataset's
    bounds kept."""
    if cfg.name in ("costvolume", "gslrm"):
        patch = cfg.patch_size if cfg.name == "gslrm" else cfg.shim_patch_size * cfg.downscale_factor

        def data_shim(batch: dict) -> dict:
            return apply_patch_shim(batch, patch_size=patch)

        return data_shim

    def data_shim(batch: dict) -> dict:
        batch = apply_patch_shim(
            batch,
            patch_size=cfg.epipolar_transformer.self_attention.patch_size
            * cfg.epipolar_transformer.downscale,
        )
        if cfg.apply_bounds_shim:
            _, _, _, h, w = batch["context"]["image"].shape
            batch = apply_bounds_shim(batch, cfg.near_disparity * min(h, w), 0.5)
        return batch

    return data_shim
