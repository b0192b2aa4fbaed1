"""Encoder data shims: batch transforms run on device before encoding.

Port of `pixelsplat_tpu/model/encoder/data_shim.py`.
"""

from __future__ import annotations

from typing import Callable

from ...dataset.shims.bounds_shim import apply_bounds_shim
from ...dataset.shims.patch_shim import apply_patch_shim
from .encoder_epipolar import EncoderEpipolarCfg

DataShim = Callable[[dict], dict]


def get_data_shim(cfg: EncoderEpipolarCfg) -> DataShim:
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
