"""Horizontal-flip augmentation (host side, numpy).

Port of `pixelsplat_tpu/dataset/shims/augmentation_shim.py`: with
probability 1/2, flip the images horizontally and reflect the extrinsics
about x.
"""

from __future__ import annotations

import numpy as np

from ..types import AnyExample, AnyViews

_REFLECT = np.diag(np.asarray([-1.0, 1.0, 1.0, 1.0], np.float32))


def reflect_extrinsics(extrinsics: np.ndarray) -> np.ndarray:
    return _REFLECT @ extrinsics @ _REFLECT


def reflect_views(views: AnyViews) -> AnyViews:
    return {
        **views,
        "image": np.ascontiguousarray(views["image"][..., ::-1]),
        "extrinsics": reflect_extrinsics(views["extrinsics"]),
    }


def apply_augmentation_shim(example: AnyExample, rng: np.random.Generator) -> AnyExample:
    if rng.random() < 0.5:
        return example
    return {
        **example,
        "context": reflect_views(example["context"]),
        "target": reflect_views(example["target"]),
    }
