"""Image IO: arrays <-> PNG (numpy, channel-first).

Port of `pixelsplat_tpu/utils/image_io.py` (without `fig_to_image`, which
only the visualizations use).
"""

from __future__ import annotations

from pathlib import Path
from typing import Union

import numpy as np
from PIL import Image


def prep_image(image: np.ndarray) -> np.ndarray:
    """(h,w) | (c,h,w) | (b,c,h,w) float [0,1] -> (h, w, c) uint8."""
    image = np.asarray(image)
    if image.ndim == 4:
        b, c, h, w = image.shape
        image = image.transpose(1, 2, 0, 3).reshape(c, h, b * w)
    if image.ndim == 2:
        image = image[None]
    if image.shape[0] == 1:
        image = np.repeat(image, 3, axis=0)
    if image.shape[0] not in (3, 4):
        raise ValueError(f"an image has 1, 3 or 4 channels, not {image.shape[0]}")
    image = (np.clip(image, 0, 1) * 255).astype(np.uint8)
    return image.transpose(1, 2, 0)


def save_image(image: np.ndarray, path: Union[Path, str]) -> None:
    """Save a [0,1] float image, creating parent directories."""
    path = Path(path)
    path.parent.mkdir(exist_ok=True, parents=True)
    Image.fromarray(prep_image(image)).save(path)


def load_image(path: Union[Path, str]) -> np.ndarray:
    """PNG/JPEG -> (3, h, w) float [0,1]."""
    img = np.asarray(Image.open(path), dtype=np.float32) / 255.0
    if img.ndim == 2:
        img = img[..., None]
    return img[..., :3].transpose(2, 0, 1)
