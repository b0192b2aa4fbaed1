"""Host-side rescale and centre crop of the views (numpy and PIL).

Port of `pixelsplat_tpu/dataset/shims/crop_shim.py`: a Lanczos rescale of
each frame through 8 bits so that it covers the target shape, a centre
crop, and the intrinsics fix-up (normalized intrinsics change only by the
fx / fy scale factors).
"""

from __future__ import annotations

import numpy as np
from PIL import Image

from ..types import AnyExample, AnyViews


def rescale(image: np.ndarray, shape: tuple[int, int]) -> np.ndarray:
    """image (3, h, w) float [0,1] -> (3, h_out, w_out), Lanczos."""
    h, w = shape
    img = (image * 255).clip(0, 255).astype(np.uint8).transpose(1, 2, 0)
    img = Image.fromarray(img).resize((w, h), Image.LANCZOS)
    return (np.asarray(img, dtype=np.float32) / 255.0).transpose(2, 0, 1)


def center_crop(
    images: np.ndarray,  # (..., c, h, w)
    intrinsics: np.ndarray,  # (..., 3, 3)
    shape: tuple[int, int],
) -> tuple[np.ndarray, np.ndarray]:
    *_, h_in, w_in = images.shape
    h_out, w_out = shape
    row = (h_in - h_out) // 2
    col = (w_in - w_out) // 2
    images = images[..., :, row : row + h_out, col : col + w_out]
    intrinsics = intrinsics.copy()
    intrinsics[..., 0, 0] *= w_in / w_out
    intrinsics[..., 1, 1] *= h_in / h_out
    return images, intrinsics


def rescale_and_crop(
    images: np.ndarray,  # (..., c, h, w)
    intrinsics: np.ndarray,
    shape: tuple[int, int],
) -> tuple[np.ndarray, np.ndarray]:
    *batch, c, h_in, w_in = images.shape
    h_out, w_out = shape
    if h_out > h_in or w_out > w_in:
        raise ValueError(f"cannot crop {(h_in, w_in)} frames to {shape}")

    scale_factor = max(h_out / h_in, w_out / w_in)
    h_scaled = round(h_in * scale_factor)
    w_scaled = round(w_in * scale_factor)
    assert h_scaled == h_out or w_scaled == w_out

    flat = images.reshape(-1, c, h_in, w_in)
    flat = np.stack([rescale(im, (h_scaled, w_scaled)) for im in flat])
    images = flat.reshape(*batch, c, h_scaled, w_scaled)
    return center_crop(images, intrinsics, shape)


def apply_crop_shim_to_views(views: AnyViews, shape: tuple[int, int]) -> AnyViews:
    images, intrinsics = rescale_and_crop(views["image"], views["intrinsics"], shape)
    return {**views, "image": images, "intrinsics": intrinsics}


def apply_crop_shim(example: AnyExample, shape: tuple[int, int]) -> AnyExample:
    return {
        **example,
        "context": apply_crop_shim_to_views(example["context"], shape),
        "target": apply_crop_shim_to_views(example["target"], shape),
    }
