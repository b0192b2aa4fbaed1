"""Image composition: overlay / hcat / vcat / add_border / resize (numpy).

The port's own copy of `pixelsplat_tpu/visualization/layout.py`. Images are
host-side numpy arrays shaped (channel, height, width) in [0, 1].
"""

from __future__ import annotations

from typing import Iterable, Literal, Union

import numpy as np
from PIL import Image

Alignment = Literal["start", "center", "end"]
Axis = Literal["horizontal", "vertical"]
Color = Union[int, float, Iterable[int], Iterable[float]]


def _sanitize_color(color: Color) -> np.ndarray:
    if isinstance(color, (int, float)):
        color = [color]
    return np.asarray(color, np.float32)


def _intersperse(iterable, delimiter):
    it = iter(iterable)
    try:
        yield next(it)
    except StopIteration:
        return
    for item in it:
        yield delimiter
        yield item


def overlay(
    main: np.ndarray,
    overlay_img: np.ndarray,
    main_offset: tuple[int, int],
    overlay_offset: tuple[int, int],
) -> np.ndarray:
    """`overlay_img` from `overlay_offset` on, pasted into `main` at
    `main_offset` and cut at `main`'s edges."""
    main = main.copy()
    mo_r, mo_c = main_offset
    oo_r, oo_c = overlay_offset
    _, h, w = overlay_img.shape
    main[:, mo_r : mo_r + h, mo_c : mo_c + w] = overlay_img[:, oo_r:, oo_c:][
        :, : main.shape[1] - mo_r, : main.shape[2] - mo_c
    ]
    return main


def cat(
    axis: Axis,
    *images: np.ndarray,
    align: Alignment = "center",
    gap: int = 8,
    gap_color: Color = 1.0,
) -> np.ndarray:
    """Concatenate images along an axis with a gap between them, padding
    the other axis with white to the largest image's size."""
    images = [np.asarray(im, np.float32) for im in images]
    gap_color_arr = _sanitize_color(gap_color)

    ax = 1 if axis == "vertical" else 2
    other = 2 if axis == "vertical" else 1
    size_other = max(im.shape[other] for im in images)

    padded = []
    for im in images:
        pad_total = size_other - im.shape[other]
        if align == "start":
            before = 0
        elif align == "end":
            before = pad_total
        else:
            before = pad_total // 2
        pads = [(0, 0), (0, 0), (0, 0)]
        pads[other] = (before, pad_total - before)
        padded.append(np.pad(im, pads, constant_values=1.0))
    if gap > 0:
        shape = list(padded[0].shape)
        shape[ax] = gap
        gap_img = np.ones(shape, np.float32) * gap_color_arr.reshape(-1, 1, 1)
        padded = list(_intersperse(padded, gap_img))
    fixed = []
    for im in padded:
        if im.shape[other] != size_other:
            pads = [(0, 0), (0, 0), (0, 0)]
            pads[other] = (0, size_other - im.shape[other])
            im = np.pad(im, pads, constant_values=1.0)
        fixed.append(im)
    return np.concatenate(fixed, axis=ax)


def hcat(*images: np.ndarray, align: str = "start", gap: int = 8, gap_color: Color = 1.0):
    return cat(
        "horizontal",
        *images,
        align={"start": "start", "top": "start", "center": "center", "end": "end", "bottom": "end"}[align],
        gap=gap,
        gap_color=gap_color,
    )


def vcat(*images: np.ndarray, align: str = "start", gap: int = 8, gap_color: Color = 1.0):
    return cat(
        "vertical",
        *images,
        align={"start": "start", "left": "start", "center": "center", "end": "end", "right": "end"}[align],
        gap=gap,
        gap_color=gap_color,
    )


def add_border(image: np.ndarray, border: int = 8, color: Color = 1.0) -> np.ndarray:
    color_arr = _sanitize_color(color).reshape(-1, 1, 1)
    c, h, w = image.shape
    out = np.ones((c, h + 2 * border, w + 2 * border), np.float32) * color_arr
    out[:, border : border + h, border : border + w] = image
    return out


def resize(
    image: np.ndarray,
    shape: tuple[int, int] | None = None,
    width: int | None = None,
    height: int | None = None,
) -> np.ndarray:
    """Lanczos resize through 8-bit PIL to `shape` (h, w), or to `width` or
    `height` keeping the aspect ratio."""
    c, h, w = image.shape
    assert (shape is not None) + (width is not None) + (height is not None) == 1
    if width is not None:
        shape = (int(h * width / w), width)
    elif height is not None:
        shape = (height, int(w * height / h))
    img = (np.clip(image, 0, 1) * 255).astype(np.uint8).transpose(1, 2, 0)
    if img.shape[-1] == 1:
        img = img[..., 0]
    resized = Image.fromarray(img).resize((shape[1], shape[0]), Image.LANCZOS)
    out = np.asarray(resized, np.float32) / 255.0
    if out.ndim == 2:
        out = out[..., None]
    return out.transpose(2, 0, 1)
