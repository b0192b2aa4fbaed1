"""Text labels rendered with PIL (numpy images, channel-first).

The port's own copy of `pixelsplat_tpu/visualization/annotation.py`: PIL's
default font stands in when the Inter font asset is absent.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
from PIL import Image, ImageDraw, ImageFont

from .layout import vcat

EXPECTED_FONT = Path("assets/Inter-Regular.otf")


def _load_font(font_path: Optional[Path], font_size: int):
    path = font_path or EXPECTED_FONT
    try:
        return ImageFont.truetype(str(path), font_size)
    except OSError:
        return ImageFont.load_default(font_size)


def draw_label(text: str, font_size: int = 24, font_path: Optional[Path] = None) -> np.ndarray:
    """Text -> (3, h, w) float image, black on white."""
    font = _load_font(font_path, font_size)
    bbox = ImageDraw.Draw(Image.new("RGB", (1, 1))).textbbox((0, 0), text, font=font)
    w = max(bbox[2] - bbox[0], 1)
    h = max(bbox[3] - bbox[1], 1)
    img = Image.new("RGB", (w + 2, h + 2), (255, 255, 255))
    ImageDraw.Draw(img).text((-bbox[0] + 1, -bbox[1] + 1), text, font=font, fill=(0, 0, 0))
    return np.asarray(img, np.float32).transpose(2, 0, 1) / 255.0


def add_label(image: np.ndarray, label: str, font_size: int = 24, font_path: Optional[Path] = None) -> np.ndarray:
    """The image with a text label stacked above it."""
    return vcat(draw_label(label, font_size=font_size, font_path=font_path), image, align="left", gap=4)
