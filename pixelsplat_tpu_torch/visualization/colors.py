"""Distinct colour palette (numpy).

The port's own copy of `pixelsplat_tpu/visualization/colors.py`.
"""

from __future__ import annotations

import numpy as np

# 20 visually distinct colours (categorical palette), RGB in [0, 1].
DISTINCT_COLORS: np.ndarray = (
    np.asarray(
        [
            (230, 25, 75),
            (60, 180, 75),
            (255, 225, 25),
            (0, 130, 200),
            (245, 130, 48),
            (145, 30, 180),
            (70, 240, 240),
            (240, 50, 230),
            (210, 245, 60),
            (250, 190, 212),
            (0, 128, 128),
            (220, 190, 255),
            (170, 110, 40),
            (255, 250, 200),
            (128, 0, 0),
            (170, 255, 195),
            (128, 128, 0),
            (255, 215, 180),
            (0, 0, 128),
            (128, 128, 128),
        ],
        dtype=np.float32,
    )
    / 255.0
)


def get_distinct_color(index: int) -> tuple[float, float, float]:
    color = DISTINCT_COLORS[index % len(DISTINCT_COLORS)]
    return float(color[0]), float(color[1]), float(color[2])
