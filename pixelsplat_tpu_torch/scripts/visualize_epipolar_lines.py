"""Epipolar geometry smoke script: random pixels' epipolar lines.

    python -m pixelsplat_tpu_torch.scripts.visualize_epipolar_lines [out_dir]

Port of `pixelsplat_tpu/scripts/visualize_epipolar_lines.py`: four random
pixels of view A (seeded), each ray projected into view B of a synthetic
camera pair, and the visible segment drawn over view B with its near end
marked. Needs no kernel. Writes PNGs to `out_dir`
(outputs/epipolar_lines). Runs on the card unless `main` is called with
`device="cpu"`.
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Union

import numpy as np
import torch

from ..geometry.epipolar_lines import project_rays
from ..geometry.projection import get_world_rays
from ..training.model_wrapper import resolve_device
from ..utils.image_io import save_image
from ..visualization.drawing.lines import draw_lines
from ..visualization.drawing.points import draw_points


def main(argv: list[str], device: Union[str, torch.device] = "cuda") -> dict[int, np.ndarray]:
    """Draw and write the lines; returns {pixel index: (3, h, w) image}."""
    device = resolve_device(device)
    out_dir = Path(argv[0]) if argv else Path("outputs/epipolar_lines")
    rng = np.random.default_rng(0)

    intr = torch.tensor([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1.0]], device=device)
    cam_a = torch.eye(4, device=device)
    cam_b = torch.eye(4, device=device)
    cam_b[:3, 3] = torch.tensor([1.0, 0.1, -0.2], device=device)

    h = w = 256
    image_b = torch.full((3, h, w), 0.25, device=device)

    canvases = {}
    for i in range(4):
        xy = torch.as_tensor(rng.uniform(0.2, 0.8, (1, 2)).astype(np.float32), device=device)
        origins, directions = get_world_rays(xy, cam_a, intr)
        seg = project_rays(origins, directions, cam_b[None], intr[None])
        if not bool(seg.overlaps_image[0]):
            print(f"pixel {xy.cpu().numpy()[0]} has no epipolar overlap; skipping")
            continue
        start = seg.xy_min[0].cpu().numpy() * [w, h]
        end = seg.xy_max[0].cpu().numpy() * [w, h]
        canvas = draw_lines(image_b, start[None], end[None], (0.2, 0.9, 0.2), 3.0, cap="round")
        canvas = draw_points(canvas, start[None], (1.0, 0.2, 0.2), 5.0)
        canvases[i] = canvas.cpu().numpy()
        save_image(canvases[i], out_dir / f"line_{i}.png")
    print(f"Wrote epipolar line visualizations to {out_dir}")
    return canvases


if __name__ == "__main__":
    main(sys.argv[1:])
