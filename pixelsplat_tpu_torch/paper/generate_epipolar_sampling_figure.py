"""Epipolar sampling explainer figure (the paper's method figure).

Port of `pixelsplat_tpu/paper/generate_epipolar_sampling_figure.py`: loads
the figure scene at full resolution, casts the published query ray in the
left context view, projects its epipolar segment into the right view, and
writes an SVG with the two photographs, the ray point, the epipolar line
with evenly spaced sample markers, and rotated depth labels (the infinity
marker at the minimum-disparity end). Geometry only: no model, no kernel.

Usage:
  python -m pixelsplat_tpu_torch.paper.generate_epipolar_sampling_figure \\
      [--output epipolar_sampling.svg] [--scene name:c0:c1] [--ray x,y] [--device cuda] \\
      [dataset.roots=[...] ...]
"""

from __future__ import annotations

import argparse
import sys
from math import atan2, pi
from pathlib import Path

import numpy as np
import torch

from ..config import load_config
from ..geometry.epipolar_lines import lift_to_3d, project_rays
from ..geometry.projection import get_world_rays
from ..training.model_wrapper import resolve_device
from .common import MARGIN, SvgFigure, load_scene

# The published figure scene and query ray.
SCENE = ("3b59c7d97b900724", 30, 70)
RAY_POSITION = (0.135, 0.44)  # xy, normalized
FIGURE_WIDTH = 240
IMAGE_SHAPE = (360, 480)  # full-resolution re10k frames
NUM_MARKERS = 8
TEXT_SIZE = 10
BLUE = "#4263eb"


def main(argv: list[str]) -> Path:
    """Write the figure; returns its path."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--output", type=Path, default=Path("epipolar_sampling.svg"))
    parser.add_argument("--scene", default=None, metavar="name:c0:c1")
    parser.add_argument("--ray", default=None, metavar="x,y")
    parser.add_argument("--device", default="cuda")
    args, overrides = parser.parse_known_args(argv)
    device = resolve_device(args.device)

    cfg = load_config(
        [
            "+experiment=re10k",
            "mode=test",
            f"dataset.image_shape=[{IMAGE_SHAPE[0]},{IMAGE_SHAPE[1]}]",
            "dataset.augment=false",
            *overrides,
        ]
    )
    if args.scene:
        scene, c0, c1 = args.scene.split(":")
        scene_spec = (scene, int(c0), int(c1))
    else:
        scene_spec = SCENE
    ray_xy_norm = tuple(float(t) for t in args.ray.split(",")) if args.ray else RAY_POSITION

    scene, c0, c1 = scene_spec
    example = load_scene(cfg.dataset, scene, [c0, c1], [c0, c1])
    left_image = np.asarray(example["context"]["image"][0, 0])
    right_image = np.asarray(example["context"]["image"][0, 1])
    extrinsics = torch.as_tensor(example["context"]["extrinsics"][0], device=device)
    intrinsics = torch.as_tensor(example["context"]["intrinsics"][0], device=device)

    # Cast the query ray and project it into the other view.
    xy = torch.tensor(ray_xy_norm, dtype=torch.float32, device=device)
    origin, direction = get_world_rays(xy, extrinsics[0], intrinsics[0])
    projection = project_rays(origin, direction, extrinsics[1], intrinsics[1])

    h, w = left_image.shape[-2:]
    image_width = (FIGURE_WIDTH - MARGIN) / 2
    image_height = image_width * h / w
    fig = SvgFigure(FIGURE_WIDTH, image_height)
    fig.add_image(left_image, 0, 0, image_width, image_height)
    fig.add_image(right_image, image_width + MARGIN, 0, image_width, image_height)

    scale = np.asarray([image_width, image_height], np.float32)
    xy_min = projection.xy_min.cpu().numpy()
    xy_max = projection.xy_max.cpu().numpy()
    start = xy_min * scale + [image_width + MARGIN, 0]
    end = xy_max * scale + [image_width + MARGIN, 0]
    ray_px = xy.cpu().numpy() * scale

    def draw_samples(r: float, fill: str) -> None:
        for i in range(1, NUM_MARKERS):
            t = i / NUM_MARKERS
            cx = start[0] * t + (1 - t) * end[0]
            cy = start[1] * t + (1 - t) * end[1]
            fig.add_circle(cx, cy, r, color="none", fill=fill)

    # White backers, then the blue overlay.
    fig.add_line(2 * start[0] - end[0], 2 * start[1] - end[1], end[0], end[1], color="#ffffff", width=4.0)
    fig.add_circle(end[0], end[1], 4.0, color="none", fill="#ffffff")
    fig.add_circle(ray_px[0], ray_px[1], 4.0, color="none", fill="#ffffff")
    draw_samples(3.5, "#ffffff")

    fig.add_line(2 * start[0] - end[0], 2 * start[1] - end[1], end[0], end[1], color=BLUE, width=2.0)
    fig.add_circle(end[0], end[1], 3.0, color="none", fill=BLUE)
    fig.add_circle(ray_px[0], ray_px[1], 3.0, color="none", fill=BLUE)
    draw_samples(2.5, BLUE)

    # Rotated depth labels along the line; marker 0 (minimum disparity) is
    # the infinity marker.
    angle = 90.0 - atan2(abs(start[1] - end[1]), abs(start[0] - end[0])) * 180.0 / pi
    for i in range(NUM_MARKERS):
        t = i / NUM_MARKERS
        xyz = lift_to_3d(
            origin, direction, torch.as_tensor(xy_min * t + (1 - t) * xy_max, device=device), extrinsics[1], intrinsics[1]
        )
        depth = float(torch.linalg.vector_norm(xyz - extrinsics[0, :3, 3]))

        x = start[0] * t + (1 - t) * end[0]
        y = start[1] * t + (1 - t) * end[1]
        place = f"translate({x}, {y}) rotate({angle}) translate(5, {-TEXT_SIZE * 0.5})"
        fig.add_rect(21.5 if i > 0 else 15, TEXT_SIZE, fill="#ffffff", rx=1.0, transform=place)
        extra = "" if i > 0 else " translate(0, -1)"
        fig.add_text(
            f"{depth:.2f}" if i > 0 else "&#8734;",
            size=TEXT_SIZE,
            transform=f"{place} translate(2, {TEXT_SIZE * 0.825}){extra}",
        )

    # The ray label in the left view.
    fig.add_rect(20, TEXT_SIZE, x=ray_px[0] - 10, y=ray_px[1] - TEXT_SIZE - 6, fill="#ffffff", rx=1.0)
    fig.add_text("Ray", x=ray_px[0], y=ray_px[1] - 8, size=TEXT_SIZE, anchor="middle")

    args.output.parent.mkdir(parents=True, exist_ok=True)
    fig.save(args.output)
    print(f"Wrote {args.output}")
    return args.output


if __name__ == "__main__":
    main(sys.argv[1:])
