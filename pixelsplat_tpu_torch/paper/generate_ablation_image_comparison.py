"""Ablation comparison figure: per-ablation render columns only.

Port of `pixelsplat_tpu/paper/generate_ablation_image_comparison.py`:
for each highlighted scene of config/evaluation/ablation.yaml, loads every
configured ablation's rendered frame and lays them out in a compact
labeled grid (no context/GT columns — the ablations are compared
against the full model's column directly).

Usage:
  python -m pixelsplat_tpu_torch.paper.generate_ablation_image_comparison \
      [--output ablation.svg] [--experiment re10k] [--evaluation ablation]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

from ..utils.image_io import load_image
from .common import MARGIN, SvgFigure, load_metrics_config

FIGURE_WIDTH = 240
TEXT_SIZE = 10
PLACEHOLDER = np.full((3, 128, 128), 0.5, np.float32)


def generate_ablation_grid(
    rows: list[list[np.ndarray | None]],
    method_names: list[str],
    out: Path,
) -> None:
    """Uniform num_methods-wide grid with a label row."""
    num_rows = len(rows)
    num_cols = len(rows[0])
    image_width = (FIGURE_WIDTH - (num_cols - 1) * MARGIN) / num_cols
    figure_height = num_rows * image_width + (num_rows - 1) * MARGIN + TEXT_SIZE
    fig = SvgFigure(FIGURE_WIDTH, figure_height)

    offset = image_width + MARGIN
    for row, row_images in enumerate(rows):
        for col, image in enumerate(row_images):
            image = PLACEHOLDER if image is None else image
            fig.add_image(
                image, offset * col, offset * row + TEXT_SIZE, image_width, image_width
            )
    for i, method_name in enumerate(method_names):
        fig.add_text(
            method_name,
            image_width * (0.5 + i) + MARGIN * i,
            TEXT_SIZE * 0.65,
            TEXT_SIZE,
            anchor="middle",
        )

    out.parent.mkdir(parents=True, exist_ok=True)
    fig.save(out)


def main(argv: list[str]) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--output", type=Path, default=Path("ablation.svg"))
    parser.add_argument("--experiment", default="re10k")
    parser.add_argument("--evaluation", default="ablation")
    args, overrides = parser.parse_known_args(argv)

    _, eval_cfg = load_metrics_config(
        [f"+experiment={args.experiment}", *overrides], args.evaluation
    )
    rows = []
    for highlighted in eval_cfg.highlighted:
        row = []
        for method in eval_cfg.methods:
            frame = (
                Path(method.path)
                / highlighted.scene
                / f"color/{highlighted.target_index:0>6}.png"
            )
            row.append(load_image(frame) if frame.exists() else None)
        rows.append(row)

    generate_ablation_grid(rows, [m.name for m in eval_cfg.methods], args.output)
    print(f"Wrote {args.output}")


if __name__ == "__main__":
    main(sys.argv[1:])
