"""Qualitative comparison figure: context refs + GT + per-method renders.

Port of `pixelsplat_tpu/paper/generate_image_comparison.py`: for every
highlighted (scene, target_index) of the re10k and acid evaluation
configs, loads the ground-truth target view through the dataset (so all
dataset shims are applied), loads each method's rendered frame from its
configured baseline directory, and lays everything out in the paper's SVG
grid — the two context views stacked into a half-width "Ref." column, then
the target view, then one column per method. Missing method renders become
gray placeholders.

Usage:
  python -m pixelsplat_tpu_torch.paper.generate_image_comparison \
      [--output image_comparison.svg] [--experiment re10k --experiment acid]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

from ..utils.image_io import load_image
from .common import MARGIN, SvgFigure, load_metrics_config, load_scene

FIGURE_WIDTH = 500
TEXT_SIZE = 9
PLACEHOLDER = np.full((3, 128, 128), 0.5, np.float32)


def generate_image_grid(
    rows: list[list[np.ndarray | None]],
    method_names: list[str],
    out: Path,
    num_context: int = 2,
) -> None:
    """The paper grid: `num_context` stacked mini context views, then the
    GT target, then one full-size cell per method (the 3-view variant
    differs only in the context-column geometry)."""
    num_rows = len(rows)
    n = len(rows[0])
    num_cells = n - num_context  # target + methods occupy full cells

    # The context column is a fraction of a full cell; solve the figure
    # width for the full cell size.
    # Total width = context column (one mini) + margin + num_cells full
    # cells with margins between them.
    context_fraction = 1.0 / num_context
    image_width = (FIGURE_WIDTH - num_cells * MARGIN) / (
        num_cells + context_fraction
    )
    mini_image_width = (image_width - (num_context - 1) * MARGIN) / num_context
    figure_height = num_rows * image_width + (num_rows - 1) * MARGIN + TEXT_SIZE
    fig = SvgFigure(FIGURE_WIDTH, figure_height)

    offset = image_width + MARGIN
    for row, row_images in enumerate(rows):
        y0 = offset * row + TEXT_SIZE
        # Stacked context views.
        for i in range(num_context):
            image = row_images[i]
            image = PLACEHOLDER if image is None else image
            fig.add_image(
                image,
                0,
                y0 + i * (mini_image_width + MARGIN),
                mini_image_width,
                mini_image_width,
            )
        # Target + method cells.
        for col, image in enumerate(row_images[num_context:]):
            image = PLACEHOLDER if image is None else image
            fig.add_image(
                image,
                mini_image_width + MARGIN + offset * col,
                y0,
                image_width,
                image_width,
            )

    # Column labels.
    fig.add_text("Ref.", mini_image_width / 2, TEXT_SIZE * 0.65, TEXT_SIZE, anchor="middle")
    fig.add_text(
        "Target View",
        mini_image_width + MARGIN + image_width * 0.5,
        TEXT_SIZE * 0.65,
        TEXT_SIZE,
        anchor="middle",
    )
    for i, method_name in enumerate(method_names):
        fig.add_text(
            method_name,
            mini_image_width + MARGIN + offset * (i + 1) + image_width * 0.5,
            TEXT_SIZE * 0.65,
            TEXT_SIZE,
            anchor="middle",
        )

    out.parent.mkdir(parents=True, exist_ok=True)
    fig.save(out)


def collect_rows(
    experiments: list[str],
    overrides: list[str],
    evaluation: str | None = None,
    num_context: int = 2,
):
    """(rows, method_names) across the given evaluation configs.
    `evaluation` overrides the config/evaluation overlay name (defaults to
    the experiment name); `num_context=3` applies the midpoint three-view
    hack to 2-view indices."""
    from ..dataset.view_sampler.view_sampler_evaluation import (
        add_third_context_index,
    )

    rows = []
    method_names: list[str] = []
    for experiment in experiments:
        cfg, eval_cfg = load_metrics_config(
            [f"+experiment={experiment}", *overrides], evaluation or experiment
        )
        method_names = [m.name for m in eval_cfg.methods]
        index = json.loads(Path(cfg.dataset.view_sampler.index_path).read_text())

        for highlighted in eval_cfg.highlighted:
            scene = highlighted.scene
            target_index = highlighted.target_index
            context_indices = list(index[scene]["context"])
            if num_context == 3 and len(context_indices) == 2:
                context_indices = add_third_context_index(
                    np.asarray(context_indices)
                ).tolist()
            assert target_index in index[scene]["target"], (scene, target_index)

            example = load_scene(
                cfg.dataset, scene, list(context_indices), [target_index]
            )
            row = [
                np.asarray(img) for img in example["context"]["image"][0]
            ] + [np.asarray(example["target"]["image"][0, 0])]
            for method in eval_cfg.methods:
                frame = Path(method.path) / scene / f"color/{target_index:0>6}.png"
                row.append(load_image(frame) if frame.exists() else None)
            rows.append(row)
    return rows, method_names


def main(argv: list[str]) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--output", type=Path, default=Path("image_comparison.svg"))
    parser.add_argument(
        "--experiment", action="append", default=None, help="default: re10k + acid"
    )
    args, overrides = parser.parse_known_args(argv)
    experiments = args.experiment or ["re10k", "acid"]

    rows, method_names = collect_rows(experiments, overrides)
    generate_image_grid(rows, method_names, args.output)
    print(f"Wrote {args.output}")


if __name__ == "__main__":
    main(sys.argv[1:])
