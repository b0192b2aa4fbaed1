"""3-context-view comparison figure: 2-view vs 3-view renders.

Port of `pixelsplat_tpu/paper/generate_3_view_image_comparison.py`: the
same highlighted scenes as the main comparison, but the context column
stacks all THREE context views (one-third-height minis) and the method
columns compare the standard 2-view model against the 3-view evaluation
renders (config/evaluation/re10k_3_view.yaml). The dataset is loaded with
the 3-view index so the extra context view passes through the same shims
as ground truth.

Usage:
  python -m pixelsplat_tpu_torch.paper.generate_3_view_image_comparison \
      [--output image_comparison_3_view.svg] [--experiment re10k_3_view]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from .generate_image_comparison import collect_rows, generate_image_grid


def main(argv: list[str]) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument(
        "--output", type=Path, default=Path("image_comparison_3_view.svg")
    )
    parser.add_argument(
        "--evaluation", default="re10k_3_view", help="evaluation config name"
    )
    parser.add_argument(
        "--experiment", default="re10k", help="experiment config name"
    )
    args, overrides = parser.parse_known_args(argv)

    rows, method_names = collect_rows(
        [args.experiment],
        list(overrides),
        evaluation=args.evaluation,
        num_context=3,
    )
    generate_image_grid(rows, method_names, args.output, num_context=3)
    print(f"Wrote {args.output}")


if __name__ == "__main__":
    main(sys.argv[1:])
