"""Build the main comparison LaTeX table from metric JSON files.

Port of `pixelsplat_tpu/paper/generate_comparison_table.py`.
Usage:
  python -m pixelsplat_tpu_torch.paper.generate_comparison_table metrics.json out.tex
where metrics.json maps method key -> {psnr, ssim, lpips} (the format
written by compute_metrics).
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

from .table import Metric, make_latex_table

METRICS = (
    Metric("PSNR", "psnr", "higher", 2),
    Metric("SSIM", "ssim", "higher", 3),
    Metric("LPIPS", "lpips", "lower", 3),
)


def main(argv: list[str]) -> None:
    metrics_path = Path(argv[0])
    out_path = Path(argv[1]) if len(argv) > 1 else metrics_path.with_suffix(".tex")
    data = json.loads(metrics_path.read_text())
    methods = [(key, values) for key, values in data.items()]
    table = make_latex_table(methods, METRICS)
    out_path.write_text(table)
    print(table)
    print(f"Wrote {out_path}")


if __name__ == "__main__":
    main(sys.argv[1:])
