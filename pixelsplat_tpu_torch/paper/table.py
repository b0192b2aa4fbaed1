"""LaTeX metric tables with per-column ranking/highlighting.

Port of `pixelsplat_tpu/paper/table.py` (numpy only): renders a methods x
metrics table where the best (and optionally second-best) value per metric
is highlighted, with configurable direction (higher/lower is better).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Literal, Sequence

import numpy as np


@dataclass(frozen=True)
class Metric:
    name: str
    key: str
    order: Literal["higher", "lower"] = "higher"
    precision: int = 3

    def format(self, value: float) -> str:
        return f"{value:.{self.precision}f}"


def make_latex_table(
    methods: Sequence[tuple[str, dict[str, float]]],
    metrics: Sequence[Metric],
    highlight_best: bool = True,
    highlight_second: bool = True,
) -> str:
    """methods: [(display name, {metric_key: value})]."""
    # Rank values per metric.
    ranks: dict[str, list[int]] = {}
    for metric in metrics:
        values = np.asarray(
            [m[1].get(metric.key, np.nan) for m in methods], np.float64
        )
        order = np.argsort(values if metric.order == "lower" else -values)
        rank = np.full(len(methods), 99)
        live = ~np.isnan(values)
        pos = 0
        for idx in order:
            if live[idx]:
                rank[idx] = pos
                pos += 1
        ranks[metric.key] = rank.tolist()

    arrow = {"higher": r"$\uparrow$", "lower": r"$\downarrow$"}
    lines = [
        r"\begin{tabular}{l" + "c" * len(metrics) + "}",
        r"\toprule",
        "Method & "
        + " & ".join(f"{m.name} {arrow[m.order]}" for m in metrics)
        + r" \\",
        r"\midrule",
    ]
    for row, (name, values) in enumerate(methods):
        cells = []
        for metric in metrics:
            value = values.get(metric.key)
            if value is None or (isinstance(value, float) and np.isnan(value)):
                cells.append("--")
                continue
            text = metric.format(float(value))
            rank = ranks[metric.key][row]
            if highlight_best and rank == 0:
                text = rf"\textbf{{{text}}}"
            elif highlight_second and rank == 1:
                text = rf"\underline{{{text}}}"
            cells.append(text)
        lines.append(f"{name} & " + " & ".join(cells) + r" \\")
    lines += [r"\bottomrule", r"\end{tabular}"]
    return "\n".join(lines)
