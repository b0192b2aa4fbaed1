"""Expand an evaluation index so that every frame between the context
views is a target.

    python -m pixelsplat_tpu_torch.scripts.generate_video_evaluation_index [input.json] [output.json]

Port of `pixelsplat_tpu/scripts/generate_video_evaluation_index.py`.
"""

from __future__ import annotations

import sys
from pathlib import Path

from ..evaluation.evaluation_index_generator import expand_to_video_index

INDEX_INPUT = Path("assets/evaluation_index_re10k.json")
INDEX_OUTPUT = Path("assets/evaluation_index_re10k_video.json")


def main(argv: list[str]) -> Path:
    src = Path(argv[0]) if len(argv) > 0 else INDEX_INPUT
    dst = Path(argv[1]) if len(argv) > 1 else INDEX_OUTPUT
    expand_to_video_index(src, dst)
    print(f"Wrote {dst}")
    return dst


if __name__ == "__main__":
    main(sys.argv[1:])
