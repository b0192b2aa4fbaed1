"""Training through the CLI on the repo's fixture.

    python -m pixelsplat_tpu_torch.scripts.train_fixture --out DIR [--copies N] [main overrides ...]

The fixture (`tests/fixtures/re10k`) holds two RE10K scenes of 8 frames at
360x640 in its test split and none in its train split. This script writes
a dataset root under `DIR/re10k`: `--copies` copies of each scene under new
keys in `train/` (`profile_protocol.write_scene_set`), and the fixture's
`test/`, which the validation stage reads. It then runs
`pixelsplat_tpu_torch.main.main` on that root with `output_dir=DIR/outputs`,
`FIXTURE_OVERRIDES` and the overrides given, `+experiment=re10k` unless an
experiment is named: checkpoints land in `DIR/outputs/checkpoints`, the
logged losses and validation metrics in `DIR/outputs/local/metrics.jsonl`,
the comparison grids in `DIR/outputs/local/comparison/`. Run again with
the same `--out`, it resumes from the latest checkpoint.

The fixture's scenes are shorter than the published training scenes, so
the bounded view sampler's context gap is cut from `bounded_re10k.yaml`'s
25 frames growing to 45 to 2 growing to 6; nothing else is cut.
"""

from __future__ import annotations

import argparse
import shutil
from pathlib import Path

from .. import main as cli
from .profile_protocol import FIXTURE, write_scene_set

VIEW_SAMPLER = "dataset.view_sampler"
# The context gap: `initial_*` at step 0, growing to `min_*` / `max_*` over
# `warm_up_steps` (25 -> 45 in `bounded_re10k.yaml`).
FIXTURE_OVERRIDES = [
    f"{VIEW_SAMPLER}.initial_min_distance_between_context_views=2",
    f"{VIEW_SAMPLER}.initial_max_distance_between_context_views=2",
    f"{VIEW_SAMPLER}.min_distance_between_context_views=6",
    f"{VIEW_SAMPLER}.max_distance_between_context_views=6",
]


def write_train_root(out: Path, copies: int = 1) -> Path:
    """A dataset root with the fixture's scenes as its train split and the
    fixture's test split; returns the root."""
    root, _ = write_scene_set(Path(out), copies=copies, chunks=1, stage="train")
    if not (root / "test").exists():
        shutil.copytree(FIXTURE / "re10k" / "test", root / "test")
    return root


def main() -> None:
    parser = argparse.ArgumentParser(description="Train through the CLI on the repo's fixture.")
    parser.add_argument("--out", type=Path, required=True)
    parser.add_argument("--copies", type=int, default=1)
    args, overrides = parser.parse_known_args()
    root = write_train_root(args.out / "re10k", args.copies)
    if not any(o.startswith("+experiment=") for o in overrides):
        overrides = ["+experiment=re10k", *overrides]
    state = cli.main(
        [f"dataset.roots=[{root}]", f"output_dir={args.out / 'outputs'}", *FIXTURE_OVERRIDES, *overrides]
    )
    print(f"trained to step {state.step}; checkpoints in {args.out / 'outputs' / 'checkpoints'}")


if __name__ == "__main__":
    main()
