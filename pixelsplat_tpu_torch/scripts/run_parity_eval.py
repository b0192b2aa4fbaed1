"""One-command checkpoint-parity evaluation against the published numbers.

Port of `tools/run_parity_eval.py`. Given the published Lightning
checkpoint (or a checkpoint of the port, such as
`scripts/import_checkpoint.py` writes), a dataset root and an evaluation
index, it runs the evaluation protocol (`Trainer.test`: the probabilistic
encoder with 3 Gaussians per pixel, every target view rendered, PSNR /
SSIM / LPIPS, PNGs and the benchmark JSONs), prints the metric table
beside the published numbers with the acceptance gate (PSNR within
+-0.05 dB and no dropped pairs), and writes `parity_summary.json`:

    python -m pixelsplat_tpu_torch.scripts.run_parity_eval \\
        --ckpt re10k.ckpt --data datasets/re10k \\
        --index assets/evaluation_index_re10k.json \\
        [--experiment re10k] [--output outputs/parity] [--device cuda] [overrides ...]

Runs on the card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Optional

from ..config import load_config
from ..interop.torch_import import load_params
from ..main import build_everything
from ..training.model_wrapper import resolve_device

# Published camera-ready numbers (BASELINE.md, from the reference README).
PUBLISHED = {
    "re10k": {"psnr": 26.09, "ssim": 0.863, "lpips": 0.136},
    "acid": {"psnr": 28.27, "ssim": 0.843, "lpips": 0.146},
}
PSNR_GATE_DB = 0.05


def run(argv: Optional[list[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ckpt", required=True, type=Path)
    p.add_argument("--data", required=True, type=Path, help="dataset root")
    p.add_argument("--index", required=True, type=Path, help="evaluation index json")
    p.add_argument("--experiment", default="re10k")
    p.add_argument("--output", default="outputs/parity", type=Path)
    p.add_argument("--chunk-size", default=32, type=int)
    p.add_argument("--device", default="cuda")
    p.add_argument("overrides", nargs="*", help="extra config overrides")
    a = p.parse_args(argv)

    cfg = load_config(
        [
            f"+experiment={a.experiment}",
            "mode=test",
            "dataset/view_sampler=evaluation",
            f"dataset.view_sampler.index_path={a.index}",
            f"dataset.roots=[{a.data}]",
            f"test.output_path={a.output}",
            f"output_dir={a.output}",
            "wandb.mode=disabled",
            *a.overrides,
        ]
    )
    trainer = build_everything(cfg, resolve_device(a.device))
    load_params(a.ckpt, trainer.wrapper.encoder)
    summary = trainer.test(chunk_size=a.chunk_size)

    published = PUBLISHED.get(a.experiment, {})
    rows = []
    for metric in ("psnr", "ssim", "lpips"):
        ours = summary.get(metric)
        ref = published.get(metric)
        delta = None if (ours is None or ref is None) else ours - ref
        rows.append((metric, ours, ref, delta))

    def f(x):
        return "n/a" if x is None else f"{x:.4f}"

    print()
    print(f"| metric | ours | published ({a.experiment}) | delta |")
    print("|---|---|---|---|")
    for metric, ours, ref, delta in rows:
        print(f"| {metric} | {f(ours)} | {f(ref)} | {f(delta)} |")
    print(
        f"| scenes | {summary['num_scenes']} | - | - |\n"
        f"| overflow pairs | {summary['overflow_pairs']} | 0 | - |"
    )

    psnr_delta = rows[0][3]
    gate = None
    if psnr_delta is not None:
        gate = abs(psnr_delta) <= PSNR_GATE_DB and summary["overflow_pairs"] == 0
        print(
            f"\nacceptance gate (|dPSNR| <= {PSNR_GATE_DB} dB, zero overflow): "
            + ("PASS" if gate else "FAIL")
        )
    summary["psnr_delta"] = psnr_delta
    summary["gate"] = gate
    out = Path(a.output) / "parity_summary.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(summary, indent=2))
    print(f"summary -> {out}")
    return summary


if __name__ == "__main__":
    run()
