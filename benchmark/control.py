"""The control that sets each limit's upper reading, at a cell's own size
on the card (the benchmark's runs never run this):

    python3 -m benchmark.control --workload <name> --seeds <n> [<n> ...]

Control: the reference put in the program's place, computed in the
nearest precision below the configuration's (TF32 for float32 with TF32
off), and compared with the reference as a run compares the program: the
same scenes a run checks. Each reading is printed as one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import check, generator, port, spec


def _tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def eval_readings(cell, seed: int, device) -> dict:
    cfg = cell.config
    units = generator.make_units(cell.traffic, cfg, seed, device)
    order = generator.window_order(cell.traffic, seed)
    checked = [units[order[k % len(order)]] for k in range(cell.traffic["check_scenes"])]
    checked = check.settle_depth_draws(checked, cfg, seed, device)
    encoder = check.reference_encoder(cfg, seed, device)
    worst: dict = {}
    for unit in checked:
        _tf32(False)
        reference, _ = check.reference_scene(encoder, cfg, unit, device)
        _tf32(True)
        control, _ = check.reference_scene(encoder, cfg, unit, device)
        for a, b in zip(control, reference):
            for k, v in check.gap_stats(a, b).items():
                worst[k] = max(worst.get(k, 0.0), v)
    _tf32(False)
    return {"control_tf32": {"image_gap_" + k: v for k, v in worst.items()}}


def main(argv: list[str]) -> int:
    parser = argparse.ArgumentParser(description="Read a cell's control and faults on the card.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    port.set_precision(cell.config)
    for seed in args.seeds:
        t = time.perf_counter()
        readings = eval_readings(cell, seed, "cuda")
        print(json.dumps({"workload": args.workload, "seed": seed, "seconds": time.perf_counter() - t, **readings}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
