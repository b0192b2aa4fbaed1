"""Where the evaluation scene's, or one training step's, time goes on the GPU.

    python -m pixelsplat_tpu_torch.scripts.profile_scene [--model NAME] [--train] [--out FILE]

Builds the scene of `eval_scene.py` (the model named, `re10k` by default,
at full width: encode, choose the render settings, render three views) or,
with `--train`, the training step of `train_scene.py` (batch 1, 2 context
+ 4 target views at 256x256, MSE; LPIPS is gated off at step 0), warms it
up, then reports:

* its host-clock milliseconds, untraced and with the program's tracer on
  (each ending in a synchronize);
* the tracer's table of that traced run (`utils/tracing.py`): each span's
  calls, host and device milliseconds, and the counters (Gaussians, pairs
  binned and dropped, the chosen capacities, host syncs and their wait,
  kernel launches);
* the device kernels that take the most time in one more run under
  `torch.profiler`, by name; with `--train` also the step's forward,
  backward and optimizer milliseconds (CUDA events) and its peak memory.

Needs a CUDA device; prints the card's name and power limit beside the
numbers. With `--out` the full profiler table also goes to that file.
"""

from __future__ import annotations

import argparse
import time

import torch

from ..config import EXPERIMENTS
from ..utils import tracing
from .eval_scene import card_line, make_eval_scene
from .train_scene import make_train_scene, timed_step


def host_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def report(run, label: str, card: str, out) -> None:
    """Host milliseconds of `run` untraced and traced, the tracer's table
    of the traced call, and the profiler's heaviest kernels of one more."""
    run()  # warm-up
    untraced = host_ms(run)
    tracing.reset()
    tracing.enable(True)
    try:
        traced = host_ms(run)
    finally:
        tracing.enable(False)
    print(f"one {label}, host clock: {untraced:.3f} ms untraced, {traced:.3f} ms traced")
    print(tracing.table())
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        run()
        torch.cuda.synchronize()
    events = prof.key_averages()
    print(events.table(sort_by="self_device_time_total", row_limit=25, max_name_column_width=70))
    if out:
        with open(out, "w") as f:
            f.write(f"card: {card}\n")
            f.write(events.table(sort_by="self_device_time_total", row_limit=200, max_name_column_width=120))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="write the full profiler table here")
    parser.add_argument("--train", action="store_true", help="profile one training step instead")
    parser.add_argument("--model", default="re10k", choices=sorted(EXPERIMENTS))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_scene needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}")
    if args.train:
        ts = make_train_scene(model=args.model)
        batch = ts.batch(1)
        torch.cuda.reset_peak_memory_stats()
        report(lambda: timed_step(ts, batch), "training step", card, args.out)
        step = timed_step(ts, batch)
        print("train step (batch 1, MSE), CUDA events: " + ", ".join(f"{k} {v:.3f}" for k, v in step.items())
              + f"; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    else:
        scene = make_eval_scene(model=args.model)
        report(lambda: scene.run(0), "scene", card, args.out)
    print(f"card: {card}")


if __name__ == "__main__":
    main()
