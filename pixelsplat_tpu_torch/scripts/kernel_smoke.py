"""Smoke test of the CUDA toolchain the port's kernels use.

    python -m pixelsplat_tpu_torch.scripts.kernel_smoke

The port's counterpart of `tools/pallas_smoke.py`. It prints the device,
builds and launches the smallest kernel (`csrc/smoke_scale.cu`, y = 2 x)
on ones((256, 256)) and checks that the mean is 2 and that the kernel
equals its plain version bit for bit; then it runs the forward compositing
kernel on the tool's 4-tile input (256 slots per tile; the same seed and
ranges, in the port's table + tile-list contract) and prints the largest
error against `composite_core_plain`. A toolchain that cannot build, load
or launch fails here in seconds, with a clear line, before any scene runs.
Needs a CUDA device.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..ops.kernel_tools import smoke_scale, smoke_scale_plain
from ..ops.rasterizer.composite_kernel import ROW, composite_core, composite_core_plain

SMOKE_TILES, SMOKE_SLOTS, SMOKE_TILES_X, CHUNK = 4, 256, 4, 128
# Kernel vs plain compositor: f32 sums of 256 terms per pixel in another
# order, expf against torch.exp.
COMPOSITE_ATOL = 1e-5


def smoke_tile_inputs(device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(table, flat, block_start, counts) of a 64x16 image's 4 tiles, each
    with a list of 256 Gaussians spread over the whole image."""
    t, k = SMOKE_TILES, SMOKE_SLOTS
    rng = np.random.default_rng(0)
    table = np.zeros((t * k + 1, ROW), np.float32)  # last row: the zero sentinel
    table[:-1, 0] = rng.uniform(0, 64, (t, k)).reshape(-1)  # mx
    table[:-1, 1] = rng.uniform(0, 16, (t, k)).reshape(-1)  # my
    table[:-1, 2] = table[:-1, 4] = 0.5  # conic a, c
    table[:-1, 5] = rng.uniform(0.1, 0.6, (t, k)).reshape(-1)  # opacity
    table[:-1, 6:9] = rng.uniform(0, 1, (t, 3, k)).transpose(0, 2, 1).reshape(-1, 3)
    flat = np.arange(t * k, dtype=np.int32)
    block_start = np.arange(t, dtype=np.int32) * (k // CHUNK)
    counts = np.full((t,), k, np.int32)
    return tuple(torch.as_tensor(a, device=device) for a in (table, flat, block_start, counts))


def run_smoke(device="cuda") -> dict:
    """Runs both checks on `device`, prints their lines, and returns
    {"mean", "scale_max_err", "composite_max_err"}; raises if a kernel does
    not build or launch."""
    device = torch.device(device)
    t0 = time.perf_counter()
    x = torch.ones((256, 256), device=device)
    y = smoke_scale(x)
    mean = float(y.mean())
    scale_err = float((y - smoke_scale_plain(x)).abs().max())
    print(f"smoke_scale ok: mean {mean} max |kernel - plain| {scale_err} {time.perf_counter() - t0:.1f}s", flush=True)

    t0 = time.perf_counter()
    inputs = smoke_tile_inputs(device)
    acc, trans, n_proc = composite_core(*inputs, SMOKE_TILES_X, CHUNK)
    acc_p, trans_p, n_proc_p = composite_core_plain(*inputs, SMOKE_TILES_X, CHUNK)
    err = max(float((acc - acc_p).abs().max()), float((trans - trans_p).abs().max()))
    if not torch.equal(n_proc, n_proc_p):
        raise RuntimeError(f"composite_core: n_proc {n_proc.tolist()} differs from the plain {n_proc_p.tolist()}")
    print(f"composite ok: {time.perf_counter() - t0:.1f}s acc mean {float(acc.mean()):.4f} "
          f"trans mean {float(trans.mean()):.4f} max err vs plain: {err:.3g}", flush=True)
    return {"mean": mean, "scale_max_err": scale_err, "composite_max_err": err}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("kernel_smoke needs a CUDA device")
    from .eval_scene import card_line

    print(f"{torch.cuda.get_device_name(0)} | {card_line()}", flush=True)
    result = run_smoke()
    if result["mean"] != 2.0 or result["scale_max_err"] != 0.0 or result["composite_max_err"] > COMPOSITE_ATOL:
        raise SystemExit(f"FAIL: {result}")


if __name__ == "__main__":
    main()
