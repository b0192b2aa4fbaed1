"""Ablation timings of the forward compositing kernel's per-slot stages,
on the GPU.

    python -m pixelsplat_tpu_torch.scripts.bench_kernel_ablation

The port's counterpart of `tools/bench_kernel_ablation.py`. It builds that
tool's scene (G = 393,216 Gaussians from `default_rng(0)`, one 256x256
view, binned at capacity 4096 with a big list of 128), then times
`csrc/composite_fwd_ablation.cu`'s variants on the scene's real tile
lists: the production kernel's device code with single stages replaced by
stubs of the same shape (numerically wrong on purpose) and a fixed-trip
loop over all of a tile's chunks, so that every variant makes the same
trips. The stages are the CUDA kernel's own; the tool's list maps so:

  full            every stage, no exit vote              (tool: full)
  exit_vote       the production loop, __syncthreads_or  (tool: while_exit)
  -gather         no staging of the chunk's rows into shared memory;
                  every slot reads row 0                  (tool: -unpack)
  -power          no quadratic form                      (tool: -basis)
  -exp_power      no expf and no alpha tests             (tool: -exp_power)
  -transmittance  no running product (tool: -log1p, -prefix_mm, -exp_excl
                  and -exp_trans: on the TPU the prefix product was a
                  matmul of logs; one thread per pixel keeps a scalar)
  -colors         no colour reads or FMAs                (tool: -colors_mm)
  -everything     all of the above                       (tool: -everything)

The tool's `-split3` (the 3-way bf16 split of the exponent coefficients)
and `quarter_exit` (quarter-burst DMA) are TPU mechanisms with no
counterpart in the CUDA kernel, so the table has no row for them; `-all_exp`
is `-exp_power` here. `full` is held against the plain compositor without
early exit; the stubbed variants are checked for shape and finiteness.
Times are CUDA events over 10 launches after a warm-up, printed as
`name ms` with the card's name and power limit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.rasterizer.binning import TileLists, bin_gaussians
from ..ops.rasterizer.composite import pack_columns
from ..ops.rasterizer.composite_ablation import VARIANTS, composite_core_ablation
from ..ops.rasterizer.composite_kernel import CH_PAD, composite_core_plain
from ..ops.rasterizer.projection import project_gaussians
from .eval_scene import card_line, cuda_ms

IMAGE_SHAPE = (256, 256)
CHUNK = 128
# `full` against the plain compositor: f32 sums of up to a few thousand
# terms per pixel in another order, expf against torch.exp.
FULL_ATOL = 1e-4
# `exit_vote` against the plain compositor with early exit: a tile whose
# largest transmittance lies within rounding of the exit threshold after a
# chunk may stop a chunk apart on the two sides. Such tiles are left out of
# the comparison, and there may be this many of them at most.
MAX_EXIT_TILES_APART = 2


def tool_scene_lists(device, g: int = 2 * 256 * 256 * 3, image_shape=IMAGE_SHAPE):
    """(table, tile lists, tiles_x) of the tool's synthetic scene."""
    rng = np.random.default_rng(0)
    means = np.stack([rng.uniform(-2, 2, g), rng.uniform(-2, 2, g), rng.uniform(1.2, 12, g)], -1).astype(np.float32)
    axes = rng.normal(size=(g, 3, 3)).astype(np.float32) * 0.01
    covs = axes @ axes.transpose(0, 2, 1) + 1e-6 * np.eye(3, dtype=np.float32)
    sh = rng.normal(size=(g, 3, 25)).astype(np.float32) * 0.1
    opac = rng.uniform(0.05, 0.6, g).astype(np.float32)
    k = torch.tensor([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1.0]], device=device)
    means, covs, sh, opac = (torch.as_tensor(a, device=device) for a in (means, covs, sh, opac))
    projected = project_gaussians(torch.eye(4, device=device), k, image_shape, means, covs, opac, harmonics=sh)
    tiles = bin_gaussians(projected, image_shape, capacity=4096, big_capacity=128, chunk=CHUNK)
    return pack_columns(projected).contiguous(), tiles, -(-image_shape[1] // 16)


def check_variants(table: torch.Tensor, tiles: TileLists, tiles_x: int, chunk: int = CHUNK) -> float:
    """Runs every variant once on these lists. `full` must agree with the
    plain compositor without early exit (returns its largest error), and
    `exit_vote` with the plain compositor with it; the stubbed variants
    must give finite outputs of the right shapes. Raises on any failure."""
    lists = (table, tiles.flat, tiles.block_start, tiles.counts)
    num_tiles = tiles.counts.numel()
    errors = {}
    for name in VARIANTS:
        acc, trans, n_proc = composite_core_ablation(name, *lists, tiles_x, chunk)
        if tuple(acc.shape) != (num_tiles, CH_PAD, 256) or tuple(trans.shape) != (num_tiles, 256):
            raise RuntimeError(f"variant {name}: wrong output shapes {tuple(acc.shape)}, {tuple(trans.shape)}")
        if not (bool(torch.isfinite(acc).all()) and bool(torch.isfinite(trans).all())):
            raise RuntimeError(f"variant {name}: non-finite output")
        if name in ("full", "exit_vote"):
            acc_p, trans_p, n_proc_p = composite_core_plain(*lists, tiles_x, chunk, early_exit=name == "exit_vote")
            same = n_proc == n_proc_p
            if name == "full" and not bool(same.all()):
                raise RuntimeError("variant full: n_proc is not every tile's chunk count")
            if int((~same).sum()) > MAX_EXIT_TILES_APART:
                raise RuntimeError(f"variant {name}: {int((~same).sum())} tiles stop at another chunk than "
                                   f"the plain compositor's, more than the {MAX_EXIT_TILES_APART} that "
                                   f"rounding at the exit threshold may explain")
            errors[name] = max(
                float((acc[same] - acc_p[same]).abs().max()), float((trans[same] - trans_p[same]).abs().max())
            )
            if errors[name] > FULL_ATOL:
                raise RuntimeError(f"variant {name} disagrees with the plain compositor: {errors[name]:.3g}")
        elif not torch.equal(n_proc, (tiles.counts + chunk - 1) // chunk):
            raise RuntimeError(f"variant {name}: the fixed-trip loop did not walk every chunk")
    return errors["full"]


def time_variants(table, tiles: TileLists, tiles_x: int, chunk: int = CHUNK, iters: int = 10) -> dict[str, float]:
    """name -> ms per launch, CUDA events over `iters` launches after a warm-up."""
    lists = (table, tiles.flat, tiles.block_start, tiles.counts)
    return {
        name: cuda_ms(lambda: composite_core_ablation(name, *lists, tiles_x, chunk), iters=iters) for name in VARIANTS
    }


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("bench_kernel_ablation needs a CUDA device")
    card = card_line()
    print(f"card: {card}", flush=True)
    table, tiles, tiles_x = tool_scene_lists("cuda")
    counts = tiles.counts.float()
    print(f"table {tuple(table.shape)}, counts mean {float(counts.mean()):.0f} max {int(counts.max())}, "
          f"chunks mean {float(((tiles.counts + CHUNK - 1) // CHUNK).float().mean()):.1f}, "
          f"overflow {int(tiles.overflow)}", flush=True)
    print(f"full vs plain (no early exit): max err {check_variants(table, tiles, tiles_x):.3g}", flush=True)
    for name, ms in time_variants(table, tiles, tiles_x).items():
        print(f"{name:16s} {ms:7.4f} ms", flush=True)
    print(f"card: {card}", flush=True)


if __name__ == "__main__":
    main()
