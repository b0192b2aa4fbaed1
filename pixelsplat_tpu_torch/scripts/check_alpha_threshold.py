"""Both compositing kernels against their plain versions on lists crowded
near the compositor's three alpha cuts, where a (slot, pixel) pair the two
round to opposite sides of a cut changes its pixel, or its gradient, by a
jump.

    python -m pixelsplat_tpu_torch.scripts.check_alpha_threshold [--seeds N] [--family F ...]

`alpha = min(0.99, op exp(power))`, zeroed where `power > 0` or where
`alpha < 1/255`. Each seed makes 256 tiles of 256 slots (two 128-slot
chunks), every slot its own Gaussian with three colours in [0, 1]. The
families (`crowded_lists`):

- `threshold`: a mean within a tile of its own, a random ellipse of 2-8
  pixels, opacity in [0.004, 0.03]: many pairs within 1 % of alpha = 1/255
  while T stays near 1;
- `clamp`: slot i's Gaussian sits on pixel i of its tile (a mean within
  0.05 pixels of it, a round footprint of 0.25-0.35 pixels) with its
  opacity set so that `op exp(power)` at that pixel lies within 1e-6 of
  0.99, relative: every pixel meets the clamp once;
- `power_cut`: slot i's Gaussian is a nearly degenerate ellipse (axis
  ratio 1e4) through pixel i, its mean moved along the long axis by at
  most 1e-3 pixels: `power` is a tiny negative number there (or rounds to
  0), with opacity in [0.01, 0.03].

Prints, per family, the forward kernel's pixels beyond 1e-5 of the plain
version, the tiles whose n_proc differs, the largest error, and the
backward kernel's rows of d_table beyond 1e-5 of their column's largest
|gradient| (cotangents drawn from the seed); exits 1 when either kernel
disagrees anywhere: a pixel or a row beyond 1e-5, or a tile's n_proc.
"""

from __future__ import annotations

import argparse
import math

import torch

from ..ops.rasterizer.composite_kernel import (
    MAX_ALPHA, composite_bwd, composite_bwd_plain, composite_core, composite_core_plain,
)

TILES_X = 16
PER_TILE = 256
CHUNK = 128
ATOL = 1e-5
FAMILIES = ("threshold", "clamp", "power_cut")


def crowded_lists(seed: int, device: str, family: str = "threshold", tiles_x: int = TILES_X):
    """(table, flat, block_start, counts) of one seed's lists of `family`,
    on a square of `tiles_x` x `tiles_x` tiles."""
    g = torch.Generator(device=device).manual_seed(seed)

    def u(*shape):
        return torch.rand(*shape, generator=g, device=device)

    num_tiles = tiles_x * tiles_x
    n = num_tiles * PER_TILE
    tile = torch.arange(num_tiles, device=device).repeat_interleave(PER_TILE)
    table = torch.zeros((n + 1, 12), device=device)  # the last row the zero sentinel
    if family == "threshold":
        table[:n, 0] = (tile % tiles_x) * 16 + 8 + (u(n) - 0.5) * 32
        table[:n, 1] = (tile // tiles_x) * 16 + 8 + (u(n) - 0.5) * 32
        # Conic: R diag(1 / s1^2, 1 / s2^2) R^T.
        a1, a2, angle = 1 / (2 + 6 * u(n)) ** 2, 1 / (2 + 6 * u(n)) ** 2, math.pi * u(n)
        table[:n, 5] = 0.004 + 0.026 * u(n)
    else:
        # Slot i of a tile on pixel i (pixel centres at integer coordinates).
        within = torch.arange(n, device=device) % PER_TILE
        pix_x = ((tile % tiles_x) * 16 + within % 16).float()
        pix_y = ((tile // tiles_x) * 16 + within // 16).float()
        angle = math.pi * u(n)
        if family == "clamp":
            a1 = a2 = 1 / (0.25 + 0.1 * u(n)) ** 2
            offset = (u(n, 2) - 0.5) * 0.1
        elif family == "power_cut":
            a1 = 1 / (2 + 6 * u(n)) ** 2
            a2 = a1 * 1e-8
            shift = (u(n) - 0.5) * 2e-3  # along the long axis
            offset = torch.stack([-torch.sin(angle) * shift, torch.cos(angle) * shift], dim=-1)
        else:
            raise ValueError(f"unknown family {family!r}: one of {FAMILIES}")
        table[:n, 0] = pix_x - offset[:, 0]
        table[:n, 1] = pix_y - offset[:, 1]
    c, s = torch.cos(angle), torch.sin(angle)
    table[:n, 2] = c * c * a1 + s * s * a2
    table[:n, 3] = c * s * (a1 - a2)
    table[:n, 4] = s * s * a1 + c * c * a2
    if family == "clamp":
        # The opacity that puts op exp(power) at the own pixel at 0.99,
        # within 1e-6 relative, power rounded as the compositors round it.
        power = own_pixel_power(table[:n], pix_x, pix_y)
        table[:n, 5] = MAX_ALPHA * (1 + (u(n) - 0.5) * 2e-6) / torch.exp(power)
    elif family == "power_cut":
        table[:n, 5] = 0.01 + 0.02 * u(n)
    table[:n, 6:9] = u(n, 3)
    flat = torch.arange(n, dtype=torch.int32, device=device)
    block_start = (torch.arange(num_tiles, device=device) * (PER_TILE // CHUNK)).to(torch.int32)
    counts = torch.full((num_tiles,), PER_TILE, dtype=torch.int32, device=device)
    return table, flat, block_start, counts


def own_pixel_power(rows: torch.Tensor, pix_x: torch.Tensor, pix_y: torch.Tensor) -> torch.Tensor:
    """Each row's power at (pix_x, pix_y), in the compositors' op order."""
    dx, dy = pix_x - rows[:, 0], pix_y - rows[:, 1]
    return -0.5 * (rows[:, 2] * dx * dx + rows[:, 4] * dy * dy) - rows[:, 3] * dx * dy


def check(seeds: int, device: str = "cuda", family: str = "threshold", tiles_x: int = TILES_X) -> dict:
    """Both kernels against their plain versions over `seeds` seeds of
    `family`'s lists: the forward's pixels beyond ATOL, tiles whose n_proc
    differs and largest error; the backward's rows of d_table beyond ATOL
    of their column's largest |gradient| and largest such error."""
    bad = differ = bwd_rows = 0
    worst = bwd_worst = 0.0
    for seed in range(seeds):
        lists = crowded_lists(seed, device, family, tiles_x)
        args = (*lists, tiles_x, CHUNK)
        acc_k, trans_k, n_k = composite_core(*args)
        acc_p, _, n_p = composite_core_plain(*args)
        err = (acc_k - acc_p).abs().amax(dim=1)  # (T, P)
        bad += int((~(err <= ATOL)).sum())  # NaN counts as beyond
        differ += int((n_k != n_p).sum())
        worst = max(worst, float(err.max()))

        g = torch.Generator(device=device).manual_seed(seed + 1)
        g_acc = torch.randn(acc_k.shape, generator=g, device=device)
        g_trans = torch.randn(trans_k.shape, generator=g, device=device)
        bwd_args = (*lists, n_k, trans_k, g_acc, g_trans, tiles_x, CHUNK)
        d_kernel, (_, d_plain) = composite_bwd(*bwd_args), composite_bwd_plain(*bwd_args)
        rel = ((d_kernel - d_plain).abs() / d_plain.abs().amax(dim=0).clamp(min=1e-30)).amax(dim=1)
        bwd_rows += int((~(rel <= ATOL)).sum())
        bwd_worst = max(bwd_worst, float(rel.max()))
    return dict(pixels_beyond=bad, tiles_n_proc_differ=differ, max_abs_err=worst,
                bwd_rows_beyond=bwd_rows, bwd_max_rel_err=bwd_worst)


def main(argv: list[str] | None = None) -> None:
    from .eval_scene import card_line

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seeds", type=int, default=200)
    parser.add_argument("--family", action="append", choices=FAMILIES, default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("check_alpha_threshold needs a CUDA device")
    print(f"card: {card_line()}")
    failed = False
    for family in args.family or FAMILIES:
        result = check(args.seeds, family=family)
        print(f"{family}: {args.seeds} seeds x {TILES_X * TILES_X} tiles x {PER_TILE} slots: forward pixels beyond "
              f"{ATOL}: {result['pixels_beyond']}; tiles whose n_proc differs: {result['tiles_n_proc_differ']}; "
              f"max |acc| err {result['max_abs_err']:.3g}; backward rows beyond {ATOL} of a column's max: "
              f"{result['bwd_rows_beyond']} (max {result['bwd_max_rel_err']:.3g})", flush=True)
        failed |= bool(result["pixels_beyond"] or result["tiles_n_proc_differ"] or result["bwd_rows_beyond"])
    if failed:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
