"""The forward compositing kernel against its plain version on lists
crowded near alpha = 1/255 with T near 1, where a pair whose alpha the two
round to opposite sides of the threshold changes its pixel by up to T / 255.

    python -m pixelsplat_tpu_torch.scripts.check_alpha_threshold [--seeds N]

Each seed makes 256 tiles of 256 slots (two 128-slot chunks), every slot
its own Gaussian: a mean within a tile of its own, a random ellipse of 2-8
pixels, opacity in [0.004, 0.03] and three colours in [0, 1]. Prints how
many pixels disagree beyond 1e-5, the tiles whose n_proc differs and the
largest error, and exits 1 when any pixel disagrees.
"""

from __future__ import annotations

import argparse
import math

import torch

from ..ops.rasterizer.composite_kernel import composite_core, composite_core_plain

TILES_X = 16
PER_TILE = 256
CHUNK = 128
ATOL = 1e-5


def crowded_lists(seed: int, device: str):
    """(table, flat, block_start, counts) of one seed's lists."""
    g = torch.Generator(device=device).manual_seed(seed)

    def u(*shape):
        return torch.rand(*shape, generator=g, device=device)

    num_tiles = TILES_X * TILES_X
    n = num_tiles * PER_TILE
    tile = torch.arange(num_tiles, device=device).repeat_interleave(PER_TILE)
    table = torch.zeros((n + 1, 12), device=device)  # the last row the zero sentinel
    table[:n, 0] = (tile % TILES_X) * 16 + 8 + (u(n) - 0.5) * 32
    table[:n, 1] = (tile // TILES_X) * 16 + 8 + (u(n) - 0.5) * 32
    # Conic: R diag(1 / s1^2, 1 / s2^2) R^T.
    a1, a2, angle = 1 / (2 + 6 * u(n)) ** 2, 1 / (2 + 6 * u(n)) ** 2, math.pi * u(n)
    c, s = torch.cos(angle), torch.sin(angle)
    table[:n, 2] = c * c * a1 + s * s * a2
    table[:n, 3] = c * s * (a1 - a2)
    table[:n, 4] = s * s * a1 + c * c * a2
    table[:n, 5] = 0.004 + 0.026 * u(n)
    table[:n, 6:9] = u(n, 3)
    flat = torch.arange(n, dtype=torch.int32, device=device)
    block_start = (torch.arange(num_tiles, device=device) * (PER_TILE // CHUNK)).to(torch.int32)
    counts = torch.full((num_tiles,), PER_TILE, dtype=torch.int32, device=device)
    return table, flat, block_start, counts


def check(seeds: int, device: str = "cuda") -> dict:
    """Kernel against plain version over `seeds` seeds of crowded lists."""
    bad = differ = 0
    worst = 0.0
    for seed in range(seeds):
        args = (*crowded_lists(seed, device), TILES_X, CHUNK)
        acc_k, _, n_k = composite_core(*args)
        acc_p, _, n_p = composite_core_plain(*args)
        err = (acc_k - acc_p).abs().amax(dim=1)  # (T, P)
        bad += int((err > ATOL).sum())
        differ += int((n_k != n_p).sum())
        worst = max(worst, float(err.max()))
    return dict(pixels_beyond=bad, tiles_n_proc_differ=differ, max_abs_err=worst)


def main(argv: list[str] | None = None) -> None:
    from .eval_scene import card_line

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seeds", type=int, default=200)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("check_alpha_threshold needs a CUDA device")
    result = check(args.seeds)
    print(f"card: {card_line()}")
    print(f"{args.seeds} seeds x {TILES_X * TILES_X} tiles x {PER_TILE} slots: pixels beyond {ATOL}: "
          f"{result['pixels_beyond']}; tiles whose n_proc differs: {result['tiles_n_proc_differ']}; "
          f"max |acc| err {result['max_abs_err']:.3g}", flush=True)
    if result["pixels_beyond"]:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
