"""The backward compositing kernel against its plain version, with every
disagreement traced to the (slot, pixel) pairs that cause it.

    python -m pixelsplat_tpu_torch.scripts.check_composite_bwd [--model NAME] [--batches N]

The gradient of the compositor jumps where a (slot, pixel) pair crosses
power = 0, raw = 1/255 or raw = 0.99. The kernel (fused multiply-adds,
expf) and the plain version round differently, so a pair within rounding
of a threshold may be composited by one and not by the other. `compare`
holds every row of d_table to one tolerance and excuses nothing by
proximity alone. A disagreement is accepted only when it is shown to be
such a pair's:

1. the tiles that list disagreeing rows are run alone, kernel and plain
   version, those that list most first, until one shows the disagreement;
2. that tile's pairs are ranked by their distance to a threshold in units
   of the rounding error of what is compared (`UNIT` times the size of the
   quadratic form's terms for power = 0; `UNIT` times that size plus a few
   roundings, relative, for raw): the closest must lie within `NEAR_UNITS`;
3. those pairs' Gaussians are moved off their threshold by a relative
   `NUDGE` (opacity down for a raw threshold, conic a and c up for power =
   0), the forward kernel is run again on the tile, and kernel and plain
   version must then agree on it to the tolerance;
4. with the single-tile disagreements of at most `MAX_TILES` such tiles
   taken out, every row of d_table must agree to the tolerance.

Run as a script it sweeps training batches of a model at full width and
prints each disagreement it meets with its pairs: power, raw and size in
float32 and float64, and the units.
"""

from __future__ import annotations

import argparse
from typing import Callable

import torch

from ..config import EXPERIMENTS
from ..ops.rasterizer.composite_kernel import (
    KERNEL_TILE, MAX_ALPHA, MIN_ALPHA, composite_bwd, composite_bwd_plain, composite_core,
)

# The sweep's tolerance, of each column's largest |gradient|: atomics sum
# in any order and expf/log1pf differ from torch's; views without a pair at
# a threshold agree to 9e-7 on an H100.
RTOL = 1e-4
UNIT = 2.0**-24  # float32 unit roundoff
# Which pairs get moved; the proof is that moving them cures the tile. The
# disagreements met on an H100 (89 tiles in 2,000 full-width views) were
# all pairs 0.0004 to 0.71 units from raw = 1/255.
NEAR_UNITS = 16.0
NUDGE = 1e-4
MAX_PAIRS = 4  # Gaussians moved per tile
MAX_TILES = 2  # tiles a view may have explained, of 256 at 256x256 (3 of those 2,000 views needed 2)
MAX_TRIED = 32  # tiles run alone in search of one disagreement
THRESHOLDS = ("power = 0", "raw = 1/255", "raw = 0.99")


def _plain_d_table(*args):
    return composite_bwd_plain(*args)[1]


def tile_slots(inp: dict, tile: int) -> torch.Tensor:
    """Indices into `flat` of the slots the forward composited for `tile`."""
    t, chunk = inp["tiles"], inp["chunk"]
    start = int(t.block_start[tile]) * chunk
    n = min(int(t.counts[tile]), int(inp["n_proc"][tile]) * chunk)
    return torch.arange(start, start + n, device=t.flat.device)


def closest_pairs(inp: dict, tile: int, k: int = MAX_PAIRS) -> list[dict]:
    """The `k` composited (slot, pixel) pairs of `tile` closest to a
    threshold, in rounding units, closest first."""
    t, table = inp["tiles"], inp["table"]
    ids = t.flat[tile_slots(inp, tile)].long()
    if ids.numel() == 0:
        return []
    within = torch.arange(KERNEL_TILE * KERNEL_TILE, device=table.device)
    px = (tile % inp["tiles_x"]) * KERNEL_TILE + within % KERNEL_TILE
    py = (tile // inp["tiles_x"]) * KERNEL_TILE + within // KERNEL_TILE
    values = {}
    for dtype in (torch.float32, torch.float64):
        r = table[ids].to(dtype)
        mx, my, ca, cb, cc, op = (r[:, j, None] for j in range(6))
        dx, dy = px.to(dtype)[None] - mx, py.to(dtype)[None] - my
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        size = 0.5 * (ca * dx * dx).abs() + 0.5 * (cc * dy * dy).abs() + (cb * dx * dy).abs()
        values[dtype] = dict(power=power, raw=op * torch.exp(power), size=size)
    v = values[torch.float64]
    op = table[ids, 5, None].double()
    inf = torch.full_like(v["power"], float("inf"))
    raw_scale = UNIT * (v["size"] + 4.0)
    units = torch.stack([
        torch.where((v["size"] > 0) & (op >= MIN_ALPHA), v["power"].abs() / (UNIT * v["size"]), inf),
        torch.where(op > 0, (v["raw"] / MIN_ALPHA - 1.0).abs() / raw_scale, inf),
        torch.where(op > 0, (v["raw"] / MAX_ALPHA - 1.0).abs() / raw_scale, inf),
    ])  # (3, slots, pixels)
    best, which = units.min(dim=0)
    order = torch.argsort(best.flatten())[:k]
    pairs = []
    for flat_index in order.tolist():
        s, p = divmod(flat_index, best.shape[1])
        pairs.append(dict(
            tile=tile, slot=s, gaussian=int(ids[s]), pixel=p, threshold=THRESHOLDS[int(which[s, p])],
            units=float(best[s, p]),
            **{f"{name}{bits}": float(values[dtype][name][s, p])
               for dtype, bits in ((torch.float32, 32), (torch.float64, 64)) for name in ("power", "raw", "size")},
        ))
    return pairs


def describe(pair: dict) -> str:
    return (f"tile {pair['tile']} slot {pair['slot']} (Gaussian {pair['gaussian']}) pixel {pair['pixel']}: "
            f"{pair['units']:.3g} rounding units from {pair['threshold']}; power {pair['power32']:.9g} (f32) "
            f"{pair['power64']:.12g} (f64), raw {pair['raw32']:.9g} (f32) {pair['raw64']:.12g} (f64), "
            f"size {pair['size64']:.6g}")


def explain_tile(
    inp: dict, tile: int, col_max: torch.Tensor, rtol: float,
    fwd: Callable = composite_core, bwd: Callable = composite_bwd, plain: Callable = _plain_d_table,
) -> dict:
    """Steps 1-3 of the module's procedure on one tile. Returns its
    single-tile disagreement `diff` (kernel minus plain), the errors before
    and after the nudge relative to `col_max`, the pairs and `explained`."""
    t, table, chunk, tiles_x = inp["tiles"], inp["table"], inp["chunk"], inp["tiles_x"]
    only = torch.arange(t.counts.numel(), device=table.device) == tile
    counts = torch.where(only, t.counts, 0)
    n_proc = torch.where(only, inp["n_proc"], 0)

    def both(tb, n, trans):
        args = (tb, t.flat, t.block_start, counts, n, trans, inp["g_acc"], inp["g_trans"], tiles_x, chunk)
        return bwd(*args) - plain(*args)

    diff = both(table, n_proc, inp["trans"])
    before = float((diff.abs() / col_max).max())
    out = dict(tile=tile, diff=diff, before=before, after=float("nan"), pairs=[], explained=False)
    if before <= rtol:
        return out
    out["pairs"] = closest_pairs(inp, tile)
    near = [p for p in out["pairs"] if p["units"] <= NEAR_UNITS]
    if not near:
        return out
    moved = table.clone()
    for g, threshold in {(p["gaussian"], p["threshold"]) for p in near}:
        if threshold == THRESHOLDS[0]:
            moved[g, 2] *= 1.0 + NUDGE
            moved[g, 4] *= 1.0 + NUDGE
        else:
            moved[g, 5] *= 1.0 - NUDGE
    _, trans_moved, n_moved = fwd(moved, t.flat, t.block_start, counts, tiles_x, chunk)
    out["after"] = float((both(moved, n_moved, trans_moved).abs() / col_max).max())
    out["explained"] = out["after"] <= rtol
    return out


def compare(
    inp: dict, rtol: float, max_tiles: int = MAX_TILES,
    fwd: Callable = composite_core, bwd: Callable = composite_bwd, plain: Callable = _plain_d_table,
) -> dict:
    """The kernel's d_table against the plain version's on one view's
    inputs (`train_scene.backward_inputs`), each column relative to its
    largest |gradient|. `ok` says that every row agrees to `rtol` once the
    disagreements of at most `max_tiles` explained tiles are taken out.
    `max_rel_err` and `max_abs_err` are over all rows, nothing taken out."""
    t = inp["tiles"]
    args = (inp["table"], t.flat, t.block_start, t.counts, inp["n_proc"], inp["trans"],
            inp["g_acc"], inp["g_trans"], inp["tiles_x"], inp["chunk"])
    d_kernel, d_plain = bwd(*args), plain(*args)
    col_max = d_plain.abs().amax(dim=0).clamp(min=1e-30)
    residual = d_kernel - d_plain
    out = dict(
        d_kernel=d_kernel, col_max=col_max, tiles=[],
        max_rel_err=float((residual.abs() / col_max).max()), max_abs_err=float(residual.abs().max()),
    )
    while True:
        rel = (residual.abs() / col_max).amax(dim=1)  # per Gaussian
        beyond = rel > rtol
        out.update(residual_rel_err=float(rel.max()), rows_beyond=int(beyond.sum()))
        if not bool(beyond.any()) or len(out["tiles"]) == max_tiles:
            break
        hits = beyond[t.flat.long()]
        per_tile = [int(hits[tile_slots(inp, tile)].sum()) for tile in range(t.counts.numel())]
        done = {e["tile"] for e in out["tiles"]}
        order = sorted((tile for tile, n in enumerate(per_tile) if n and tile not in done), key=lambda x: -per_tile[x])
        for tile in order[:MAX_TRIED]:
            explained = explain_tile(inp, tile, col_max, rtol, fwd, bwd, plain)
            if explained["before"] > rtol:
                break
        else:
            out["tried"] = len(order[:MAX_TRIED])  # no tile shows the disagreement alone
            break
        explained["rows"] = per_tile[tile]
        out["tiles"].append(explained)
        diff = explained.pop("diff")
        if not explained["explained"]:
            break
        residual = residual - diff
    out["ok"] = out["rows_beyond"] == 0 and all(e["explained"] for e in out["tiles"])
    return out


def report(result: dict) -> list[str]:
    """Lines that say what `compare` found in the tiles it had to explain."""
    lines = []
    for e in result["tiles"]:
        lines.append(f"tile {e['tile']} lists {e['rows']} of the disagreeing rows; alone, kernel against plain "
                     f"{e['before']:.3g} of a column's max, {e['after']:.3g} with its closest pairs moved off "
                     f"their thresholds: {'explained' if e['explained'] else 'NOT explained'}")
        lines += ["  " + describe(p) for p in e["pairs"]]
    if "tried" in result:
        lines.append(f"none of the {result['tried']} tiles that list the disagreeing rows shows the disagreement alone")
    return lines


def main() -> None:
    from .eval_scene import card_line
    from .train_scene import backward_inputs, make_train_scene

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--model", default="re10k", choices=sorted(EXPERIMENTS))
    parser.add_argument("--batches", type=int, default=25)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("check_composite_bwd needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {card_line()}", flush=True)
    scene = make_train_scene(model=args.model)
    views = events = failures = 0
    worst_clean = 0.0
    for i in range(args.batches):
        for v, inp in enumerate(backward_inputs(scene, scene.batch(1, seed_offset=i), seed=i)):
            result = compare(inp, RTOL)
            views += 1
            if result["tiles"]:
                events += 1
                print(f"batch {i} view {v}: max err / column max {result['max_rel_err']:.3g} over all rows, "
                      f"{result['residual_rel_err']:.3g} with the explained tiles' share taken out, "
                      f"ok {result['ok']}", flush=True)
                for line in report(result):
                    print("  " + line, flush=True)
            else:
                worst_clean = max(worst_clean, result["max_rel_err"])
            failures += not result["ok"]
    print(f"{args.model}: {views} views, {events} with a disagreement beyond {RTOL}, {failures} not explained; "
          f"largest error of the others {worst_clean:.3g} of a column's max", flush=True)
    if failures:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
