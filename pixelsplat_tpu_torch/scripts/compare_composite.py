"""The compositing kernels of this checkout against those of another, on
one card, in turns.

    python -m pixelsplat_tpu_torch.scripts.compare_composite --other DIR [--model NAME]

`DIR` is the `pixelsplat_tpu_torch/csrc` directory of another checkout (an
unpacked `git archive` of an earlier commit, say). Both builds' forward
(`composite_fwd`) and backward (`composite_bwd`) kernels run on the same
inputs: the model's evaluation scene's target views (forward) and a
training step's target views (backward), at full width with seeded random
weights. Each is first held against its plain version: the forward's
n_proc and outputs, the backward through `check_composite_bwd.compare`.
Then each view is timed with CUDA events in the order other, this, this,
other, whole and on its longest tile alone (the tile with the most
processed chunks, every other tile's counts set to 0), and the means are
printed with the card's name and power limit.

The other checkout's kernels are taken to have this checkout's C
signatures (the chunk-parallel `composite_bwd`, with its scratch).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch

from .. import kernel_build
from ..config import EXPERIMENTS
from ..ops.rasterizer import composite_kernel as ck
from . import check_composite_bwd
from .check_composite_bwd import chunk_stats, longest_tile_only
from .eval_scene import card_line, cuda_ms, make_eval_scene, view_inputs
from .train_scene import backward_inputs, make_train_scene


def other_kernels(csrc: Path):
    """(forward, backward) of the other build, with the wrappers' Python
    signatures; neither counts launches."""
    fwd_fn = kernel_build.declare(kernel_build.load("composite_fwd", csrc),
                                  (("composite_fwd", ck.FWD_ARGTYPES),)).composite_fwd
    bwd_fn = kernel_build.declare(kernel_build.load("composite_bwd", csrc),
                                  (("composite_bwd", ck.BWD_ARGTYPES),)).composite_bwd

    def fwd(table, flat, block_start, counts, tiles_x, chunk, tile_size=16):
        n = counts.shape[0]
        acc = torch.empty((n, ck.CH_PAD, 256), device=table.device)
        trans = torch.empty((n, 256), device=table.device)
        n_proc = torch.empty((n,), dtype=torch.int32, device=table.device)
        kernel_build.launch("the other composite_fwd", fwd_fn, table.get_device(), table.data_ptr(), flat.data_ptr(),
                            block_start.data_ptr(), counts.data_ptr(), n, tiles_x, chunk, acc.data_ptr(),
                            trans.data_ptr(), n_proc.data_ptr())
        return acc, trans, n_proc

    def bwd(table, flat, block_start, counts, n_proc, trans, g_acc, g_trans, tiles_x, chunk, tile_size=16):
        d_table = torch.zeros_like(table)
        n_blocks = flat.numel() // chunk
        sums = torch.empty((n_blocks, 256, 2), device=table.device)
        block_map = torch.empty((n_blocks,), dtype=torch.int32, device=table.device)
        kernel_build.launch("the other composite_bwd", bwd_fn, table.get_device(), table.data_ptr(), flat.data_ptr(),
                            block_start.data_ptr(), counts.data_ptr(), n_proc.data_ptr(), trans.data_ptr(),
                            g_acc.data_ptr(), g_trans.data_ptr(), counts.shape[0], tiles_x, chunk, table.shape[0],
                            n_blocks, sums.data_ptr(), block_map.data_ptr(), d_table.data_ptr())
        return d_table

    return fwd, bwd


def in_turns(fns: dict, iters: int) -> dict:
    """name -> ms, timed other, this, this, other and averaged."""
    ms = {name: [] for name in fns}
    for name in ("other", "this", "this", "other"):
        ms[name].append(cuda_ms(fns[name], iters=iters))
    return {name: sum(v) / len(v) for name, v in ms.items()}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--other", type=Path, required=True, help="csrc directory of the other checkout")
    parser.add_argument("--model", default="re10k", choices=sorted(EXPERIMENTS))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("compare_composite needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}", flush=True)
    for name in ("composite_fwd", "composite_bwd"):
        for label, csrc in (("this", kernel_build.CSRC), ("other", args.other)):
            path, log = kernel_build.build(name, csrc)
            print(f"build {label} {name} -> {path.name}", flush=True)
            for line in log.splitlines():
                if "registers" in line or "spill" in line or "Compiling entry" in line:
                    print(f"  {line.strip()}", flush=True)
    fwd_other, bwd_other = other_kernels(args.other)

    # Forward: the evaluation scene's target views.
    scene = make_eval_scene(model=args.model)
    gaussians, settings, _, _ = scene.run(0)
    tiles_x, chunk = scene.image_shape[1] // settings.tile_size, settings.chunk
    fwd_ms = {"this": [], "other": []}
    fwd_long = {"this": [], "other": []}
    for v, (_, tiles, table) in enumerate(view_inputs(scene, gaussians, settings)):
        lists = (table, tiles.flat, tiles.block_start, tiles.counts)
        acc_p, trans_p, n_p = ck.composite_core_plain(*lists, tiles_x, chunk)
        for label, fn in (("this", ck.composite_core), ("other", fwd_other)):
            acc, trans, n = fn(*lists, tiles_x, chunk)
            same = n == n_p
            err = max(float((acc - acc_p)[same].abs().max()), float((trans - trans_p)[same].abs().max()))
            print(f"forward view {v} {label}: n_proc equal on {int(same.sum())}/{same.numel()} tiles, "
                  f"max err {err:.3g}", flush=True)
        counts_1, _ = longest_tile_only(tiles.counts, n_p)
        one = (table, tiles.flat, tiles.block_start, counts_1)
        whole = in_turns({"this": lambda: ck.composite_core(*lists, tiles_x, chunk),
                          "other": lambda: fwd_other(*lists, tiles_x, chunk)}, iters=50)
        longest = in_turns({"this": lambda: ck.composite_core(*one, tiles_x, chunk),
                            "other": lambda: fwd_other(*one, tiles_x, chunk)}, iters=50)
        print(f"forward view {v} ({int(tiles.counts.sum())} slots, {chunk_stats(n_p)}): ms/launch "
              f"this {whole['this']:.4f}, other {whole['other']:.4f}; longest tile alone this "
              f"{longest['this']:.4f}, other {longest['other']:.4f}", flush=True)
        for label in ("this", "other"):
            fwd_ms[label].append(whole[label])
            fwd_long[label].append(longest[label])
    del scene, gaussians
    torch.cuda.empty_cache()

    # Backward: a training step's target views.
    ts = make_train_scene(model=args.model)
    bwd_ms = {"this": [], "other": []}
    bwd_long = {"this": [], "other": []}
    for v, inp in enumerate(backward_inputs(ts, ts.batch(1), seed=0)):
        for label, fn in (("this", ck.composite_bwd), ("other", bwd_other)):
            result = check_composite_bwd.compare(inp, check_composite_bwd.RTOL, bwd=fn)
            print(f"backward view {v} {label}: max err / column max {result['max_rel_err']:.3g}, "
                  f"{len(result['tiles'])} tiles explained, ok {result['ok']}", flush=True)
            for line in check_composite_bwd.report(result):
                print(f"  {line}", flush=True)
        t = inp["tiles"]
        full = (inp["table"], t.flat, t.block_start, t.counts, inp["n_proc"], inp["trans"], inp["g_acc"],
                inp["g_trans"], inp["tiles_x"], inp["chunk"])
        counts_1, n_1 = longest_tile_only(t.counts, inp["n_proc"])
        one = full[:3] + (counts_1, n_1) + full[5:]
        whole = in_turns({"this": lambda: ck.composite_bwd(*full), "other": lambda: bwd_other(*full)}, iters=20)
        longest = in_turns({"this": lambda: ck.composite_bwd(*one), "other": lambda: bwd_other(*one)}, iters=20)
        print(f"backward view {v} ({int(t.counts.sum())} slots, {chunk_stats(inp['n_proc'])}): ms/launch "
              f"this {whole['this']:.4f}, other {whole['other']:.4f}; longest tile alone this "
              f"{longest['this']:.4f}, other {longest['other']:.4f}", flush=True)
        for label in ("this", "other"):
            bwd_ms[label].append(whole[label])
            bwd_long[label].append(longest[label])

    def mean(x):
        return sum(x) / len(x)

    for name, ms, long_ms in (("composite_fwd", fwd_ms, fwd_long), ("composite_bwd", bwd_ms, bwd_long)):
        print(f"{args.model} | {card} | {name} mean ms/launch: this {mean(ms['this']):.4f}, other "
              f"{mean(ms['other']):.4f}; longest tile alone: this {mean(long_ms['this']):.4f}, other "
              f"{mean(long_ms['other']):.4f} ({len(ms['this'])} views)", flush=True)


if __name__ == "__main__":
    main()
