"""Stage ablation of the backward compositing kernel, on the GPU.

    python -m pixelsplat_tpu_torch.scripts.bench_bwd_ablation [--model NAME]

Builds variants of `csrc/composite_bwd.cu`, each with one stage knocked out
by a text substitution in the source (the script fails if a substitution no
longer matches, so it follows the kernel as it changes), and times them on
a training step's target views at full width with seeded random weights:

  full          the kernel as it is
  -pass_b       no per-chunk gradient pass: memset, map, pass A, scan
  -pass_a       no per-chunk sums (pass B runs from unset seeds)
  -butterfly    pass B's warp sum replaced by one read of the lane's own
                partials (indexed by lane, so possibly through local memory)

Only `full` is numerically right; it is held against `composite_bwd_plain`.
Each view's variants are timed in turns (CUDA events over 20 calls after a
warm-up, twice), and the means are printed with the card's name and power
limit. A call includes the wrapper's allocations, as the kernel's own
ms/launch in `chip_smoke.py` does.
"""

from __future__ import annotations

import argparse
import ctypes
from pathlib import Path

import torch

from .. import kernel_build
from ..config import EXPERIMENTS
from ..ops.rasterizer import composite_kernel as ck
from .eval_scene import card_line, cuda_ms
from .train_scene import backward_inputs, make_train_scene

VARIANTS = {
    "full": (),
    "-pass_b": (("  chunk_grad_kernel<<<", "  if (0) chunk_grad_kernel<<<"),),
    "-pass_a": (("  chunk_sums_kernel<<<", "  if (0) chunk_sums_kernel<<<"),),
    "-butterfly": (("const float sum = warp_sum_16(part, lane);", "const float sum = part[lane & 15];"),),
}
VARIANT_DIR = kernel_build.BUILD_DIR / "bwd_ablation"


def variant_entry(name: str):
    """`composite_bwd` of the variant's library, built on first use."""
    source = (kernel_build.CSRC / "composite_bwd.cu").read_text()
    for old, new in VARIANTS[name]:
        if old not in source:
            raise RuntimeError(f"variant {name}: {old!r} is not in composite_bwd.cu")
        source = source.replace(old, new)
    csrc = VARIANT_DIR / name.lstrip("-")
    csrc.mkdir(parents=True, exist_ok=True)
    (csrc / "composite_bwd.cu").write_text(source)
    fn = kernel_build.load("composite_bwd", csrc).composite_bwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    return fn


def call(fn, inp: dict) -> torch.Tensor:
    """One call of a variant on a view's inputs, allocating as the wrapper
    does; returns d_table."""
    t, table, chunk = inp["tiles"], inp["table"], inp["chunk"]
    n_blocks = t.flat.numel() // chunk
    d_table = torch.zeros_like(table)
    sums = torch.empty((n_blocks, 256, 2), dtype=torch.float32, device=table.device)
    block_map = torch.empty((n_blocks,), dtype=torch.int32, device=table.device)
    err = fn(table.data_ptr(), t.flat.data_ptr(), t.block_start.data_ptr(), t.counts.data_ptr(),
             inp["n_proc"].data_ptr(), inp["trans"].data_ptr(), inp["g_acc"].data_ptr(), inp["g_trans"].data_ptr(),
             t.counts.numel(), inp["tiles_x"], chunk, table.shape[0], n_blocks,
             sums.data_ptr(), block_map.data_ptr(), d_table.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"composite_bwd variant failed: cudaError {err}")
    return d_table


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--model", default="re10k", choices=sorted(EXPERIMENTS))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_bwd_ablation needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}", flush=True)
    fns = {name: variant_entry(name) for name in VARIANTS}
    ts = make_train_scene(model=args.model)
    inputs = backward_inputs(ts, ts.batch(1), seed=0)

    first = inputs[0]
    t = first["tiles"]
    d_plain = ck.composite_bwd_plain(first["table"], t.flat, t.block_start, t.counts, first["n_proc"], first["trans"],
                                     first["g_acc"], first["g_trans"], first["tiles_x"], first["chunk"])[1]
    err = (call(fns["full"], first) - d_plain).abs() / d_plain.abs().amax(dim=0).clamp(min=1e-30)
    print(f"full against the plain version on view 0: max err / column max {float(err.max()):.3g}", flush=True)

    ms = {name: [] for name in VARIANTS}
    for v, inp in enumerate(inputs):
        view = {name: [] for name in VARIANTS}
        for order in (list(VARIANTS), list(reversed(VARIANTS))):
            for name in order:
                view[name].append(cuda_ms(lambda: call(fns[name], inp), iters=20))
        for name, x in view.items():
            ms[name].append(sum(x) / len(x))
        print(f"view {v} ({int(inp['n_proc'].sum())} processed chunks): "
              + ", ".join(f"{name} {ms[name][-1]:.4f}" for name in VARIANTS) + " ms", flush=True)
    print(f"{args.model} | {card} | mean ms per call over {len(inputs)} views: "
          + ", ".join(f"{name} {sum(x) / len(x):.4f}" for name, x in ms.items()), flush=True)


if __name__ == "__main__":
    main()
