"""Stage ablation of the forward compositing kernel: wrapper and variants.

`composite_core_ablation` replaces `tools/bench_kernel_ablation.py::
run_variant.call`, the Pallas compositor with chosen stages stubbed out
and a fixed-trip loop, built to say which stage of the per-slot work the
time goes to. It launches `csrc/composite_fwd_ablation.cu`, which
instantiates the production kernel's own device code
(`csrc/composite_fwd_body.cuh`) once per variant. It takes and returns
what `composite_kernel.composite_core` does.

`VARIANTS` maps a name to (drop mask, exit vote); the masks are the
header's. `full` walks every chunk of every tile with every stage on, so
its plain version is `composite_core_plain(..., early_exit=False)`;
`exit_vote` is the production loop, whose plain version is
`composite_core_plain`. The other variants are wrong on purpose and have
no plain version: they exist on the card only.
The tracer's counter `k1_ablation_launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ... import kernel_build
from ...utils import tracing
from .composite_kernel import CH_PAD, FWD_ARGTYPES, KERNEL_TILE, _check_lists, composite_core_plain

DROP_GATHER, DROP_POWER, DROP_EXP_POWER, DROP_TRANSMITTANCE, DROP_COLOURS = 1, 2, 4, 8, 16
DROP_EVERYTHING = 31

# name -> (drop mask, exit vote), in the order the bench prints them.
VARIANTS = {
    "full": (0, False),
    "exit_vote": (0, True),
    "-gather": (DROP_GATHER, False),
    "-power": (DROP_POWER, False),
    "-exp_power": (DROP_EXP_POWER, False),
    "-transmittance": (DROP_TRANSMITTANCE, False),
    "-colors": (DROP_COLOURS, False),
    "-everything": (DROP_EVERYTHING, False),
}


@functools.cache
def _entry_point():
    """`composite_fwd_ablation` of the built library, its C signature declared."""
    signature = ("composite_fwd_ablation", [ctypes.c_int] * 2 + FWD_ARGTYPES)
    return kernel_build.declare(kernel_build.load("composite_fwd_ablation"), (signature,)).composite_fwd_ablation


def composite_core_ablation(
    variant: str,
    table: torch.Tensor,  # (rows, 12) f32, last row the zero sentinel
    flat: torch.Tensor,  # (pair_budget,) int32
    block_start: torch.Tensor,  # (T,) int32
    counts: torch.Tensor,  # (T,) int32
    tiles_x: int,
    chunk: int = 128,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (acc (T, 8, 256), trans (T, 256), n_proc (T,) int32) of the
    named variant. On CPU tensors `full` and `exit_vote` run their plain
    versions; the stubbed variants raise."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {list(VARIANTS)}")
    drop, exit_vote = VARIANTS[variant]
    if table.device.type == "cpu":
        if drop:
            raise ValueError(f"variant {variant!r} is wrong on purpose and has no plain version: CUDA only")
        return composite_core_plain(table, flat, block_start, counts, tiles_x, chunk, early_exit=exit_vote)
    if table.device.type != "cuda":
        raise ValueError(f"composite_core_ablation runs on CUDA or CPU tensors, not {table.device}")
    _check_lists(table, flat, block_start, counts, chunk)
    fn = _entry_point()
    num_tiles = counts.shape[0]
    p = KERNEL_TILE * KERNEL_TILE
    acc = torch.empty((num_tiles, CH_PAD, p), dtype=torch.float32, device=table.device)
    trans = torch.empty((num_tiles, p), dtype=torch.float32, device=table.device)
    n_proc = torch.empty((num_tiles,), dtype=torch.int32, device=table.device)
    kernel_build.launch(
        f"composite_fwd_ablation ({variant})", fn, table.get_device(),
        drop, int(exit_vote),
        table.data_ptr(), flat.data_ptr(), block_start.data_ptr(), counts.data_ptr(),
        num_tiles, tiles_x, chunk,
        acc.data_ptr(), trans.data_ptr(), n_proc.data_ptr(),
    )
    tracing.count_launch("k1_ablation_launches")
    return acc, trans, n_proc
