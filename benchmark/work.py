"""The benchmark's own yardstick: the H100's peaks, the model FLOPs of a
scene, and the operations and bytes the compositing kernel needs for the
pairs the reference found.

Model FLOPs are the matrix products and convolutions of the forward pass
of the configuration's reference model (`spec.reference_module`), counted
by `torch.utils.flop_counter.FlopCounterMode` on meta tensors, so shapes
alone decide them. They are kept as data in
`flops/<config>.json`; `python -m benchmark.work <config>` writes them.

The compositing kernel's work is per (Gaussian, tile) pair that reached an
open pixel in the reference's own binning and early stop, times the 256
pixels of a tile: (19 + 2c) operations for c colour channels. Its bytes
count each input and output once: a row of 6 + c floats per distinct
Gaussian, an index per pair, and per pixel the c colours and the
transmittance.
"""

from __future__ import annotations

import json
import sys

import torch
from torch.utils.flop_counter import FlopCounterMode

from . import generator, spec
from .spec import HERE, load_json

PEAK_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
PEAK_BYTES = 3.35e12  # HBM3
TILE_PIXELS = 256
COLOURS = 3


def k1_work(works) -> tuple[float, float]:
    """(operations, bytes) of the forward compositing of these views."""
    ops = sum(w.pairs for w in works) * TILE_PIXELS * (19 + 2 * COLOURS)
    nbytes = sum(4 * ((6 + COLOURS) * w.gaussians + w.pairs + (COLOURS + 1) * w.pixels) for w in works)
    return float(ops), float(nbytes)


def roofline_share(ops: float, nbytes: float, seconds: float) -> tuple[float, str]:
    """(percent of the roofline, which peak bounds it)."""
    t_ops, t_bytes = ops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return 100.0 * max(t_ops, t_bytes) / seconds, ("operations" if t_ops >= t_bytes else "bytes")


def _context(config: dict, b: int) -> dict:
    enc = config["encoder"]
    h, w = config["image_shape"]
    v = enc["num_context_views"]
    eye = torch.eye(4).repeat(b, v, 1, 1)
    eye[:, :, 0, 3] = torch.linspace(0, 1, v)
    k = torch.tensor([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1]]).repeat(b, v, 1, 1)
    return {
        "image": torch.zeros(b, v, 3, h, w),
        "extrinsics": eye, "intrinsics": k,
        "near": torch.ones(b, v), "far": torch.full((b, v), 100.0),
    }


def count_flops(config: dict) -> dict:
    """Model FLOPs of one evaluation scene, by the configuration's reference
    model."""
    with torch.device("meta"):
        model = spec.reference_module(config).Encoder(config["encoder"])
        ctx = {k: t.to("meta") for k, t in _context(config, 1).items()}
        with FlopCounterMode(display=False) as counter:
            with torch.no_grad():
                model(ctx, 0, torch.zeros(generator.u_shape(config, 1)), None)
    return {"eval_scene": counter.get_total_flops()}


def flops_of(config_name: str) -> dict:
    return load_json(HERE / "flops" / f"{config_name}.json")


def main(argv: list[str]) -> None:
    for name in argv:
        config = load_json(HERE / "configs" / f"{name}.json")
        path = HERE / "flops" / f"{name}.json"
        path.parent.mkdir(exist_ok=True)
        path.write_text(json.dumps(count_flops(config), indent=1) + "\n")
        print(path.read_text())


if __name__ == "__main__":
    main(sys.argv[1:])
