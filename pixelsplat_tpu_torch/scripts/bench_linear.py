"""K10 (`csrc/linear_split.cu`) at every linear layer of an evaluation
scene, on the card: its error against float64 and against its plain twin,
and its time, beside its bound and cuBLAS.

    python -m pixelsplat_tpu_torch.scripts.bench_linear [--scenes re10k re10k_3_view gslrm] [--rounds 5]

Each scene runs each of its layers once as the encoder does, all views in
one launch, on seeded random weights and activations:

* `re10k` and `re10k_3_view` (2 or 3 context views at 256x256: 1025 tokens
  a view, ViT-B/8's widths): qkv 768 -> 2304 with its bias, proj 768 -> 768
  with its bias and the residual, fc1 768 -> 3072 with its bias and the
  GELU, fc2 3072 -> 768 with its bias and the residual; 12 blocks.
* `gslrm` (2 views at 256x256: 2,048 tokens, GS-LRM's widths): the patch's
  layer 576 -> 1024, qkv 1024 -> 3072, proj 1024 -> 1024 with the residual,
  fc1 1024 -> 4096 with the GELU, fc2 4096 -> 1024 with the residual, the
  head 1024 -> 768; the four block layers 24 times.

For each layer it prints the relative RMS error against float64 of K10, of
its plain TF32 build and of cuBLAS float32, K10's against its plain twin
(`linear_split_plain`, the parts summed in float64), and the milliseconds of a launch (CUDA events, the
median of `--rounds` rounds, the versions in a new order each round) of:

* K10 at the block width `tile_n` chooses, and at each width it takes
  (`ms_by_width`);
* cuBLAS float32, TF32 off, with the epilogue as separate ops, the route
  the encoder took before K10 (`library_ms`);

beside the bound, the layer's FLOP over 165 TFLOP/s (the H100's 495 TFLOP/s
TF32 rate over the three products). A scene's total is each layer's time
times its launches a scene. It ends with one JSON line and exits 1 where
K10's error is above twice cuBLAS float32's or its twin's difference above
`TWIN_RTOL`.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch
import torch.nn.functional as F

from pixelsplat_tpu_torch.scripts.bench_conv7 import PEAK_SPLIT_FLOPS, rel_rms, time_versions

# name: (K, N, epilogue, launches a scene)
VIT = {"qkv": (768, 2304, "bias", 12), "proj": (768, 768, "residual", 12), "fc1": (768, 3072, "gelu", 12),
       "fc2": (3072, 768, "residual", 12)}
GSLRM = {"patch": (576, 1024, "bias", 1), "qkv": (1024, 3072, "bias", 24), "proj": (1024, 1024, "residual", 24),
         "fc1": (1024, 4096, "gelu", 24), "fc2": (4096, 1024, "residual", 24), "head": (1024, 768, "bias", 1)}
# name: (rows, layers): ViT-B/8's 1025 tokens a 256x256 view (patch 8 and
# the CLS token); GS-LRM's 1,024 a view, both views in one sequence.
SCENES = {"re10k": (2 * 1025, VIT), "re10k_3_view": (3 * 1025, VIT), "gslrm": (2 * 1024, GSLRM)}
# K10 against its plain twin: the test's tolerance (`tests/test_torch_linear_split.py`).
TWIN_RTOL = 1e-6


def flops(m: int, k: int, n: int) -> float:
    return 2.0 * m * k * n


def cublas(x, w, b, gelu, residual):
    z = F.linear(x, w, b)
    z = F.gelu(z) if gelu else z
    return z if residual is None else residual + z


def layer(k: int, n: int, epi: str, m: int, rounds: int, gen: torch.Generator) -> dict:
    from pixelsplat_tpu_torch.ops import linear_kernel

    x = torch.randn((m, k), generator=gen).cuda()
    w = ((torch.rand((n, k), generator=gen) * 2 - 1) / k**0.5).cuda()
    b = ((torch.rand((n,), generator=gen) * 2 - 1) / k**0.5).cuda()
    residual = torch.randn((m, n), generator=gen).cuda() if epi == "residual" else None
    gelu = epi == "gelu"
    with torch.no_grad():
        want = F.linear(x.double(), w.double(), b.double())
        want = F.gelu(want) if gelu else want
        base = 0.0
        if residual is not None:
            base = residual.double()
            want = base + want
        k10 = linear_kernel.launch(x, w, b, residual, gelu)[0]
        tf32 = linear_kernel.launch(x, w, b, residual, gelu, terms=1)[0]
        lib = cublas(x, w, b, gelu, residual)
        twin = linear_kernel.linear_split_plain(x, w, b, residual, gelu, dtype=torch.float64)
        errors = {"k10": rel_rms(k10, want, base), "tf32": rel_rms(tf32, want, base),
                  "cublas_f32": rel_rms(lib, want, base), "twin": rel_rms(k10, twin, base)}
        del k10, tf32, lib, want, twin
        width = linear_kernel.tile_n(m, n, torch.cuda.get_device_properties(0).multi_processor_count)
        fns = {"ms": lambda: linear_kernel.launch(x, w, b, residual, gelu),
               "library_ms": lambda: cublas(x, w, b, gelu, residual)}
        for wd in linear_kernel.WIDTHS:
            if n % wd == 0:
                fns[f"ms_{wd}"] = lambda wd=wd: linear_kernel.launch(x, w, b, residual, gelu, block_n=wd)
        times = time_versions(fns, rounds)
    bound = flops(m, k, n) / PEAK_SPLIT_FLOPS * 1e3
    return {"m": m, "k": k, "n": n, "width": width, "ms": times["ms"], "library_ms": times["library_ms"],
            "ms_by_width": {wd: times[f"ms_{wd}"] for wd in linear_kernel.WIDTHS if n % wd == 0},
            "bound_ms": bound, "tflops": flops(m, k, n) / times["ms"] / 1e9, "errors": errors}


def scene(name: str, rounds: int) -> dict:
    m, layers = SCENES[name]
    gen = torch.Generator().manual_seed(23)
    out = {"name": name, "m": m, "layers": {}}
    total = {"ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    for label, (k, n, epi, count) in layers.items():
        r = layer(k, n, epi, m, rounds, gen)
        out["layers"][label] = r
        for key in total:
            total[key] += count * r[key]
        e = r["errors"]
        widths = ", ".join(f"{wd}: {ms:.4f}" for wd, ms in r["ms_by_width"].items())
        print(f"{name} {label} ({m} x {k} -> {n}, {count} a scene): K10 {r['ms']:.4f} ms at width {r['width']} "
              f"({r['tflops']:.1f} TFLOP/s, {100 * r['bound_ms'] / r['ms']:.1f} % of the bound {r['bound_ms']:.4f}; "
              f"by width {widths}), cuBLAS float32 {r['library_ms']:.4f} | relative RMS error against float64: "
              f"K10 {e['k10']:.3g}, plain TF32 {e['tf32']:.3g}, cuBLAS float32 {e['cublas_f32']:.3g}; "
              f"against the twin {e['twin']:.3g}", flush=True)
    out["launches"] = sum(count for *_, count in layers.values())
    out["scene"] = total
    out["roofline_share"] = 100.0 * total["bound_ms"] / total["ms"]
    print(f"{name} a scene ({out['launches']} launches): K10 {total['ms']:.3f} ms ({out['roofline_share']:.1f} % of "
          f"the 3xTF32 bound {total['bound_ms']:.3f}), cuBLAS float32 {total['library_ms']:.3f}", flush=True)
    return out


def faults(record: dict) -> list[str]:
    """Each layer whose K10 error is above twice cuBLAS float32's against
    float64, or whose difference from the twin is above `TWIN_RTOL`."""
    out = []
    for label, v in record["layers"].items():
        e = v["errors"]
        if not e["k10"] <= 2 * e["cublas_f32"]:
            out.append(f"{record['name']} {label}: relative RMS error {e['k10']:.3g} against float64, above twice "
                       f"cuBLAS float32's {e['cublas_f32']:.3g}")
        if not e["twin"] <= TWIN_RTOL:
            out.append(f"{record['name']} {label}: relative RMS difference {e['twin']:.3g} from the plain twin, "
                       f"above {TWIN_RTOL:g}")
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--scenes", nargs="+", default=list(SCENES), choices=list(SCENES))
    parser.add_argument("--rounds", type=int, default=5)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_linear needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from pixelsplat_tpu_torch.scripts.eval_scene import card_line

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    record = {"card": card, "scenes": [scene(s, args.rounds) for s in args.scenes]}
    print(json.dumps(record))
    bad = [f for s in record["scenes"] for f in faults(s)]
    for f in bad:
        print(f, file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
