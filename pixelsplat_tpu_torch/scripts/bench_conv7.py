"""K9 (`csrc/conv7.cu`), the refinement's two 7x7 convolutions, on the card:
its error against float64 and its time, beside its bound, its plain twin and
cuDNN.

    python -m pixelsplat_tpu_torch.scripts.bench_conv7 [--scenes re10k re10k_3_view] [--rounds 5]

For each evaluation scene (2 or 3 context views at 256x256, d_feature 128,
seeded random weights and features) it runs both launches of the
refinement as the encoder does: conv1 128 -> 256 with its bias and the
GELU, conv2 256 -> 128 with its bias and the residual. For each it prints
the relative RMS error against a float64 convolution of K9, of its plain
TF32 build and of cuDNN float32, and the milliseconds of a launch (CUDA
events, the median of `--rounds` rounds, the versions in a new order each
round) of:

* K9;
* its plain twin (`conv7_split_plain`: three float32 convolutions);
* cuDNN float32, TF32 off, on a contiguous channels-first input with the
  epilogue as separate ops: the default algorithm (`library_ms`), then the
  fastest that `torch.backends.cudnn.benchmark` finds (`library_best_ms`),
  which the port never sets;

beside the bound, the convolution's FLOP over 165 TFLOP/s (the H100's 495
TFLOP/s TF32 rate over the three products). It ends with one JSON line and
exits 1 where K9's error is above twice cuDNN float32's.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

import torch
import torch.nn.functional as F
from torch import nn

SCENES = {"re10k": 2, "re10k_3_view": 3}
SIZE = 256
D_FEATURE = 128
PEAK_SPLIT_FLOPS = 495e12 / 3  # TF32 tensor cores, three products a multiply-add


def flops(n: int, c_in: int, c_out: int) -> float:
    return 2.0 * 49 * c_in * c_out * n * SIZE * SIZE


def rel_rms(got, want, base) -> float:
    return float((got.double() - want).pow(2).mean().sqrt() / (want - base).pow(2).mean().sqrt())


def event_ms(fn, reps: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_versions(fns: dict, rounds: int, reps: int = 5) -> dict:
    """Median ms a call of each, over `rounds` rounds in rotating order."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    names = list(fns)
    ms = {name: [] for name in names}
    for r in range(rounds):
        for name in names[r % len(names):] + names[:r % len(names)]:
            ms[name].append(event_ms(fns[name], reps))
    return {name: statistics.median(v) for name, v in ms.items()}


def cudnn(x_cf, conv, gelu, residual_cf):
    z = F.conv2d(x_cf, conv.weight, conv.bias, padding=3)
    z = F.gelu(z) if gelu else z
    return z if residual_cf is None else residual_cf + z


def scene(name: str, rounds: int) -> dict:
    from pixelsplat_tpu_torch.ops import conv7_kernel

    n = SCENES[name]
    gen = torch.Generator().manual_seed(17)
    torch.manual_seed(17)
    conv1 = nn.Conv2d(D_FEATURE, 2 * D_FEATURE, 7, 1, 3).cuda()
    conv2 = nn.Conv2d(2 * D_FEATURE, D_FEATURE, 7, 1, 3).cuda()
    x = torch.randn((n, SIZE, SIZE, D_FEATURE), generator=gen).cuda()
    out = {"scene": name, "views": n, "launches": {}}
    with torch.no_grad():
        hidden64 = F.gelu(F.conv2d(x.double().permute(0, 3, 1, 2), conv1.weight.double(), conv1.bias.double(),
                                   padding=3)).permute(0, 2, 3, 1)
        hidden = hidden64.float()
        cases = {
            "conv1": (x, conv1, True, None, hidden64),
            "conv2": (hidden, conv2, False, x, None),
        }
        total = {"ms": 0.0, "bound_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "library_best_ms": 0.0}
        for label, (inp, conv, gelu, residual, want) in cases.items():
            if want is None:
                want = x.double() + F.conv2d(inp.double().permute(0, 3, 1, 2), conv.weight.double(),
                                             conv.bias.double(), padding=3).permute(0, 2, 3, 1)
            base = 0.0 if residual is None else residual.double()
            inp_cf = inp.permute(0, 3, 1, 2).contiguous()
            res_cf = None if residual is None else residual.permute(0, 3, 1, 2).contiguous()
            torch.backends.cudnn.benchmark = False
            k9 = conv7_kernel.launch(inp, conv.weight, conv.bias, residual, gelu)[0]
            tf32 = conv7_kernel.launch(inp, conv.weight, conv.bias, residual, gelu, terms=1)[0]
            lib = cudnn(inp_cf, conv, gelu, res_cf).permute(0, 2, 3, 1)
            errors = {"k9": rel_rms(k9, want, base), "tf32": rel_rms(tf32, want, base),
                      "cudnn_f32": rel_rms(lib, want, base)}
            del k9, tf32, lib
            fns = {
                "ms": lambda: conv7_kernel.launch(inp, conv.weight, conv.bias, residual, gelu),
                "plain_ms": lambda: conv7_kernel.conv7_split_plain(inp, conv.weight, conv.bias, residual, gelu),
                "library_ms": lambda: cudnn(inp_cf, conv, gelu, res_cf),
            }
            times = time_versions(fns, rounds)
            torch.backends.cudnn.benchmark = True
            best = time_versions({"ms": fns["ms"], "library_best_ms": fns["library_ms"]}, rounds)
            torch.backends.cudnn.benchmark = False
            times["library_best_ms"] = best["library_best_ms"]
            times["ms_beside_best"] = best["ms"]
            times["bound_ms"] = flops(n, conv.in_channels, conv.out_channels) / PEAK_SPLIT_FLOPS * 1e3
            out["launches"][label] = {**times, "errors": errors,
                                      "tflops": flops(n, conv.in_channels, conv.out_channels) / times["ms"] / 1e9}
            for k in total:
                total[k] += times[k]
            print(f"{name} {label}: K9 {times['ms']:.3f} ms ({out['launches'][label]['tflops']:.1f} TFLOP/s; "
                  f"{times['ms_beside_best']:.3f} beside cuDNN's best), bound {times['bound_ms']:.3f}, "
                  f"twin {times['plain_ms']:.3f}, cuDNN default {times['library_ms']:.3f}, best "
                  f"{times['library_best_ms']:.3f} | relative RMS error against float64: K9 {errors['k9']:.3g}, "
                  f"plain TF32 {errors['tf32']:.3g}, cuDNN float32 {errors['cudnn_f32']:.3g}", flush=True)
    out["scene"] = total
    out["roofline_share"] = 100.0 * total["bound_ms"] / total["ms"]
    print(f"{name} both launches: K9 {total['ms']:.3f} ms ({out['roofline_share']:.1f} % of the 3xTF32 bound "
          f"{total['bound_ms']:.3f}), twin {total['plain_ms']:.3f}, cuDNN default {total['library_ms']:.3f}, "
          f"best {total['library_best_ms']:.3f}", flush=True)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--scenes", nargs="+", default=list(SCENES), choices=list(SCENES))
    parser.add_argument("--rounds", type=int, default=5)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_conv7 needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from pixelsplat_tpu_torch.scripts.eval_scene import card_line

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    record = {"card": card, "scenes": [scene(s, args.rounds) for s in args.scenes]}
    print(json.dumps(record))
    bad = [(s["views"], k) for s in record["scenes"] for k, v in s["launches"].items()
           if not v["errors"]["k9"] <= 2 * v["errors"]["cudnn_f32"]]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
