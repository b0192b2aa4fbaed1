"""K11 (`csrc/conv3x3.cu`), MVSplat's stride-1 3x3 convolutions, on the card:
its error against float64 and its time, beside its bound, its plain twin and
cuDNN.

    python -m pixelsplat_tpu_torch.scripts.bench_conv3x3 [--rounds 5]

The convolutions are those K11 runs in an evaluation scene of the `mvsplat`
experiment (2 context views at 256x256, MVSplat's published widths), found
by running its encoder on meta tensors: 87 of them, at 25 distinct (c_in,
c_out, h, w) with the GELU where the encoder applies it. For each distinct
one, on seeded random weights and features, it prints the relative RMS
error against a float64 convolution of K11, of its plain TF32 build and of
cuDNN float32, and the device milliseconds of a launch (CUDA events around
a CUDA graph of 10 launches, the median of `--rounds` rounds, the versions
in a new order each round) of:

* K11;
* its plain twin (`conv3x3_split_plain`: three float32 convolutions);
* cuDNN float32, TF32 off, with the GELU as a separate op (`library_ms`),
  which the port never calls;

beside the bound, the convolution's FLOP over 165 TFLOP/s (the H100's 495
TFLOP/s TF32 rate over the three products). Then the same for the scene,
each distinct convolution times its count. It ends with one JSON line and
exits 1 where K11's error is above twice cuDNN float32's.
"""

from __future__ import annotations

import argparse
import collections
import json
import statistics
import sys

import torch
import torch.nn.functional as F

SIZE = 256
VIEWS = 2
PEAK_SPLIT_FLOPS = 495e12 / 3  # TF32 tensor cores, three products a multiply-add


def scene_convolutions(views: int = VIEWS, size: int = SIZE) -> list[dict]:
    """The convolutions K11 computes in one `mvsplat` evaluation scene, in
    the order the encoder runs them: name, c_in, c_out, n, h, w, gelu."""
    from pixelsplat_tpu_torch.config import mvsplat
    from pixelsplat_tpu_torch.model.encoder.encoder_costvolume import EncoderCostVolume
    from pixelsplat_tpu_torch.ops import conv3x3_kernel

    with torch.device("meta"):
        encoder = EncoderCostVolume(mvsplat()[0])
    names = {m: name for name, m in encoder.named_modules()}
    found = []

    def hook(module, inputs, _out):
        if isinstance(module, conv3x3_kernel.Conv3x3) and conv3x3_kernel.computes(module):
            n, c, h, w = inputs[0].shape
            found.append(dict(name=names[module], c_in=c, c_out=module.out_channels, n=n, h=h, w=w,
                              gelu=module.gelu))

    for module in names:
        module.register_forward_hook(hook)
    e = torch.eye(4).repeat(1, views, 1, 1)
    e[:, :, 0, 3] = torch.linspace(0, 1, views)
    k = torch.tensor([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1]]).repeat(1, views, 1, 1)
    context = {"image": torch.zeros(1, views, 3, size, size), "extrinsics": e, "intrinsics": k,
               "near": torch.ones(1, views), "far": torch.full((1, views), 100.0)}
    with torch.no_grad():
        encoder({name: t.to("meta") for name, t in context.items()}, 0, False)
    return found


def flops(c: dict) -> float:
    return 2.0 * 9 * c["c_in"] * c["c_out"] * c["n"] * c["h"] * c["w"]


def rel_rms(got, want) -> float:
    return float((got.double() - want).pow(2).mean().sqrt() / want.pow(2).mean().sqrt())


def graph_ms(graph: torch.cuda.CUDAGraph, reps: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_versions(fns: dict, rounds: int, reps: int = 10) -> dict:
    """Median device ms a call of each, over `rounds` rounds in rotating
    order; a round replays a CUDA graph of `reps` calls, so that the host's
    launch time, which the encoder's graphs do not pay either, is left out."""
    graphs = {}
    for name, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        graphs[name] = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graphs[name]):
            for _ in range(reps):
                fn()
    torch.cuda.synchronize()
    names = list(fns)
    ms = {name: [] for name in names}
    for r in range(rounds):
        for name in names[r % len(names):] + names[:r % len(names)]:
            ms[name].append(graph_ms(graphs[name], reps))
    return {name: statistics.median(v) for name, v in ms.items()}


def cudnn(x, weight, bias, gelu):
    z = F.conv2d(x, weight, bias, padding=1)
    return F.gelu(z) if gelu else z


def distinct(convs: list[dict]) -> list[tuple[dict, int]]:
    """Each distinct (c_in, c_out, n, h, w, gelu) with its count."""
    key = lambda c: (c["c_in"], c["c_out"], c["n"], c["h"], c["w"], c["gelu"])  # noqa: E731
    counts = collections.Counter(key(c) for c in convs)
    first = {}
    for c in convs:
        first.setdefault(key(c), c)
    return [(first[k], counts[k]) for k in first]


def measure(conv: dict, rounds: int, seed: int = 17) -> dict:
    """Errors and times of one distinct convolution."""
    from pixelsplat_tpu_torch.ops import conv3x3_kernel

    gen = torch.Generator().manual_seed(seed)
    c_in, c_out, gelu = conv["c_in"], conv["c_out"], conv["gelu"]
    x = torch.randn((conv["n"], c_in, conv["h"], conv["w"]), generator=gen).cuda()
    weight = (torch.randn((c_out, c_in, 3, 3), generator=gen) / (9 * c_in) ** 0.5).cuda()
    bias = (0.1 * torch.randn((c_out,), generator=gen)).cuda()
    with torch.no_grad():
        want = cudnn(x.double(), weight.double(), bias.double(), gelu)
        errors = {
            "k11": rel_rms(conv3x3_kernel.launch(x, weight, bias, gelu), want),
            "tf32": rel_rms(conv3x3_kernel.launch(x, weight, bias, gelu, terms=1), want),
            "cudnn_f32": rel_rms(cudnn(x, weight, bias, gelu), want),
        }
        del want
        times = time_versions({
            "ms": lambda: conv3x3_kernel.launch(x, weight, bias, gelu),
            "plain_ms": lambda: conv3x3_kernel.conv3x3_split_plain(x, weight, bias, gelu),
            "library_ms": lambda: cudnn(x, weight, bias, gelu),
        }, rounds)
    times["bound_ms"] = flops(conv) / PEAK_SPLIT_FLOPS * 1e3
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    width, n_tiles, splits = conv3x3_kernel.plan(conv["n"], c_in, conv["h"], conv["w"], c_out, sms)
    return {**times, "errors": errors, "tflops": flops(conv) / times["ms"] / 1e9,
            "roofline_share": 100.0 * times["bound_ms"] / times["ms"],
            "plan": {"width": width, "n_tiles": n_tiles, "splits": splits}}


def scene(rounds: int = 5) -> dict:
    """Every distinct convolution of a scene measured, and the scene's sums."""
    convs = scene_convolutions()
    out = {"convolutions": len(convs), "shapes": []}
    total = {"ms": 0.0, "bound_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
    for conv, count in distinct(convs):
        r = measure(conv, rounds)
        label = f"{conv['c_in']}->{conv['c_out']} {conv['n']}x{conv['h']}x{conv['w']}{' gelu' if conv['gelu'] else ''}"
        out["shapes"].append({"shape": label, "count": count, "first": conv["name"], **r})
        for k in total:
            total[k] += count * r[k]
        e = r["errors"]
        plan = r["plan"]
        print(f"{label} x{count} (width {plan['width']} x {plan['n_tiles']}, K in {plan['splits']}): "
              f"K11 {r['ms']:.4f} ms ({r['tflops']:.1f} TFLOP/s, {r['roofline_share']:.1f} % of "
              f"{r['bound_ms']:.4f}), twin {r['plain_ms']:.4f}, cuDNN f32 {r['library_ms']:.4f} | relative RMS error "
              f"against float64: K11 {e['k11']:.3g}, TF32 {e['tf32']:.3g}, cuDNN f32 {e['cudnn_f32']:.3g}", flush=True)
    out["scene"] = total
    out["roofline_share"] = 100.0 * total["bound_ms"] / total["ms"]
    print(f"scene, {len(convs)} convolutions: K11 {total['ms']:.3f} ms ({out['roofline_share']:.1f} % of the 3xTF32 "
          f"bound {total['bound_ms']:.3f}), twin {total['plain_ms']:.3f}, cuDNN f32 {total['library_ms']:.3f}",
          flush=True)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rounds", type=int, default=5)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_conv3x3 needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from pixelsplat_tpu_torch.scripts.eval_scene import card_line

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    record = {"card": card, **scene(args.rounds)}
    print(json.dumps(record))
    bad = [s["shape"] for s in record["shapes"] if not s["errors"]["k11"] <= 2 * s["errors"]["cudnn_f32"]]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
