"""Where the evaluation scene's time goes on the GPU.

    python -m pixelsplat_tpu_torch.scripts.profile_scene [--out FILE]

Builds the scene of `eval_scene.py` (full width, 393,216 Gaussians),
warms up, then reports:

* host-clock milliseconds of encode, choose settings and render (each
  ending in a synchronize), and the device's busy share over one scene,
  from `torch.profiler`;
* CUDA-event milliseconds of the render's stages per view (project and
  bin together, bin alone, pack, the compositing kernel, and
  `composite_tiles` with its packing and image assembly) and of the
  encoder's backbone;
* the device kernels that take the most time, by name.

Needs a CUDA device; prints the card's name and power limit beside the
numbers. With `--out` the full profiler table also goes to that file.
"""

from __future__ import annotations

import argparse
import time

import torch

from ..ops.rasterizer.binning import bin_gaussians
from ..ops.rasterizer.composite import composite_tiles, pack_columns
from ..ops.rasterizer.composite_kernel import composite_core
from ..ops.rasterizer.projection import GaussiansSoA
from ..ops.rasterizer.render import project_and_bin
from .eval_scene import TARGET_VIEWS, card_line, cuda_ms, make_eval_scene, view_inputs


def host_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="write the full profiler table here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_scene needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}")

    scene = make_eval_scene()
    gaussians, settings, _, _ = scene.run(1)  # warm-up
    gaussians, settings, _, _ = scene.run(0)
    torch.cuda.synchronize()

    # Host clock, one scene.
    box = {}
    t_encode = host_ms(lambda: box.update(g=scene.encode(scene.batch, False, 0)))
    t_choose = host_ms(lambda: box.update(s=scene.choose(box["g"])))
    t_render = host_ms(lambda: scene.render(box["g"], box["s"]))
    print(f"host ms: encode {t_encode:.3f}, choose settings {t_choose:.3f}, "
          f"render {t_render:.3f} ({t_render / TARGET_VIEWS:.3f} per view)")

    # Render stages per view, CUDA events.
    soa = GaussiansSoA(*(None if x is None else x[0] for x in gaussians))
    t = scene.target
    h, w = scene.image_shape
    stages = {"project + bin": 0.0, "bin": 0.0, "pack": 0.0, "composite kernel": 0.0, "composite_tiles": 0.0}
    background = torch.zeros(3, device=t["near"].device)
    for v, (proj, tiles, table) in enumerate(view_inputs(scene, gaussians, settings)):
        cams = (t["extrinsics"][0, v], t["intrinsics"][0, v], t["near"][0, v])
        bin_kw = dict(tile_size=settings.tile_size, capacity=settings.capacity, span=settings.span,
                      big_capacity=settings.big_capacity, chunk=settings.chunk,
                      pair_budget=settings.pair_budget)
        stages["project + bin"] += cuda_ms(
            lambda: project_and_bin(*cams, soa, image_shape=(h, w), settings=settings)
        )
        stages["bin"] += cuda_ms(lambda: bin_gaussians(proj, (h, w), **bin_kw))
        stages["pack"] += cuda_ms(lambda: pack_columns(proj).contiguous())
        stages["composite kernel"] += cuda_ms(
            lambda: composite_core(table, tiles.flat, tiles.block_start, tiles.counts,
                                   w // settings.tile_size, settings.chunk),
            iters=50,
        )
        stages["composite_tiles"] += cuda_ms(
            lambda: composite_tiles(proj, tiles, (h, w), background, settings.tile_size, settings.chunk)
        )
    print("render stages, ms per view: " + ", ".join(f"{k} {v / TARGET_VIEWS:.3f}" for k, v in stages.items()))

    encoder = scene.wrapper.encoder
    image = scene.wrapper.data_shim(scene.batch)["context"]["image"]
    with torch.no_grad():
        backbone = cuda_ms(lambda: encoder.backbone(image))
        vit = cuda_ms(lambda: encoder.backbone.dino(image.reshape(-1, *image.shape[2:])))
        resnet = cuda_ms(lambda: encoder.backbone.resnet_backbone(image))
    print(f"encoder stages, ms: backbone {backbone:.3f} (ViT {vit:.3f}, ResNet {resnet:.3f})")

    # Device busy share and kernel breakdown over one scene.
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        scene.run(0)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    device_us = sum(
        e.self_device_time_total for e in events if e.device_type == torch.autograd.DeviceType.CUDA
    )
    scene_ms = t_encode + t_choose + t_render
    print(f"one scene: device kernels {device_us / 1e3:.3f} ms; busy {device_us / 1e3 / scene_ms:.1%} "
          f"of the unprofiled host-clock scene ({scene_ms:.3f} ms), "
          f"{device_us / wall_us:.1%} of the profiled one ({wall_us / 1e3:.3f} ms)")
    table = events.table(sort_by="self_device_time_total", row_limit=25, max_name_column_width=70)
    print(table)
    if args.out:
        with open(args.out, "w") as f:
            f.write(f"card: {card}\n")
            f.write(events.table(sort_by="self_device_time_total", row_limit=200, max_name_column_width=120))
    print(f"card: {card}")


if __name__ == "__main__":
    main()
