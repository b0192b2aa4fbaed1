"""Where the evaluation scene's, or one training step's, time goes on the GPU.

    python -m pixelsplat_tpu_torch.scripts.profile_scene [--model NAME] [--train] [--out FILE]

Builds the scene of `eval_scene.py` (the model named, `re10k` by default,
at full width; 393,216 Gaussians),
warms up, then reports:

* host-clock milliseconds of encode, choose settings and render (each
  ending in a synchronize), and the device's busy share over one scene,
  from `torch.profiler`;
* CUDA-event milliseconds of the render's stages per view (project and
  bin together, bin alone, pack, the compositing kernel, and
  `composite_tiles` with its packing and image assembly), of the encoder's
  backbone and, where the model has one, of the epipolar transformer and
  its parts (sampling, depth encoding, the attention stack, the upscale
  with its two 7x7 refinement convolutions);
* the device kernels that take the most time, by name.

With `--train` it builds the training step of `train_scene.py` instead
(batch 1, 2 context + 4 target views at 256x256, MSE; LPIPS is gated off
at step 0) and reports the step's forward, backward and optimizer
milliseconds (CUDA events), the forward's stages (encode; per view project
and bin, pack, the forward kernel), the backward's (per view the
rasterizer's backward with the backward kernel alone beside it; the
encoder's backward as the rest), peak memory, and the device's busy share
and heaviest kernels over one step.

Needs a CUDA device; prints the card's name and power limit beside the
numbers. With `--out` the full profiler table also goes to that file.
"""

from __future__ import annotations

import argparse
import time

import torch

from ..config import EXPERIMENTS
from ..geometry.epipolar_lines import get_depth
from ..model.encoder.epipolar.epipolar_sampler import collect_other_views, sample_along_epipolar_lines
from ..model.encoder.epipolar.epipolar_transformer import conv_nhwc
from ..ops.rasterizer.binning import bin_gaussians
from ..ops.rasterizer.composite import composite_tiles, pack_columns
from ..ops.rasterizer.composite_kernel import composite_core
from ..ops.rasterizer.projection import GaussiansSoA
from ..ops.rasterizer.render import project_and_bin
from ..ops.rasterizer.composite_kernel import composite_bwd
from ..ops.rasterizer.projection import pack_gaussians_soa
from .eval_scene import TARGET_VIEWS, card_line, cuda_ms, make_eval_scene, view_inputs
from .train_scene import backward_inputs, make_train_scene, timed_step


def host_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def profile_and_report(run, label: str, reference_ms: float, card: str, out) -> None:
    """Device busy share and kernel breakdown over one call of `run`."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    device_us = sum(
        e.self_device_time_total for e in events if e.device_type == torch.autograd.DeviceType.CUDA
    )
    print(f"one {label}: device kernels {device_us / 1e3:.3f} ms; busy {device_us / 1e3 / reference_ms:.1%} "
          f"of the unprofiled host-clock {label} ({reference_ms:.3f} ms), "
          f"{device_us / wall_us:.1%} of the profiled one ({wall_us / 1e3:.3f} ms)")
    print(events.table(sort_by="self_device_time_total", row_limit=25, max_name_column_width=70))
    if out:
        with open(out, "w") as f:
            f.write(f"card: {card}\n")
            f.write(events.table(sort_by="self_device_time_total", row_limit=200, max_name_column_width=120))


def epipolar_transformer_stages(scene) -> dict[str, float]:
    """CUDA-event milliseconds of the epipolar transformer and its parts
    on the scene's context views, without autograd."""
    encoder = scene.wrapper.encoder
    et = encoder.epipolar_transformer
    context = scene.wrapper.data_shim(scene.batch)["context"]
    cams = [context[k] for k in ("extrinsics", "intrinsics", "near", "far")]
    with torch.no_grad():
        features = encoder.backbone_projection(encoder.backbone(context["image"]))
        b, v, h, w, c = features.shape
        down = conv_nhwc(et.downscaler, features.reshape(b * v, h, w, c))
        low = down.reshape(b, v, *down.shape[1:])
        sampling = sample_along_epipolar_lines(low, *cams, et.cfg.num_samples)
        rays = (sampling.origins[:, :, None, :, None], sampling.directions[:, :, None, :, None])
        others = [collect_other_views(x, v)[:, :, :, None, None] for x in cams[:2]]
        q = low.reshape(-1, 1, c)
        kv = sampling.features.permute(0, 1, 3, 4, 2, 5).reshape(q.shape[0], -1, c)
        hl, wl = low.shape[2:4]
        up = conv_nhwc(et.upscaler, low.reshape(b * v, hl, wl, c))
        up_nchw = up.permute(0, 3, 1, 2).contiguous()
        attention = et.transformer.layers[0][0]
        feed_forward = et.transformer.layers[0][1]
        return {
            "all": cuda_ms(lambda: et(features, *cams)),
            "downscale": cuda_ms(lambda: conv_nhwc(et.downscaler, features.reshape(b * v, h, w, c))),
            "sampling": cuda_ms(lambda: sample_along_epipolar_lines(low, *cams, et.cfg.num_samples)),
            "sample depths": cuda_ms(lambda: get_depth(*rays, sampling.xy_sample, *others)),
            "transformer": cuda_ms(lambda: et.transformer(q, z=kv, b=b, v=v, h=hl, w=wl)),
            "one cross-attention": cuda_ms(lambda: attention(q, z=kv)),
            "one image self-attention": cuda_ms(lambda: feed_forward(q, b=b, v=v, h=hl, w=wl)),
            "upscale": cuda_ms(lambda: conv_nhwc(et.upscaler, low.reshape(b * v, hl, wl, c))),
            "refinement (two 7x7 convs)": cuda_ms(lambda: conv_nhwc(et.upscale_refinement, up)),
            "refinement, channels-first contiguous input": cuda_ms(lambda: et.upscale_refinement(up_nchw)),
            "refinement, channels-last input": cuda_ms(
                lambda: et.upscale_refinement(up_nchw.contiguous(memory_format=torch.channels_last))
            ),
        }


def profile_train(card: str, out, model: str) -> None:
    ts = make_train_scene(model=model)
    wrapper, state = ts.wrapper, ts.state
    batch = ts.batch(1)
    timed_step(ts, batch)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    splits = [timed_step(ts, batch) for _ in range(3)]
    step = {k: sum(s[k] for s in splits) / len(splits) for k in splits[0]}
    peak = torch.cuda.max_memory_allocated() / 2**30
    step_host = host_ms(lambda: timed_step(ts, batch))
    print(f"train step (batch 1, MSE), CUDA events: forward {step['forward_ms']:.3f} ms, backward "
          f"{step['backward_ms']:.3f} ms, optimizer {step['optimizer_ms']:.3f} ms; host clock "
          f"{step_host:.3f} ms; peak memory {peak:.2f} GiB")

    # Forward stages. The encoder with autograd on, then per target view.
    shimmed = wrapper.data_shim(batch)
    generator = torch.Generator(device=wrapper.device).manual_seed(1)
    encode = cuda_ms(lambda: wrapper.encoder(shimmed["context"], 0, False, generator=generator))
    gaussians = wrapper.encoder(shimmed["context"], 0, False, generator=generator)
    leaves = [x[0].detach().requires_grad_(True) for x in
              (gaussians.means, gaussians.covariances, gaussians.opacities, gaussians.harmonics)]
    settings = wrapper.decoder.cfg.render
    target = shimmed["target"]
    h, w = ts.image_shape
    views = target["image"].shape[1]
    background = torch.zeros(3, device=wrapper.device)

    def render_view(v, backward):
        soa = pack_gaussians_soa(leaves[0], leaves[1], leaves[2], harmonics=leaves[3])
        projected, tiles = project_and_bin(
            target["extrinsics"][0, v], target["intrinsics"][0, v], target["near"][0, v], soa,
            image_shape=(h, w), settings=settings,
        )
        image = composite_tiles(projected, tiles, (h, w), background, settings.tile_size, settings.chunk)
        if backward:
            ((image - target["image"][0, v]) ** 2).mean().backward()
            for x in leaves:
                x.grad = None

    render_fwd = sum(cuda_ms(lambda: render_view(v, False)) for v in range(views)) / views
    render_both = sum(cuda_ms(lambda: render_view(v, True)) for v in range(views)) / views
    inputs = backward_inputs(ts, batch)
    k1 = k2 = 0.0
    for inp in inputs:
        t = inp["tiles"]
        lists = (inp["table"], t.flat, t.block_start, t.counts)
        k1 += cuda_ms(lambda: composite_core(*lists, inp["tiles_x"], inp["chunk"]), iters=50) / views
        k2 += cuda_ms(
            lambda: composite_bwd(*lists, inp["n_proc"], inp["trans"], inp["g_acc"], inp["g_trans"],
                                  inp["tiles_x"], inp["chunk"]),
            iters=20,
        ) / views
    raster_bwd = render_both - render_fwd
    print(f"forward stages, ms: encode {encode:.3f}; per view render {render_fwd:.3f} "
          f"(forward kernel {k1:.3f}); {views} views {views * render_fwd:.3f}")
    print(f"backward stages, ms: per view rasterizer backward {raster_bwd:.3f} (backward kernel {k2:.3f}); "
          f"{views} views {views * raster_bwd:.3f}; encoder backward and the rest "
          f"{step['backward_ms'] - views * raster_bwd:.3f}; the backward kernel's share of the step "
          f"{views * k2 / sum(step.values()):.2%}")
    profile_and_report(lambda: timed_step(ts, batch), "training step", step_host, card, out)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="write the full profiler table here")
    parser.add_argument("--train", action="store_true", help="profile one training step instead")
    parser.add_argument("--model", default="re10k", choices=sorted(EXPERIMENTS))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_scene needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}")
    if args.train:
        profile_train(card, args.out, args.model)
        print(f"card: {card}")
        return

    scene = make_eval_scene(model=args.model)
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
    if encoder.cfg.use_epipolar_transformer:
        print("epipolar transformer, ms: " + ", ".join(
            f"{k} {v:.3f}" for k, v in epipolar_transformer_stages(scene).items()))

    profile_and_report(lambda: scene.run(0), "scene", t_encode + t_choose + t_render, card, args.out)
    print(f"card: {card}")


if __name__ == "__main__":
    main()
