#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`pixelsplat_tpu_torch`) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each reported on its own lines; any failure exits non-zero:

1. device: the card's name and power limit (nvidia-smi); TF32 off for
   cuDNN convolutions and matmuls.
2. build: every CUDA kernel under pixelsplat_tpu_torch/csrc, one nvcc each,
   all at once.
3. smoke (`scripts/kernel_smoke.py`): the smallest kernel (y = 2 x) against
   its plain version, exactly, then the forward compositing kernel on a
   4-tile input against its plain version: a broken toolchain fails here.
4. For each model, `re10k_ablation_no_epipolar_transformer` and then the
   production `re10k` (with the epipolar transformer, `remat_encoder` on),
   at full width with random weights from a seeded torch.Generator,
   through the `ModelWrapper` entry points:
   - scene (`scripts/eval_scene.py`): encode 2 context views at 256x256
     (probabilistic, 3 Gaussians per pixel, SoA), choose render settings,
     render 3 target views. Checks 393,216 Gaussians, finite images, no
     dropped pairs, the forward kernel launched exactly once per view;
   - kernels: the forward compositing kernel against its plain version on
     that scene's three tile lists;
   - reference: the same weights on a 64x64 input, card against the port
     on the CPU;
   - train (`scripts/train_scene.py`; 2 context + 4 target views): the
     ablation takes one step from step 0 and one at `apply_after_step`, so
     LPIPS's VGG runs; `re10k` takes one step at batch 1 from step 0, one
     `accumulate=2` step on a batch of 2 and one step of its recipe (batch
     7, `accumulate=7`). Checks finite losses and gradients, a gradient on
     every parameter (for `re10k` a non-zero one on every
     `epipolar_transformer.*` tensor), moved weights, no dropped pairs,
     both compositing kernels launched exactly once per target view per
     micro-batch;
   - kernels: the backward compositing kernel against its plain version
     on a training step's real inputs, every row to one tolerance; a
     disagreement passes only when `scripts/check_composite_bwd.py`
     traces it to a (slot, pixel) pair within rounding of an alpha
     threshold;
   - reference: gradients of a 64x64 batch, card against CPU;
   - timing: encode, render per view, the step's forward, backward and
     optimizer, each kernel and its plain version (CUDA events after
     warm-up), each compositing kernel also on its view's longest tile
     alone (the tile with the most processed chunks, the other tiles'
     counts set to 0), peak memory. The kernel lines give each view's
     processed chunks: sum, mean and max per tile.
5. tools: the row-major copy kernel against `clone`, bit for bit, on the
   segment-sum bench's (820,224, 24) 16-bit table, contiguous and
   transposed; the four segment sums of `scripts/bench_segment_sum.py`
   against each other; every variant of the stage-ablation kernel
   (`scripts/bench_kernel_ablation.py`) on `re10k`'s first view, `full`
   against the plain compositor without early exit; their times beside
   their bounds and library calls.

Every kernel's launch count is set to 0 just before each path is driven
and read just after it. The run ends with the card line, a JSON record of
the five kernels and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0

# H100 SXM peaks from NVIDIA's data sheet (dense): HBM bandwidth and FP32
# (non-tensor-core) rate.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
# FP32 operations per (list slot, pixel) evaluation in the compositing
# loop: offset 2, quadratic form 9, opacity scale 1, clamp 1, tests and
# select 3, weight 1, six colour FMAs 12, transmittance update 2 (the expf
# goes to the special-function units and is not counted here).
COMPOSITE_OPS_PER_EVAL = 31
# FP32 operations per (list slot, pixel) evaluation in the backward sweep:
# the forward's alpha recomputed 16 (offset 2, quadratic form 9, opacity
# scale 1, tests, select and clamp 4), colour . g 12, log T, w, S, d_alpha,
# d_power and d_opacity 10, the five geometry partials 18, six colour
# partials 6, and one add per partial into its per-slot sum 12 (expf,
# log1pf and the second expf go to the special-function units).
COMPOSITE_BWD_OPS_PER_EVAL = 74
# Kernel vs plain version: f32 sums of up to a few thousand terms per pixel
# in another order, and the kernel's expf against torch.exp.
KERNEL_ATOL = 1e-4
# Backward kernel vs plain version, per column of d_table relative to that
# column's largest |gradient|: each entry sums up to 256 pixels x several
# tiles in an order the atomics choose, and T is rebuilt through
# exp(log T_end - sum log1p(-alpha)) with expf/log1pf against torch's.
# Every row is held to it; a disagreement passes only when
# `scripts/check_composite_bwd.py` traces it to a (slot, pixel) pair within
# rounding of an alpha threshold, in at most two tiles of a view.
BWD_KERNEL_RTOL = 1e-4
# Card vs CPU gradients on the small input: relative L2 error over all
# parameters. f32 through ~70 layers forward and back in another order;
# a depth sample whose CDF comparison falls the other way moves one of
# 24,576 Gaussians to a neighbouring bucket.
GRAD_REFERENCE_RTOL = 1e-3
# The references of a model with the epipolar transformer are held twice.
# Its depth encoding feeds sin(2 pi 2^o d) of each sample's relative
# disparity d for o < 10. d comes from a least-squares intersection of two
# nearly parallel rays, which float32 gives to ~2e-5 (card and CPU each lie
# 1.8e-5 from the float64 value and 2.6e-5 from each other on the small
# input), so the top octave's argument differs by 2 pi 512 x 2.6e-5 = 0.08
# rad between any two float32 evaluations, and single Gaussians by up to
# 14 % of the largest opacity. With the encoding cut to REFERENCE_OCTAVES
# (seeded weights of that shape) the card meets the tight tolerances. As
# configured it is held to limits a few times what the H100 reads on this
# input (Gaussians: largest error 0.137 of a field's largest entry, median
# 1.4e-6; images: mean error 2.8e-5, 0.74 % of pixels off by more than 1e-3;
# gradients: relative L2 error 5.2e-4, loss equal to 8e-6 relative): a
# single Gaussian may move, the median one, the images and the gradients
# may not.
REFERENCE_OCTAVES = 4
LOOSE_GAUSSIAN_MAX_ERR = 0.3
LOOSE_GAUSSIAN_MEDIAN_ERR = 5e-6
LOOSE_IMAGE_MEAN_ERR = 1e-4
LOOSE_IMAGE_FRAC_OFF = 0.02
LOOSE_GRAD_REFERENCE_RTOL = 5e-3
# The smoke phase's compositor check: 256 slots per pixel.
SMOKE_COMPOSITE_ATOL = 1e-5
ABLATION, RE10K = "re10k_ablation_no_epipolar_transformer", "re10k"
APPLY_LPIPS_AFTER = 150_000
# (label, state step to start from or None to go on, steps, batch, accumulate)
TRAIN_PLANS = {
    ABLATION: (("step 0 (MSE)", 0, 1, 1, 1), ("step with LPIPS", APPLY_LPIPS_AFTER, 1, 1, 1)),
    RE10K: (
        ("step 0 (MSE, remat)", 0, 1, 1, 1),
        ("accumulate=2, batch 2", None, 1, 2, 2),
        ("recipe: accumulate=7, batch 7", None, 1, 7, 7),
    ),
}


def fail(message: str) -> None:
    print(f"FAIL: {message}", flush=True)
    sys.exit(1)


def phase(name: str, message: str) -> None:
    print(f"[{name}] {message}", flush=True)


def composite_bound_ms(tiles, table, n_proc, chunk: int) -> tuple[float, str]:
    """Least time for one compositing launch on these inputs: the larger of
    its bytes (inputs read once, outputs written once) over HBM bandwidth
    and its FP32 work on the list slots it composites over the FP32 rate."""
    import torch

    num_tiles = tiles.counts.numel()
    pixels = 256
    evals = int(torch.minimum(tiles.counts.long(), n_proc.long() * chunk).sum()) * pixels
    bytes_in = table.numel() * 4 + tiles.flat.numel() * 4 + 2 * num_tiles * 4
    bytes_out = num_tiles * (8 * pixels + pixels + 1) * 4
    t_bytes = (bytes_in + bytes_out) / PEAK_BYTES_PER_S
    t_ops = evals * COMPOSITE_OPS_PER_EVAL / PEAK_FP32_PER_S
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def composite_bwd_bound_ms(inp) -> tuple[float, str]:
    """Least time for one backward compositing launch on these inputs: the
    larger of its bytes (table, ids, per-tile integers, T and both
    cotangents read once, d_table written once) over HBM bandwidth and its
    FP32 work on the list slots the forward composited over the FP32 rate."""
    import torch

    tiles, table, chunk = inp["tiles"], inp["table"], inp["chunk"]
    num_tiles = tiles.counts.numel()
    pixels = 256
    evals = int(torch.minimum(tiles.counts.long(), inp["n_proc"].long() * chunk).sum()) * pixels
    bytes_in = (
        table.numel() * 4 + tiles.flat.numel() * 4 + 3 * num_tiles * 4
        + num_tiles * (pixels + 8 * pixels + pixels) * 4
    )
    bytes_out = table.numel() * 4
    t_bytes = (bytes_in + bytes_out) / PEAK_BYTES_PER_S
    t_ops = evals * COMPOSITE_BWD_OPS_PER_EVAL / PEAK_FP32_PER_S
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def bwd_args(inp):
    t = inp["tiles"]
    return (inp["table"], t.flat, t.block_start, t.counts, inp["n_proc"], inp["trans"],
            inp["g_acc"], inp["g_trans"], inp["tiles_x"], inp["chunk"])


def check_bwd_kernel_against_plain(v, inp) -> tuple[float, float, int]:
    """K2 against composite_bwd_plain on one view's inputs, through
    `scripts/check_composite_bwd.py::compare`; returns the largest error of
    d_table relative to its column's largest |gradient| and the largest
    absolute error, both over all rows, and how many tiles' disagreements
    were traced to a pair at a threshold."""
    from pixelsplat_tpu_torch.scripts import check_composite_bwd
    from pixelsplat_tpu_torch.scripts.check_composite_bwd import chunk_stats

    result = check_composite_bwd.compare(inp, BWD_KERNEL_RTOL)
    d_kernel = result["d_kernel"]
    if not bool(d_kernel.isfinite().all()):
        fail(f"view {v}: composite_bwd returned non-finite gradients")
    phase(
        "kernels",
        f"composite_bwd view {v}: max err / column max {result['max_rel_err']:.3g} over all "
        f"{d_kernel.shape[0]} rows; {len(result['tiles'])} tiles had to be explained, "
        f"{result['residual_rel_err']:.3g} with their share taken out; largest column max |grad| "
        f"{float(result['col_max'].max()):.3g}, {chunk_stats(inp['n_proc'])}, "
        f"list slots {int(inp['tiles'].counts.sum())}",
    )
    for line in check_composite_bwd.report(result):
        phase("kernels", f"composite_bwd view {v}: {line}")
    if float(d_kernel[-1].abs().max()) != 0.0:
        fail(f"view {v}: composite_bwd wrote to the sentinel row")
    if not result["ok"]:
        fail(f"view {v}: composite_bwd off by {result['residual_rel_err']:.3g} of a column's max on "
             f"{result['rows_beyond']} rows that no pair at a threshold explains")
    return result["max_rel_err"], result["max_abs_err"], len(result["tiles"])


def train_phase(torch, kernels, model):
    """Training steps of `model` at full width through make_train_step;
    returns the scene, the kernels' launch counts and the peak memory per
    kind of step."""
    from pixelsplat_tpu_torch.config import NUM_TARGET_VIEWS
    from pixelsplat_tpu_torch.scripts.train_scene import make_train_scene

    ts = make_train_scene(seed=SEED, model=model)
    state = ts.state
    before = {k: v.detach().clone() for k, v in state.params.items()}
    for fn in kernels.values():
        fn.launches = 0
    peaks, parts = {}, []
    micro_batches = 0
    for i, (label, at_step, n, batch_size, accumulate) in enumerate(TRAIN_PLANS[model]):
        if at_step is not None:
            state.step = at_step
        batch = ts.batch(batch_size, seed_offset=i)
        torch.cuda.reset_peak_memory_stats()
        parts += [(label, p) for p in ts.steps(n, batch, accumulate=accumulate)]
        torch.cuda.synchronize()
        peaks[label] = torch.cuda.max_memory_allocated() / 2**30
        micro_batches += n * accumulate
        del batch
    launches = {name: fn.launches for name, fn in kernels.items()}

    for label, p in parts:
        values = {k: float(v) for k, v in p.items()}
        phase("train", f"{model} {label}: " + ", ".join(f"{k} {x:.6g}" for k, x in values.items()))
        if not all(x == x and abs(x) != float("inf") for x in values.values()):
            fail(f"{label}: a loss part is not finite")
        if values["train/overflow_pairs"] != 0:
            fail(f"{label}: {values['train/overflow_pairs']} (gaussian, tile) pairs dropped")
        if (values["loss/lpips"] != 0.0) != ("LPIPS" in label):
            fail(f"{label}: the LPIPS gate: expected 0 before apply_after_step and a value from it on")

    missing = [k for k, p in state.params.items() if p.requires_grad and p.grad is None]
    if missing:
        fail(f"{len(missing)} parameters have no gradient, e.g. {missing[:3]}")
    if not all(bool(torch.isfinite(p.grad).all()) for p in state.params.values()):
        fail("a gradient is not finite")
    for group in ("to_gaussians", "depth_predictor", "backbone.dino", "backbone.resnet_backbone"):
        grads = [p.grad for k, p in state.params.items() if k.startswith(group)]
        if not grads or not any(bool((g != 0).any()) for g in grads):
            fail(f"no non-zero gradient under {group}")
    transformer = {k: p for k, p in state.params.items() if k.startswith("epipolar_transformer.")}
    if bool(transformer) != ts.wrapper.encoder_cfg.use_epipolar_transformer:
        fail(f"{model}: {len(transformer)} epipolar_transformer tensors")
    dead = [k for k, p in transformer.items() if not bool((p.grad != 0).any())]
    if dead:
        fail(f"{len(dead)} epipolar_transformer tensors have an all-zero gradient, e.g. {dead[:3]}")
    moved = sum(bool((before[k] != p.detach()).any()) for k, p in state.params.items())
    phase("train", f"{model}: {moved}/{len(before)} parameter tensors moved, {len(transformer)} of the epipolar "
          f"transformer with non-zero gradients, remat_encoder {ts.wrapper.train_cfg.remat_encoder}, "
          f"launches {launches} over {micro_batches} micro-batches, "
          f"peak memory GiB {({k: round(v, 2) for k, v in peaks.items()})}")
    if moved < len(before) // 2:
        fail("the weights did not move")
    expected = micro_batches * NUM_TARGET_VIEWS
    for name in ("composite_fwd", "composite_bwd"):
        if launches[name] != expected:
            fail(f"{name} launched {launches[name]} times in training, expected {expected} "
                 f"({micro_batches} micro-batches x {NUM_TARGET_VIEWS} target views)")
    return ts, launches, peaks


def reference_pair(torch, gpu, octaves, training_losses=()):
    """(card wrapper, CPU wrapper) with equal weights for a small-input
    reference: `gpu` itself, or, with `octaves`, a model whose depth
    encoding is cut to that many octaves, with seeded random weights."""
    import dataclasses

    from pixelsplat_tpu_torch.scripts.eval_scene import init_random_weights
    from pixelsplat_tpu_torch.training.model_wrapper import ModelWrapper

    cfg = gpu.encoder_cfg
    kwargs = dict(optimizer_cfg=gpu.optimizer_cfg, train_cfg=gpu.train_cfg, loss_cfgs=training_losses)
    if octaves is not None:
        et = dataclasses.replace(cfg.epipolar_transformer, num_octaves=octaves)
        cfg = dataclasses.replace(cfg, epipolar_transformer=et)
        gpu = ModelWrapper(cfg, gpu.decoder.cfg, device=gpu.device, **kwargs)
        init_random_weights(gpu.encoder, torch.Generator(device=gpu.device).manual_seed(SEED + 7))
    cpu = ModelWrapper(cfg, gpu.decoder.cfg, device="cpu", **kwargs)
    cpu.encoder.load_state_dict({k: v.cpu() for k, v in gpu.encoder.state_dict().items()})
    return gpu, cpu


def reference_cases(wrapper):
    """(label, octaves or None for the model as configured, tight?)."""
    if not wrapper.encoder_cfg.use_epipolar_transformer:
        return (("", None, True),)
    full = wrapper.encoder_cfg.epipolar_transformer.num_octaves
    return (
        (f" (depth encoding cut to {REFERENCE_OCTAVES} octaves)", REFERENCE_OCTAVES, True),
        (f" (as configured, {full} octaves: loose)", None, False),
    )


def small_gradient_reference(torch, ts, seed):
    """Gradients of the training loss on a 64x64 batch at equal weights and
    the same uniforms, card against the port on the CPU."""
    from pixelsplat_tpu_torch.scripts.eval_scene import scene_batch
    from pixelsplat_tpu_torch.scripts.train_scene import TARGET_SHIFTS

    small = scene_batch("cpu", torch.Generator().manual_seed(seed), 64, 64, target_shifts=TARGET_SHIFTS)
    u = torch.rand((1, 2, 64 * 64, 1, 3), generator=torch.Generator().manual_seed(seed + 1))
    for label, octaves, tight in reference_cases(ts.wrapper):
        gpu, cpu = reference_pair(torch, ts.wrapper, octaves, ts.training.loss)
        grads, losses = [], []
        for w in (gpu, cpu):
            for p in w.encoder.parameters():
                p.grad = None
            total, _ = w.loss_fn(small, 0, u=u)  # step 0: LPIPS gated off
            total.backward()
            losses.append(float(total.detach()))
            grads.append({k: p.grad.detach().cpu() for k, p in w.encoder.named_parameters() if p.grad is not None})
            for p in w.encoder.parameters():
                p.grad = None
        g_gpu, g_cpu = grads
        if g_gpu.keys() != g_cpu.keys():
            fail("the card and the CPU give gradients to different parameters")
        err2 = sum(float(((g_gpu[k] - g_cpu[k]) ** 2).sum()) for k in g_cpu)
        ref2 = sum(float((g_cpu[k] ** 2).sum()) for k in g_cpu)
        rel_l2 = (err2 / ref2) ** 0.5
        worst = max(
            (float((g_gpu[k] - g_cpu[k]).abs().max() / g_cpu[k].abs().max().clamp(min=1e-30)), k) for k in g_cpu
        )
        phase("reference", f"64x64 gradients{label}: loss {losses[0]:.8g} (card) vs {losses[1]:.8g} (CPU), "
              f"relative L2 error over {len(g_cpu)} tensors {rel_l2:.3g}, "
              f"worst tensor {worst[1]} at {worst[0]:.3g} of its max")
        rtol = GRAD_REFERENCE_RTOL if tight else LOOSE_GRAD_REFERENCE_RTOL
        if not rel_l2 <= rtol or abs(losses[0] - losses[1]) > 1e-4 * abs(losses[1]):
            fail(f"the card's gradients disagree with the CPU reference on the small input{label}")


def summarize(kernel_ms, plain_ms, bounds):
    """Means over the views: (kernel ms, plain ms, bound ms, what binds most views)."""
    n = len(bounds)
    by = "operations" if sum(b == "operations" for _, b in bounds) * 2 > n else "bytes"
    return sum(kernel_ms) / n, sum(plain_ms) / n, sum(b for b, _ in bounds) / n, by


def check_kernel_against_plain(composite_kernel, v, tiles, table, chunk, tiles_x):
    """K1 against composite_core_plain on one view's lists; returns
    (max abs error, the kernel's n_proc). A tile whose chunk counts differ
    is excused only when its max T after the deciding chunk lies within
    1e-6 relative of the 1e-4 exit threshold."""
    import torch
    from pixelsplat_tpu_torch.scripts.check_composite_bwd import chunk_stats

    args = (table, tiles.flat, tiles.block_start, tiles.counts, tiles_x, chunk)
    acc_k, trans_k, n_k = composite_kernel.composite_core(*args)
    acc_p, trans_p, n_p = composite_kernel.composite_core_plain(*args)
    torch.cuda.synchronize()
    differ = n_k != n_p
    if bool(differ.any()):
        # Max T after the deciding chunk, from the plain version stopped there.
        counts = torch.where(differ, torch.minimum(n_k, n_p) * chunk, tiles.counts).to(torch.int32)
        _, trans_d, _ = composite_kernel.composite_core_plain(
            table, tiles.flat, tiles.block_start, counts, tiles_x, chunk
        )
        eps = composite_kernel.TRANS_EPS
        t_max = trans_d.amax(dim=1)
        excused = (t_max - eps).abs() <= 1e-6 * eps
        for tile in torch.nonzero(differ).flatten().tolist():
            phase("kernels", f"view {v} tile {tile}: n_proc {int(n_k[tile])} vs {int(n_p[tile])}, "
                  f"max T {float(t_max[tile]):.9g} ({'excused' if excused[tile] else 'NOT excused'})")
        if bool((differ & ~excused).any()):
            fail(f"view {v}: n_proc differs on tiles the exit rule does not excuse")
    keep = ~differ
    acc_err = (acc_k - acc_p).abs().amax(dim=(1, 2))  # per tile
    trans_err = (trans_k - trans_p).abs().amax(dim=1)
    err_acc, err_trans = float(acc_err[keep].max()), float(trans_err[keep].max())
    phase(
        "kernels",
        f"composite_fwd view {v}: max |acc| err {err_acc:.3g}, max |T| err {err_trans:.3g}, "
        f"n_proc equal on {int((~differ).sum())}/{differ.numel()} tiles, "
        f"list slots {int(tiles.counts.sum())}, {chunk_stats(n_k)}",
    )
    return max(err_acc, err_trans), n_k


def small_input_reference(torch, scene, seed):
    """A 64x64 input at equal weights and the same uniforms, card against
    the port on the CPU: Gaussians, settings, images."""
    from pixelsplat_tpu_torch.scripts.eval_scene import scene_batch
    from pixelsplat_tpu_torch.training.model_wrapper import batch_to

    small = scene_batch("cpu", torch.Generator().manual_seed(seed), 64, 64)
    u = torch.rand((1, 2, 64 * 64, 1, 3), generator=torch.Generator().manual_seed(seed + 1))
    for label, octaves, tight in reference_cases(scene.wrapper):
        results = []
        for w in reference_pair(torch, scene.wrapper, octaves):
            g = w.make_eval_encode(pack_soa=True)(small, False, 0, u=u.to(w.device))
            t = w.data_shim(batch_to(small, w.device))["target"]
            s = w.choose_eval_settings(g, t["extrinsics"], t["intrinsics"], t["near"], (64, 64))
            c, o = w.make_eval_decode()(g, t["extrinsics"], t["intrinsics"], t["near"], t["far"], (64, 64), s)
            results.append((g, s, c.cpu(), int(o)))
        (g_gpu, s_gpu, c_gpu, o_gpu), (g_cpu, s_cpu, c_cpu, o_cpu) = results
        # Per field of the Gaussians, errors relative to the field's largest entry.
        errs = [(a.cpu() - b).abs() / b.abs().max().clamp(min=1e-12) for a, b in zip(g_gpu, g_cpu) if a is not None]
        rel, median = max(float(e.max()) for e in errs), max(float(e.median()) for e in errs)
        diff = (c_gpu - c_cpu).abs()
        frac_off = float((diff > 1e-3).float().mean())
        phase(
            "reference", f"64x64{label}: Gaussians max rel err {rel:.3g}, median {median:.3g}, "
            f"image max err {float(diff.max()):.3g}, mean err {float(diff.mean()):.3g}, "
            f"pixels off by >1e-3: {frac_off:.4%}, "
            f"settings equal {s_gpu == s_cpu}, overflow {o_gpu}/{o_cpu}",
        )
        # Gaussians: f32 through ~70 layers in another order. Images: depth-key
        # ties may composite in another order where the two sides' depths
        # differ in their last bits, so a few pixels may differ more.
        rel_max, median_max, mean_max, frac_max = (1e-4, 1e-6, 1e-4, 0.01) if tight else (
            LOOSE_GAUSSIAN_MAX_ERR, LOOSE_GAUSSIAN_MEDIAN_ERR, LOOSE_IMAGE_MEAN_ERR, LOOSE_IMAGE_FRAC_OFF
        )
        if (rel > rel_max or median > median_max or float(diff.mean()) > mean_max or frac_off > frac_max
                or s_gpu != s_cpu or o_gpu or o_cpu):
            fail(f"the card disagrees with the CPU reference on the small input{label}")


def model_phases(torch, kernels, model, seed):
    """Scene, kernels, references, training and timing of one model; returns
    what the kernels' record needs and, for the tools phase, the first
    view's compositor inputs."""
    from pixelsplat_tpu_torch.ops.rasterizer import composite_kernel
    from pixelsplat_tpu_torch.scripts.check_composite_bwd import longest_tile_only
    from pixelsplat_tpu_torch.scripts.eval_scene import TARGET_VIEWS, card_line, cuda_ms, make_eval_scene, view_inputs
    from pixelsplat_tpu_torch.scripts.train_scene import backward_inputs, timed_step

    # Scene, through the entry points, on the default device (the card).
    scene = make_eval_scene(seed=seed, model=model)
    h, w = scene.image_shape
    scene.run(seed + 1)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    gaussians, settings, color, overflow = scene.run(seed)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in kernels.items()}
    n_gaussians = gaussians.mean_x.shape[1]
    phase(
        "scene",
        f"{model}: {n_gaussians} Gaussians, settings capacity={settings.capacity} "
        f"pair_budget={settings.pair_budget}, images {tuple(color.shape)}, "
        f"overflow {int(overflow)}, launches {launches}",
    )
    if n_gaussians != 2 * h * w * 3:
        fail(f"expected {2 * h * w * 3} Gaussians, got {n_gaussians}")
    if tuple(color.shape) != (1, TARGET_VIEWS, 3, h, w) or not bool(torch.isfinite(color).all()):
        fail(f"images are not finite of shape (1, {TARGET_VIEWS}, 3, {h}, {w})")
    if int(overflow) != 0:
        fail(f"{int(overflow)} (gaussian, tile) pairs dropped")
    if launches["composite_fwd"] != TARGET_VIEWS:
        fail(f"composite_fwd launched {launches['composite_fwd']} times on the main path, expected {TARGET_VIEWS}")
    if any(n for name, n in launches.items() if name != "composite_fwd"):
        fail(f"the evaluation scene launched another kernel: {launches}")
    eval_peak = torch.cuda.max_memory_allocated() / 2**30
    phase("scene", f"{model}: image mean {float(color.mean()):.6f}, peak memory {eval_peak:.2f} GiB")

    # The forward kernel against its plain version, on this scene's inputs.
    inputs = view_inputs(scene, gaussians, settings)
    chunk, tiles_x = settings.chunk, w // settings.tile_size
    max_err, n_proc_views = 0.0, []
    for v, (_, tiles, table) in enumerate(inputs):
        err, n_k = check_kernel_against_plain(composite_kernel, v, tiles, table, chunk, tiles_x)
        max_err = max(max_err, err)
        n_proc_views.append(n_k)
    if max_err > KERNEL_ATOL:
        fail(f"composite_fwd disagrees with its plain version: {max_err:.3g} > {KERNEL_ATOL}")

    # Evaluation timing (before the CPU reference, whose threads would
    # compete with the eager launches), then the reference; then the
    # scene's model makes room for the trainer's.
    card = card_line()
    encode_ms = cuda_ms(lambda: scene.encode(scene.batch, False, 0), iters=5)
    render_ms = cuda_ms(lambda: scene.render(gaussians, settings), iters=5) / TARGET_VIEWS
    k_ms, p_ms, bounds, long_ms = [], [], [], []
    for (_, tiles, table), n_k in zip(inputs, n_proc_views):
        args = (table, tiles.flat, tiles.block_start, tiles.counts, tiles_x, chunk)
        k_ms.append(cuda_ms(lambda: composite_kernel.composite_core(*args), iters=50))
        p_ms.append(cuda_ms(lambda: composite_kernel.composite_core_plain(*args), iters=5))
        bounds.append(composite_bound_ms(tiles, table, n_k, chunk))
        one = args[:3] + (longest_tile_only(tiles.counts, n_k)[0],) + args[4:]
        long_ms.append(cuda_ms(lambda: composite_kernel.composite_core(*one), iters=50))
    fwd = summarize(k_ms, p_ms, bounds) + (sum(long_ms) / len(long_ms),)
    phase("timing", f"{model} | {card} | encode {encode_ms:.3f} ms | render {render_ms:.3f} ms/view | "
          f"composite_fwd {fwd[0]:.4f} ms/launch (per view {[round(x, 4) for x in k_ms]}), "
          f"longest tile alone {fwd[4]:.4f} ms (per view {[round(x, 4) for x in long_ms]}), "
          f"plain {fwd[1]:.3f} ms, bound {fwd[2]:.4f} ms ({fwd[3]}) | peak memory {eval_peak:.2f} GiB")
    small_input_reference(torch, scene, seed + 2)
    _, tiles0, table0 = inputs[0]
    first_view = dict(table=table0, tiles=tiles0, tiles_x=tiles_x, chunk=chunk)
    del scene, gaussians, color, inputs
    torch.cuda.empty_cache()

    # Training steps, through the entry points.
    ts, train_launches, train_peaks = train_phase(torch, kernels, model)

    # The backward kernel against its plain version, on a step's inputs.
    bwd_inputs = backward_inputs(ts, ts.batch(1), seed=seed)
    bwd_errs = [check_bwd_kernel_against_plain(v, inp) for v, inp in enumerate(bwd_inputs)]
    bwd_err, bwd_abs_err, bwd_tiles = (f(e[i] for e in bwd_errs) for i, f in enumerate((max, max, sum)))

    bk_ms, bp_ms, b_bounds, b_long_ms = [], [], [], []
    for inp in bwd_inputs:
        args = bwd_args(inp)
        bk_ms.append(cuda_ms(lambda: composite_kernel.composite_bwd(*args), iters=20))
        bp_ms.append(cuda_ms(lambda: composite_kernel.composite_bwd_plain(*args), iters=2, warmup=1))
        b_bounds.append(composite_bwd_bound_ms(inp))
        one = args[:3] + longest_tile_only(inp["tiles"].counts, inp["n_proc"]) + args[5:]
        b_long_ms.append(cuda_ms(lambda: composite_kernel.composite_bwd(*one), iters=20))
    bwd = summarize(bk_ms, bp_ms, b_bounds) + (sum(b_long_ms) / len(b_long_ms),)
    batch1 = ts.batch(1)
    ts.state.step = 0
    timed_step(ts, batch1)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    splits = [timed_step(ts, batch1) for _ in range(3)]
    step_ms = {k: sum(x[k] for x in splits) / len(splits) for k in splits[0]}
    timed_peak = torch.cuda.max_memory_allocated() / 2**30
    phase("timing", f"{model} | {card} | train step (batch 1, MSE, remat_encoder {ts.wrapper.train_cfg.remat_encoder}) "
          f"forward {step_ms['forward_ms']:.3f} ms, backward {step_ms['backward_ms']:.3f} ms, "
          f"optimizer {step_ms['optimizer_ms']:.3f} ms, peak memory {timed_peak:.2f} GiB | "
          f"composite_bwd {bwd[0]:.4f} ms/launch (per view {[round(x, 4) for x in bk_ms]}), "
          f"longest tile alone {bwd[4]:.4f} ms (per view {[round(x, 4) for x in b_long_ms]}), "
          f"plain {bwd[1]:.3f} ms, bound {bwd[2]:.4f} ms ({bwd[3]}) | "
          f"peak memory GiB by kind of step: {({k: round(v, 2) for k, v in train_peaks.items()})}")
    small_gradient_reference(torch, ts, seed + 3)
    del ts, bwd_inputs, batch1
    torch.cuda.empty_cache()
    return dict(
        launches={"evaluation": launches, "training": train_launches}, first_view=first_view,
        fwd=fwd, fwd_err=max_err, bwd=bwd, bwd_err=bwd_err, bwd_abs_err=bwd_abs_err, bwd_tiles=bwd_tiles,
    )


def tools_phase(torch, kernels, first_view):
    """The kernel tools' path (the segment-sum bench's checks and the stage
    ablation on `first_view`'s lists), then each tool kernel against its
    plain version and its time beside its bound and library call."""
    from pixelsplat_tpu_torch.ops import kernel_tools
    from pixelsplat_tpu_torch.ops.rasterizer import composite_kernel
    from pixelsplat_tpu_torch.ops.rasterizer.composite_ablation import composite_core_ablation
    from pixelsplat_tpu_torch.scripts import bench_kernel_ablation, bench_segment_sum
    from pixelsplat_tpu_torch.scripts.eval_scene import card_line, cuda_ms

    table, tiles = first_view["table"], first_view["tiles"]
    tiles_x, chunk = first_view["tiles_x"], first_view["chunk"]
    for fn in kernels.values():
        fn.launches = 0
    d_rows, ids = bench_segment_sum.bench_inputs("cuda")
    calls = bench_segment_sum.variants(d_rows, ids, bench_segment_sum.ROWS)
    seg_errors = bench_segment_sum.check_variants(calls)
    full_err = bench_kernel_ablation.check_variants(table, tiles, tiles_x, chunk)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in kernels.items()}
    phase("tools", f"segment sums against index_add, max err / max entry: "
          f"{({k: float(f'{v:.3g}') for k, v in seg_errors.items()})}; stage ablation: full against the plain "
          f"compositor without early exit {full_err:.3g}, {len(bench_kernel_ablation.VARIANTS)} variants finite "
          f"and of the right shape; launches {launches}")
    for name, err in seg_errors.items():
        if not err <= bench_segment_sum.TOLERANCE[name]:
            fail(f"segment sum {name} disagrees with index_add: {err:.3g} > {bench_segment_sum.TOLERANCE[name]}")
    if launches["copy_rows"] != 2 or launches["composite_fwd_ablation"] != len(bench_kernel_ablation.VARIANTS):
        fail(f"the tools' path did not launch its kernels as expected: {launches}")

    # copy_rows against clone, bit for bit, on the bench's 16-bit table.
    card = card_line()
    contiguous, transposed = bench_segment_sum.u16_table(d_rows)
    if tuple(contiguous.shape) != (bench_segment_sum.N, 2 * bench_segment_sum.F):
        fail(f"the 16-bit table is {tuple(contiguous.shape)}")
    copy_ms, clone_ms, copy_err = {}, {}, 0
    for label, x in (("contiguous", contiguous), ("transposed", transposed)):
        out, plain = kernel_tools.copy_rows(x), kernel_tools.copy_rows_plain(x)
        copy_err = max(copy_err, int((out.int() - plain.int()).abs().max()))
        if not (out.is_contiguous() and out.shape == plain.shape and copy_err == 0):
            fail(f"copy_rows differs from clone on the {label} table by up to {copy_err}")
        copy_ms[label] = cuda_ms(lambda: kernel_tools.copy_rows(x), iters=20)
        clone_ms[label] = cuda_ms(lambda: kernel_tools.copy_rows_plain(x), iters=20)
    copy_bound = 2 * contiguous.numel() * contiguous.element_size() / PEAK_BYTES_PER_S * 1e3
    seg_ms = {name: cuda_ms(fn, iters=10) for name, fn in calls.items()}
    phase("tools", f"{card} | copy_rows on {tuple(contiguous.shape)} 16-bit: max |difference| from clone {copy_err}; "
          f"ms/launch {({k: round(v, 4) for k, v in copy_ms.items()})}, "
          f"clone {({k: round(v, 4) for k, v in clone_ms.items()})}, "
          f"bound {copy_bound:.4f} ms (bytes) | segment sums ms {({k: round(v, 3) for k, v in seg_ms.items()})}")
    del d_rows, ids, calls, contiguous, transposed

    # smoke_scale against x * 2, exactly, on random values.
    x = torch.randn((256, 256), device="cuda", generator=torch.Generator(device="cuda").manual_seed(SEED))
    if not torch.equal(kernel_tools.smoke_scale(x), kernel_tools.smoke_scale_plain(x)):
        fail("smoke_scale differs from x * 2")
    scale_ms = cuda_ms(lambda: kernel_tools.smoke_scale(x), iters=200)
    scale_plain_ms = cuda_ms(lambda: kernel_tools.smoke_scale_plain(x), iters=200)
    scale_library_ms = cuda_ms(lambda: torch.mul(x, 2.0), iters=200)
    scale_bound = 2 * x.numel() * 4 / PEAK_BYTES_PER_S * 1e3

    # The stage ablation's table on the first view's lists.
    lists = (table, tiles.flat, tiles.block_start, tiles.counts)
    variant_ms = bench_kernel_ablation.time_variants(table, tiles, tiles_x, chunk)
    full_plain_ms = cuda_ms(
        lambda: composite_kernel.composite_core_plain(*lists, tiles_x, chunk, early_exit=False), iters=3
    )
    _, _, n_all = composite_core_ablation("full", *lists, tiles_x, chunk)
    full_bound, full_bound_by = composite_bound_ms(tiles, table, n_all, chunk)
    phase("tools", f"{card} | smoke_scale {scale_ms:.5f} ms/launch, x * 2 {scale_plain_ms:.5f}, torch.mul "
          f"{scale_library_ms:.5f}, bound {scale_bound:.6f} ms (bytes) | stage ablation on view 0 "
          f"({int(tiles.counts.sum())} slots), ms/launch: {({k: round(v, 4) for k, v in variant_ms.items()})}, "
          f"plain without early exit {full_plain_ms:.3f} ms, bound of full {full_bound:.4f} ms ({full_bound_by})")
    return dict(
        launches=launches, full_err=full_err, variant_ms=variant_ms, full_plain_ms=full_plain_ms,
        full_bound=(full_bound, full_bound_by), copy_ms=copy_ms, clone_ms=clone_ms, copy_err=copy_err,
        copy_bound=copy_bound,
        scale=(scale_ms, scale_plain_ms, scale_library_ms, scale_bound), seg_ms=seg_ms,
    )


def main() -> None:
    if not (ROOT / "pixelsplat_tpu_torch").is_dir():
        fail("pixelsplat_tpu_torch/ not found beside chip_smoke.py: run from a checkout")
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs an NVIDIA GPU")

    from pixelsplat_tpu_torch import kernel_build
    from pixelsplat_tpu_torch.ops import kernel_tools
    from pixelsplat_tpu_torch.ops.rasterizer import composite_ablation, composite_kernel
    from pixelsplat_tpu_torch.scripts import kernel_smoke
    from pixelsplat_tpu_torch.scripts.eval_scene import card_line

    # 1. device
    try:
        card = card_line()
    except (OSError, subprocess.SubprocessError) as exc:
        fail(f"nvidia-smi: {exc}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    phase("device", f"{card} | torch {torch.__version__} CUDA {torch.version.cuda} | TF32 off")

    # 2. build
    t0 = time.perf_counter()
    built = kernel_build.build_all()
    build_s = time.perf_counter() - t0
    kernels = {
        "composite_fwd": composite_kernel.composite_core,
        "composite_bwd": composite_kernel.composite_bwd,
        "copy_rows": kernel_tools.copy_rows,
        "composite_fwd_ablation": composite_ablation.composite_core_ablation,
        "smoke_scale": kernel_tools.smoke_scale,
    }
    if set(built) != set(kernels):
        fail(f"built {sorted(built)}, expected the kernels {sorted(kernels)}")
    for name, (path, log) in built.items():
        regs = [line.strip() for line in log.splitlines() if "registers" in line]
        phase("build", f"{name} -> {path.relative_to(ROOT)} {regs[0] if regs else ''}")
    phase("build", f"{len(built)} kernel(s) in {build_s:.2f} s")

    # 3. smoke: the tools' first entry point
    for fn in kernels.values():
        fn.launches = 0
    smoke = kernel_smoke.run_smoke()
    smoke_launches = {name: fn.launches for name, fn in kernels.items()}
    if smoke["mean"] != 2.0 or smoke["scale_max_err"] != 0.0:
        fail(f"smoke_scale: mean {smoke['mean']}, max error {smoke['scale_max_err']} against x * 2")
    if not smoke["composite_max_err"] <= SMOKE_COMPOSITE_ATOL:
        fail(f"composite_fwd on the smoke input: {smoke['composite_max_err']:.3g} > {SMOKE_COMPOSITE_ATOL}")
    if smoke_launches["smoke_scale"] != 1 or smoke_launches["composite_fwd"] != 1:
        fail(f"the smoke phase launched {smoke_launches}")

    # 4. both models, each through scene, kernels, references, training, timing
    results = {model: model_phases(torch, kernels, model, SEED) for model in (ABLATION, RE10K)}

    # 5. tools, on the production model's first view
    tools = tools_phase(torch, kernels, results[RE10K]["first_view"])

    by_path = {"tools": {name: smoke_launches[name] + tools["launches"][name] for name in kernels}}
    for model, r in results.items():
        for path, counts in r["launches"].items():
            by_path[f"{model} {path}"] = counts

    def entry(name, source, replaces, **numbers):
        per_path = {path: counts[name] for path, counts in by_path.items() if counts[name]}
        return {
            "name": name, "route": "cuda", "source": f"pixelsplat_tpu_torch/csrc/{source}", "replaces": replaces,
            "launches": sum(per_path.values()), "launches_by_path": per_path, **numbers,
        }

    main_model = results[RE10K]  # the production model's inputs give the record's times
    scale_ms, scale_plain_ms, scale_library_ms, scale_bound = tools["scale"]
    record = {
        "kernels": [
            entry(
                "composite_fwd", "composite_fwd.cu", "pixelsplat_tpu/ops/rasterizer/pallas_composite.py:281",
                max_abs_err=max(r["fwd_err"] for r in results.values()), ms=main_model["fwd"][0],
                plain_ms=main_model["fwd"][1], bound_ms=main_model["fwd"][2], bound_by=main_model["fwd"][3],
                longest_tile_ms=main_model["fwd"][4],
                library_ms=None, ms_by_model={m: r["fwd"][0] for m, r in results.items()},
            ),
            entry(
                "composite_bwd", "composite_bwd.cu", "pixelsplat_tpu/ops/rasterizer/pallas_backward.py:234",
                max_abs_err=max(r["bwd_abs_err"] for r in results.values()),
                # Relative to each d_table column's largest |gradient|, the check's measure; both
                # errors are over all rows, those of explained threshold pairs included.
                max_rel_err=max(r["bwd_err"] for r in results.values()),
                threshold_tiles=sum(r["bwd_tiles"] for r in results.values()), ms=main_model["bwd"][0],
                plain_ms=main_model["bwd"][1], bound_ms=main_model["bwd"][2], bound_by=main_model["bwd"][3],
                longest_tile_ms=main_model["bwd"][4],
                library_ms=None, ms_by_model={m: r["bwd"][0] for m, r in results.items()},
            ),
            entry(
                "copy_rows", "copy_rows.cu", "tools/bench_segment_sum.py:112",
                max_abs_err=tools["copy_err"], ms=tools["copy_ms"]["contiguous"],
                plain_ms=tools["clone_ms"]["contiguous"],
                bound_ms=tools["copy_bound"], bound_by="bytes", library_ms=tools["clone_ms"]["contiguous"],
                ms_transposed=tools["copy_ms"]["transposed"], library_ms_transposed=tools["clone_ms"]["transposed"],
            ),
            entry(
                "composite_fwd_ablation", "composite_fwd_ablation.cu", "tools/bench_kernel_ablation.py:309",
                max_abs_err=tools["full_err"], ms=tools["variant_ms"]["full"], plain_ms=tools["full_plain_ms"],
                bound_ms=tools["full_bound"][0], bound_by=tools["full_bound"][1], library_ms=None,
                ms_by_variant=tools["variant_ms"],
            ),
            entry(
                "smoke_scale", "smoke_scale.cu", "tools/pallas_smoke.py:10",
                max_abs_err=smoke["scale_max_err"], ms=scale_ms, plain_ms=scale_plain_ms, bound_ms=scale_bound,
                bound_by="bytes", library_ms=scale_library_ms,
            ),
        ]
    }
    for k in record["kernels"]:
        if k["launches"] == 0:
            fail(f"{k['name']} was launched no time on any path")
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
