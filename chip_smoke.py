#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`pixelsplat_tpu_torch`) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each reported on its own line; any failure exits non-zero:

1. device: the card's name and power limit (nvidia-smi); TF32 off for
   cuDNN convolutions and matmuls.
2. build: every CUDA kernel under pixelsplat_tpu_torch/csrc, one nvcc each,
   all at once.
3. scene: the evaluation scene of the `re10k_ablation_no_epipolar_
   transformer` model at full width with random weights from a seeded
   torch.Generator (`scripts/eval_scene.py`): encode 2 context views at
   256x256 (probabilistic, 3 Gaussians per pixel, SoA), choose render
   settings, render 3 target views, through the `ModelWrapper` entry
   points. Checks 393,216 Gaussians, finite images, no dropped pairs, and
   that the compositing kernel was launched exactly once per view.
4. kernels: the forward compositing kernel against its plain PyTorch
   version on that scene's inputs (the three views' tile lists).
5. reference: the same weights on a small input, card against the port
   on the CPU.
6. train: training steps of the same model at full width through
   `ModelWrapper.make_train_step` (`scripts/train_scene.py`; batch 1 of 2
   context + 4 target views at 256x256): two steps from step 0, one at
   `apply_after_step` so LPIPS's VGG runs forward and backward, and one
   `accumulate=2` step on a batch of 2. Checks finite losses and gradients,
   a gradient on every parameter and non-zero ones on the heads and both
   backbones, moved weights, no dropped pairs, and that both compositing
   kernels were launched exactly once per target view per micro-batch.
7. kernels: the backward compositing kernel against its plain version on
   a training step's real inputs (the 4 views' lists, the forward's n_proc
   and T, the cotangents the MSE produced).
8. reference: gradients of a 64x64 batch, card against the port on the CPU.
9. timing: encode, render per view, the training step split into forward,
   backward and optimizer, and each kernel and its plain version, with
   CUDA events after warm-up; peak memory per phase.

It ends with the card line, a JSON record of the kernels and
{"ok": true, "device": {...}}.
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
BWD_KERNEL_RTOL = 1e-4
# The same, for the Gaussians of a tile in which some (slot, pixel) pair
# lies within 1e-6 relative of an alpha threshold: the pair may count on
# one side and not on the other, worth up to one pair's share of a sum.
BWD_NEAR_THRESHOLD_RTOL = 5e-2
# Card vs CPU gradients on the small input: relative L2 error over all
# parameters. f32 through ~70 layers forward and back in another order;
# a depth sample whose CDF comparison falls the other way moves one of
# 24,576 Gaussians to a neighbouring bucket.
GRAD_REFERENCE_RTOL = 1e-3
TRAIN_STEPS_FROM_ZERO = 2


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


def check_bwd_kernel_against_plain(composite_kernel, v, inp) -> tuple[float, float]:
    """K2 against composite_bwd_plain on one view's inputs; returns the
    largest error of d_table relative to its column's largest |gradient|,
    and the largest absolute error.

    The gradient jumps where a (slot, pixel) pair crosses power = 0, raw =
    1/255 or raw = 0.99, and the kernel (fused multiply-adds, expf) and the
    plain version round differently, so a pair within rounding of a
    threshold may fall on opposite sides. Such a pair changes the gradients
    of its tile's Gaussians only. Tiles holding a pair within 1e-6 relative
    of a threshold are counted and reported, and the Gaussians of their
    lists are held to BWD_NEAR_THRESHOLD_RTOL; every other row of d_table
    is held to BWD_KERNEL_RTOL."""
    import torch

    args = bwd_args(inp)
    d_kernel = composite_kernel.composite_bwd(*args)
    _, d_plain = composite_kernel.composite_bwd_plain(*args)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(d_kernel).all()):
        fail(f"view {v}: composite_bwd returned non-finite gradients")
    t, chunk = inp["tiles"], inp["chunk"]
    near = composite_kernel.near_threshold_pairs(
        inp["table"], t.flat, t.block_start, t.counts, inp["n_proc"], inp["tiles_x"], chunk, margin=1e-6
    )
    loose = torch.zeros(d_plain.shape[0], dtype=torch.bool, device=d_plain.device)
    for tile in torch.nonzero(near).flatten().tolist():
        start = int(t.block_start[tile]) * chunk
        loose[t.flat[start : start + int(t.counts[tile])].long()] = True
    col_max = d_plain.abs().amax(dim=0).clamp(min=1e-30)
    rel = ((d_kernel - d_plain).abs() / col_max).amax(dim=1)  # per Gaussian
    rel_tight = float(rel[~loose].max())
    rel_loose = float(rel[loose].max()) if bool(loose.any()) else 0.0
    phase(
        "kernels",
        f"composite_bwd view {v}: max err / column max {rel_tight:.3g} over {int((~loose).sum())} rows; "
        f"{int(near.sum())} (slot, pixel) pairs in {int((near > 0).sum())} tiles within 1e-6 of a threshold, "
        f"their {int(loose.sum())} rows at {rel_loose:.3g}; largest column max |grad| {float(col_max.max()):.3g}, "
        f"chunks {int(inp['n_proc'].sum())}, list slots {int(t.counts.sum())}",
    )
    if float(d_kernel[-1].abs().max()) != 0.0:
        fail(f"view {v}: composite_bwd wrote to the sentinel row")
    if rel_loose > BWD_NEAR_THRESHOLD_RTOL:
        fail(f"view {v}: composite_bwd off by {rel_loose:.3g} of a column's max on near-threshold tiles")
    return rel_tight, float((d_kernel - d_plain)[~loose].abs().max())


def train_phase(torch, kernels, apply_after_step):
    """Training steps at full width through make_train_step; returns the
    scene, the kernels' launch counts and the peak memory per kind of step."""
    from pixelsplat_tpu_torch.config import NUM_TARGET_VIEWS
    from pixelsplat_tpu_torch.scripts.train_scene import make_train_scene

    ts = make_train_scene(seed=SEED)
    state = ts.state
    before = {k: v.detach().clone() for k, v in state.params.items()}
    batch1, batch2 = ts.batch(1), ts.batch(2, seed_offset=1)
    for fn in kernels.values():
        fn.launches = 0
    peaks, parts = {}, []
    plan = (
        ("step 0-1 (MSE)", 0, TRAIN_STEPS_FROM_ZERO, batch1, 1),
        ("step with LPIPS", apply_after_step, 1, batch1, 1),
        ("accumulate=2, batch 2", None, 1, batch2, 2),
    )
    micro_batches = 0
    for label, at_step, n, batch, accumulate in plan:
        if at_step is not None:
            state.step = at_step
        torch.cuda.reset_peak_memory_stats()
        parts += [(label, p) for p in ts.steps(n, batch, accumulate=accumulate)]
        torch.cuda.synchronize()
        peaks[label] = torch.cuda.max_memory_allocated() / 2**30
        micro_batches += n * accumulate
    launches = {name: fn.launches for name, fn in kernels.items()}

    for label, p in parts:
        values = {k: float(v) for k, v in p.items()}
        phase("train", f"{label}: " + ", ".join(f"{k} {x:.6g}" for k, x in values.items()))
        if not all(x == x and abs(x) != float("inf") for x in values.values()):
            fail(f"{label}: a loss part is not finite")
        if values["train/overflow_pairs"] != 0:
            fail(f"{label}: {values['train/overflow_pairs']} (gaussian, tile) pairs dropped")
    if float(parts[TRAIN_STEPS_FROM_ZERO][1]["loss/lpips"]) == 0.0 or float(parts[0][1]["loss/lpips"]) != 0.0:
        fail("the LPIPS gate: expected 0 before apply_after_step and a value from it on")

    missing = [k for k, p in state.params.items() if p.requires_grad and p.grad is None]
    if missing:
        fail(f"{len(missing)} parameters have no gradient, e.g. {missing[:3]}")
    if not all(bool(torch.isfinite(p.grad).all()) for p in state.params.values()):
        fail("a gradient is not finite")
    for group in ("to_gaussians", "depth_predictor", "backbone.dino", "backbone.resnet_backbone"):
        grads = [p.grad for k, p in state.params.items() if k.startswith(group)]
        if not grads or not any(bool((g != 0).any()) for g in grads):
            fail(f"no non-zero gradient under {group}")
    moved = sum(bool((before[k] != p.detach()).any()) for k, p in state.params.items())
    bn_moved = sum(
        bool((before[k] != p.detach()).any()) for k, p in state.params.items() if "running_" in k
    )
    phase("train", f"{moved}/{len(before)} parameter tensors moved ({bn_moved} BatchNorm statistics), "
          f"launches {launches} over {micro_batches} micro-batches, "
          f"peak memory GiB {({k: round(v, 2) for k, v in peaks.items()})}")
    if moved < len(before) // 2:
        fail("the weights did not move")
    expected = micro_batches * NUM_TARGET_VIEWS
    for name, n in launches.items():
        if n != expected:
            fail(f"{name} launched {n} times in training, expected {expected} "
                 f"({micro_batches} micro-batches x {NUM_TARGET_VIEWS} target views)")
    return ts, launches, peaks


def small_gradient_reference(torch, ts, seed):
    """Gradients of the training loss on a 64x64 batch at the scene's
    weights and the same uniforms, card against the port on the CPU."""
    from pixelsplat_tpu_torch.scripts.eval_scene import scene_batch
    from pixelsplat_tpu_torch.scripts.train_scene import TARGET_SHIFTS
    from pixelsplat_tpu_torch.training.model_wrapper import ModelWrapper

    gpu = ts.wrapper
    cpu = ModelWrapper(
        gpu.encoder_cfg, gpu.decoder.cfg, device="cpu", optimizer_cfg=gpu.optimizer_cfg,
        train_cfg=gpu.train_cfg, loss_cfgs=ts.training.loss,
    )
    cpu.encoder.load_state_dict({k: v.cpu() for k, v in gpu.encoder.state_dict().items()})
    small = scene_batch("cpu", torch.Generator().manual_seed(seed), 64, 64, target_shifts=TARGET_SHIFTS)
    u = torch.rand((1, 2, 64 * 64, 1, 3), generator=torch.Generator().manual_seed(seed + 1))
    grads, losses = [], []
    for w in (gpu, cpu):
        for p in w.encoder.parameters():
            p.grad = None
        total, _ = w.loss_fn(small, 0, u=u)
        total.backward()
        losses.append(float(total.detach()))
        grads.append({k: p.grad.detach().cpu() for k, p in w.encoder.named_parameters() if p.grad is not None})
    g_gpu, g_cpu = grads
    if g_gpu.keys() != g_cpu.keys():
        fail("the card and the CPU give gradients to different parameters")
    err2 = sum(float(((g_gpu[k] - g_cpu[k]) ** 2).sum()) for k in g_cpu)
    ref2 = sum(float((g_cpu[k] ** 2).sum()) for k in g_cpu)
    rel_l2 = (err2 / ref2) ** 0.5
    worst = max(
        (float((g_gpu[k] - g_cpu[k]).abs().max() / g_cpu[k].abs().max().clamp(min=1e-30)), k) for k in g_cpu
    )
    phase("reference", f"64x64 gradients: loss {losses[0]:.8g} (card) vs {losses[1]:.8g} (CPU), "
          f"relative L2 error over {len(g_cpu)} tensors {rel_l2:.3g}, "
          f"worst tensor {worst[1]} at {worst[0]:.3g} of its max")
    if not rel_l2 <= GRAD_REFERENCE_RTOL or abs(losses[0] - losses[1]) > 1e-4 * abs(losses[1]):
        fail("the card's gradients disagree with the CPU reference on the small input")


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
    err_acc = float((acc_k[keep] - acc_p[keep]).abs().max())
    err_trans = float((trans_k[keep] - trans_p[keep]).abs().max())
    phase(
        "kernels",
        f"composite_fwd view {v}: max |acc| err {err_acc:.3g}, max |T| err {err_trans:.3g}, "
        f"n_proc equal on {int(keep.sum())}/{keep.numel()} tiles, "
        f"list slots {int(tiles.counts.sum())}, chunks {int(n_k.sum())}",
    )
    return max(err_acc, err_trans), n_k


def small_input_reference(torch, scene, seed):
    """The scene's weights on a 64x64 input, card against CPU."""
    from pixelsplat_tpu_torch.scripts.eval_scene import scene_batch
    from pixelsplat_tpu_torch.training.model_wrapper import ModelWrapper, batch_to

    gpu = scene.wrapper
    cpu = ModelWrapper(gpu.encoder_cfg, gpu.decoder.cfg, device="cpu")
    cpu.encoder.load_state_dict({k: v.cpu() for k, v in gpu.encoder.state_dict().items()})
    small = scene_batch("cpu", torch.Generator().manual_seed(seed), 64, 64)
    u = torch.rand((1, 2, 64 * 64, 1, 3), generator=torch.Generator().manual_seed(seed + 1))
    results = []
    for w in (gpu, cpu):
        g = w.make_eval_encode(pack_soa=True)(small, False, 0, u=u.to(w.device))
        t = w.data_shim(batch_to(small, w.device))["target"]
        s = w.choose_eval_settings(g, t["extrinsics"], t["intrinsics"], t["near"], (64, 64))
        c, o = w.make_eval_decode()(g, t["extrinsics"], t["intrinsics"], t["near"], t["far"], (64, 64), s)
        results.append((g, s, c.cpu(), int(o)))
    (g_gpu, s_gpu, c_gpu, o_gpu), (g_cpu, s_cpu, c_cpu, o_cpu) = results
    rel = max(
        float((a.cpu() - b).abs().max() / b.abs().max().clamp(min=1e-12))
        for a, b in zip(g_gpu, g_cpu) if a is not None
    )
    diff = (c_gpu - c_cpu).abs()
    frac_off = float((diff > 1e-3).float().mean())
    phase(
        "reference", f"64x64: Gaussians max rel err {rel:.3g}, image max err {float(diff.max()):.3g}, "
        f"mean err {float(diff.mean()):.3g}, pixels off by >1e-3: {frac_off:.4%}, "
        f"settings equal {s_gpu == s_cpu}, overflow {o_gpu}/{o_cpu}",
    )
    # Gaussians: f32 through ~70 layers in another order. Images: depth-key
    # ties may composite in another order where the two sides' depths
    # differ in their last bits, so a few pixels may differ more.
    if rel > 1e-4 or float(diff.mean()) > 1e-4 or frac_off > 0.01 or s_gpu != s_cpu or o_gpu or o_cpu:
        fail("the card disagrees with the CPU reference on the small input")


def main() -> None:
    if not (ROOT / "pixelsplat_tpu_torch").is_dir():
        fail("pixelsplat_tpu_torch/ not found beside chip_smoke.py: run from a checkout")
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs an NVIDIA GPU")

    from pixelsplat_tpu_torch import kernel_build
    from pixelsplat_tpu_torch.ops.rasterizer import composite_kernel
    from pixelsplat_tpu_torch.scripts.eval_scene import (
        TARGET_VIEWS, card_line, cuda_ms, make_eval_scene, view_inputs,
    )

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
    if not built:
        fail("no kernel sources under pixelsplat_tpu_torch/csrc")
    for name, (path, log) in built.items():
        regs = [line.strip() for line in log.splitlines() if "registers" in line]
        phase("build", f"{name} -> {path.relative_to(ROOT)} {regs[0] if regs else ''}")
    phase("build", f"{len(built)} kernel(s) in {build_s:.2f} s")

    # 3. scene, through the entry points, on the default device (the card)
    scene = make_eval_scene(seed=SEED)
    h, w = scene.image_shape
    scene.run(SEED + 1)  # warm-up
    torch.cuda.synchronize()
    kernels = {
        "composite_fwd": composite_kernel.composite_core,
        "composite_bwd": composite_kernel.composite_bwd,
    }
    for fn in kernels.values():
        fn.launches = 0
    gaussians, settings, color, overflow = scene.run(SEED)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in kernels.items()}
    n_gaussians = gaussians.mean_x.shape[1]
    phase(
        "scene",
        f"{n_gaussians} Gaussians, settings capacity={settings.capacity} "
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
    if launches["composite_bwd"] != 0:
        fail("composite_bwd was launched by the evaluation scene")
    eval_peak = torch.cuda.max_memory_allocated() / 2**30
    phase("scene", f"image mean {float(color.mean()):.6f}, peak memory {eval_peak:.2f} GiB")

    # 4. kernels against their plain versions, on this scene's inputs
    inputs = view_inputs(scene, gaussians, settings)
    chunk, tiles_x = settings.chunk, w // settings.tile_size
    max_err, n_proc_views = 0.0, []
    for v, (_, tiles, table) in enumerate(inputs):
        err, n_k = check_kernel_against_plain(composite_kernel, v, tiles, table, chunk, tiles_x)
        max_err = max(max_err, err)
        n_proc_views.append(n_k)
    if max_err > KERNEL_ATOL:
        fail(f"composite_fwd disagrees with its plain version: {max_err:.3g} > {KERNEL_ATOL}")

    # 5. reference on a small input
    small_input_reference(torch, scene, SEED + 2)

    # 6. training steps, through the entry points
    from pixelsplat_tpu_torch.scripts.train_scene import backward_inputs, timed_step

    ts, train_launches, train_peaks = train_phase(
        torch, kernels, apply_after_step=150_000
    )

    # 7. the backward kernel against its plain version, on a step's inputs
    bwd_inputs = backward_inputs(ts, ts.batch(1), seed=SEED)
    bwd_errs = [check_bwd_kernel_against_plain(composite_kernel, v, inp) for v, inp in enumerate(bwd_inputs)]
    bwd_err, bwd_abs_err = max(r for r, _ in bwd_errs), max(a for _, a in bwd_errs)
    if not bwd_err <= BWD_KERNEL_RTOL:
        fail(f"composite_bwd disagrees with its plain version: {bwd_err:.3g} > {BWD_KERNEL_RTOL} of a column's max")

    # 8. gradients on a small input against the CPU
    small_gradient_reference(torch, ts, SEED + 3)

    # 9. timing
    card = card_line()
    encode_ms = cuda_ms(lambda: scene.encode(scene.batch, False, 0), iters=5)
    render_ms = cuda_ms(lambda: scene.render(gaussians, settings), iters=5) / TARGET_VIEWS
    k_ms, p_ms, bounds = [], [], []
    for (_, tiles, table), n_k in zip(inputs, n_proc_views):
        args = (table, tiles.flat, tiles.block_start, tiles.counts, tiles_x, chunk)
        k_ms.append(cuda_ms(lambda: composite_kernel.composite_core(*args), iters=50))
        p_ms.append(cuda_ms(lambda: composite_kernel.composite_core_plain(*args), iters=5))
        bounds.append(composite_bound_ms(tiles, table, n_k, chunk))
    kernel_ms, plain_ms, bound_ms, bound_by = summarize(k_ms, p_ms, bounds)
    phase("timing", f"{card} | encode {encode_ms:.3f} ms | render {render_ms:.3f} ms/view | "
          f"composite_fwd {kernel_ms:.4f} ms/launch (per view {[round(x, 4) for x in k_ms]}), "
          f"plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by})")

    bk_ms, bp_ms, b_bounds = [], [], []
    for inp in bwd_inputs:
        args = bwd_args(inp)
        bk_ms.append(cuda_ms(lambda: composite_kernel.composite_bwd(*args), iters=20))
        bp_ms.append(cuda_ms(lambda: composite_kernel.composite_bwd_plain(*args), iters=2, warmup=1))
        b_bounds.append(composite_bwd_bound_ms(inp))
    bwd_ms, bwd_plain_ms, bwd_bound_ms, bwd_bound_by = summarize(bk_ms, bp_ms, b_bounds)
    batch1 = ts.batch(1)
    ts.state.step = 0
    timed_step(ts, batch1)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    splits = [timed_step(ts, batch1) for _ in range(3)]
    step_ms = {k: sum(s[k] for s in splits) / len(splits) for k in splits[0]}
    phase("timing", f"{card} | train step (batch 1, MSE) forward {step_ms['forward_ms']:.3f} ms, "
          f"backward {step_ms['backward_ms']:.3f} ms, optimizer {step_ms['optimizer_ms']:.3f} ms | "
          f"composite_bwd {bwd_ms:.4f} ms/launch (per view {[round(x, 4) for x in bk_ms]}), "
          f"plain {bwd_plain_ms:.3f} ms, bound {bwd_bound_ms:.4f} ms ({bwd_bound_by}) | "
          f"peak memory GiB: evaluation {eval_peak:.2f}, training {({k: round(v, 2) for k, v in train_peaks.items()})}")

    record = {
        "kernels": [
            {
                "name": "composite_fwd",
                "route": "cuda",
                "source": "pixelsplat_tpu_torch/csrc/composite_fwd.cu",
                "replaces": "pixelsplat_tpu/ops/rasterizer/pallas_composite.py:281",
                "launches": launches["composite_fwd"] + train_launches["composite_fwd"],
                "launches_by_path": {"evaluation": launches["composite_fwd"], "training": train_launches["composite_fwd"]},
                "max_abs_err": max_err,
                "ms": kernel_ms,
                "plain_ms": plain_ms,
                "bound_ms": bound_ms,
                "bound_by": bound_by,
                "library_ms": None,
            },
            {
                "name": "composite_bwd",
                "route": "cuda",
                "source": "pixelsplat_tpu_torch/csrc/composite_bwd.cu",
                "replaces": "pixelsplat_tpu/ops/rasterizer/pallas_backward.py:234",
                "launches": train_launches["composite_bwd"],
                "launches_by_path": {"evaluation": launches["composite_bwd"], "training": train_launches["composite_bwd"]},
                "max_abs_err": bwd_abs_err,
                # Relative to each d_table column's largest |gradient|; the check's measure.
                "max_rel_err": bwd_err,
                "ms": bwd_ms,
                "plain_ms": bwd_plain_ms,
                "bound_ms": bwd_bound_ms,
                "bound_by": bwd_bound_by,
                "library_ms": None,
            },
        ]
    }
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
