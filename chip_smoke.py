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
5. eval_protocol: `pixelsplat_tpu_torch.main.main` in this process, as
   `python -m pixelsplat_tpu_torch.main +experiment=re10k mode=test` runs it
   on the repo's fixture (`tests/fixtures/re10k`, two scenes, under
   `tests/fixtures/evaluation_index_fixture.json`: 2 context and 3 target
   views each), `re10k` at full width, the configured 4 data workers, and a
   checkpoint written from `init_state` with seeded weights. Checks 2
   scenes of 393,216 Gaussians encoded probabilistically into SoA, no
   dropped pairs, finite PSNR and SSIM, LPIPS null unless its weights are on
   disk, six 256x256 PNGs named by the fixture's target indices,
   `benchmark.json` (2 encoder, 6 decoder entries), `peak_memory.json`, the
   forward compositing kernel launched exactly 6 times and no other kernel;
   then replays the first scene through `make_eval_encode(pack_soa=True)` +
   `make_eval_decode` on the same batch and uniforms, and holds its PSNR and
   SSIM on the card (cuDNN TF32 on) against the CPU's. Prints encoder ms
   per scene and decoder ms per view (the Benchmarker's), data ms per scene
   and peak memory beside the card line.
6. tools: the four segment sums of `scripts/bench_segment_sum.py` against
   each other (the sorted one through the row-major copy kernel, twice);
   every variant of the stage-ablation kernel
   (`scripts/bench_kernel_ablation.py`) on `re10k`'s first view, `full`
   against the plain compositor without early exit; then, through
   `scripts/bench_tool_kernels.py`, the launch path's raw stream handle
   against PyTorch's on a side stream, the row-major copy against `clone`
   bit for bit on each of its routes' layouts (the segment-sum bench's
   (820,224, 24) 16-bit table contiguous and transposed, its f32 `d_rows`
   and `csum` tables, a view with padded rows, and small edge cases), each
   with its route, and y = 2 x against `x * 2` exactly; their times (ms
   per call from CUDA events in alternating rounds with the library call,
   device-only ms from `torch.profiler`, host us per call) beside their
   bounds.
7. train_protocol: `pixelsplat_tpu_torch.main.main` in this process in
   `mode=train`, as `python -m pixelsplat_tpu_torch.main +experiment=re10k
   mode=train` runs it (cuDNN's TF32 on, as the CLI leaves it; TF32 off
   again after), at full width (256x256, gpp 3, 393,216 Gaussians per
   example, 4 target views) with the configured 16 train and 1 validation
   data workers, on the fixture made into a train split
   (`scripts/train_fixture.py`: the two scenes under new keys in `train/`,
   the fixture's `test/` for validation; the context gap cut from 25 -> 45
   frames to 2 -> 6, the only cut). Run A trains `re10k`'s recipe (batch 7,
   `accumulate_grad_batches` 7, `remat_encoder`) 4 steps from fresh
   weights, a validation check every step and a checkpoint every 2, LPIPS
   with random VGG weights allowed. Checks the returned step and the step
   tracker at 4, checkpoints `step_2` and `step_4` saved once each,
   validation passes at steps 1 and 3 (the one-batch validation iterator is
   restarted at every other check, as the JAX package's `fit` does) with
   finite PSNR and SSIM, their comparison grids on disk at the layout's
   size, finite losses and no dropped pairs at every logged step, weights
   moved after `step_2`, and K1 launched exactly once per target view per example plus
   once per validation view per variant, K2 once per target view per
   example, no other kernel. Run B is the same command to step 6: it must
   resume from `step_4` with the weights and Adam's moments bit for bit
   and end at 6. Run C trains `re10k_depth_loss` 2 steps at its recipe
   (batch 7 in one micro-batch, no remat; running out of memory fails the
   run): a finite `loss/depth` at every logged step, K1 and K2 each
   launched twice per target view per example (colour and depth). Then K1
   and K2 against their plain versions on run C's depth renders (one colour
   channel; the first batch of a new train stream, the final weights, the
   depth loss's cotangents), K1 to the scene's tolerance times the largest
   depth, K2 every row as in phase 4. Prints, from the `benchmark.json` and
   `peak_memory.json` that `fit` writes, per step the data wait (host),
   each micro-batch's forward and backward and the optimizer (CUDA events)
   and the step (host), then validation ms, checkpoint save ms and MiB and
   peak memory, beside the card line.

8. experiments: the evaluation scene on `bench.py`'s cameras, 3 target
   views, at 256x256 with seeded weights, of `acid` (393,216 Gaussians),
   `re10k_ablation_no_depth_encoding` (393,216), `re10k_3_view` (three
   context views at x = 0, 0.4, 0.8: 589,824),
   `re10k_ablation_no_probabilistic_sampling` (gpp 1 with transmittance
   opacities: 131,072) and the encoder's default config
   (`config/model/encoder/epipolar.yaml`: the resnet50 InstanceNorm
   backbone, 393,216). Checks the count v x h x w x gpp from the
   configuration, finite images, no dropped pairs, K1 launched exactly once
   per target view and held against its plain version on view 0; prints
   encode and render ms. Then one training step at batch 1 (4 target
   views) of `re10k_3_view` and of the no-probabilistic-sampling ablation:
   finite losses, a finite gradient on every parameter (a non-zero one on
   the view embeddings of three views), K1 and K2 once per target view, K2
   against its plain version on view 0; its forward, backward and
   optimizer ms.
9. bf16: the `re10k` scene encoded with `compute_dtype=bfloat16` and in
   f32 on the same weights and uniforms (TF32 off): bf16 against f32 mean
   |d opacity| < 0.05 and mean |d mean| < 0.15 (the JAX package's
   `tests/test_model.py` bounds), both rendered finite with no dropped
   pairs, every parameter float32 and each refinement convolution's output
   in its policy's dtype; encode ms of each in alternating rounds, and the
   device ms of the tracer's spans `encoder.epipolar` and `encoder.refine`
   (the upscaler and the two 7x7 refinement convolutions).
10. native: `main.main` as `python -m pixelsplat_tpu_torch.main
   +experiment=re10k_3_view mode=test` runs it (the evaluation sampler
   inserts the midpoint as the third context view; 589,824 Gaussians per
   scene), on a copy of the fixture whose chunk has a `.psz` sibling
   written by `scripts/transcode_chunks.py`, with the configured 4 workers.
   Checks as phase 5, then prints the route the chunk took (or the
   compiler's message where the native loader cannot build, and the CLI
   read `.torch`); where `.psz` ran, its images within 1/255 of the
   `.torch` route's; the data ms per scene on each route.

11. distributed: two ranks sharing the card over gloo
   (`scripts/distributed_step.py`, spawned with a FileStore under the
   gitignored `build/`), `re10k` at full width with the same seeded weights
   on both: one data-parallel training step from step 0 (batch 1 per rank,
   2 context + 4 target views, each rank its own example and uniforms),
   rank 0's weights, averaged gradients and loss parts against one process
   taking both examples as `accumulate=2`, the two ranks' weights equal bit
   for bit, K1 and K2 exactly 4 times per rank; the evaluation scene's 3
   target views split over the ranks (padded to 4) with
   `parallel/render.py::render_views_sharded`, equal bit for bit to the
   plain decoder on rank 0's Gaussians, K1 exactly twice per rank. Prints
   step ms, the all-reduce's ms and MiB and peak memory per rank, labelled
   two processes sharing one card over gloo. Then `main.main` `mode=train`
   in this process under RANK=0 WORLD_SIZE=1 LOCAL_RANK=0 and a free
   MASTER_PORT, over NCCL: the recipe 2 steps on the fixture's train split;
   `rank=0/1` on the mode line, the NCCL group up during the run and
   destroyed after, the first step's loss bit for bit `[train_protocol]`
   run A's, rank 0's checkpoint, launches as in `[train_protocol]`.
12. eval_tools: `scripts/generate_evaluation_index.py` over the fixture on
   the card and on the CPU (the same index), then
   `scripts/compute_metrics.py` over the PNGs that `[eval_protocol]` wrote:
   PSNR and SSIM per view against `Trainer.test`'s on the float renders,
   within a bound on what 8-bit rounding can move them (derived above
   `eval_tools_phase`), printed beside the measured difference.

13. visualization: `main.main` as `python -m pixelsplat_tpu_torch.main
   +experiment=re10k mode=train train.extended_visualization=true` runs it,
   on the fixture's train split as in phase 7 (TF32 off), `re10k` at full
   width, 2 steps of the recipe with a validation check every step (the
   pass falls on step 1). Checks no visualization failure caught, every
   artifact of the validation (the three 256x256 Gaussian projections, the
   camera diagram, each encoder figure, less `gaussian_stats` where
   matplotlib does not import, with the omission printed; the wobble video
   of 60 frames and the interpolation video of 30, MP4 or GIF as printed),
   no dropped pair in any projection or video frame (and prints what the
   JAX package's fixed projection settings would drop), and K1 launched
   exactly steps x batch x views + per validation (2 variants x views + 3
   projections per example + 90 frames), K2 steps x batch x views. Then K1
   against its plain version on wobble frame 0 and on the XY projection
   (the final weights), a 64x64 wobble frame card against the CPU port;
   times of the frames (ms per frame), the projections, the visualizer's
   encode with capture against the plain encode, and the figure drawing.
   Then `scripts/test_splatter.py` (12 frames: K1 exactly 12 times, frame
   0 against the CPU port) and `scripts/visualize_epipolar_lines.py` (card
   against CPU, no kernel).

14. paper: the reference-checkpoint route and the paper's scripts, `re10k`
   at full width with seeded random weights on the fixture's first scene.
   A Lightning `.ckpt` of the encoder in the published layout
   (`num_batches_tracked` counters, `global_step`) is loaded directly
   (`interop/torch_import.py`) and imported (`scripts/import_checkpoint.py`)
   then read through `checkpointing.load`: both equal the source bit for
   bit, the step kept. `scripts/run_parity_eval.py` on the `.ckpt` over the
   fixture's index (its gate reads FAIL on random weights; K1 6 times, 0
   dropped pairs). The figures through their scripts at their default
   resolutions: the point cloud at 1024 (K1 3 + 4 times: three orthographic
   passes and the decoder's colour and depth renders of both context
   views), the sampling figure at 1536 with 2,048 samples per ray (K1 3
   times; the density volume in plain PyTorch), the attention and epipolar
   sampling figures (no kernel). Prints per figure the Gaussians after the
   trim, the pairs the JAX package's fixed settings would drop, the
   settings rendered at, dropped pairs (must be 0), K1's launches against
   the count the script implies and the wall time; K1 against its plain
   version on the densest figure render's lists, its time against its
   bound. The tables and comparison grids over `[eval_protocol]`'s PNGs and
   benchmark files and `[eval_tools]`' metrics, and the launch commands.
   Then both compositing kernels against their plain versions on lists
   crowded at each alpha cut (`scripts/check_alpha_threshold.py`: alpha =
   1/255, the 0.99 clamp, power = 0): pixels and d_table rows beyond 1e-5.

15. assets: the port's own weight import and fixture generator, last
   (it writes into `weights/`, refuses to start where a file it would write
   is already there, and removes what it wrote, pass or fail). (a)
   `scripts/make_fixture_chunk.py` regenerates the fixture under the
   gitignored `build/`: keys, urls, timestamps, cameras and both indexes
   equal to `tests/fixtures` bit for bit, frames within 2/255 in mean; the
   byte-identical share and the largest frame difference. (b) seeded random
   weights in the published layouts at full width (the `lpips` lin file,
   torchvision's VGG16, the DINO ViT-B/8 and ResNet-50 hub checkpoints
   carrying `[eval_protocol]`'s seeded trunks) through
   `scripts/export_weights.py` into `weights/`: on the card the LPIPS npz,
   the direct read and the full state_dict bit-equal, the DINO graft equal
   to the seeded trunks bit for bit. (c) the protocol (`main +experiment=re10k
   mode=test`) on the regenerated fixture with a checkpoint written with
   the DINO npz on disk (bit-equal to `[eval_protocol]`'s) and LPIPS from
   the npz: K1 exactly 6 times, 0 dropped pairs, finite scores; PSNR and
   SSIM per view against `[eval_protocol]`'s within the bound the JPEG
   difference of (a) allows; LPIPS from the direct read on the card against
   the CPU within 1e-4 relative. Prints the seconds of (a), (b), (c) and
   the protocol's ms per scene beside the card line.

After phase 4, project_bin (`scripts/check_project_bin.py`): for the
`re10k` and `re10k_3_view` evaluation scenes, the projection kernel against
its plain version on every target view (every field and the colour within
1e-5 of its largest magnitude, `valid` or a radius different for at most
1e-4 of the Gaussians), the binning kernels against `bin_gaussians_plain` on
every caller's shapes (each target view at the chosen settings, wide keys,
span 3, a one-channel depth colour, a big list that overflows, a 1024x1024
orthographic view, the XY projection): every list entry equal; the
occupancy kernel against `count_big` and `tile_occupancy`: every integer
equal; one scene's launches (4 projections, 3 binnings, 1 occupancy
count); then each stage's ms against its plain version and its bound.

Then conv7 (`scripts/bench_conv7.py`): the refinement's two 7x7
convolutions of the `re10k` and `re10k_3_view` scenes (2 and 3 views at
256x256, 128 -> 256 -> 128 channels) through K9, each within twice cuDNN
float32's relative RMS error against float64; K9's ms beside its bound (165
TFLOP/s), its plain twin and cuDNN float32's default and best algorithms,
K9 faster than the best; one scene's launches (2).

Then linear (`scripts/bench_linear.py`): the DINO ViT's four linear layers
of the `re10k` and `re10k_3_view` scenes (2050 and 3075 tokens, 768 ->
2304, 768, 3072 and 3072 -> 768) and GS-LRM's six of the `gslrm` scene
(2,048 tokens, 576 -> 1024, 1024 -> 3072, 1024, 4096 and 768, 4096 ->
1024) through K10, each within twice cuBLAS float32's relative RMS error
against float64 and within 1e-6 of its plain twin (its parts summed in
float64); K10's ms beside its bound (165 TFLOP/s) and cuBLAS float32, K10
faster over each scene's launches; one `re10k` scene's launches (48) and
one `gslrm` scene's (98), with no float32 layer on the plain route
(`linear_plain_on_card` 0).

Then conv3x3 (`scripts/bench_conv3x3.py`): the 87 stride-1 3x3
convolutions of an `mvsplat` evaluation scene (25 distinct shapes, 2 views
at 256x256) through K11, each within twice cuDNN float32's relative RMS
error against float64; K11's ms beside its bound (165 TFLOP/s), its plain
twin and cuDNN float32, K11 faster over the scene; one `mvsplat` scene's
launches (87).

Every kernel's launch count is set to 0 just before each path is driven
and read just after it. The run ends with the card line, a JSON record of
the kernels and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import shutil
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
# loop, for c colour channels: offset 2, quadratic form 9, opacity scale 1,
# clamp 1, tests and select 3, weight 1, transmittance update 2, and one
# FMA (2) per channel (the expf goes to the special-function units and is
# not counted here): 25 for a colour render (c = 3), 21 for a depth render
# (c = 1). The kernel runs all six colour columns of its 12-float rows;
# the bound counts only the channels the render uses.
COMPOSITE_OPS_PER_EVAL = 19
COMPOSITE_OPS_PER_CHANNEL = 2
# FP32 operations per (list slot, pixel) evaluation in the backward sweep,
# for c channels: the forward's alpha recomputed 16 (offset 2, quadratic
# form 9, opacity scale 1, tests, select and clamp 4), log T, w, S,
# d_alpha, d_power and d_opacity 10, the five geometry partials 18, one
# add each of those six partials into its per-slot sum 6, and per channel
# colour . g 2, its partial 1 and its add 1 (expf, log1pf and the second
# expf go to the special-function units): 62 for c = 3, 54 for c = 1.
COMPOSITE_BWD_OPS_PER_EVAL = 50
COMPOSITE_BWD_OPS_PER_CHANNEL = 4
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


def launch_counts(kernels) -> dict:
    """Each kernel's launches since the tracer was last reset, by the
    kernel's name (`kernels` maps it to its launch counter)."""
    from pixelsplat_tpu_torch.utils import tracing

    return {name: tracing.counter(c) for name, c in kernels.items()}


def reset_launches(kernels) -> None:
    from pixelsplat_tpu_torch.utils import tracing

    tracing.reset()


def colour_channels(table) -> int:
    """The colour channels a render uses: its table's colour columns (6 on)
    up to the last one that is not all zeros."""
    used = (table[:, 6:] != 0).any(dim=0).nonzero()
    return int(used.max()) + 1 if used.numel() else 0


def composite_bound_ms(tiles, table, n_proc, chunk: int) -> tuple[float, str]:
    """Least time for one compositing launch on these inputs: the larger of
    its bytes (inputs read once, outputs written once) over HBM bandwidth
    and its FP32 work on the list slots it composites, for the channels the
    render uses, over the FP32 rate."""
    import torch

    num_tiles = tiles.counts.numel()
    pixels = 256
    evals = int(torch.minimum(tiles.counts.long(), n_proc.long() * chunk).sum()) * pixels
    ops = COMPOSITE_OPS_PER_EVAL + COMPOSITE_OPS_PER_CHANNEL * colour_channels(table)
    bytes_in = table.numel() * 4 + tiles.flat.numel() * 4 + 2 * num_tiles * 4
    bytes_out = num_tiles * (8 * pixels + pixels + 1) * 4
    t_bytes = (bytes_in + bytes_out) / PEAK_BYTES_PER_S
    t_ops = evals * ops / PEAK_FP32_PER_S
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def composite_bwd_bound_ms(inp) -> tuple[float, str]:
    """Least time for one backward compositing launch on these inputs: the
    larger of its bytes (table, ids, per-tile integers, T and both
    cotangents read once, d_table written once) over HBM bandwidth and its
    FP32 work on the list slots the forward composited, for the channels
    the render uses, over the FP32 rate."""
    import torch

    tiles, table, chunk = inp["tiles"], inp["table"], inp["chunk"]
    num_tiles = tiles.counts.numel()
    pixels = 256
    evals = int(torch.minimum(tiles.counts.long(), inp["n_proc"].long() * chunk).sum()) * pixels
    ops = COMPOSITE_BWD_OPS_PER_EVAL + COMPOSITE_BWD_OPS_PER_CHANNEL * colour_channels(table)
    bytes_in = (
        table.numel() * 4 + tiles.flat.numel() * 4 + 3 * num_tiles * 4
        + num_tiles * (pixels + 8 * pixels + pixels) * 4
    )
    bytes_out = table.numel() * 4
    t_bytes = (bytes_in + bytes_out) / PEAK_BYTES_PER_S
    t_ops = evals * ops / PEAK_FP32_PER_S
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
    reset_launches(kernels)
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
    launches = launch_counts(kernels)

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
    reset_launches(kernels)
    gaussians, settings, color, overflow = scene.run(seed)
    torch.cuda.synchronize()
    launches = launch_counts(kernels)
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

# The evaluation protocol's phase: the CLI's configuration on the repo's
# fixture (two scenes of 8 frames at 360x640, 2 context and 3 target views
# each under the fixture's evaluation index), at full width.
FIXTURE = ROOT / "tests" / "fixtures"
EVAL_PROTOCOL_ARGV = [
    "+experiment=re10k",
    "mode=test",
    f"dataset.roots=[{FIXTURE / 're10k'}]",
    "dataset/view_sampler=evaluation",
    f"dataset.view_sampler.index_path={FIXTURE / 'evaluation_index_fixture.json'}",
]
EVAL_PROTOCOL_SHAPE = (256, 256)
# The CLI's first scene against make_eval_encode + make_eval_decode on the
# same batch and uniforms, on the same card with the same settings: the same
# program on the same inputs, so any difference is nondeterminism.
EVAL_REPLAY_ATOL = 1e-5
# Card against CPU for the metrics of those images: PSNR in dB, SSIM. Both
# are float32 means over 196,608 values; with TF32 in cuDNN (PyTorch's
# default, on during this check) SSIM would be off by ~1e-3.
EVAL_PSNR_ATOL_DB = 1e-4
EVAL_SSIM_ATOL = 1e-6
# Where `[eval_protocol]` leaves its PNGs for `[eval_tools]` (gitignored).
EVAL_TOOLS_DIR = ROOT / "build" / "chip_smoke" / "eval_tools"


@contextlib.contextmanager
def watched_protocol():
    """Watch the protocol's encodes and renders through the wrapper's
    factories: yields {"encode": [batch, generator state, ...], "decode":
    [colour, settings]}, one entry per call."""
    from pixelsplat_tpu_torch.training.model_wrapper import ModelWrapper

    seen = {"encode": [], "decode": []}
    make_encode, make_decode = ModelWrapper.make_eval_encode, ModelWrapper.make_eval_decode

    def watched_encode(self, pack_soa=False):
        encode = make_encode(self, pack_soa=pack_soa)

        def encode_fn(batch, deterministic, step, generator=None, u=None, view_order=None):
            state = None if generator is None else generator.get_state()
            g = encode(batch, deterministic, step, generator=generator, u=u, view_order=view_order)
            seen["encode"].append(dict(batch=batch, generator_state=state, pack_soa=pack_soa,
                                       deterministic=deterministic, gaussians=g.mean_x.shape[1]))
            return g

        return encode_fn

    def watched_decode(self):
        decode = make_decode(self)

        def decode_fn(*args, **kwargs):
            color, overflow = decode(*args, **kwargs)
            seen["decode"].append(dict(color=color, settings=args[6] if len(args) > 6 else None))
            return color, overflow

        return decode_fn

    ModelWrapper.make_eval_encode, ModelWrapper.make_eval_decode = watched_encode, watched_decode
    try:
        yield seen
    finally:
        ModelWrapper.make_eval_encode, ModelWrapper.make_eval_decode = make_encode, make_decode


def eval_protocol_phase(torch, kernels) -> dict:
    """`pixelsplat_tpu_torch.main.main` in this process, as the CLI runs it:
    `re10k` at full width, the fixture, the configured data workers (forked
    after CUDA is initialised), a checkpoint that
    `scripts/write_checkpoint.py` writes from `init_state` with seeded
    weights. Returns the kernels' launch counts of the run, the summary,
    and each scene's ground truth and float renders (its PNGs are copied to
    `EVAL_TOOLS_DIR`)."""
    import shutil
    import tempfile

    from PIL import Image

    from pixelsplat_tpu_torch import main as cli
    from pixelsplat_tpu_torch.config import load_config
    from pixelsplat_tpu_torch.dataset.data_module import DataModule
    from pixelsplat_tpu_torch.evaluation.lpips import load_lpips
    from pixelsplat_tpu_torch.evaluation.metrics import compute_psnr, compute_ssim
    from pixelsplat_tpu_torch.scripts.eval_scene import card_line
    from pixelsplat_tpu_torch.scripts.write_checkpoint import write_checkpoint
    from pixelsplat_tpu_torch.training.checkpoint import load_checkpoint
    from pixelsplat_tpu_torch.training.model_wrapper import ModelWrapper
    from pixelsplat_tpu_torch.training.trainer import RESULTS_NAME

    index = json.loads((FIXTURE / "evaluation_index_fixture.json").read_text())
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        argv = EVAL_PROTOCOL_ARGV + [f"test.output_path={tmp / 'test'}", f"output_dir={tmp / 'outputs'}"]
        cfg = load_config(argv + ["checkpointing.load=unused"])
        h, w = cfg.dataset.image_shape
        checkpoint = write_checkpoint(tmp / "checkpoints", RE10K, SEED)  # the preset equals the experiment

        held_gib = torch.cuda.memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        reset_launches(kernels)
        with watched_protocol() as seen:
            t0 = time.perf_counter()
            summary = cli.main(argv + [f"checkpointing.load={checkpoint}"])
        run_s = time.perf_counter() - t0
        launches = launch_counts(kernels)

        phase("eval_protocol", f"main {' '.join(EVAL_PROTOCOL_ARGV)} ... in {run_s:.1f} s: {summary}")
        if summary["num_scenes"] != len(index) or summary["overflow_pairs"] != 0:
            fail(f"eval_protocol: {summary['num_scenes']} scenes, {summary['overflow_pairs']} dropped pairs")
        if not (math.isfinite(summary["psnr"]) and math.isfinite(summary["ssim"])):
            fail(f"eval_protocol: PSNR {summary['psnr']}, SSIM {summary['ssim']}")
        pretrained_lpips = load_lpips() is not None
        if (summary["lpips"] is None) == pretrained_lpips:
            fail(f"eval_protocol: lpips {summary['lpips']} with pretrained weights on disk: {pretrained_lpips}")
        counts = [e["gaussians"] for e in seen["encode"]]
        if counts != [2 * h * w * 3] * len(index) or (h, w) != EVAL_PROTOCOL_SHAPE:
            fail(f"eval_protocol: Gaussians per scene {counts}, images {h}x{w}")
        if any(not e["pack_soa"] or e["deterministic"] or e["generator_state"] is None for e in seen["encode"]):
            fail("eval_protocol: the protocol did not encode probabilistically into SoA from its generator")
        if launches["composite_fwd"] != 3 * len(index) or any(n for k, n in launches.items() if k != "composite_fwd"):
            fail(f"eval_protocol: kernel launches {launches}, expected composite_fwd once per target view")

        results = tmp / "test" / RESULTS_NAME
        want_pngs = sorted(f"{scene}/color/{i:0>6}.png" for scene, e in index.items() for i in e["target"])
        pngs = sorted(str(p.relative_to(results)) for p in results.rglob("*.png"))
        if pngs != want_pngs:
            fail(f"eval_protocol: PNGs {pngs}, expected {want_pngs}")
        sizes = {Image.open(results / name).size for name in pngs}
        if sizes != {(w, h)}:
            fail(f"eval_protocol: PNG sizes {sizes}")
        bench = json.loads((results / "benchmark.json").read_text())
        if {k: len(v) for k, v in bench.items()} != {"encoder": len(index), "decoder": 3 * len(index)}:
            fail(f"eval_protocol: benchmark.json holds {({k: len(v) for k, v in bench.items()})}")
        memory = json.loads((results / "peak_memory.json").read_text())
        if "peak_bytes_in_use" not in memory:
            fail(f"eval_protocol: peak_memory.json has no peak_bytes_in_use ({len(memory)} keys)")
        phase("eval_protocol", f"{len(pngs)} PNGs at {w}x{h}: {', '.join(pngs)}; composite_fwd launched "
              f"{launches['composite_fwd']} times; {counts[0]} Gaussians per scene")

        # The first scene again through the wrapper's evaluation entry points.
        reference = ModelWrapper(cfg.model.encoder, cfg.model.decoder)
        reference.encoder.load_state_dict(load_checkpoint(checkpoint)["params"], strict=True)
        first = seen["encode"][0]
        generator = torch.Generator(device=reference.device)
        generator.set_state(first["generator_state"])
        gaussians = reference.make_eval_encode(pack_soa=True)(first["batch"], False, 0, generator=generator)
        target = first["batch"]["target"]
        settings = reference.choose_eval_settings(
            gaussians, target["extrinsics"], target["intrinsics"], target["near"], (h, w)
        )
        color, overflow = reference.make_eval_decode()(
            gaussians, target["extrinsics"], target["intrinsics"], target["near"], target["far"], (h, w), settings
        )
        torch.cuda.synchronize()
        replay_err = float((color - seen["decode"][0]["color"]).abs().max())
        phase("eval_protocol", f"first scene replayed through make_eval_encode(pack_soa=True) + "
              f"make_eval_decode: max |diff| {replay_err:.3g} (atol {EVAL_REPLAY_ATOL}), settings "
              f"{'equal' if settings == seen['decode'][0]['settings'] else 'DIFFER'}, overflow {int(overflow)}")
        if not replay_err <= EVAL_REPLAY_ATOL or settings != seen["decode"][0]["settings"] or int(overflow):
            fail(f"eval_protocol: the replayed first scene differs by {replay_err:.3g}")

        # Its metrics on the card, with cuDNN's TF32 on as PyTorch leaves it,
        # against the same functions on the CPU.
        gt, img = target["image"][0], color[0]
        cudnn = torch.backends.cudnn
        with cudnn.flags(enabled=True, benchmark=cudnn.benchmark, deterministic=cudnn.deterministic,
                         allow_tf32=True):
            card_metrics = [float(compute_psnr(gt, img).mean()), float(compute_ssim(gt, img).mean())]
        cpu_metrics = [float(compute_psnr(gt.cpu(), img.cpu()).mean()), float(compute_ssim(gt.cpu(), img.cpu()).mean())]
        psnr_err, ssim_err = (abs(a - b) for a, b in zip(card_metrics, cpu_metrics))
        phase("eval_protocol", f"first scene PSNR {card_metrics[0]:.6f} dB (card) vs {cpu_metrics[0]:.6f} (CPU), "
              f"SSIM {card_metrics[1]:.8f} vs {cpu_metrics[1]:.8f}")
        if not (psnr_err <= EVAL_PSNR_ATOL_DB and ssim_err <= EVAL_SSIM_ATOL):
            fail(f"eval_protocol: card vs CPU metrics off by {psnr_err:.3g} dB PSNR, {ssim_err:.3g} SSIM")
        # What `[eval_tools]` scores again: the PNGs, and each scene's ground
        # truth and float renders as `Trainer.test` scored them.
        shutil.rmtree(EVAL_TOOLS_DIR, ignore_errors=True)
        shutil.copytree(results, EVAL_TOOLS_DIR / "frames")
        renders = [
            dict(gt=e["batch"]["target"]["image"][0].cpu(), color=d["color"][0].cpu(),
                 index=e["batch"]["target"]["index"][0].tolist())
            for e, d in zip(seen["encode"], seen["decode"])
        ]
        del reference, gaussians, color, seen

        # The data path alone: the test loader with the configured workers
        # (their start included), then inline.
        data_ms = {}
        for workers in (cfg.data_loader.test.num_workers, 0):
            loader_cfg = dataclasses.replace(
                cfg.data_loader, test=dataclasses.replace(cfg.data_loader.test, num_workers=workers)
            )
            t0 = time.perf_counter()
            scenes = sum(1 for _ in DataModule(cfg.dataset, loader_cfg).test_dataloader())
            data_ms[workers] = (time.perf_counter() - t0) * 1e3 / scenes

    encoder_ms = [1e3 * t for t in bench["encoder"]]
    decoder_ms = [1e3 * t for t in bench["decoder"]]
    peak_gib = memory["peak_bytes_in_use"] / 2**30
    phase("timing", f"eval_protocol | {card_line()} | encoder ms per scene {[round(t, 3) for t in encoder_ms]} "
          f"(mean {sum(encoder_ms) / len(encoder_ms):.3f}) | decoder ms per view "
          f"{[round(t, 3) for t in decoder_ms[::3]]} (mean {sum(decoder_ms) / len(decoder_ms):.3f}; the settings "
          f"probe included) | data ms per scene {data_ms[cfg.data_loader.test.num_workers]:.1f} with "
          f"{cfg.data_loader.test.num_workers} workers, {data_ms[0]:.1f} inline | peak memory {peak_gib:.2f} GiB "
          f"({held_gib:.2f} GiB held by earlier phases) | main {run_s:.1f} s")
    return {"launches": launches, "renders": renders, "summary": summary}


# The training phase: the CLI's `mode=train` on the fixture made into a
# train split (`scripts/train_fixture.py`: the two scenes under new keys in
# `train/`, the fixture's `test/` for validation; the context gap cut from
# 25 -> 45 frames to 2 -> 6), at full width (256x256, gpp 3, 4 target views).
# A check every step: `fit`'s validation iterator holds one batch and is
# restarted when a check finds it spent, as the JAX package's `fit` does, so
# the passes fall on every other check (steps 1 and 3 of 4).
TRAIN_PROTOCOL_ARGV = [
    "+experiment=re10k", "mode=train", "loss.lpips.allow_random_weights=true", "trainer.max_steps=4",
    "trainer.val_check_interval=1", "checkpointing.every_n_train_steps=2", "trainer.log_every_n_steps=1",
]
RESUME_STEPS = 6
DEPTH_LOSS_ARGV = [
    "+experiment=re10k_depth_loss", "mode=train", "loss.lpips.allow_random_weights=true", "trainer.max_steps=2",
    "trainer.val_check_interval=0", "checkpointing.every_n_train_steps=2", "trainer.log_every_n_steps=1",
]


class Captured:
    """What `main` does not return: the trainer that `build_everything`
    makes and, when `reference` (a TrainState) is given, whether the state
    that `load_state_dict` restores equals it bit for bit."""

    def __init__(self, torch, reference=None):
        self.torch, self.reference, self.trainer, self.loaded = torch, reference, None, None

    def __enter__(self):
        from pixelsplat_tpu_torch import main as cli
        from pixelsplat_tpu_torch.training.model_wrapper import ModelWrapper

        torch, watch = self.torch, self
        build, load = self.originals = cli.build_everything, ModelWrapper.load_state_dict

        def build_everything(*a, **k):
            watch.trainer = build(*a, **k)
            return watch.trainer

        def load_state_dict(self, state, payload):
            state = load(self, state, payload)
            ref = watch.reference
            if ref is not None:
                adam, ref_adam = state.optimizer.adam.state, ref.optimizer.adam.state
                params = sum(not torch.equal(p, ref.params[k]) for k, p in state.params.items())
                moments = sum(
                    adam[p].keys() != ref_adam[ref.params[k]].keys()
                    or any(not torch.equal(v, ref_adam[ref.params[k]][n]) for n, v in adam[p].items())
                    for k, p in state.params.items()
                )
                watch.loaded = dict(step=state.step, params_differ=params, moments_differ=moments,
                                    tensors=len(state.params))
            return state

        cli.build_everything, ModelWrapper.load_state_dict = build_everything, load_state_dict
        return self

    def __exit__(self, *exc):
        from pixelsplat_tpu_torch import main as cli
        from pixelsplat_tpu_torch.training.model_wrapper import ModelWrapper

        cli.build_everything, ModelWrapper.load_state_dict = self.originals
        return False


def report_fit(label, out, accumulate, card) -> dict:
    """Prints a run's per-step, validation and checkpoint timings, as `fit`
    writes them to `out/benchmark.json` (data waits, steps, validation and
    checkpoint saves on the host clock; each micro-batch's forward and
    backward and the optimizer on CUDA events), beside the card line and
    the peak of `out/peak_memory.json`; returns their summary and the
    number of checkpoint saves."""
    ms = {k: [1e3 * t for t in v] for k, v in json.loads((out / "benchmark.json").read_text()).items()}
    steps = []
    for k, step_ms in enumerate(ms["step"]):
        micro = slice(k * accumulate, (k + 1) * accumulate)
        steps.append(dict(data_ms=ms["data"][k], forward_ms=ms["forward"][micro], backward_ms=ms["backward"][micro],
                          optimizer_ms=ms["optimizer"][k], step_ms=step_ms))
        st = steps[-1]
        fb = [f + b for f, b in zip(st["forward_ms"], st["backward_ms"])]
        phase("timing", f"train_protocol {label} | {card} | step {k + 1}: data wait {st['data_ms']:.1f} ms (host), "
              f"{len(fb)} micro-batch(es) forward + backward {[round(x, 1) for x in fb]} ms (forward "
              f"{[round(x, 1) for x in st['forward_ms']]}; CUDA events), optimizer {st['optimizer_ms']:.2f} ms, "
              f"step {st['step_ms']:.1f} ms (host)")
    later = steps[1:] or steps
    saved = sorted(int(p.name.split("_")[1]) for p in (out / "checkpoints").iterdir())[-len(ms.get("checkpoint", [])):]
    summary = dict(
        step_ms=sorted(s["step_ms"] for s in later)[len(later) // 2],
        micro_ms=sum(sum(s["forward_ms"]) + sum(s["backward_ms"]) for s in later)
        / sum(len(s["forward_ms"]) for s in later),
        optimizer_ms=sum(s["optimizer_ms"] for s in later) / len(later),
        first_wait_ms=ms["data"][0], later_wait_ms=sorted(ms["data"][1:]),
        validation_ms=ms.get("validation", []),
        checkpoints=[(step, t, (out / "checkpoints" / f"step_{step}").stat().st_size / 2**20)
                     for step, t in zip(saved, ms.get("checkpoint", []))],
        peak_gib=json.loads((out / "peak_memory.json").read_text())["peak_bytes_in_use"] / 2**30,
    )
    phase("timing", f"train_protocol {label} | {card} | median step {summary['step_ms']:.1f} ms after the first, "
          f"forward + backward {summary['micro_ms']:.1f} ms per micro-batch, optimizer {summary['optimizer_ms']:.2f} ms; "
          f"data wait {summary['first_wait_ms']:.1f} ms for the first batch, then "
          f"{[round(x, 2) for x in summary['later_wait_ms']]} ms; validation ms "
          f"{[round(x, 1) for x in summary['validation_ms']]}; checkpoint saves (step, ms, MiB) "
          f"{[(s, round(t, 1), round(m, 1)) for s, t, m in summary['checkpoints']]}; peak memory "
          f"{summary['peak_gib']:.2f} GiB")
    return summary


def validation_steps(start: int, end: int, interval: int) -> list[int]:
    """The steps of a `fit` from `start` to `end` that validate: every other
    multiple of `interval`, from the first (the one-batch iterator is spent
    at the check after a pass, and restarted at the next)."""
    out, fresh = [], True
    for step in range(start + 1, end + 1):
        if interval > 0 and step % interval == 0:
            if fresh:
                out.append(step)
            fresh = not fresh
    return out


def logged(out) -> tuple[dict, dict]:
    """(training parts by step, validation metrics by step) of a run's log."""
    lines = [json.loads(x) for x in (out / "local" / "metrics.jsonl").read_text().splitlines()]
    train = {x["step"]: x for x in lines if "loss/total" in x}
    val = {x["step"]: x for x in lines if "val/psnr_probabilistic" in x}
    return train, val


def check_logged(label, train, steps, need=()):
    for step in steps:
        if step not in train:
            fail(f"train_protocol {label}: step {step} not logged ({sorted(train)})")
        bad = [k for k, v in train[step].items() if k != "step" and not math.isfinite(v)]
        if bad or train[step]["train/overflow_pairs"] != 0 or any(k not in train[step] for k in need):
            fail(f"train_protocol {label}: step {step} logged {train[step]}")


def train_protocol_phase(torch, kernels) -> dict:
    """`pixelsplat_tpu_torch.main.main` in this process in `mode=train`, as
    `python -m pixelsplat_tpu_torch.main +experiment=re10k mode=train` runs
    it (cuDNN's TF32 on, as the CLI leaves it), on the fixture made into a
    train split, at full width with the configured data workers: run A
    trains `re10k`'s recipe 4 steps with validation and checkpoints, run B
    resumes it to step 6, run C trains `re10k_depth_loss` 2 steps; then K1
    and K2 against their plain versions on run C's depth renders."""
    import gc
    import tempfile
    from types import SimpleNamespace

    import numpy as np
    from PIL import Image

    from pixelsplat_tpu_torch import main as cli
    from pixelsplat_tpu_torch.config import NUM_TARGET_VIEWS, load_config
    from pixelsplat_tpu_torch.ops.rasterizer import composite_kernel
    from pixelsplat_tpu_torch.scripts.eval_scene import card_line, cuda_ms
    from pixelsplat_tpu_torch.scripts.train_fixture import FIXTURE_OVERRIDES, write_train_root
    from pixelsplat_tpu_torch.scripts.train_scene import backward_inputs
    from pixelsplat_tpu_torch.visualization.annotation import add_label
    from pixelsplat_tpu_torch.visualization.layout import add_border, hcat, vcat

    card = card_line()
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    result = {"launches": {}}

    def run(argv, reference=None):
        reset_launches(kernels)
        torch.cuda.reset_peak_memory_stats()
        with Captured(torch, reference) as captured:
            t0 = time.perf_counter()
            state = cli.main(argv)
            seconds = time.perf_counter() - t0
        return state, captured, launch_counts(kernels), seconds

    def expect_launches(label, launches, fwd, bwd):
        if launches["composite_fwd"] != fwd or launches["composite_bwd"] != bwd or any(
            n for k, n in launches.items() if k not in ("composite_fwd", "composite_bwd")
        ):
            fail(f"train_protocol {label}: launches {launches}, expected composite_fwd {fwd}, composite_bwd {bwd}")

    try:
        with tempfile.TemporaryDirectory() as tmp:
            tmp = Path(tmp)
            root = write_train_root(tmp / "re10k")
            common = [f"dataset.roots=[{root}]", *FIXTURE_OVERRIDES]
            out = tmp / "outputs"
            argv_a = TRAIN_PROTOCOL_ARGV + common + [f"output_dir={out}"]
            cfg = load_config(argv_a)
            batch, accumulate = cfg.data_loader.train.batch_size, cfg.trainer.accumulate_grad_batches
            steps_a, every = cfg.trainer.max_steps, cfg.checkpointing.every_n_train_steps
            phase("train_protocol", f"main {' '.join(TRAIN_PROTOCOL_ARGV)} on the fixture's train split; cuts: "
                  f"{' '.join(FIXTURE_OVERRIDES)}; batch {batch}, accumulate {accumulate}, remat_encoder "
                  f"{cfg.train.remat_encoder}, {cfg.data_loader.train.num_workers} train and "
                  f"{cfg.data_loader.val.num_workers} val workers, images {cfg.dataset.image_shape}, "
                  f"{cfg.dataset.view_sampler.num_target_views} target views, cuDNN TF32 on")

            # Run A: the recipe from fresh weights.
            held_gib = torch.cuda.memory_allocated() / 2**30
            state_a, captured_a, launches, seconds = run(argv_a)
            result["launches"]["train_protocol re10k"] = launches
            trainer = captured_a.trainer
            train, val = logged(out)
            result["run_a_first_loss"] = train[1]["loss/total"]
            phase("train_protocol", f"run A: main returned step {state_a.step} in {seconds:.1f} s; step tracker "
                  f"{trainer.step_tracker.get_step()}; checkpoints "
                  f"{sorted(p.name for p in (out / 'checkpoints').iterdir())}; validation "
                  f"{({s: {k: round(v, 4) for k, v in x.items() if k != 'step'} for s, x in val.items()})}; "
                  f"launches {launches}")
            for step, parts in train.items():
                phase("train_protocol", f"run A step {step}: " + ", ".join(
                    f"{k} {v:.6g}" for k, v in parts.items() if k != "step"))
            if state_a.step != steps_a or trainer.step_tracker.get_step() != steps_a:
                fail(f"train_protocol: run A ended at step {state_a.step}, tracker {trainer.step_tracker.get_step()}")
            check_logged("run A", train, range(1, steps_a + 1))
            want_ckpts = [f"step_{s}" for s in range(every, steps_a + 1, every)]
            saves = len(json.loads((out / "benchmark.json").read_text()).get("checkpoint", []))
            if sorted(p.name for p in (out / "checkpoints").iterdir()) != want_ckpts or saves != len(want_ckpts):
                fail(f"train_protocol: run A saved {saves} time(s), expected {want_ckpts} once each")
            val_steps = validation_steps(0, steps_a, cfg.trainer.val_check_interval)
            if sorted(val) != val_steps or not all(
                math.isfinite(x[f"val/{m}_{v}"]) for x in val.values() for m in ("psnr", "ssim")
                for v in ("probabilistic", "deterministic")
            ):
                fail(f"train_protocol: run A validation {val}, expected finite PSNR and SSIM at steps {val_steps}")
            h, w = cfg.dataset.image_shape
            grid = add_border(vcat(*(
                add_label(hcat(*([np.zeros((3, h, w), np.float32)] * n)), label)
                for n, label in ((2, "Context"), (4, "Target (GT)"), (4, "Target (probabilistic)"),
                                 (4, "Target (deterministic)"))
            )))
            grids = sorted((out / "local" / "comparison").iterdir())
            sizes = [Image.open(p).size for p in grids]
            if [p.name for p in grids] != [f"{s:06d}.png" for s in val_steps] or set(sizes) != {grid.shape[:0:-1]}:
                fail(f"train_protocol: comparison grids {[p.name for p in grids]} of sizes {sizes}, expected "
                     f"{grid.shape[:0:-1]} at steps {val_steps}")
            # The weights moved between the first checkpoint and the last step.
            earlier = torch.load(out / "checkpoints" / want_ckpts[0], map_location="cuda")["params"]
            moved = sum(bool((earlier[k] != p.detach()).any()) for k, p in state_a.params.items())
            del earlier
            if moved < len(state_a.params) // 2:
                fail(f"train_protocol: run A moved {moved} of {len(state_a.params)} parameter tensors after "
                     f"{want_ckpts[0]}")
            per_view = steps_a * batch * NUM_TARGET_VIEWS
            expect_launches("run A", launches, per_view + len(val_steps) * 2 * NUM_TARGET_VIEWS, per_view)
            phase("train_protocol", f"run A: {moved}/{len(state_a.params)} parameter tensors moved after "
                  f"{want_ckpts[0]}; grids "
                  f"{[p.name for p in grids]} at {sizes[0]}; composite_fwd {launches['composite_fwd']} = "
                  f"{steps_a} steps x {batch} examples x {NUM_TARGET_VIEWS} views + {len(val_steps)} validations x 2 "
                  f"variants x {NUM_TARGET_VIEWS}; composite_bwd {launches['composite_bwd']}")
            result["re10k"] = report_fit("re10k", out, accumulate, card)
            result["re10k"]["held_gib"] = held_gib
            del trainer, captured_a

            # Run B: the same command to step 6 resumes from the latest checkpoint.
            argv_b = argv_a + [f"trainer.max_steps={RESUME_STEPS}"]
            state_b, captured_b, launches, seconds = run(argv_b, reference=state_a)
            result["launches"]["train_protocol resume"] = launches
            loaded = captured_b.loaded
            phase("train_protocol", f"run B: resumed {loaded}; main returned step {state_b.step} in {seconds:.1f} s; "
                  f"checkpoints {sorted(p.name for p in (out / 'checkpoints').iterdir())}; launches {launches}")
            if loaded is None or loaded["step"] != steps_a or loaded["params_differ"] or loaded["moments_differ"]:
                fail(f"train_protocol: run B did not restore run A's state bit for bit: {loaded}")
            if state_b.step != RESUME_STEPS:
                fail(f"train_protocol: run B ended at step {state_b.step}")
            train, val = logged(out)
            check_logged("run B", train, range(steps_a + 1, RESUME_STEPS + 1))
            resumed, val_b = RESUME_STEPS - steps_a, validation_steps(steps_a, RESUME_STEPS, cfg.trainer.val_check_interval)
            if sorted(s for s in val if s > steps_a) != val_b:
                fail(f"train_protocol: run B validated at {sorted(val)}, expected {val_b} after step {steps_a}")
            expect_launches("run B", launches, resumed * batch * NUM_TARGET_VIEWS + len(val_b) * 2 * NUM_TARGET_VIEWS,
                            resumed * batch * NUM_TARGET_VIEWS)
            result["resume"] = report_fit("resume", out, accumulate, card)
            del state_a, state_b, captured_b
            gc.collect()
            torch.cuda.empty_cache()

            # Run C: re10k_depth_loss as its recipe is; out of memory fails the run.
            out_c = tmp / "outputs_depth"
            argv_c = DEPTH_LOSS_ARGV + common + [f"output_dir={out_c}"]
            cfg_c = load_config(argv_c)
            phase("train_protocol", f"run C: main {' '.join(DEPTH_LOSS_ARGV)}: batch {cfg_c.data_loader.train.batch_size}, "
                  f"accumulate {cfg_c.trainer.accumulate_grad_batches}, remat_encoder {cfg_c.train.remat_encoder}, "
                  f"depth_mode {cfg_c.train.depth_mode}")
            try:
                state_c, captured_c, launches, seconds = run(argv_c)
            except torch.cuda.OutOfMemoryError as exc:
                fail(f"train_protocol: run C ran out of memory as configured (peak "
                     f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB before the failed allocation): "
                     f"{str(exc).splitlines()[0]}")
            result["launches"]["train_protocol re10k_depth_loss"] = launches
            train, _ = logged(out_c)
            for step, parts in train.items():
                phase("train_protocol", f"run C step {step}: " + ", ".join(
                    f"{k} {v:.6g}" for k, v in parts.items() if k != "step"))
            steps_c, batch_c = cfg_c.trainer.max_steps, cfg_c.data_loader.train.batch_size
            if state_c.step != steps_c:
                fail(f"train_protocol: run C ended at step {state_c.step}")
            check_logged("run C", train, range(1, steps_c + 1), need=("loss/depth",))
            per_view = steps_c * batch_c * NUM_TARGET_VIEWS
            expect_launches("run C", launches, 2 * per_view, 2 * per_view)
            phase("train_protocol", f"run C: main returned step {state_c.step} in {seconds:.1f} s; launches {launches} "
                  f"= 2 x ({steps_c} steps x {batch_c} examples x {NUM_TARGET_VIEWS} views): colour and depth")
            result["re10k_depth_loss"] = report_fit("re10k_depth_loss", out_c, cfg_c.trainer.accumulate_grad_batches, card)

            # K1 and K2 against their plain versions on run C's depth renders:
            # the first batch of a new train stream, the weights the run ended with.
            wrapper = captured_c.trainer.wrapper
            first_batch = next(iter(captured_c.trainer.data_module.train_dataloader()))
            batch_arrays = {k: v for k, v in first_batch.items() if k != "scene"}
            scene = SimpleNamespace(wrapper=wrapper, state=state_c)
            inputs = backward_inputs(scene, batch_arrays, seed=SEED, depth_mode=cfg_c.train.depth_mode)
            # Pixels no Gaussian reaches keep T = 1 and render depth 0, where
            # the JAX package's depth loss takes 1 / 0; the port's leaves them out.
            empty = [int((inp["trans"] == 1.0).sum()) for inp in inputs]
            phase("train_protocol", f"run C: pixels of depth 0 (T = 1) in the first batch's first example, per "
                  f"target view: {empty} of {inputs[0]['trans'].numel()}")
            result["empty_pixels"] = empty
            fwd_errs, bwd_errs, timing = [], [], dict(k1=[], k1_plain=[], k1_bound=[], k2=[], k2_plain=[], k2_bound=[])
            for v, inp in enumerate(inputs):
                if not all(bool(x.isfinite().all()) for x in (inp["g_acc"], inp["g_trans"])):
                    fail(f"train_protocol: view {v}'s depth loss cotangent is not finite (a pixel of depth 0?)")
                tiles, table, chunk, tiles_x = inp["tiles"], inp["table"], inp["chunk"], inp["tiles_x"]
                scale = max(1.0, float(table[:, 6:].abs().max()))
                err, n_k = check_kernel_against_plain(composite_kernel, f"depth {v}", tiles, table, chunk, tiles_x)
                if float(table[:, 7:].abs().max()) != 0.0:
                    fail(f"train_protocol: view {v}'s depth table has more than one colour channel")
                if err > KERNEL_ATOL * scale:
                    fail(f"train_protocol: composite_fwd on depth view {v}: {err:.3g} > {KERNEL_ATOL} x {scale:.3g}")
                fwd_errs.append(err)
                bwd_errs.append(check_bwd_kernel_against_plain(f"depth {v}", inp))
                args = (table, tiles.flat, tiles.block_start, tiles.counts, tiles_x, chunk)
                timing["k1"].append(cuda_ms(lambda: composite_kernel.composite_core(*args), iters=20))
                timing["k1_plain"].append(cuda_ms(lambda: composite_kernel.composite_core_plain(*args), iters=2, warmup=1))
                timing["k1_bound"].append(composite_bound_ms(tiles, table, n_k, chunk))
                timing["k2"].append(cuda_ms(lambda: composite_kernel.composite_bwd(*bwd_args(inp)), iters=20))
                timing["k2_plain"].append(
                    cuda_ms(lambda: composite_kernel.composite_bwd_plain(*bwd_args(inp)), iters=2, warmup=1)
                )
                timing["k2_bound"].append(composite_bwd_bound_ms(inp))
            result["depth_fwd"] = summarize(timing["k1"], timing["k1_plain"], timing["k1_bound"]) + (max(fwd_errs),)
            result["depth_bwd"] = summarize(timing["k2"], timing["k2_plain"], timing["k2_bound"]) + (
                max(e[1] for e in bwd_errs), max(e[0] for e in bwd_errs), sum(e[2] for e in bwd_errs))
            f1, f2 = result["depth_fwd"], result["depth_bwd"]
            phase("timing", f"train_protocol depth renders ({colour_channels(inputs[0]['table'])} colour channel in "
                  f"the bounds) | {card} | composite_fwd {f1[0]:.4f} ms/launch, plain "
                  f"{f1[1]:.3f} ms, bound {f1[2]:.4f} ms ({f1[3]}), max |err| {f1[4]:.3g}; composite_bwd {f2[0]:.4f} "
                  f"ms/call, plain {f2[1]:.3f} ms, bound {f2[2]:.4f} ms ({f2[3]}), max |err| {f2[4]:.3g}, max err / "
                  f"column max {f2[5]:.3g}, {f2[6]} threshold tiles explained")
            del state_c, captured_c, wrapper, scene, inputs, first_batch, batch_arrays
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    return result


def project_bin_phase(torch) -> dict:
    """`scripts/check_project_bin.py` on both evaluation scenes, then one
    scene's launches of the three kernels."""
    from pixelsplat_tpu_torch.scripts import check_project_bin
    from pixelsplat_tpu_torch.scripts.eval_scene import make_eval_scene
    from pixelsplat_tpu_torch.utils import tracing

    record = check_project_bin.check((RE10K, "re10k_3_view"))
    for model, r in record["models"].items():
        worst = {f: max(v[f] for v in r["projection"])
                 for f in check_project_bin.FIELDS[:6] + ("color", "valid_differ", "radius_differ")}
        phase("project_bin", f"{model}: projection against plain, largest relative difference and most Gaussians "
                             f"whose valid or radius differ, over the views: {worst}")
        if not all(check_project_bin.projection_agrees(v) for v in r["projection"]):
            fail(f"{model}: the projection kernel differs from its plain version beyond its tolerance: "
                 f"{r['projection']}")
        for name, c in r["lists"].items():
            phase("project_bin", f"{model} {name}: lists {'equal' if c['equal'] else 'DIFFER'}, {c['pairs']} pairs, "
                                 f"overflow {c['overflow']}")
        for case, (kernel, plain) in r["occupancy"].items():
            phase("project_bin", f"{model} occupancy (big list {case}): kernel {kernel}, plain {plain}")
        for stage, t in r["times"].items():
            phase("project_bin", f"{model} {stage}: {t['ms']:.4f} ms a call against plain {t['plain_ms']:.3f} ms; "
                                 f"bound {t['bound_ms']:.4f} ms (bytes){''.join(f'; {k} {v}' for k, v in t.items() if k not in ('ms', 'plain_ms', 'bound_ms'))}")
    if not record["ok"]:
        fail("project_bin: a projection, tile list or occupancy count differs from its plain version")
    scene = make_eval_scene("cuda", seed=SEED)
    scene.run(SEED)
    tracing.reset()
    scene.run(SEED)
    record["scene_launches"] = [
        tracing.counter(c) for c in ("project_launches", "bin_launches", "occupancy_launches")
    ]
    if record["scene_launches"] != [4, 3, 1]:
        fail(f"one scene launched project, bin, occupancy {record['scene_launches']} times, expected 4, 3, 1")
    phase("project_bin", f"one re10k scene: project, bin, occupancy launched {record['scene_launches']} times")
    return record


def conv7_phase(torch) -> dict:
    """`scripts/bench_conv7.py` on both evaluation scenes' refinements: K9
    within twice cuDNN float32's error against float64 and faster than
    cuDNN's best float32 algorithm; then one scene's launches (2)."""
    from pixelsplat_tpu_torch.scripts import bench_conv7
    from pixelsplat_tpu_torch.scripts.eval_scene import make_eval_scene
    from pixelsplat_tpu_torch.utils import tracing

    scenes = {name: bench_conv7.scene(name, rounds=5) for name in bench_conv7.SCENES}
    for name, r in scenes.items():
        for label, v in r["launches"].items():
            if not v["errors"]["k9"] <= 2 * v["errors"]["cudnn_f32"]:
                fail(f"conv7 {name} {label}: relative RMS error {v['errors']['k9']:.3g} against float64, above twice "
                     f"cuDNN float32's {v['errors']['cudnn_f32']:.3g}")
        if not r["scene"]["ms"] < r["scene"]["library_best_ms"]:
            fail(f"conv7 {name}: {r['scene']['ms']:.3f} ms, not faster than cuDNN's best float32 "
                 f"{r['scene']['library_best_ms']:.3f} ms")
    scene = make_eval_scene("cuda", seed=SEED)
    scene.run(SEED)
    tracing.reset()
    scene.run(SEED)
    launches = tracing.counter("conv7_launches")
    if launches != 2:
        fail(f"one re10k scene launched conv7 {launches} times, expected 2")
    phase("conv7", f"one re10k scene: conv7 launched {launches} times")
    return dict(scenes=scenes, scene_launches=launches)


def linear_phase(torch) -> dict:
    """`scripts/bench_linear.py` on the evaluation scenes' linear layers (the
    ViT's of `re10k` and `re10k_3_view`, GS-LRM's of `gslrm`): K10 within
    twice cuBLAS float32's error against float64 and within `TWIN_RTOL` of
    its plain twin, and faster than cuBLAS over each scene's launches; then
    one scene's launches of each model that runs K10 (48, 98), no float32
    layer on the plain route."""
    from pixelsplat_tpu_torch.scripts import bench_linear
    from pixelsplat_tpu_torch.scripts.eval_scene import make_eval_scene
    from pixelsplat_tpu_torch.utils import tracing

    scenes = {name: bench_linear.scene(name, rounds=5) for name in bench_linear.SCENES}
    for name, r in scenes.items():
        for fault in bench_linear.faults(r):
            fail(f"linear {fault}")
        if not r["scene"]["ms"] < r["scene"]["library_ms"]:
            fail(f"linear {name}: {r['scene']['ms']:.3f} ms a scene, not faster than cuBLAS float32 "
                 f"{r['scene']['library_ms']:.3f} ms")
    launches = {}
    for model, want in (("re10k", 48), ("gslrm", 98)):
        scene = make_eval_scene("cuda", seed=SEED, model=model)
        scene.run(SEED)
        tracing.reset()
        scene.run(SEED)
        launches[f"{model} scene"] = tracing.counter("linear_split_launches")
        plain = tracing.counter("linear_plain_on_card")
        if launches[f"{model} scene"] != want or plain:
            fail(f"one {model} scene launched linear_split {launches[f'{model} scene']} times, expected {want}, "
                 f"and ran {plain} float32 layers on the plain route, expected 0")
        phase("linear", f"one {model} scene: linear_split launched {launches[f'{model} scene']} times, "
                        f"no float32 layer on the plain route")
        del scene
        torch.cuda.empty_cache()
    return dict(scenes=scenes, scene_launches=launches)


def conv3x3_phase(torch) -> dict:
    """`scripts/bench_conv3x3.py` on an `mvsplat` scene's 87 convolutions:
    K11 within twice cuDNN float32's error against float64 at every shape
    and faster than cuDNN float32 over the scene; then one `mvsplat` scene's
    launches (87)."""
    from pixelsplat_tpu_torch.scripts import bench_conv3x3
    from pixelsplat_tpu_torch.scripts.eval_scene import make_eval_scene
    from pixelsplat_tpu_torch.utils import tracing

    record = bench_conv3x3.scene(rounds=5)
    for s in record["shapes"]:
        if not s["errors"]["k11"] <= 2 * s["errors"]["cudnn_f32"]:
            fail(f"conv3x3 {s['shape']}: relative RMS error {s['errors']['k11']:.3g} against float64, above twice "
                 f"cuDNN float32's {s['errors']['cudnn_f32']:.3g}")
    if not record["scene"]["ms"] < record["scene"]["library_ms"]:
        fail(f"conv3x3: {record['scene']['ms']:.3f} ms a scene, not faster than cuDNN float32 "
             f"{record['scene']['library_ms']:.3f} ms")
    scene = make_eval_scene("cuda", seed=SEED, model="mvsplat")
    scene.run(SEED)
    tracing.reset()
    scene.run(SEED)
    launches = tracing.counter("conv3x3_launches")
    if launches != 87:
        fail(f"one mvsplat scene launched conv3x3 {launches} times, expected 87")
    phase("conv3x3", f"one mvsplat scene: conv3x3 launched {launches} times")
    return dict(record=record, scene_launches=launches)


def tools_phase(torch, kernels, first_view):
    """The kernel tools' path (the segment-sum bench's checks and the stage
    ablation on `first_view`'s lists), then each tool kernel against its
    plain version and its time beside its bound and library call."""
    from pixelsplat_tpu_torch.ops.rasterizer import composite_kernel
    from pixelsplat_tpu_torch.ops.rasterizer.composite_ablation import composite_core_ablation
    from pixelsplat_tpu_torch.scripts import bench_kernel_ablation, bench_segment_sum, bench_tool_kernels
    from pixelsplat_tpu_torch.scripts.eval_scene import card_line, cuda_ms

    table, tiles = first_view["table"], first_view["tiles"]
    tiles_x, chunk = first_view["tiles_x"], first_view["chunk"]
    reset_launches(kernels)
    d_rows, ids = bench_segment_sum.bench_inputs("cuda")
    calls = bench_segment_sum.variants(d_rows, ids, bench_segment_sum.ROWS)
    seg_errors = bench_segment_sum.check_variants(calls)
    full_err = bench_kernel_ablation.check_variants(table, tiles, tiles_x, chunk)
    torch.cuda.synchronize()
    launches = launch_counts(kernels)
    phase("tools", f"segment sums against index_add, max err / max entry: "
          f"{({k: float(f'{v:.3g}') for k, v in seg_errors.items()})}; stage ablation: full against the plain "
          f"compositor without early exit {full_err:.3g}, {len(bench_kernel_ablation.VARIANTS)} variants finite "
          f"and of the right shape; launches {launches}")
    for name, err in seg_errors.items():
        if not err <= bench_segment_sum.TOLERANCE[name]:
            fail(f"segment sum {name} disagrees with index_add: {err:.3g} > {bench_segment_sum.TOLERANCE[name]}")
    if launches["copy_rows"] != 2 or launches["composite_fwd_ablation"] != len(bench_kernel_ablation.VARIANTS):
        fail(f"the tools' path did not launch its kernels as expected: {launches}")
    seg_ms = {name: cuda_ms(fn, iters=10) for name, fn in calls.items()}

    # copy_rows against clone, bit for bit, on every route's layouts; its
    # times and smoke_scale's beside their library calls
    # (`scripts/bench_tool_kernels.py`).
    card = card_line()
    if not bench_tool_kernels.raw_stream_matches():
        fail("the launch path's raw stream handle differs from torch.cuda.current_stream() on a side stream")
    edges = bench_tool_kernels.check_edges(bench_tool_kernels.edge_layouts("cuda", seed=SEED))
    phase("tools", "copy_rows on the routes' edge layouts, same bits as clone: "
          f"{({r['label']: (r['route'], r['equal']) for r in edges})}")
    del d_rows, ids, calls
    copy_rows, scale = bench_tool_kernels.bench_tools(bench_tool_kernels.copy_layouts("cuda"), seed=SEED)
    for r in copy_rows:
        phase("tools", f"{card} | " + bench_tool_kernels.format_row("copy_rows", r))
    phase("tools", f"{card} | " + bench_tool_kernels.format_row("smoke_scale", scale)
          + f" | x * 2 {scale['plain_ms']:.5f} ms")
    bad = [r["label"] for r in edges + copy_rows if not r["equal"]]
    if bad:
        fail(f"copy_rows differs from clone on {bad}")
    if not scale["equal"]:
        fail("smoke_scale differs from x * 2")
    torch.cuda.empty_cache()

    # The stage ablation's table on the first view's lists.
    lists = (table, tiles.flat, tiles.block_start, tiles.counts)
    variant_ms = bench_kernel_ablation.time_variants(table, tiles, tiles_x, chunk)
    full_plain_ms = cuda_ms(
        lambda: composite_kernel.composite_core_plain(*lists, tiles_x, chunk, early_exit=False), iters=3
    )
    _, _, n_all = composite_core_ablation("full", *lists, tiles_x, chunk)
    full_bound, full_bound_by = composite_bound_ms(tiles, table, n_all, chunk)
    phase("tools", f"{card} | segment sums ms {({k: round(v, 3) for k, v in seg_ms.items()})} | stage ablation on view 0 "
          f"({int(tiles.counts.sum())} slots), ms/launch: {({k: round(v, 4) for k, v in variant_ms.items()})}, "
          f"plain without early exit {full_plain_ms:.3f} ms, bound of full {full_bound:.4f} ms ({full_bound_by})")
    return dict(
        launches=launches, full_err=full_err, variant_ms=variant_ms, full_plain_ms=full_plain_ms,
        full_bound=(full_bound, full_bound_by), copy_rows=copy_rows, copy_edges=edges, scale=scale, seg_ms=seg_ms,
    )


# The five configurations of `[experiments]`: the four shipped experiments
# beyond re10k, the ablation and the depth loss, and the encoder's default
# config (`config/model/encoder/epipolar.yaml`, the resnet50 InstanceNorm
# backbone), each as `scripts/eval_scene.py` names it.
EXPERIMENT_SCENES = (
    "acid", "re10k_ablation_no_depth_encoding", "re10k_3_view", "re10k_ablation_no_probabilistic_sampling", "default",
)
TRAINED_EXPERIMENTS = ("re10k_3_view", "re10k_ablation_no_probabilistic_sampling")


def experiments_phase(torch, kernels, seed) -> dict:
    """Each configuration's evaluation scene on `bench.py`'s cameras (three
    context views for `re10k_3_view`), 3 target views, through the
    `ModelWrapper` entry points, K1 against its plain version on view 0;
    then one training step at batch 1 of each trained experiment (4 target
    views, its preset's settings), K2 against its plain version on view 0."""
    from pixelsplat_tpu_torch.config import NUM_TARGET_VIEWS
    from pixelsplat_tpu_torch.ops.rasterizer import composite_kernel
    from pixelsplat_tpu_torch.scripts.eval_scene import (
        TARGET_VIEWS, card_line, cuda_ms, make_eval_scene, num_gaussians, view_inputs,
    )
    from pixelsplat_tpu_torch.scripts.train_scene import backward_inputs, make_train_scene, timed_step

    card = card_line()
    result = dict(launches={}, scenes={}, steps={}, fwd_err=0.0, bwd_err=0.0, bwd_abs_err=0.0, bwd_tiles=0)
    for model in EXPERIMENT_SCENES:
        scene = make_eval_scene(seed=seed, model=model)
        cfg, (h, w) = scene.wrapper.encoder_cfg, scene.image_shape
        want = num_gaussians(cfg, scene.image_shape)
        scene.run(seed + 1)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches(kernels)
        gaussians, settings, color, overflow = scene.run(seed)
        torch.cuda.synchronize()
        launches = launch_counts(kernels)
        result["launches"][f"experiments {model} evaluation"] = launches
        peak = torch.cuda.max_memory_allocated() / 2**30
        n = gaussians.mean_x.shape[1]
        backbone = cfg.backbone.model if cfg.backbone.name == "resnet" else f"{cfg.backbone.model} + dino_resnet50"
        phase("experiments", f"{model}: backbone {backbone}, {cfg.num_context_views} context views, gpp "
              f"{cfg.gaussians_per_pixel}, transmittance {cfg.use_transmittance}, depth-encoding octaves "
              f"{cfg.epipolar_transformer.num_octaves}: {n} Gaussians (v x h x w x gpp = {want}), settings capacity="
              f"{settings.capacity} pair_budget={settings.pair_budget}, images {tuple(color.shape)}, overflow "
              f"{int(overflow)}, launches {launches}, image mean {float(color.mean()):.6f}")
        if n != want:
            fail(f"experiments {model}: {n} Gaussians, expected {want}")
        if tuple(color.shape) != (1, TARGET_VIEWS, 3, h, w) or not bool(torch.isfinite(color).all()):
            fail(f"experiments {model}: images are not finite of shape (1, {TARGET_VIEWS}, 3, {h}, {w})")
        if int(overflow) != 0:
            fail(f"experiments {model}: {int(overflow)} (gaussian, tile) pairs dropped")
        if launches["composite_fwd"] != TARGET_VIEWS or any(n for k, n in launches.items() if k != "composite_fwd"):
            fail(f"experiments {model}: launches {launches}, expected composite_fwd once per target view")
        _, tiles, table = view_inputs(scene, gaussians, settings)[0]
        chunk, tiles_x = settings.chunk, w // settings.tile_size
        err, n_k = check_kernel_against_plain(composite_kernel, f"{model} 0", tiles, table, chunk, tiles_x)
        if err > KERNEL_ATOL:
            fail(f"experiments {model}: composite_fwd disagrees with its plain version: {err:.3g} > {KERNEL_ATOL}")
        result["fwd_err"] = max(result["fwd_err"], err)
        args = (table, tiles.flat, tiles.block_start, tiles.counts, tiles_x, chunk)
        numbers = dict(
            gaussians=n,
            encode_ms=cuda_ms(lambda: scene.encode(scene.batch, False, 0), iters=3, warmup=1),
            render_ms=cuda_ms(lambda: scene.render(gaussians, settings), iters=3, warmup=1) / TARGET_VIEWS,
            k1_ms=cuda_ms(lambda: composite_kernel.composite_core(*args), iters=20),
            k1_plain_ms=cuda_ms(lambda: composite_kernel.composite_core_plain(*args), iters=2, warmup=1),
            k1_bound=composite_bound_ms(tiles, table, n_k, chunk), peak_gib=peak,
        )
        result["scenes"][model] = numbers
        phase("timing", f"experiments {model} | {card} | encode {numbers['encode_ms']:.3f} ms | render "
              f"{numbers['render_ms']:.3f} ms/view | composite_fwd view 0 {numbers['k1_ms']:.4f} ms/launch, plain "
              f"{numbers['k1_plain_ms']:.3f} ms, bound {numbers['k1_bound'][0]:.4f} ms ({numbers['k1_bound'][1]}), "
              f"list slots {int(tiles.counts.sum())} | peak memory {peak:.2f} GiB")
        del scene, gaussians, color, tiles, table
        torch.cuda.empty_cache()

    for model in TRAINED_EXPERIMENTS:
        ts = make_train_scene(seed=seed, model=model)
        batch = ts.batch(1)
        torch.cuda.reset_peak_memory_stats()
        reset_launches(kernels)
        parts = ts.steps(1, batch)[0]
        torch.cuda.synchronize()
        launches = launch_counts(kernels)
        result["launches"][f"experiments {model} training"] = launches
        peak = torch.cuda.max_memory_allocated() / 2**30
        values = {k: float(v) for k, v in parts.items()}
        cfg = ts.wrapper.encoder_cfg
        phase("experiments", f"{model} train step (batch 1, {cfg.num_context_views} context + {NUM_TARGET_VIEWS} "
              f"target views, remat_encoder {ts.wrapper.train_cfg.remat_encoder}): "
              + ", ".join(f"{k} {x:.6g}" for k, x in values.items()) + f"; launches {launches}")
        if not all(math.isfinite(x) for x in values.values()) or values["train/overflow_pairs"] != 0:
            fail(f"experiments {model}: a loss part is not finite, or pairs were dropped: {values}")
        params = ts.state.params
        missing = [k for k, p in params.items() if p.grad is None]
        if missing:
            fail(f"experiments {model}: {len(missing)} parameters have no gradient, e.g. {missing[:3]}")
        if not all(bool(torch.isfinite(p.grad).all()) for p in params.values()):
            fail(f"experiments {model}: a gradient is not finite")
        embeddings = params.get("epipolar_transformer.view_embeddings.weight")
        if (embeddings is not None) != (cfg.num_context_views > 2) or (
            embeddings is not None and not bool((embeddings.grad != 0).any())
        ):
            fail(f"experiments {model}: view embeddings missing, unexpected or without a gradient")
        expected = NUM_TARGET_VIEWS
        if launches["composite_fwd"] != expected or launches["composite_bwd"] != expected or any(
            n for k, n in launches.items() if k not in ("composite_fwd", "composite_bwd")
        ):
            fail(f"experiments {model} training: launches {launches}, expected composite_fwd and composite_bwd "
                 f"{expected} each")
        inp = backward_inputs(ts, batch, seed=seed)[0]
        rel, abs_err, tiles_explained = check_bwd_kernel_against_plain(f"{model} 0", inp)
        result["bwd_err"] = max(result["bwd_err"], rel)
        result["bwd_abs_err"] = max(result["bwd_abs_err"], abs_err)
        result["bwd_tiles"] += tiles_explained
        timed_step(ts, batch)  # warm-up of the timed path
        split = timed_step(ts, batch)
        numbers = dict(
            peak_gib=peak, **split,
            k2_ms=cuda_ms(lambda: composite_kernel.composite_bwd(*bwd_args(inp)), iters=10),
            k2_plain_ms=cuda_ms(lambda: composite_kernel.composite_bwd_plain(*bwd_args(inp)), iters=2, warmup=1),
            k2_bound=composite_bwd_bound_ms(inp),
        )
        result["steps"][model] = numbers
        phase("timing", f"experiments {model} train step | {card} | forward {split['forward_ms']:.3f} ms, backward "
              f"{split['backward_ms']:.3f} ms, optimizer {split['optimizer_ms']:.3f} ms | composite_bwd view 0 "
              f"{numbers['k2_ms']:.4f} ms/call, plain {numbers['k2_plain_ms']:.3f} ms, bound "
              f"{numbers['k2_bound'][0]:.4f} ms ({numbers['k2_bound'][1]}) | peak memory {peak:.2f} GiB")
        del ts, batch, inp
        torch.cuda.empty_cache()
    return result


# `[bf16]`: the JAX package's own bounds on bf16 against f32 Gaussians
# (tests/test_model.py:240-244), mean over every entry.
BF16_OPACITY_BOUND = 0.05
BF16_MEAN_BOUND = 0.15


def bf16_phase(torch, kernels, seed) -> dict:
    """The `re10k` scene encoded with `compute_dtype=bfloat16` and in f32, TF32
    off, on the same weights and uniforms: Gaussians within the JAX
    package's bounds, both rendered finite, every parameter f32 and the
    refinement convolutions' outputs in the dtype each policy asks for;
    encode and refinement-convolution ms of each (CUDA events, alternating
    rounds)."""
    from pixelsplat_tpu_torch.config import re10k
    from pixelsplat_tpu_torch.scripts.eval_scene import TARGET_VIEWS, card_line, cuda_ms, make_eval_scene
    from pixelsplat_tpu_torch.utils import tracing

    card = card_line()
    reduced = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    policies = {"float32": None, "bfloat16": "bfloat16"}
    scenes = {
        name: make_eval_scene(seed=seed, encoder_cfg=dataclasses.replace(re10k()[0], compute_dtype=policy))
        for name, policy in policies.items()
    }
    encoders = {name: sc.wrapper.encoder for name, sc in scenes.items()}
    sd32, sd16 = (encoders[n].state_dict() for n in policies)
    if sd32.keys() != sd16.keys() or not all(torch.equal(sd32[k], sd16[k]) for k in sd32):
        fail("bf16: the two policies' encoders do not hold the same weights")
    wrong = [f"{n}:{k}" for n, e in encoders.items() for k, p in e.named_parameters() if p.dtype != torch.float32]
    if wrong:
        fail(f"bf16: parameters not in float32: {wrong[:3]}")
    h, w = scenes["float32"].image_shape
    u = torch.rand((1, 2, h * w, 1, 3), generator=torch.Generator(device="cuda").manual_seed(seed + 5), device="cuda")

    seen = {}
    handles = []
    for name, encoder in encoders.items():
        refinement = encoder.epipolar_transformer.upscale_refinement
        for i in (0, 2):
            def hook(_m, _i, out, key=(name, f"refine{i // 2 + 1}")):
                seen[key] = out.dtype
            handles.append(refinement[i].register_forward_hook(hook))
    aos, color = {}, {}
    reset_launches(kernels)
    try:
        for name, sc in scenes.items():
            aos[name] = sc.wrapper.make_eval_encode(pack_soa=False)(sc.batch, False, 0, u=u)
            soa = sc.encode(sc.batch, False, 0, u=u)
            settings = sc.choose(soa)
            color[name], overflow = sc.render(soa, settings)
            if int(overflow) or not bool(torch.isfinite(color[name]).all()):
                fail(f"bf16: the {name} render dropped {int(overflow)} pairs or is not finite")
    finally:
        for handle in handles:
            handle.remove()
    torch.cuda.synchronize()
    launches = launch_counts(kernels)
    # The f32 policy runs the refinement as K9 (two launches an encode, two
    # encodes), which calls neither module; the bf16 policy calls both.
    want_dtypes = {("bfloat16", c): torch.bfloat16 for c in ("refine1", "refine2")}
    if seen != want_dtypes or tracing.counter("conv7_launches") != 4:
        fail(f"bf16: refinement outputs {seen}, expected {want_dtypes}; conv7 launched "
             f"{tracing.counter('conv7_launches')} times, expected 4 (the f32 policy's)")
    # The f32 policy runs the ViT's linear layers as K10 (48 launches an
    # encode); the bf16 policy calls `precision.Linear`.
    if tracing.counter("linear_split_launches") != 96:
        fail(f"bf16: linear_split launched {tracing.counter('linear_split_launches')} times, expected 96 (the f32 "
             f"policy's two encodes)")
    if launches["composite_fwd"] != 2 * TARGET_VIEWS or any(n for k, n in launches.items() if k != "composite_fwd"):
        fail(f"bf16: launches {launches}, expected composite_fwd once per target view per policy")
    g32, g16 = aos["float32"], aos["bfloat16"]
    d_opacity = float((g16.opacities - g32.opacities).abs().mean())
    d_mean = float((g16.means - g32.means).abs().mean())
    d_image = float((color["bfloat16"] - color["float32"]).abs().mean())
    phase("bf16", f"re10k, {g32.means.shape[1]} Gaussians, same weights and uniforms: bf16 against f32 mean "
          f"|d opacity| {d_opacity:.4g} (bound {BF16_OPACITY_BOUND}), mean |d mean| {d_mean:.4g} (bound "
          f"{BF16_MEAN_BOUND}), images mean |d| {d_image:.4g}; refinement outputs "
          f"{({f'{n} {c}': str(d).replace('torch.', '') for (n, c), d in seen.items()})}; every parameter float32; "
          f"launches {launches}; TF32 off; allow_bf16_reduced_precision_reduction {reduced}")
    if not (d_opacity < BF16_OPACITY_BOUND and d_mean < BF16_MEAN_BOUND):
        fail(f"bf16: Gaussians off the f32 ones by {d_opacity:.4g} (opacity), {d_mean:.4g} (mean)")

    encode_ms = {n: [] for n in policies}
    for _ in range(2):  # alternating rounds
        for name, sc in scenes.items():
            encode_ms[name].append(cuda_ms(lambda: sc.encode(sc.batch, False, 0, u=u), iters=5))
    # The epipolar transformer's two spans over five traced encodes.
    stages = {}
    for name, sc in scenes.items():
        tracing.reset()
        tracing.enable(True)
        try:
            for _ in range(5):
                sc.encode(sc.batch, False, 0, u=u)
        finally:
            tracing.enable(False)
        spans = tracing.read()["spans"]
        stages[name] = {stage: spans[f"encoder.{stage}"]["device_ms"] / 5 for stage in ("epipolar", "refine")}
    numbers = {
        name: dict(encode_ms=sum(encode_ms[name]) / len(encode_ms[name]),
                   refinement_ms=stages[name]["refine"],
                   epipolar_transformer_ms=stages[name]["epipolar"] + stages[name]["refine"])
        for name in policies
    }
    phase("timing", f"bf16 | {card} | encode ms f32 {numbers['float32']['encode_ms']:.3f}, bf16 "
          f"{numbers['bfloat16']['encode_ms']:.3f} (rounds f32 {[round(x, 3) for x in encode_ms['float32']]}, bf16 "
          f"{[round(x, 3) for x in encode_ms['bfloat16']]}) | upscale and refinement convs (span encoder.refine) "
          f"ms f32 {numbers['float32']['refinement_ms']:.3f}, bf16 {numbers['bfloat16']['refinement_ms']:.3f} | "
          f"epipolar transformer ms f32 {numbers['float32']['epipolar_transformer_ms']:.3f}, bf16 "
          f"{numbers['bfloat16']['epipolar_transformer_ms']:.3f} | allow_bf16_reduced_precision_reduction {reduced}")
    del scenes, encoders, aos, color
    torch.cuda.empty_cache()
    return dict(launches=launches, numbers=numbers, d_opacity=d_opacity, d_mean=d_mean)


# `[native]`: the CLI's evaluation protocol with `+experiment=re10k_3_view`
# (the evaluation sampler inserts the midpoint as the third context view)
# on a copy of the fixture whose chunk has a `.psz` sibling.
NATIVE_ARGV = [
    "+experiment=re10k_3_view",
    "mode=test",
    "dataset/view_sampler=evaluation",
    f"dataset.view_sampler.index_path={FIXTURE / 'evaluation_index_fixture.json'}",
]
NATIVE_IMAGE_ATOL = 1 / 255  # tests/test_native_loader.py:69-72


def native_phase(torch, kernels) -> dict:
    """`main.main` as `python -m pixelsplat_tpu_torch.main +experiment=re10k_3_view
    mode=test` runs it, on a copy of the fixture with `test/000000.psz`
    written by `scripts/transcode_chunks.py`; the configured 4 workers load
    the native loader themselves (this process has not loaded it before the
    fork). Then the route each chunk takes, the `.psz` route's images
    against the `.torch` route's, and the data wait per scene on each."""
    import shutil
    import tempfile

    import numpy as np

    from pixelsplat_tpu_torch import main as cli
    from pixelsplat_tpu_torch import native
    from pixelsplat_tpu_torch.config import load_config
    from pixelsplat_tpu_torch.dataset.data_module import DataModule
    from pixelsplat_tpu_torch.dataset.dataset_re10k import chunk_route
    from pixelsplat_tpu_torch.scripts.eval_scene import card_line
    from pixelsplat_tpu_torch.scripts.transcode_chunks import transcode
    from pixelsplat_tpu_torch.scripts.write_checkpoint import write_checkpoint
    from pixelsplat_tpu_torch.training.model_wrapper import ModelWrapper
    from pixelsplat_tpu_torch.training.trainer import RESULTS_NAME

    if native._lib is not None:
        fail("native: the loader was loaded in this process before the workers' fork")
    index = json.loads((FIXTURE / "evaluation_index_fixture.json").read_text())
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        root = tmp / "re10k"
        shutil.copytree(FIXTURE / "re10k", root)
        chunk = root / "test" / "000000.torch"
        transcode(chunk, chunk.with_suffix(".psz"))
        argv = NATIVE_ARGV + [f"dataset.roots=[{root}]", f"test.output_path={tmp / 'test'}",
                              f"output_dir={tmp / 'outputs'}"]
        cfg = load_config(argv + ["checkpointing.load=unused"])
        h, w = cfg.dataset.image_shape
        checkpoint = write_checkpoint(tmp / "checkpoints", "re10k_3_view", SEED)

        encodes = []
        make_encode = ModelWrapper.make_eval_encode

        def watched_encode(self, pack_soa=False):
            encode = make_encode(self, pack_soa=pack_soa)

            def encode_fn(batch, *args, **kwargs):
                g = encode(batch, *args, **kwargs)
                encodes.append((batch["context"]["image"].shape[1], g.mean_x.shape[1]))
                return g

            return encode_fn

        reset_launches(kernels)
        ModelWrapper.make_eval_encode = watched_encode
        t0 = time.perf_counter()
        try:
            summary = cli.main(argv + [f"checkpointing.load={checkpoint}"])
        finally:
            ModelWrapper.make_eval_encode = make_encode
        run_s = time.perf_counter() - t0
        launches = launch_counts(kernels)
        phase("native", f"main {' '.join(NATIVE_ARGV)} ... on the fixture with a .psz sibling, in {run_s:.1f} s: "
              f"{summary}; (context views, Gaussians) per scene {encodes}; launches {launches}")
        if summary["num_scenes"] != len(index) or summary["overflow_pairs"] != 0:
            fail(f"native: {summary['num_scenes']} scenes, {summary['overflow_pairs']} dropped pairs")
        if not (math.isfinite(summary["psnr"]) and math.isfinite(summary["ssim"])):
            fail(f"native: PSNR {summary['psnr']}, SSIM {summary['ssim']}")
        if encodes != [(3, 3 * h * w * 3)] * len(index):
            fail(f"native: (context views, Gaussians) per scene {encodes}, expected 3 and {3 * h * w * 3}")
        if launches["composite_fwd"] != 3 * len(index) or any(n for k, n in launches.items() if k != "composite_fwd"):
            fail(f"native: launches {launches}, expected composite_fwd once per target view")
        pngs = sorted((tmp / "test" / RESULTS_NAME).rglob("*.png"))
        if len(pngs) != 3 * len(index):
            fail(f"native: {len(pngs)} PNGs, expected {3 * len(index)}")

        # The route, decided in this process as the workers decided it.
        route = chunk_route(chunk)
        available = native.native_available()
        phase("native", f"test/000000.torch read through {'its .psz sibling (native loader)' if route == 'psz' else '.torch'};"
              f" native loader {'built at ' + str(native.library_path().relative_to(ROOT)) if available else 'unavailable'}")
        if not available:
            phase("native", f"the loader does not build on this machine, so the CLI read .torch: {native.build_error()}")
        if (route == "psz") != available:
            fail(f"native: route {route} with the loader {'available' if available else 'unavailable'}")

        def loader(roots, workers):
            c = load_config(argv + [f"dataset.roots=[{roots}]", f"data_loader.test.num_workers={workers}",
                                    "checkpointing.load=unused"])
            return DataModule(c.dataset, c.data_loader).test_dataloader()

        routes = {"psz": root, "torch": FIXTURE / "re10k"} if route == "psz" else {"torch": root}
        if route == "psz":
            for got, want in zip(loader(root, 0), loader(FIXTURE / "re10k", 0)):
                for side in ("context", "target"):
                    err = float(np.abs(got[side]["image"] - want[side]["image"]).max())
                    same = all(np.array_equal(got[side][k], want[side][k]) for k in ("extrinsics", "intrinsics", "index"))
                    phase("native", f"{got['scene'][0]} {side}: .psz images against .torch max |d| {err * 255:.3f}/255, "
                          f"cameras and indices {'equal' if same else 'DIFFER'}")
                    if err > NATIVE_IMAGE_ATOL + 1e-7 or not same:
                        fail(f"native: the .psz route's {side} differs from the .torch route's by {err:.4g}")
        data_ms = {}
        for name, roots in routes.items():
            for workers in (cfg.data_loader.test.num_workers, 0):
                t0 = time.perf_counter()
                scenes = sum(1 for _ in loader(roots, workers))
                data_ms[(name, workers)] = (time.perf_counter() - t0) * 1e3 / scenes
        phase("timing", f"native | {card_line()} | data ms per scene (3 context + 3 target views): " + ", ".join(
            f"{name} route {ms:.1f} with {workers} workers" if workers else f"{name} route {ms:.1f} inline"
            for (name, workers), ms in data_ms.items()) + f" | main {run_s:.1f} s")
    return dict(launches=launches, route=route, data_ms={f"{n} {wk}": v for (n, wk), v in data_ms.items()})


# `[distributed]`: two ranks sharing the one card over gloo
# (`scripts/distributed_step.py`), then `main` in this process over NCCL.
DIST_WORLD = 2
DIST_DIR = ROOT / "build" / "chip_smoke" / "distributed"
# Rank 0's weights after one step against one process taking the same two
# examples as accumulated micro-batches. Adam's first update moves each
# weight by lr0 * g / (|g| + eps), |.| < lr0 (lr0 = 1.5e-4 / 2000 warm-up
# steps = 7.5e-8 for `re10k`), so any two gradients give weights within
# 2 lr0; that is the bound, and the gradients are held on their own:
# per tensor relative to its largest entry, the averaged and clipped
# gradients differ only in the order of atomic adds (K2's, cuDNN's weight
# gradients) in the two backward passes of each example.
DIST_GRAD_RTOL = 1e-3
# The loss parts: the same forward on the same inputs, averaged as (a + b) / 2
# on both sides.
DIST_LOSS_RTOL = 1e-6
NCCL_ARGV_STEPS = 2


def free_port() -> int:
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def distributed_phase(torch, kernels, run_a_first_loss: float) -> dict:
    """Two gloo ranks on the one card: one data-parallel step of `re10k` at
    full width (batch 1 each, 2 context + 4 target views, own uniforms)
    against one process's `accumulate=2` step, the replicas bit for bit,
    and the evaluation scene's 3 target views rendered split over the ranks
    against the plain decoder bit for bit. Then `main` `mode=train` in this
    process under RANK=0 WORLD_SIZE=1 over NCCL, 2 steps of the recipe on
    the fixture, its first loss against `[train_protocol]` run A's."""
    import contextlib
    import io
    import os
    import tempfile

    import torch.distributed as dist

    from pixelsplat_tpu_torch import main as cli
    from pixelsplat_tpu_torch.config import NUM_TARGET_VIEWS, load_config
    from pixelsplat_tpu_torch.scripts import distributed_step
    from pixelsplat_tpu_torch.scripts.eval_scene import card_line
    from pixelsplat_tpu_torch.scripts.train_fixture import FIXTURE_OVERRIDES, write_train_root

    card = card_line()
    result = {"launches": {}}
    t0 = time.perf_counter()
    try:
        ranks = distributed_step.launch(DIST_DIR, world=DIST_WORLD, backend="gloo", seed=SEED, model=RE10K)
    except RuntimeError as exc:
        fail(f"distributed: {exc}")
    ranks_s = time.perf_counter() - t0
    for r in ranks:
        phase("distributed", f"rank {r['rank']}/{r['world']} ({r['backend']} on {r['device']}): step parts "
              f"{({k: round(v, 6) for k, v in r['parts'].items()})}, launches step {r['step_launches']} render "
              f"{r['render_launches']}, render {r['render_views']} overflow {r['render_overflow']}, replica equal "
              f"to rank 0's: {r['replica_equal_to_rank0']}")
        if r["backend"] != "gloo" or r["world"] != DIST_WORLD:
            fail(f"distributed: rank {r['rank']} ran {r['backend']} over {r['world']}")
        if r["step_launches"] != {"composite_fwd": NUM_TARGET_VIEWS, "composite_bwd": NUM_TARGET_VIEWS}:
            fail(f"distributed: rank {r['rank']} step launches {r['step_launches']}, expected {NUM_TARGET_VIEWS} each")
        if r["render_launches"] != {"composite_fwd": 2, "composite_bwd": 0}:
            fail(f"distributed: rank {r['rank']} render launches {r['render_launches']}, expected 2 composite_fwd")
        if not r["replica_equal_to_rank0"] or r["render_overflow"] or r["render_views"] != [1, 3, 3, 256, 256]:
            fail(f"distributed: rank {r['rank']}: {r}")
        if not all(math.isfinite(v) for v in r["parts"].values()) or r["parts"]["train/overflow_pairs"]:
            fail(f"distributed: rank {r['rank']} parts {r['parts']}")
    for path in ("step", "render"):
        result["launches"][f"distributed {path} (2 ranks, gloo)"] = {
            name: sum(r[f"{path}_launches"].get(name, 0) for r in ranks) for name in kernels
        }
    reference = distributed_step.one_process(DIST_DIR, world=DIST_WORLD, seed=SEED, model=RE10K)
    bound = 2 * reference["step0_lr"]
    loss_errs = {k: abs(ranks[0]["parts"][k] - v) / max(abs(v), 1e-30) for k, v in reference["parts"].items()}
    render = reference["render"]
    phase("distributed", f"against one process (accumulate={DIST_WORLD} on the same two examples and uniforms): "
          f"weights max |err| {reference['param_max_abs_err']:.3g} (bound 2 lr0 = {bound:.3g}), averaged "
          f"gradients max err / tensor max {reference['grad_max_rel_err']:.3g} (tol {DIST_GRAD_RTOL}) over "
          f"{reference['tensors']} tensors, loss parts max rel err {max(loss_errs.values()):.3g} (tol "
          f"{DIST_LOSS_RTOL}); sharded render against the plain decoder: "
          f"{'equal bit for bit' if render['equal'] else 'DIFFERENT'} (max |err| {render['max_abs_err']:.3g})")
    if not reference["param_max_abs_err"] <= bound or not reference["grad_max_rel_err"] <= DIST_GRAD_RTOL:
        fail(f"distributed: two ranks off one process: {reference}")
    if not max(loss_errs.values()) <= DIST_LOSS_RTOL:
        fail(f"distributed: loss parts off one process's: {loss_errs}")
    if not render["equal"] or render["overflow"] or render["shape"] != [1, 3, 3, 256, 256]:
        fail(f"distributed: the sharded render differs from the plain decoder's: {render}")
    label = "two processes sharing one card over gloo"
    for r in ranks:
        ms = r["parts_ms"]
        phase("timing", f"distributed | {card} | {label} | rank {r['rank']}: step ms {r['step_ms'][0]:.1f} (first, "
              f"from step 0) then {r['step_ms'][1]:.1f}; second step forward {ms['forward'][1]:.1f}, backward "
              f"{ms['backward'][1]:.1f}, all-reduce {ms['all_reduce'][1]:.2f} (first {ms['all_reduce'][0]:.2f}) "
              f"of {r['reduced_bytes'] / 2**20:.1f} MiB, optimizer {ms['optimizer'][1]:.2f} (CUDA events); "
              f"sharded render {r['render_ms']:.1f} ms; peak memory {r['peak_gib']:.2f} GiB")
    result["gloo"] = dict(ranks=ranks, reference=reference, seconds=ranks_s)

    # `main` over NCCL, one rank, as torchrun's environment names it.
    port = free_port()
    wiring = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost", MASTER_PORT=str(port))
    saved = {k: os.environ.get(k) for k in wiring}
    tf32 = torch.backends.cudnn.allow_tf32
    seen = {}
    build = cli.build_everything

    def watched_build(*args, **kwargs):
        seen.update(initialized=dist.is_initialized(), backend=dist.is_initialized() and dist.get_backend(),
                    world=dist.is_initialized() and dist.get_world_size(), rank_args=args[2:])
        return build(*args, **kwargs)

    try:
        with tempfile.TemporaryDirectory() as tmp:
            tmp = Path(tmp)
            root = write_train_root(tmp / "re10k")
            out = tmp / "outputs"
            argv = TRAIN_PROTOCOL_ARGV + [f"dataset.roots=[{root}]", *FIXTURE_OVERRIDES, f"output_dir={out}",
                                          f"trainer.max_steps={NCCL_ARGV_STEPS}"]
            cfg = load_config(argv)
            os.environ.update(wiring)
            torch.backends.cudnn.allow_tf32 = True  # as [train_protocol] ran run A
            cli.build_everything = watched_build
            reset_launches(kernels)
            printed = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(printed):
                state = cli.main(argv)
            seconds = time.perf_counter() - t0
            launches = launch_counts(kernels)
            result["launches"]["distributed main (NCCL, 1 rank)"] = launches
            train, _ = logged(out)
            mode_line = next((x for x in printed.getvalue().splitlines() if "mode=train" in x), "")
            first_loss = train[1]["loss/total"]
            phase("distributed", f"NCCL: main {' '.join(TRAIN_PROTOCOL_ARGV)} trainer.max_steps={NCCL_ARGV_STEPS} "
                  f"under {' '.join(f'{k}={v}' for k, v in wiring.items())}: mode line {mode_line.strip()!r}; group "
                  f"during the run {seen}; after: {'up' if dist.is_initialized() else 'destroyed'}; returned step "
                  f"{state.step} in {seconds:.1f} s; checkpoints {sorted(p.name for p in (out / 'checkpoints').iterdir())}; "
                  f"first step's loss {first_loss!r} against run A's {run_a_first_loss!r}; launches {launches}")
            if "rank=0/1" not in mode_line or seen.get("backend") != "nccl" or seen.get("world") != 1:
                fail(f"distributed: NCCL run's group {seen}, mode line {mode_line!r}")
            if dist.is_initialized():
                fail("distributed: main left its NCCL group up")
            if state.step != NCCL_ARGV_STEPS or sorted(p.name for p in (out / "checkpoints").iterdir()) != [
                f"step_{NCCL_ARGV_STEPS}"
            ]:
                fail(f"distributed: NCCL run ended at step {state.step}")
            check_logged("NCCL", train, range(1, NCCL_ARGV_STEPS + 1))
            batch = cfg.data_loader.train.batch_size
            per_view = NCCL_ARGV_STEPS * batch * NUM_TARGET_VIEWS
            val_steps = validation_steps(0, NCCL_ARGV_STEPS, cfg.trainer.val_check_interval)
            if launches != {**{k: 0 for k in kernels}, "composite_fwd": per_view + len(val_steps) * 2 * NUM_TARGET_VIEWS,
                            "composite_bwd": per_view}:
                fail(f"distributed: NCCL run launches {launches}")
            if first_loss != run_a_first_loss:
                # Only if two runs without the environment differ too: held to their difference.
                for k in wiring:
                    os.environ.pop(k, None)
                again = tmp / "again"
                cli.main(argv[:-2] + [f"output_dir={again}", f"trainer.max_steps={NCCL_ARGV_STEPS}"])
                spread = abs(logged(again)[0][1]["loss/total"] - run_a_first_loss)
                phase("distributed", f"NCCL: first loss differs by {abs(first_loss - run_a_first_loss):.3g}; two "
                      f"runs without the environment differ by {spread:.3g}")
                if not abs(first_loss - run_a_first_loss) <= spread:
                    fail("distributed: the NCCL run's first loss differs from run A's beyond two plain runs' spread")
            result["nccl"] = dict(first_loss=first_loss, seconds=seconds, launches=launches)
    finally:
        cli.build_everything = build
        torch.backends.cudnn.allow_tf32 = tf32
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return result


# `[eval_tools]`: the evaluation index over the fixture on the card and on
# the CPU, and `compute_metrics` over `[eval_protocol]`'s PNGs against the
# float renders `Trainer.test` scored.
#
# The PNG of a render c holds q = floor(255 clamp(c, 0, 1)) / 255, so with
# e = clamp(c) - q in [0, 1/255) per value:
# - PSNR (both sides clamp): MSE_q = MSE + 2 mean(d e) + mean(e^2) with
#   d = gt - clamp(c), and |mean(d e)| <= sqrt(MSE) / 255, so PSNR moves by
#   at most max(10 log10(1 + (2 sqrt(MSE) / 255 + 1 / 255^2) / MSE),
#   -10 log10(1 - 2 / (255 sqrt(MSE)))) dB, plus EVAL_TOOLS_FLOAT_SLACK;
# - SSIM (not clamped on the `Trainer.test` side): to first order in the
#   change c - q, |dSSIM| <= sum_p |dSSIM/dc_p| max_p |c_p - q_p|, taken at
#   the float render by autograd; EVAL_TOOLS_SSIM_MARGIN covers the second
#   order.
EVAL_TOOLS_FLOAT_SLACK = 1e-4
EVAL_TOOLS_SSIM_MARGIN = 1.5


def eval_tools_phase(torch, renders: list) -> dict:
    import numpy as np

    from pixelsplat_tpu_torch.evaluation.metrics import compute_psnr, compute_ssim
    from pixelsplat_tpu_torch.scripts import compute_metrics, generate_evaluation_index
    from pixelsplat_tpu_torch.scripts.eval_scene import card_line

    fixture_argv = [f"dataset.roots=[{FIXTURE / 're10k'}]", "data_loader.test.num_workers=0",
                    *generate_evaluation_index.FIXTURE_OVERRIDES]
    t0 = time.perf_counter()
    indices = {}
    for device in ("cuda", "cpu"):
        path = generate_evaluation_index.main(
            fixture_argv + [f"index_generator.output_path={EVAL_TOOLS_DIR / f'index_{device}'}"], device=device)
        indices[device] = json.loads(path.read_text())
    index_s = time.perf_counter() - t0
    phase("eval_tools", f"generate_evaluation_index over the fixture ({' '.join(generate_evaluation_index.FIXTURE_OVERRIDES)}): "
          f"card {indices['cuda']}; CPU {'the same' if indices['cuda'] == indices['cpu'] else indices['cpu']}")
    if indices["cuda"] != indices["cpu"] or not all(indices["cuda"].values()) or len(indices["cuda"]) != 2:
        fail(f"eval_tools: the index on the card differs from the CPU's or misses a scene: {indices}")

    argv = EVAL_PROTOCOL_ARGV[:1] + EVAL_PROTOCOL_ARGV[2:] + [
        "data_loader.test.num_workers=0",
        f"evaluation.methods=[{{name: pixelSplat, key: ours, path: {EVAL_TOOLS_DIR / 'frames'}}}]",
        f"output_metrics_path={EVAL_TOOLS_DIR / 'metrics.json'}",
    ]
    t0 = time.perf_counter()
    computer = compute_metrics.main(argv, device="cuda")
    metrics_s = time.perf_counter() - t0
    scores = computer.scores["ours"]
    want = {"psnr": [], "ssim": []}
    bounds = {"psnr": [], "ssim": []}
    for r in renders:
        gt, color = r["gt"].cuda(), r["color"].cuda()
        q = (color.clamp(0, 1) * 255).to(torch.uint8).float() / 255
        want["psnr"] += compute_psnr(gt, color).tolist()
        mse = ((gt - color.clamp(0, 1)) ** 2).mean(dim=(1, 2, 3)).double()
        up = 10 * torch.log10(1 + (2 * mse.sqrt() / 255 + 1 / 255**2) / mse)
        down = -10 * torch.log10((1 - 2 / (255 * mse.sqrt())).clamp(min=1e-12))
        bounds["psnr"] += (torch.maximum(up, down) + EVAL_TOOLS_FLOAT_SLACK).tolist()
        c = color.clone().requires_grad_()
        ssim = compute_ssim(gt, c)
        want["ssim"] += ssim.tolist()
        (grad,) = torch.autograd.grad(ssim.sum(), c)
        step = float((color - q).abs().max())
        bounds["ssim"] += (EVAL_TOOLS_SSIM_MARGIN * grad.abs().sum(dim=(1, 2, 3)) * step + 1e-6).tolist()
    errs = {k: [abs(a - b) for a, b in zip(scores[k], want[k])] for k in want}
    phase("eval_tools", f"compute_metrics over {len(scores['psnr'])} PNGs of [eval_protocol]: PSNR per view "
          f"{[round(x, 4) for x in scores['psnr']]} against Trainer.test's {[round(x, 4) for x in want['psnr']]}: "
          f"|diff| {[float(f'{e:.3g}') for e in errs['psnr']]} within {[float(f'{b:.3g}') for b in bounds['psnr']]} dB; "
          f"SSIM |diff| {[float(f'{e:.3g}') for e in errs['ssim']]} within {[float(f'{b:.3g}') for b in bounds['ssim']]}")
    if len(scores["psnr"]) != len(want["psnr"]) or any(
        not e <= b for k in errs for e, b in zip(errs[k], bounds[k])
    ):
        fail(f"eval_tools: compute_metrics off Trainer.test beyond 8-bit rounding: {errs} vs {bounds}")
    if any(not math.isfinite(x) for x in scores["psnr"] + scores["ssim"]):
        fail(f"eval_tools: non-finite metrics {scores}")
    phase("timing", f"eval_tools | {card_line()} | generate_evaluation_index card + CPU {index_s:.1f} s | "
          f"compute_metrics {metrics_s:.1f} s for {len(scores['psnr'])} views")
    return dict(psnr_err=errs["psnr"], ssim_err=errs["ssim"], bounds=bounds, index=indices["cuda"])


# The extended visualization: the CLI's `mode=train` on the fixture's train
# split as [train_protocol] runs it, with `train.extended_visualization` on,
# 2 steps and a validation check every step (the pass falls on step 1).
VISUALIZATION_ARGV = [
    "+experiment=re10k", "mode=train", "loss.lpips.allow_random_weights=true", "train.extended_visualization=true",
    "trainer.max_steps=2", "trainer.val_check_interval=1", "checkpointing.every_n_train_steps=2",
    "trainer.log_every_n_steps=1",
]
VIDEO_FRAMES = {"wobble": 60, "interpolation": 30}
SPLATTER_FRAMES = 12
# Card against the CPU: the drawing primitives (f32 of the same formulas)
# and the single splatted Gaussian (one K1 render against the plain one).
DRAW_ATOL = 1e-5


def video_frame_count(path: Path, rendered: int) -> tuple[int, str]:
    """Frames in a logged video: decoded from a GIF; from ffprobe for an MP4
    where it is on PATH, else the frames rendered into it."""
    import shutil

    from PIL import Image

    if path.suffix == ".gif":
        with Image.open(path) as gif:
            return gif.n_frames, "GIF (PIL; no ffmpeg on PATH)"
    if shutil.which("ffprobe"):
        out = subprocess.run(
            ["ffprobe", "-v", "error", "-count_frames", "-select_streams", "v:0", "-show_entries",
             "stream=nb_read_frames", "-of", "csv=p=0", str(path)], capture_output=True, text=True, check=True,
        ).stdout
        return int(out.strip()), "MP4 (ffmpeg), frames counted by ffprobe"
    return rendered, "MP4 (ffmpeg), frames as rendered (no ffprobe)"


def visualization_phase(torch, kernels) -> dict:
    """`main.main` in `mode=train` with `train.extended_visualization` on,
    `re10k` at full width on the fixture's train split: every artifact of
    each validation, K1's launches against the count the path implies, no
    caught failure, no dropped pair; K1 against its plain version on a
    wobble frame and a projection; a video frame of a small input against
    the CPU port; `scripts/test_splatter.py` (12 launches, frame 0 against
    the CPU port) and `scripts/visualize_epipolar_lines.py`; times."""
    import tempfile

    import numpy as np
    from PIL import Image

    from pixelsplat_tpu_torch import main as cli
    from pixelsplat_tpu_torch.config import NUM_TARGET_VIEWS, load_config
    from pixelsplat_tpu_torch.model.encoder.visualization.encoder_visualizer_epipolar import (
        FIGURES,
        EncoderVisualizerEpipolar,
    )
    from pixelsplat_tpu_torch.ops.rasterizer import composite_kernel
    from pixelsplat_tpu_torch.ops.rasterizer.adaptive import probe, sufficient_settings
    from pixelsplat_tpu_torch.ops.rasterizer.composite import pack_columns
    from pixelsplat_tpu_torch.ops.rasterizer.projection import aos_planes, pack_gaussians_soa
    from pixelsplat_tpu_torch.ops.rasterizer.render import orthographic_frustum, project_and_bin
    from pixelsplat_tpu_torch.scripts import test_splatter, visualize_epipolar_lines
    from pixelsplat_tpu_torch.scripts.eval_scene import card_line, cuda_ms, scene_batch
    from pixelsplat_tpu_torch.scripts.train_fixture import FIXTURE_OVERRIDES, write_train_root
    from pixelsplat_tpu_torch.training.model_wrapper import batch_to
    from pixelsplat_tpu_torch.training.trainer import (
        _strip_non_arrays,
        interpolation_cameras,
        render_frames,
        wobble_cameras,
    )
    from pixelsplat_tpu_torch.visualization.validation_in_3d import (
        PROJECTION_SETTINGS,
        projection_cameras,
        render_projections,
    )

    card = card_line()
    result = {"launches": {}}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        root = write_train_root(tmp / "re10k")
        out = tmp / "outputs"
        argv = VISUALIZATION_ARGV + [f"dataset.roots=[{root}]", *FIXTURE_OVERRIDES, f"output_dir={out}"]
        cfg = load_config(argv)
        batch, views = cfg.data_loader.train.batch_size, cfg.dataset.view_sampler.num_target_views
        val_batch = cfg.data_loader.val.batch_size
        steps = cfg.trainer.max_steps
        phase("visualization", f"main {' '.join(VISUALIZATION_ARGV)} on the fixture's train split; cuts: "
              f"{' '.join(FIXTURE_OVERRIDES)}; batch {batch}, accumulate {cfg.trainer.accumulate_grad_batches}, "
              f"images {cfg.dataset.image_shape}, {views} target views, TF32 off")
        reset_launches(kernels)
        with Captured(torch) as captured:
            t0 = time.perf_counter()
            state = cli.main(argv)
            seconds = time.perf_counter() - t0
        launches = launch_counts(kernels)
        result["launches"]["visualization train_protocol re10k"] = launches
        trainer = captured.trainer
        val_steps = validation_steps(0, steps, cfg.trainer.val_check_interval)
        phase("visualization", f"main returned step {state.step} in {seconds:.1f} s; validations at {val_steps}; "
              f"caught visualization failures {trainer.visualization_failures}; launches {launches}")
        if state.step != steps or trainer.visualization_failures or len(trainer.visualization_log) != len(val_steps):
            fail(f"visualization: step {state.step}, failures {trainer.visualization_failures}, "
                 f"{len(trainer.visualization_log)} extended validations for {len(val_steps)} validation passes")

        # Every artifact of every validation.
        local = out / "local"
        for record, step in zip(trainer.visualization_log, val_steps):
            png = f"{step:06d}.png"
            omitted = record.get("encoder_omitted", {})
            for name, reason in omitted.items():
                phase("visualization", f"step {step}: encoder/{name} left out: {reason}")
            if set(omitted) - {"gaussian_stats"}:
                fail(f"visualization: encoder figures left out {omitted}")
            want_figures = sorted(set(FIGURES) - set(omitted))
            if record.get("encoder_figures") != want_figures:
                fail(f"visualization: step {step} encoder figures {record.get('encoder_figures')}, expected {want_figures}")
            sizes = {}
            for key in ["projections", "cameras", *(f"encoder/{n}" for n in want_figures)]:
                path = local / key / png
                if not path.is_file():
                    fail(f"visualization: {key} not logged at step {step}")
                sizes[key] = Image.open(path).size
            if sizes["projections"] != (3 * 256 + 4 * 8, 256 + 2 * 8) or sizes["cameras"] != (256, 256):
                fail(f"visualization: projections {sizes['projections']}, cameras {sizes['cameras']}")
            phase("visualization", f"step {step}: figures (w, h) {sizes}")
            phase("visualization", f"step {step}: projections XY / ZY / XZ dropped pairs {record['projection_overflow']}; "
                  f"settings rendered: " + "; ".join(
                      f"capacity {s.capacity}, big_capacity {s.big_capacity}, pair_budget {s.pair_budget}"
                      for s in record["projection_settings"]))
            if any(record["projection_overflow"]):
                fail(f"visualization: the projections dropped {record['projection_overflow']} pairs")
            for name, frames in VIDEO_FRAMES.items():
                path, dropped = record[f"{name}_file"], record[f"{name}_overflow"]
                count, how = video_frame_count(path, len(dropped))
                phase("visualization", f"step {step}: video/{name} {path.name}: {count} frames, {how}; dropped pairs "
                      f"per frame: {'all 0' if not any(dropped) else dropped}")
                if count != frames or len(dropped) != frames or any(dropped):
                    fail(f"visualization: video/{name} has {count} frames ({len(dropped)} rendered, dropped "
                         f"{dropped}), expected {frames} with none dropped")

        # K1's launches: the training renders, the validation's two variants,
        # 3 projections per validation example, and the videos' frames.
        per_val = 2 * views + 3 * val_batch + sum(VIDEO_FRAMES.values())
        want_fwd = steps * batch * views + len(val_steps) * per_val
        want_bwd = steps * batch * views
        formula = (f"{steps} steps x {batch} examples x {views} views + {len(val_steps)} validation(s) x (2 variants x "
                   f"{views} views + 3 projections x {val_batch} example(s) + {' + '.join(map(str, VIDEO_FRAMES.values()))} "
                   f"video frames)")
        phase("visualization", f"composite_fwd {launches['composite_fwd']} = {formula} = {want_fwd}; composite_bwd "
              f"{launches['composite_bwd']} = {steps} x {batch} x {views} = {want_bwd}")
        if launches["composite_fwd"] != want_fwd or launches["composite_bwd"] != want_bwd or any(
            n for k, n in launches.items() if k not in ("composite_fwd", "composite_bwd")
        ):
            fail(f"visualization: launches {launches}, expected composite_fwd {want_fwd}, composite_bwd {want_bwd}")

        # K1 against its plain version on a wobble frame and a projection, at
        # the weights the run ended with, on the validation batch.
        wrapper = trainer.wrapper
        batch_v = next(iter(trainer.data_module.val_dataloader()))
        arrays = batch_to(_strip_non_arrays(batch_v), wrapper.device)
        h, w = arrays["context"]["image"].shape[-2:]
        with torch.no_grad():
            gaussians = wrapper.make_eval_encode()(arrays, True, state.step)
            soa = pack_gaussians_soa(gaussians.means[0], gaussians.covariances[0], gaussians.opacities[0],
                                     harmonics=gaussians.harmonics[0])
            cams, intr = (torch.tensor(np.asarray(x), dtype=torch.float32, device=wrapper.device)
                          for x in wobble_cameras(batch_v, VIDEO_FRAMES["wobble"]))
            near, far = arrays["context"]["near"][0, 0], arrays["context"]["far"][0, 0]
            render = wrapper.decoder.cfg.render
            cases = {"wobble frame 0": (*project_and_bin(cams[0], intr[0], near, soa, image_shape=(h, w),
                                                         settings=render), render, w)}
            # The pairs the JAX package's fixed projection settings drop from
            # each view of this scene (binning only), and the settings the
            # port renders the XY view at.
            jax_drop = []
            for camera in projection_cameras(gaussians.means):
                e, k, n, _ = orthographic_frustum(camera.extrinsics, camera.width, camera.width, camera.near, camera.far)
                _, tiles = project_and_bin(e[0], k[0], n[0], soa, image_shape=(256, 256), scale_invariant=False,
                                           settings=PROJECTION_SETTINGS)
                jax_drop.append(int(tiles.overflow))
            camera = projection_cameras(gaussians.means)[0]
            e, k, n, _ = orthographic_frustum(camera.extrinsics, camera.width, camera.width, camera.near, camera.far)
            planes = aos_planes(gaussians.means, gaussians.covariances, gaussians.opacities)
            occupancy = probe(e, k, n, planes, (256, 256), PROJECTION_SETTINGS, scale_invariant=False)
            proj_settings = sufficient_settings(occupancy, PROJECTION_SETTINGS, gaussians.means.shape[1], (256, 256))
            cases["projection XY"] = (*project_and_bin(e[0], k[0], n[0], soa, image_shape=(256, 256),
                                                       scale_invariant=False, settings=proj_settings), proj_settings, 256)
        result["jax_settings_drop"] = jax_drop
        phase("visualization", f"at the JAX package's projection settings (capacity {PROJECTION_SETTINGS.capacity}, big "
              f"list {PROJECTION_SETTINGS.big_capacity}) the XY / ZY / XZ views of validation batch 0 at the final "
              f"weights would drop {jax_drop} pairs; the port renders the XY view at capacity {proj_settings.capacity}, "
              f"big_capacity {proj_settings.big_capacity}, pair_budget {proj_settings.pair_budget}")
        errs, timing = [], {}
        for label, (projected, tiles, settings, width) in cases.items():
            table = pack_columns(projected).contiguous()
            tiles_x = -(-width // settings.tile_size)
            scale = max(1.0, float(table[:, 6:].abs().max()))
            err, n_k = check_kernel_against_plain(composite_kernel, label, tiles, table, settings.chunk, tiles_x)
            if err > KERNEL_ATOL * scale:
                fail(f"visualization: composite_fwd on the {label}: {err:.3g} > {KERNEL_ATOL} x {scale:.3g}")
            errs.append(err)
            args = (table, tiles.flat, tiles.block_start, tiles.counts, tiles_x, settings.chunk)
            bound, by = composite_bound_ms(tiles, table, n_k, settings.chunk)
            timing[label] = dict(
                ms=cuda_ms(lambda: composite_kernel.composite_core(*args), iters=20),
                plain_ms=cuda_ms(lambda: composite_kernel.composite_core_plain(*args), iters=2, warmup=1),
                bound_ms=bound, bound_by=by, slots=int(tiles.counts.sum()), max_tile=int(tiles.counts.max()),
            )
            phase("timing", f"visualization {label} | {card} | composite_fwd {timing[label]['ms']:.4f} ms, plain "
                  f"{timing[label]['plain_ms']:.3f} ms, bound {bound:.4f} ms ({by}); list slots "
                  f"{timing[label]['slots']}, longest tile {timing[label]['max_tile']}, capacity {settings.capacity}")
        result["fwd_err"], result["k1"] = max(errs), timing

        # Times: the videos' frames, the projections, the visualizer's encode
        # with capture against the plain encode, and the figure drawing.
        with torch.no_grad():
            video_ms = {}
            for name, frames in VIDEO_FRAMES.items():
                maker = wobble_cameras if name == "wobble" else interpolation_cameras
                c, i = (torch.tensor(np.asarray(x), dtype=torch.float32, device=wrapper.device)
                        for x in maker(batch_v, frames))
                video_ms[name] = cuda_ms(lambda: render_frames(wrapper.decoder, gaussians, c, i, near, far, (h, w)),
                                         iters=2, warmup=1) / frames
            projections_ms = cuda_ms(lambda: render_projections(gaussians, 256), iters=2, warmup=1)
            encoder, context = wrapper.encoder, arrays["context"]

            def plain_encode():
                encoder(context, state.step, False, generator=torch.Generator(device=wrapper.device).manual_seed(0))

            def captured_encode():
                with encoder.capture_intermediates():
                    encoder(context, state.step, False, generator=torch.Generator(device=wrapper.device).manual_seed(0),
                            visualization_dump={})

            encode_ms = {"plain": [], "capture": []}
            for which in ("plain", "capture", "capture", "plain"):
                encode_ms[which].append(cuda_ms(plain_encode if which == "plain" else captured_encode, iters=3))
            encode_ms = {k: sum(v) / len(v) for k, v in encode_ms.items()}
            visualizer = EncoderVisualizerEpipolar(encoder)
            visualizer.visualize(context, state.step, generator=torch.Generator(device=wrapper.device).manual_seed(0))  # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            figures = visualizer.visualize(context, state.step, generator=torch.Generator(device=wrapper.device).manual_seed(0))
            torch.cuda.synchronize()
            visualize_ms = 1e3 * (time.perf_counter() - t0)
        result["times"] = dict(video_ms_per_frame=video_ms, projections_ms=projections_ms, encode_ms=encode_ms,
                               visualize_ms=visualize_ms, figures_ms=visualize_ms - encode_ms["capture"])
        phase("timing", f"visualization | {card} | video frames {({k: round(v, 3) for k, v in video_ms.items()})} ms "
              f"per frame (CUDA events; packing once, then one decoder call per frame); projections "
              f"{projections_ms:.2f} ms for 3 views (with the list-sizing pre-pass and its host syncs); "
              f"encode plain {encode_ms['plain']:.2f} ms, with capture {encode_ms['capture']:.2f} ms (CUDA events, "
              f"alternating); visualize {visualize_ms:.1f} ms on the host clock, of which figure drawing "
              f"{visualize_ms - encode_ms['capture']:.1f} ms ({len(figures)} figures)")

        # A video frame of a small input, card against the CPU port: the
        # depth encoding cut as in the tight references, equal weights.
        small = scene_batch("cpu", torch.Generator().manual_seed(SEED + 11), 64, 64)
        frames = []
        for ref in reference_pair(torch, wrapper, REFERENCE_OCTAVES):
            with torch.no_grad():
                g = ref.make_eval_encode()(small, True, 0)
                c, i = (torch.tensor(np.asarray(x), dtype=torch.float32, device=ref.device)[:1]
                        for x in wobble_cameras(small, VIDEO_FRAMES["wobble"]))
                frames.append(render_frames(ref.decoder, g, c, i, small["context"]["near"][0, 0].to(ref.device),
                                            small["context"]["far"][0, 0].to(ref.device), (64, 64)))
        (f_gpu, d_gpu), (f_cpu, d_cpu) = frames
        diff = (f_gpu.cpu() - f_cpu).abs()
        frac_off = float((diff > 1e-3).float().mean())
        phase("reference", f"64x64 wobble frame 0 (depth encoding cut to {REFERENCE_OCTAVES} octaves): max err "
              f"{float(diff.max()):.3g}, mean err {float(diff.mean()):.3g}, pixels off by >1e-3: {frac_off:.4%}, "
              f"dropped {d_gpu}/{d_cpu}")
        if float(diff.mean()) > 1e-4 or frac_off > 0.01 or any(d_gpu + d_cpu):
            fail("visualization: the card's wobble frame disagrees with the CPU port on the small input")
        del gaussians, soa, cases, visualizer, figures, batch_v, arrays, trainer, captured, state, wrapper, encoder
        del frames, g
        gc_cuda(torch)

    # The two smoke scripts.
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        reset_launches(kernels)
        t0 = time.perf_counter()
        splat = test_splatter.main([str(tmp / "splatter"), str(SPLATTER_FRAMES)])
        splat_s = time.perf_counter() - t0
        splat_launches = launch_counts(kernels)
        result["launches"]["visualization test_splatter"] = splat_launches
        cpu0 = test_splatter.render_frames(1, torch.device("cpu"))[0]  # the orbit's first camera
        err = float((splat[0] - cpu0).abs().max())
        pngs = sorted(p.name for p in (tmp / "splatter").iterdir())
        phase("visualization", f"test_splatter: {len(pngs)} PNGs in {splat_s:.2f} s, launches {splat_launches}; "
              f"frame 0 against the CPU port max |d| {err:.3g}; frame means "
              f"{[round(float(x.mean()), 4) for x in splat[:4]]} ...")
        if splat_launches["composite_fwd"] != SPLATTER_FRAMES or sum(splat_launches.values()) != SPLATTER_FRAMES:
            fail(f"visualization: test_splatter launched {splat_launches}, expected composite_fwd {SPLATTER_FRAMES}")
        if len(pngs) != SPLATTER_FRAMES or err > KERNEL_ATOL or not float(splat.max()) > 0.1:
            fail(f"visualization: test_splatter wrote {len(pngs)} frames, frame 0 off the CPU port by {err:.3g}")
        reset_launches(kernels)
        lines_card = visualize_epipolar_lines.main([str(tmp / "lines")])
        lines_launches = launch_counts(kernels)
        lines_cpu = visualize_epipolar_lines.main([str(tmp / "lines_cpu")], device="cpu")
        errs = {i: float(np.abs(lines_card[i] - lines_cpu[i]).max()) for i in lines_cpu}
        phase("visualization", f"visualize_epipolar_lines: lines {sorted(lines_card)} drawn, card against CPU max "
              f"|d| {errs}, launches {lines_launches}")
        if sorted(lines_card) != sorted(lines_cpu) or not lines_card or any(e > DRAW_ATOL for e in errs.values()) \
                or any(lines_launches.values()):
            fail("visualization: visualize_epipolar_lines differs between the card and the CPU, or launched a kernel")
    return result


# The paper's figures and tables, and the reference-checkpoint route, on
# the fixture's first scene at `re10k`'s full width (random weights).
PAPER_DIR = ROOT / "build" / "chip_smoke" / "paper"
PAPER_SCENE = ("fixture_scene_a", 0, 5)
PAPER_FAR = {"point_cloud": 30.0, "sampling": 30.0}
PAPER_ANGLE = 60.0
# The scripts' default resolutions: the point cloud's, the sampling figure's.
PAPER_RESOLUTIONS = (1024, 1536)
LIGHTNING_STEP = 123456
# Lists crowded at each alpha cut, per family, for both compositing kernels.
ALPHA_CUT_SEEDS = 20


def lightning_checkpoint(torch, path: Path, encoder) -> None:
    """`encoder`'s weights as the published `.ckpt` lays them out
    (`tests/test_parity_runbook.py::_lightning_checkpoint`): `encoder.*`
    entries of `state_dict` with BatchNorm's `num_batches_tracked` beside
    every frozen BatchNorm's statistics, `global_step`, Lightning's other
    top-level entries and Adam's state."""
    state_dict = {}
    for k, v in encoder.state_dict().items():
        state_dict[f"encoder.{k}"] = v.detach().cpu()
        if k.endswith(".running_var"):
            state_dict[f"encoder.{k[: -len('running_var')]}num_batches_tracked"] = torch.tensor(0)
    params = list(encoder.parameters())
    torch.save({
        "epoch": 3, "global_step": LIGHTNING_STEP, "pytorch-lightning_version": "2.1.0", "state_dict": state_dict,
        "loops": {"fit_loop": {"epoch_progress": {}}}, "callbacks": {"ModelCheckpoint": {"best_model_score": None}},
        "optimizer_states": [{
            "state": {i: {"step": torch.tensor(float(LIGHTNING_STEP)), "exp_avg": torch.zeros(p.shape),
                          "exp_avg_sq": torch.zeros(p.shape)} for i, p in enumerate(params)},
            "param_groups": [{"lr": 1.5e-4, "betas": (0.9, 0.999), "params": list(range(len(params)))}],
        }],
        "lr_schedulers": [{"_step_count": LIGHTNING_STEP + 1, "lr_lambdas": [None]}],
        "hparams_name": "kwargs", "hyper_parameters": {},
    }, path)


def paper_evaluation_overlay(index: dict, frames: Path) -> str:
    """A config/evaluation overlay over the fixture: `[eval_protocol]`'s
    PNGs as the one method, both scenes highlighted at their first target;
    returned as its path without `.yaml`."""
    highlighted = "\n".join(f"    - scene: {s}\n      target_index: {e['target'][0]}" for s, e in index.items())
    path = PAPER_DIR / "fixture_evaluation.yaml"
    path.write_text(
        f"dataset:\n  view_sampler:\n    index_path: {FIXTURE / 'evaluation_index_fixture.json'}\n"
        f"evaluation:\n  methods:\n    - name: pixelSplat (port)\n      key: ours\n      path: {frames}\n"
        f"  side_by_side_path: null\n  animate_side_by_side: false\n  highlighted:\n{highlighted}\n"
    )
    return str(path.with_suffix(""))


class StageTimes:
    """Within the block, each call of the functions `targets` names
    ((module, name) pairs) is timed on the host clock between two device
    syncs and summed under its name."""

    def __init__(self, torch, targets):
        self.torch, self.targets, self.ms, self.originals = torch, targets, {}, []

    def __enter__(self) -> dict:
        for module, name in self.targets:
            fn = getattr(module, name)

            def timed(*args, _fn=fn, _name=name, **kwargs):
                self.torch.cuda.synchronize()
                t0 = time.perf_counter()
                try:
                    return _fn(*args, **kwargs)
                finally:
                    self.torch.cuda.synchronize()
                    self.ms[_name] = self.ms.get(_name, 0.0) + 1e3 * (time.perf_counter() - t0)

            self.originals.append((module, name, fn))
            setattr(module, name, timed)
        return self.ms

    def __exit__(self, *exc) -> None:
        for module, name, fn in self.originals:
            setattr(module, name, fn)


def paper_phase(torch, kernels) -> dict:
    """The reference-checkpoint loader and import script, the parity
    runbook, every paper figure and table, and the launch commands, as a
    user runs them (the figures at their default resolutions); K1 against
    its plain version on the densest figure render, with its time against
    its bound; both compositing kernels on lists crowded at the three alpha
    cuts."""
    import shutil

    import numpy as np
    from PIL import Image

    from pixelsplat_tpu_torch.config import load_config
    from pixelsplat_tpu_torch.interop.torch_import import load_lightning_checkpoint
    from pixelsplat_tpu_torch.model.encoder.encoder_epipolar import EncoderEpipolar
    from pixelsplat_tpu_torch.ops.rasterizer import composite_kernel
    from pixelsplat_tpu_torch.ops.rasterizer.composite import pack_columns
    from pixelsplat_tpu_torch.ops.rasterizer.projection import pack_gaussians_soa
    from pixelsplat_tpu_torch.ops.rasterizer.render import orthographic_frustum, project_and_bin
    from pixelsplat_tpu_torch.paper import common as paper_common
    from pixelsplat_tpu_torch.paper import (
        generate_3_view_image_comparison, generate_ablation_image_comparison, generate_attention_figure,
        generate_benchmark_table, generate_comparison_table, generate_epipolar_sampling_figure,
        generate_image_comparison, generate_point_cloud_figure, generate_sampling_figure,
    )
    from pixelsplat_tpu_torch.scripts import check_alpha_threshold, dump_launch_configs, import_checkpoint
    from pixelsplat_tpu_torch.scripts import run_parity_eval
    from pixelsplat_tpu_torch.scripts.eval_scene import card_line, cuda_ms, init_random_weights
    from pixelsplat_tpu_torch.training.checkpoint import load_checkpoint

    card, device, sync = card_line(), "cuda", torch.cuda.synchronize
    pc_resolution, sampling_resolution = PAPER_RESOLUTIONS
    shutil.rmtree(PAPER_DIR, ignore_errors=True)
    PAPER_DIR.mkdir(parents=True)
    dataset = [f"dataset.roots=[{FIXTURE / 're10k'}]"]
    cfg = load_config(["+experiment=re10k", "mode=test", *dataset])
    result = {"launches": {}, "figures": {}}

    # 1. The two load routes: the `.ckpt` read directly, and imported into a
    #    checkpoint of the port that `checkpointing.load` reads.
    source = EncoderEpipolar(cfg.model.encoder).to(device).eval()
    init_random_weights(source, torch.Generator(device=device).manual_seed(SEED + 13))
    ckpt = PAPER_DIR / "re10k_random.ckpt"
    t0 = time.perf_counter()
    lightning_checkpoint(torch, ckpt, source)
    direct = EncoderEpipolar(cfg.model.encoder).to(device).eval()
    step = load_lightning_checkpoint(ckpt, direct)
    imported = import_checkpoint.main([str(ckpt), str(PAPER_DIR / "imported"), "--device", device, "+experiment=re10k",
                                       *dataset])
    load_cfg = load_config(["+experiment=re10k", "mode=test", *dataset, f"checkpointing.load={imported}"])
    via_import, _ = paper_common.load_model(load_cfg, device)
    sync()
    load_s = time.perf_counter() - t0
    want = source.state_dict()
    unequal = [k for k, v in want.items()
               if not (torch.equal(direct.state_dict()[k], v) and torch.equal(via_import.state_dict()[k], v))]
    counters = sum(k.endswith(".running_var") for k in want)  # one num_batches_tracked each
    imported_step = load_checkpoint(imported)["step"]
    phase("paper", f"{ckpt.name}: {len(want)} encoder tensors + {counters} num_batches_tracked counters, global_step "
          f"{LIGHTNING_STEP}; the direct load and the import ({imported.name}) read through checkpointing.load "
          f"agree with the source bit for bit on {len(want) - len(unequal)}/{len(want)} tensors on the {device}; "
          f"steps {step} / {imported_step}; {load_s:.1f} s")
    if unequal or step != LIGHTNING_STEP or imported_step != LIGHTNING_STEP or not counters:
        fail(f"paper: the load routes differ on {unequal[:5]}, steps {step} / {imported_step}, {counters} counters")
    del source, direct, via_import

    # 2. The parity runbook on the `.ckpt` over the fixture's evaluation index.
    index = json.loads((FIXTURE / "evaluation_index_fixture.json").read_text())
    reset_launches(kernels)
    t0 = time.perf_counter()
    summary = run_parity_eval.run([
        "--ckpt", str(ckpt), "--data", str(FIXTURE / "re10k"), "--index", str(FIXTURE / "evaluation_index_fixture.json"),
        "--output", str(PAPER_DIR / "parity"), "--device", device, "data_loader.test.num_workers=0",
    ])
    runbook_s = time.perf_counter() - t0
    launches = launch_counts(kernels)
    result["launches"]["paper run_parity_eval"] = launches
    written = json.loads((PAPER_DIR / "parity" / "parity_summary.json").read_text())
    phase("paper", f"run_parity_eval on {ckpt.name}: {summary['num_scenes']} scenes, PSNR {summary['psnr']:.4f} "
          f"(published {run_parity_eval.PUBLISHED['re10k']['psnr']}), overflow pairs {summary['overflow_pairs']}, "
          f"gate {'PASS' if summary['gate'] else 'FAIL (random weights: expected)'}; parity_summary.json written; "
          f"launches {launches}; {runbook_s:.1f} s")
    if written != summary or summary["num_scenes"] != len(index) or summary["overflow_pairs"] != 0 or \
            launches["composite_fwd"] != 3 * len(index) or sum(launches.values()) != launches["composite_fwd"]:
        fail(f"paper: the runbook's summary {summary}, launches {launches}")

    # 3. The figures, each through its script's entry point.
    scene, c0, c1 = PAPER_SCENE
    model = [f"checkpointing.load={imported}", *dataset]
    figures = {
        "point_cloud": lambda: generate_point_cloud_figure.main([
            "--output", str(PAPER_DIR / "point_clouds"), "--scene",
            f"{scene}:{c0}:{c1}:{PAPER_FAR['point_cloud']}:{PAPER_ANGLE}", "--device", device, *model]),
        "sampling": lambda: generate_sampling_figure.main([
            "--output", str(PAPER_DIR / "sampling_figure"), "--scene", f"{scene}:{c0}:{c1}:{PAPER_FAR['sampling']}",
            "--device", device, *model]),
        "attention": lambda: generate_attention_figure.main([
            "--output", str(PAPER_DIR / "attention.svg"), "--scene", f"{scene}:{c0}:{c1}", "--device", device, *model]),
        "epipolar_sampling": lambda: generate_epipolar_sampling_figure.main([
            "--output", str(PAPER_DIR / "epipolar_sampling.svg"), "--scene", f"{scene}:{c0}:{c1}", "--device", device,
            *dataset]),
    }
    views = 2
    want_k1 = {"point_cloud": 3 + 2 * views, "sampling": 3, "attention": 0, "epipolar_sampling": 0}
    # The figures' stages, each timed where its script calls it.
    stages = [(module, name) for module in (generate_point_cloud_figure, generate_sampling_figure)
              for name in ("load_model", "load_scene", "encode_scene", "line_overlay_layers",
                           "composite_depth_layers", "save_image")]
    stages += [(generate_point_cloud_figure, "probe"), (generate_point_cloud_figure, "render_orthographic"),
               (generate_point_cloud_figure, "export_ply"), (generate_sampling_figure, "density_volume")]

    def bin_view(p, settings):
        """An orthographic figure render's view, binned at `settings`."""
        means, covariances, harmonics, opacities = p["scene"]
        e, k, n, _ = orthographic_frustum(*p["camera"].values())
        soa = pack_gaussians_soa(means[0], covariances[0], opacities[0], harmonics=harmonics[0])
        return project_and_bin(e[0], k[0], n[0], soa, image_shape=p["image_shape"], scale_invariant=False,
                               settings=settings)

    def decoder_dropped(dec, settings) -> int:
        """The pairs `settings` drop from the point-cloud figure's context
        depth renders."""
        (e, k, n, _), (means, covariances, opacities) = dec["cameras"], dec["scene"]
        soa = pack_gaussians_soa(means[0], covariances[0], opacities[0], colors_precomp=means.new_zeros((means.shape[1], 1)))
        return sum(int(project_and_bin(e[0, i], k[0, i], n[0, i], soa, image_shape=dec["image_shape"],
                                       scale_invariant=True, settings=settings)[1].overflow) for i in range(dec["views"]))

    # What the JAX settings would drop is counted here, after each figure's
    # run: the scripts grow the settings and drop nothing.
    outputs, renders = {}, []
    for name, run in figures.items():
        sync()
        reset_launches(kernels)
        t0 = time.perf_counter()
        with StageTimes(torch, stages) as stage_ms:
            outputs[name] = run()
        sync()
        wall_ms = 1e3 * (time.perf_counter() - t0)
        launches = launch_counts(kernels)
        result["launches"][f"paper {name}"] = launches
        record = {"wall_ms": wall_ms, "k1": launches["composite_fwd"], "k1_expected": want_k1[name],
                  "stages_ms": stage_ms}
        line = f"{name}: wall {wall_ms:.1f} ms (model build and checkpoint read included); composite_fwd " \
               f"{launches['composite_fwd']} (expected {want_k1[name]})"
        if stage_ms:
            line += f"; stages ms (host clock, device synced) {({k: round(v, 1) for k, v in stage_ms.items()})}"
        passes = []
        if name == "point_cloud":
            (pc,) = outputs[name]
            passes = pc["orthographic"]
            dec = pc["decoder"]
            record["decoder"] = {"jax_dropped": decoder_dropped(dec, dec["jax_settings"]), "dropped": dec["dropped"],
                                 "capacity": dec["settings"].capacity, "big_capacity": dec["settings"].big_capacity}
            line += f"; decoder's context depth renders: capacity {dec['settings'].capacity}, big list " \
                    f"{dec['settings'].big_capacity}, the decoder's settings would drop " \
                    f"{record['decoder']['jax_dropped']}, dropped {dec['dropped']}"
            if dec["dropped"]:
                fail(f"paper: the point-cloud figure's depth renders dropped {dec['dropped']} pairs")
        elif name == "sampling":
            passes = outputs[name]
        for p in passes:
            s, j = p["settings"], p["jax_settings"]
            p["jax_dropped"] = int(bin_view(p, j)[1].overflow)
            line += f"; orthographic {p['image_shape'][0]}x{p['image_shape'][1]}: {p['gaussians']} Gaussians after " \
                    f"the trim, the JAX settings (capacity {j.capacity}, big list {j.big_capacity}) would drop " \
                    f"{p['jax_dropped']} pairs, rendered at capacity {s.capacity}, big list {s.big_capacity}, pair " \
                    f"budget {s.pair_budget}: dropped {p['dropped']}"
            renders.append((name, p))
            if any(p["dropped"]) or len(p["dropped"]) != 3:
                fail(f"paper: {name} dropped {p['dropped']} pairs")
        record["passes"] = [{k: p[k] for k in ("gaussians", "jax_dropped", "dropped")} | {
            "capacity": p["settings"].capacity, "big_capacity": p["settings"].big_capacity} for p in passes]
        result["figures"][name] = record
        phase("paper", line)
        if launches["composite_fwd"] != want_k1[name] or sum(launches.values()) != launches["composite_fwd"]:
            fail(f"paper: {name} launched {launches}, expected composite_fwd {want_k1[name]}")

    # Every figure file, finite and of its size.
    pngs = {
        "point_clouds": (sorted((PAPER_DIR / "point_clouds").glob("*.png")), 3),
        "sampling_figure": (sorted((PAPER_DIR / "sampling_figure").glob("*.png")), 2),
    }
    sizes = {}
    for folder, (paths, count) in pngs.items():
        for path in paths:
            sizes[path.name] = Image.open(path).size
        if len(paths) != count:
            fail(f"paper: {folder} holds {[p.name for p in paths]}")
    if sizes[f"000000_{scene}_angle_{PAPER_ANGLE}.png"] != (pc_resolution,) * 2 or \
            sizes["density.png"] != (sampling_resolution,) * 2:
        fail(f"paper: figure sizes {sizes}")
    ply = PAPER_DIR / "point_clouds" / f"000000_{scene}" / "gaussians.ply"
    attention = outputs["attention"]
    svgs = {name: (PAPER_DIR / f"{name}.svg").read_text() for name in ("attention", "epipolar_sampling")}
    phase("paper", f"files: {sizes}; {ply.name} {ply.stat().st_size} bytes; attention maps {attention.shape} "
          f"(layer, tokens, head, 1, samples), finite {bool(np.isfinite(attention).all())}; SVGs "
          f"{({k: v.count('<image') for k, v in svgs.items()})} images, {svgs['attention'].count('<line')} lines")
    if not ply.stat().st_size or not np.isfinite(attention).all() or \
            any(v.count("<image") != 2 for v in svgs.values()) or "&#8734;" not in svgs["epipolar_sampling"]:
        fail("paper: a figure file is missing, empty or not finite")

    # K1 on the densest figure render's lists, against its plain version.
    densest = None
    for name, p in renders:
        projected, tiles = bin_view(p, p["settings"])
        slots = int(tiles.counts.sum())
        if densest is None or slots > densest[0]:
            densest = (slots, name, projected, tiles, p["settings"], p["image_shape"][1])
    slots, name, projected, tiles, settings, width = densest
    table = pack_columns(projected).contiguous()
    tiles_x = -(-width // settings.tile_size)
    scale = max(1.0, float(table[:, 6:].abs().max()))
    err, n_k = check_kernel_against_plain(composite_kernel, f"paper {name}", tiles, table, settings.chunk, tiles_x)
    if err > KERNEL_ATOL * scale:
        fail(f"paper: composite_fwd on the {name} figure's lists: {err:.3g} > {KERNEL_ATOL} x {scale:.3g}")
    args = (table, tiles.flat, tiles.block_start, tiles.counts, tiles_x, settings.chunk)
    bound, by = composite_bound_ms(tiles, table, n_k, settings.chunk)
    k1 = dict(figure=name, ms=cuda_ms(lambda: composite_kernel.composite_core(*args), iters=10),
              plain_ms=cuda_ms(lambda: composite_kernel.composite_core_plain(*args), iters=1, warmup=1),
              bound_ms=bound, bound_by=by, slots=slots, max_tile=int(tiles.counts.max()), tiles=tiles.counts.numel(),
              max_abs_err=err)
    result["k1"] = k1
    phase("timing", f"paper {name} (densest figure render) | {card} | composite_fwd {k1['ms']:.4f} ms, plain "
          f"{k1['plain_ms']:.3f} ms, bound {bound:.4f} ms ({by}); list slots {slots} over {k1['tiles']} tiles, "
          f"longest tile {k1['max_tile']}, capacity {settings.capacity}")
    del renders, densest, projected, tiles, table, outputs

    # 4. The tables and comparison figures over what earlier phases wrote:
    #    [eval_protocol]'s PNGs and benchmark files, [eval_tools]' metrics.
    frames = EVAL_TOOLS_DIR / "frames"
    generate_benchmark_table.main([f"port={frames}", str(PAPER_DIR / "benchmark.tex")])
    generate_comparison_table.main([str(EVAL_TOOLS_DIR / "metrics.json"), str(PAPER_DIR / "comparison.tex")])
    overlay = paper_evaluation_overlay(index, frames)
    grid_args = [f"dataset.roots=[{FIXTURE / 're10k'}]"]
    rows, names = generate_image_comparison.collect_rows(["re10k"], grid_args, overlay)
    generate_image_comparison.generate_image_grid(rows, names, PAPER_DIR / "image_comparison.svg")
    generate_3_view_image_comparison.main(["--output", str(PAPER_DIR / "image_comparison_3_view.svg"),
                                           "--evaluation", overlay, *grid_args])
    generate_ablation_image_comparison.main(["--output", str(PAPER_DIR / "ablation.svg"), "--evaluation", overlay,
                                             *grid_args])
    tables = {name: (PAPER_DIR / name).read_text() for name in ("benchmark.tex", "comparison.tex")}
    grids = {name: (PAPER_DIR / name).read_text().count("<image")
             for name in ("image_comparison.svg", "image_comparison_3_view.svg", "ablation.svg")}
    phase("paper", f"tables: benchmark.tex {tables['benchmark.tex'].count(chr(10)) + 1} lines "
          f"({'encoder (ms)' in tables['benchmark.tex']}), comparison.tex {tables['comparison.tex'].count(chr(10)) + 1} "
          f"lines; comparison grids' images {grids}")
    want_grids = {"image_comparison.svg": len(index) * 4, "image_comparison_3_view.svg": len(index) * 5,
                  "ablation.svg": len(index)}
    if grids != want_grids or "encoder (ms)" not in tables["benchmark.tex"] or "PSNR" not in tables["comparison.tex"] \
            or any(row[-1] is None for row in rows):
        fail(f"paper: tables or grids wrong: {grids} (expected {want_grids})")

    # 5. The launch commands.
    commands = dump_launch_configs.render()
    phase("paper", f"dump_launch_configs: {len(dump_launch_configs.LAUNCHES)} commands, torchrun line: "
          f"{dump_launch_configs.LAUNCHES['train re10k (8 GPUs)']}")
    if "torchrun --nproc_per_node" not in commands or "pixelsplat_tpu_torch.main" not in commands:
        fail("paper: dump_launch_configs printed no torchrun or main line")

    # Both compositing kernels on lists crowded at each alpha cut.
    cuts = {}
    for family in check_alpha_threshold.FAMILIES:
        cuts[family] = check_alpha_threshold.check(ALPHA_CUT_SEEDS, device, family)
        c = cuts[family]
        phase("alpha_cuts", f"{family}: {ALPHA_CUT_SEEDS} seeds x 256 tiles x 256 slots: composite_fwd pixels beyond "
              f"{check_alpha_threshold.ATOL}: {c['pixels_beyond']} (max |acc| err {c['max_abs_err']:.3g}, tiles "
              f"whose n_proc differs {c['tiles_n_proc_differ']}); composite_bwd rows of d_table beyond "
              f"{check_alpha_threshold.ATOL} of their column's max: {c['bwd_rows_beyond']} (max "
              f"{c['bwd_max_rel_err']:.3g})")
        if c["pixels_beyond"] or c["tiles_n_proc_differ"] or c["bwd_rows_beyond"]:
            fail(f"alpha_cuts: on the {family} lists composite_fwd has {c['pixels_beyond']} pixels beyond "
                 f"{check_alpha_threshold.ATOL} (max {c['max_abs_err']:.3g}) and {c['tiles_n_proc_differ']} tiles "
                 f"whose n_proc differs; composite_bwd has {c['bwd_rows_beyond']} rows beyond "
                 f"{check_alpha_threshold.ATOL} (max {c['bwd_max_rel_err']:.3g})")
    result["alpha_cuts"] = cuts
    return result


# The port's weight import and fixture generator, run last: `[assets]`
# writes seeded random weights into `weights/` for its protocol run and
# removes them when it ends, pass or fail; it refuses to start where
# `weights/` already holds a file it would write (a user's real weights).
ASSETS_DIR = ROOT / "build" / "chip_smoke" / "assets"
ASSETS_WEIGHTS = ("lpips_vgg.npz", "dino_vitb8.npz", "dino_resnet50.npz")
# The fixture regenerated against the checked-in one: frames within 2/255
# in mean absolute value (the JPEG encoder's version may differ).
FIXTURE_MEAN_LEVELS = 2.0
# LPIPS on the card against the CPU, relative (TF32 off).
ASSETS_LPIPS_RTOL = 1e-4


def published_layouts(torch, reference: dict, directory: Path, seed: int) -> dict:
    """Seeded random weights in the published files' layouts, at full width.

    The DINO hub checkpoints carry the reference checkpoint's own trunks
    (`reference`: the encoder's parameters): `dino_vitbase8_pretrain.pth`
    its ViT-B/8, `dino_resnet50_pretrain.pth` torchvision's four-stage
    ResNet-50 with its stages 1-3 (stage 4, the BatchNorm counters and the
    `fc` head, which the encoder does not hold, seeded). The LPIPS files are
    the `lpips` package's lin file (`weights/v0.1/vgg.pth`) and torchvision's
    VGG16 state_dict, classifier included."""
    from pixelsplat_tpu_torch.evaluation import lpips
    from pixelsplat_tpu_torch.model.encoder.backbone.resnet import BackboneResnet, BackboneResnetCfg
    from pixelsplat_tpu_torch.scripts.eval_scene import init_random_weights

    generator = torch.Generator().manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=generator) * scale

    vit = {k[len("backbone.dino."):]: v.cpu() for k, v in reference.items() if k.startswith("backbone.dino.")}
    trunk = BackboneResnet(BackboneResnetCfg(model="dino_resnet50", num_layers=5)).model  # four stages
    init_random_weights(trunk, generator)
    resnet = {}
    for k, v in trunk.state_dict().items():
        resnet[k] = reference.get(f"backbone.resnet_backbone.model.{k}", v).detach().cpu().clone()
        if k.endswith("running_var"):
            resnet[k.replace("running_var", "num_batches_tracked")] = torch.tensor(seed + 1, dtype=torch.int64)
    resnet["fc.weight"], resnet["fc.bias"] = randn(1000, 2048, scale=2048**-0.5), torch.zeros(1000)

    vgg, in_ch = {}, 3
    for tv, (ch, _) in zip(lpips.TV_INDICES, lpips.VGG16_PLAN):
        vgg[f"features.{tv}.weight"] = randn(ch, in_ch, 3, 3, scale=(9 * in_ch) ** -0.5)
        vgg[f"features.{tv}.bias"] = randn(ch, scale=0.1)
        in_ch = ch
    for i, (n_in, n_out) in zip((0, 3, 6), ((25088, 4096), (4096, 4096), (4096, 1000))):
        vgg[f"classifier.{i}.weight"] = randn(n_out, n_in, scale=n_in**-0.5)
        vgg[f"classifier.{i}.bias"] = torch.zeros(n_out)
    lin = {f"lin{i}.model.1.weight": randn(1, lpips.VGG16_PLAN[t][0], 1, 1).abs() * 0.1
           for i, t in enumerate(lpips.TAPS)}
    files = {"vit": directory / "dino_vitbase8_pretrain.pth", "resnet": directory / "dino_resnet50_pretrain.pth",
             "vgg": directory / "vgg16-397923af.pth", "lin": directory / "vgg.pth"}
    directory.mkdir(parents=True, exist_ok=True)
    for key, sd in (("vit", vit), ("resnet", resnet), ("vgg", vgg), ("lin", lin)):
        torch.save(sd, files[key])
    files["vit_tensors"], files["resnet_tensors"] = len(vit), len(resnet)
    return files


def assets_phase(torch, kernels, protocol: dict) -> dict:
    """The fixture regenerated by `scripts/make_fixture_chunk.py`, the
    published weight layouts through `scripts/export_weights.py`, and the
    evaluation protocol on that fixture with those weights."""
    from pixelsplat_tpu_torch.interop.pretrained import WEIGHTS_DIR

    present = [name for name in ASSETS_WEIGHTS if (WEIGHTS_DIR / name).exists()]
    if present:
        fail(f"assets: weights/ already holds {present}; this phase writes random weights there and stops "
             "rather than overwrite them")
    created = not WEIGHTS_DIR.exists()
    try:
        return assets_run(torch, kernels, protocol)
    finally:
        for name in ASSETS_WEIGHTS:
            (WEIGHTS_DIR / name).unlink(missing_ok=True)
        if created and WEIGHTS_DIR.exists() and not any(WEIGHTS_DIR.iterdir()):
            WEIGHTS_DIR.rmdir()
        for name in ("published", "reference", "checkpoints"):  # ~2.5 GB of weights
            shutil.rmtree(ASSETS_DIR / name, ignore_errors=True)


def assets_run(torch, kernels, protocol: dict) -> dict:
    from pixelsplat_tpu_torch import main as cli
    from pixelsplat_tpu_torch.config import EXPERIMENTS
    from pixelsplat_tpu_torch.evaluation import lpips as lpips_consts
    from pixelsplat_tpu_torch.evaluation.lpips import load_lpips, load_lpips_published
    from pixelsplat_tpu_torch.evaluation.metrics import compute_psnr, compute_ssim
    from pixelsplat_tpu_torch.interop.pretrained import WEIGHTS_DIR, init_backbone_from_pretrained
    from pixelsplat_tpu_torch.scripts import export_weights, make_fixture_chunk
    from pixelsplat_tpu_torch.scripts.eval_scene import card_line
    from pixelsplat_tpu_torch.scripts.write_checkpoint import write_checkpoint
    from pixelsplat_tpu_torch.training.checkpoint import load_checkpoint
    from pixelsplat_tpu_torch.training.model_wrapper import ModelWrapper
    from pixelsplat_tpu_torch.training.trainer import RESULTS_NAME

    shutil.rmtree(ASSETS_DIR, ignore_errors=True)

    # (a) The fixture, regenerated and held against the checked-in one.
    t0 = time.perf_counter()
    fixture = ASSETS_DIR / "fixtures" / "re10k"
    make_fixture_chunk.main(["--out", str(fixture)])
    stats = make_fixture_chunk.compare_fixtures(fixture, FIXTURE / "re10k")
    index_path = fixture.parent / "evaluation_index_fixture.json"
    same_eval_index = json.loads(index_path.read_text()) == json.loads(
        (FIXTURE / "evaluation_index_fixture.json").read_text())
    fixture_s = time.perf_counter() - t0
    phase("assets", f"(a) fixture regenerated into {fixture.relative_to(ROOT)}: {stats['identical_share']:.3f} of "
          f"{stats['frames']} JPEGs byte-identical to tests/fixtures/re10k, largest frame difference "
          f"{stats['max_levels']} levels (largest mean {stats['max_mean_levels']:.4f}); keys, urls, timestamps and "
          f"cameras {'equal' if stats['same_metadata'] else 'DIFFER'}, index.json "
          f"{'equal' if stats['same_index'] else 'DIFFERS'}, evaluation index {'equal' if same_eval_index else 'DIFFERS'}")
    if not (stats["same_metadata"] and stats["same_index"] and same_eval_index
            and stats["max_mean_levels"] <= FIXTURE_MEAN_LEVELS):
        fail(f"assets: the regenerated fixture differs from the checked-in one: {stats}")

    # (b) The weights: published layouts through the export script.
    t0 = time.perf_counter()
    reference_ckpt = write_checkpoint(ASSETS_DIR / "reference", RE10K, SEED)  # [eval_protocol]'s weights
    reference = load_checkpoint(reference_ckpt)["params"]
    files = published_layouts(torch, reference, ASSETS_DIR / "published", SEED)
    written = export_weights.main([
        "--lpips-lin", str(files["lin"]), "--vgg16", str(files["vgg"]),
        "--dino-vit", f"dino_vitb8={files['vit']}", "--dino-resnet50", str(files["resnet"]),
    ])
    if sorted(p.name for p in written) != sorted(ASSETS_WEIGHTS) or any(p.parent != WEIGHTS_DIR for p in written):
        fail(f"assets: export_weights wrote {written}")
    npz = load_lpips().cuda().state_dict()
    direct = load_lpips_published(files["lin"], files["vgg"]).state_dict()
    # One full `lpips.LPIPS(net="vgg").state_dict()` of the same weights.
    full = {"scaling_layer.shift": torch.tensor(lpips_consts.SHIFT)[None, :, None, None],
            "scaling_layer.scale": torch.tensor(lpips_consts.SCALE)[None, :, None, None],
            **direct, **torch.load(files["lin"], weights_only=True)}
    from_full = load_lpips_published(state_dict=full).cuda().state_dict()
    direct = {k: v.cuda() for k, v in direct.items()}
    lpips_differ = [k for k, v in direct.items() if not (torch.equal(v, npz[k]) and torch.equal(v, from_full[k]))]
    grafted = ModelWrapper(*EXPERIMENTS[RE10K][0]())
    n_grafted = init_backbone_from_pretrained(grafted.encoder)
    trunk_state = grafted.encoder.state_dict()
    trunk_keys = [k for k in trunk_state if k.startswith(("backbone.dino.", "backbone.resnet_backbone.model."))]
    graft_differ = [k for k in trunk_keys if not torch.equal(trunk_state[k].cpu(), reference[k].cpu())]
    del grafted, trunk_state
    weights_s = time.perf_counter() - t0
    sizes = {p.name: round(p.stat().st_size / 2**20, 1) for p in written}
    phase("assets", f"(b) export_weights from the published layouts wrote {sizes} MiB; LPIPS on the card: npz route "
          f"against the direct read (lin file + VGG16) and the full state_dict, {len(direct)} tensors, "
          f"{len(lpips_differ)} differ; DINO: {n_grafted} trunk tensors grafted ({files['vit_tensors']} ViT-B/8 "
          f"tensors, {files['resnet_tensors']} in the hub ResNet-50 file), {len(graft_differ)} of {len(trunk_keys)} "
          f"differ from the seeded checkpoint's")
    if lpips_differ or graft_differ or n_grafted != len(trunk_keys):
        fail(f"assets: LPIPS routes differ at {lpips_differ[:3]}, grafted trunk differs at {graft_differ[:3]}, "
             f"{n_grafted} grafted of {len(trunk_keys)}")

    # (c) The protocol on the regenerated fixture, the backbone from the
    # DINO npz (grafted by `init_state` on top of the seeded weights) and
    # LPIPS from the LPIPS npz.
    t0 = time.perf_counter()
    checkpoint = write_checkpoint(ASSETS_DIR / "checkpoints", RE10K, SEED)
    params = load_checkpoint(checkpoint)["params"]
    ckpt_differ = [k for k, v in params.items() if not torch.equal(v, reference[k])]
    if ckpt_differ or params.keys() != reference.keys():
        fail(f"assets: the checkpoint with the grafted backbone differs from [eval_protocol]'s at {ckpt_differ[:3]}")
    argv = [
        "+experiment=re10k", "mode=test", f"dataset.roots=[{fixture}]", "dataset/view_sampler=evaluation",
        f"dataset.view_sampler.index_path={index_path}", f"test.output_path={ASSETS_DIR / 'test'}",
        f"output_dir={ASSETS_DIR / 'outputs'}", f"checkpointing.load={checkpoint}",
    ]
    reset_launches(kernels)
    with watched_protocol() as seen:
        t1 = time.perf_counter()
        summary = cli.main(argv)
        run_s = time.perf_counter() - t1
    launches = launch_counts(kernels)
    phase("assets", f"(c) main +experiment=re10k mode=test on {fixture.relative_to(ROOT)} in {run_s:.1f} s: {summary}")
    n_scenes = len(protocol["renders"])
    finite = all(summary[k] is not None and math.isfinite(summary[k]) for k in ("psnr", "ssim", "lpips"))
    if summary["num_scenes"] != n_scenes or summary["overflow_pairs"] != 0 or not finite:
        fail(f"assets: {summary['num_scenes']} scenes, {summary['overflow_pairs']} dropped pairs, scores {summary}")
    if launches["composite_fwd"] != 3 * n_scenes or any(n for k, n in launches.items() if k != "composite_fwd"):
        fail(f"assets: kernel launches {launches}, expected composite_fwd once per target view")
    if [e["gaussians"] for e in seen["encode"]] != [2 * 256 * 256 * 3] * n_scenes:
        fail(f"assets: Gaussians per scene {[e['gaussians'] for e in seen['encode']]}")

    # Against [eval_protocol]'s renders on the checked-in fixture: the same
    # weights, seed and program. Byte-identical JPEGs give the same inputs,
    # so the scores agree to the card's run-to-run noise; otherwise to a
    # bound from the largest frame difference d (in [0, 1]) that (a)
    # measured: a ground truth and a render each moved by at most d move a
    # view's RMSE by at most 2 d, its PSNR by at most 20 log10(1 + 2 d /
    # RMSE), and (an assumed sensitivity of one) its SSIM by 2 d.
    d = 0.0 if stats["identical_share"] == 1.0 else stats["max_levels"] / 255
    worst = {"psnr": 0.0, "ssim": 0.0, "psnr_bound": 0.0}
    lpips_module = load_lpips_published(files["lin"], files["vgg"]).eval().cuda()
    pairs = []
    for e, dec, ref in zip(seen["encode"], seen["decode"], protocol["renders"]):
        gt, color = e["batch"]["target"]["image"][0], dec["color"][0]
        psnr, ssim = compute_psnr(gt, color).cpu(), compute_ssim(gt, color).cpu()
        psnr_ref, ssim_ref = compute_psnr(ref["gt"], ref["color"]), compute_ssim(ref["gt"], ref["color"])
        rmse = ((ref["gt"] - ref["color"].clamp(0, 1)) ** 2).mean(dim=(1, 2, 3)).sqrt()
        psnr_bound = EVAL_PSNR_ATOL_DB + 20 * torch.log10(1 + 2 * d / rmse)
        psnr_off, ssim_off = (psnr - psnr_ref).abs(), (ssim - ssim_ref).abs()
        if bool((psnr_off > psnr_bound).any()) or bool((ssim_off > EVAL_SSIM_ATOL + 2 * d).any()):
            fail(f"assets: PSNR per view {psnr.tolist()} against [eval_protocol]'s {psnr_ref.tolist()} "
                 f"(bound {psnr_bound.tolist()}), SSIM {ssim.tolist()} against {ssim_ref.tolist()}")
        worst = {"psnr": max(worst["psnr"], float(psnr_off.max())), "ssim": max(worst["ssim"], float(ssim_off.max())),
                 "psnr_bound": max(worst["psnr_bound"], float(psnr_bound.max()))}
        pairs.append((gt, color))
    with torch.no_grad():
        lpips_card = [lpips_module(gt, color).cpu() for gt, color in pairs]
        lpips_module.cpu()
        lpips_cpu = [lpips_module(gt.cpu(), color.cpu()) for gt, color in pairs]
    card_values, cpu_values = torch.cat(lpips_card), torch.cat(lpips_cpu)
    lpips_rel = float(((card_values - cpu_values).abs() / cpu_values.abs()).max())
    scene_means = [float(v.mean()) for v in lpips_card]
    summary_rel = abs(sum(scene_means) / len(scene_means) - summary["lpips"]) / abs(summary["lpips"])
    phase("assets", f"(c) against [eval_protocol] on the checked-in fixture: PSNR per view off by at most "
          f"{worst['psnr']:.3g} dB (bound {worst['psnr_bound']:.3g}), SSIM by {worst['ssim']:.3g} (bound "
          f"{EVAL_SSIM_ATOL + 2 * d:.3g}); LPIPS (direct read) per view card {card_values.tolist()} against CPU "
          f"{cpu_values.tolist()}: largest relative difference {lpips_rel:.3g} (limit {ASSETS_LPIPS_RTOL}; "
          f"{int((card_values != cpu_values).sum())} of {len(card_values)} values not bit-equal), the summary's LPIPS (npz) "
          f"against the card's direct read {summary_rel:.3g}; composite_fwd launched {launches['composite_fwd']} times")
    if not (bool(torch.isfinite(card_values).all()) and lpips_rel <= ASSETS_LPIPS_RTOL
            and summary_rel <= ASSETS_LPIPS_RTOL):
        fail(f"assets: LPIPS card {card_values.tolist()}, CPU {cpu_values.tolist()}, summary {summary['lpips']}")
    protocol_s = time.perf_counter() - t0

    bench = json.loads((ASSETS_DIR / "test" / RESULTS_NAME / "benchmark.json").read_text())
    per_scene = [1e3 * (enc + sum(bench["decoder"][3 * i: 3 * i + 3])) for i, enc in enumerate(bench["encoder"])]
    phase("timing", f"assets | {card_line()} | (a) fixture {fixture_s:.1f} s | (b) weights {weights_s:.1f} s | "
          f"(c) protocol {protocol_s:.1f} s (main {run_s:.1f} s) | protocol ms per scene (encoder + 3 views) "
          f"{[round(t, 3) for t in per_scene]}")
    return {"launches": launches, "lpips_rel": lpips_rel, "identical_share": stats["identical_share"]}


def gc_cuda(torch) -> None:
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def main() -> None:
    if not (ROOT / "pixelsplat_tpu_torch").is_dir():
        fail("pixelsplat_tpu_torch/ not found beside chip_smoke.py: run from a checkout")
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs an NVIDIA GPU")

    from pixelsplat_tpu_torch import kernel_build
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
        "composite_fwd": "k1_launches",
        "composite_bwd": "k2_launches",
        "copy_rows": "copy_rows_launches",
        "composite_fwd_ablation": "k1_ablation_launches",
        "smoke_scale": "smoke_scale_launches",
    }
    if set(built) != set(kernels) | {"project_bin", "conv7", "linear_split", "conv3x3"}:
        fail(f"built {sorted(built)}, expected the kernels {sorted(kernels)}, project_bin, conv7, linear_split "
             f"and conv3x3")
    for name, (path, log) in built.items():
        regs = [line.strip() for line in log.splitlines() if "registers" in line]
        phase("build", f"{name} -> {path.relative_to(ROOT)} {regs[0] if regs else ''}")
    phase("build", f"{len(built)} kernel(s) in {build_s:.2f} s")

    # 3. smoke: the tools' first entry point
    reset_launches(kernels)
    smoke = kernel_smoke.run_smoke()
    smoke_launches = launch_counts(kernels)
    if smoke["mean"] != 2.0 or smoke["scale_max_err"] != 0.0:
        fail(f"smoke_scale: mean {smoke['mean']}, max error {smoke['scale_max_err']} against x * 2")
    if not smoke["composite_max_err"] <= SMOKE_COMPOSITE_ATOL:
        fail(f"composite_fwd on the smoke input: {smoke['composite_max_err']:.3g} > {SMOKE_COMPOSITE_ATOL}")
    if smoke_launches["smoke_scale"] != 1 or smoke_launches["composite_fwd"] != 1:
        fail(f"the smoke phase launched {smoke_launches}")

    # 4. both models, each through scene, kernels, references, training, timing
    results = {model: model_phases(torch, kernels, model, SEED) for model in (ABLATION, RE10K)}

    # projection, binning and the probe's count against their plain versions
    prep = project_bin_phase(torch)

    # the refinement's two 7x7 convolutions against float64 and cuDNN
    conv7 = conv7_phase(torch)

    # the ViT's four linear layers against float64 and cuBLAS
    linear = linear_phase(torch)

    # MVSplat's 3x3 convolutions against float64 and cuDNN
    conv3 = conv3x3_phase(torch)

    # 5. the evaluation protocol through the CLI's entry point
    protocol = eval_protocol_phase(torch, kernels)

    # 6. tools, on the production model's first view
    tools = tools_phase(torch, kernels, results[RE10K]["first_view"])

    # 7. training through the CLI's entry point, resumed, and with the depth loss
    training = train_protocol_phase(torch, kernels)

    # 8. the other shipped experiments and the encoder's default config
    experiments = experiments_phase(torch, kernels, SEED)

    # 9. the bf16 compute policy against f32
    bf16 = bf16_phase(torch, kernels, SEED)

    # 10. the .psz route through the CLI, three context views
    native = native_phase(torch, kernels)

    # 11. across processes: two gloo ranks on the card, then main over NCCL
    distributed = distributed_phase(torch, kernels, training["run_a_first_loss"])

    # 12. the evaluation tools on the fixture and on [eval_protocol]'s PNGs
    eval_tools_phase(torch, protocol["renders"])

    # 13. training's extended visualization through the CLI, and the smoke scripts
    visualization = visualization_phase(torch, kernels)

    # 14. the reference-checkpoint route, the parity runbook, the paper's figures and tables
    paper = paper_phase(torch, kernels)

    # 15. the weight import, the fixture generator and the protocol on both (last: it writes into weights/)
    gc_cuda(torch)
    assets = assets_phase(torch, kernels, protocol)

    by_path = {"tools": {name: smoke_launches[name] + tools["launches"][name] for name in kernels}}
    by_path["eval_protocol"] = protocol["launches"]
    by_path.update(training["launches"])
    by_path.update(experiments["launches"])
    by_path["bf16"] = bf16["launches"]
    by_path["native re10k_3_view eval_protocol"] = native["launches"]
    by_path.update(distributed["launches"])
    by_path.update(visualization["launches"])
    by_path.update(paper["launches"])
    by_path["assets"] = assets["launches"]
    for model, r in results.items():
        for path, counts in r["launches"].items():
            by_path[f"{model} {path}"] = counts

    def depth_numbers(r):
        """A compositing kernel on the depth renders of `re10k_depth_loss`
        (one colour channel): ms, plain ms, bound ms, what binds, max |err|."""
        return dict(depth_ms=r[0], depth_plain_ms=r[1], depth_bound_ms=r[2], depth_bound_by=r[3], depth_max_abs_err=r[4])

    def entry(name, source, replaces, **numbers):
        per_path = {path: counts[name] for path, counts in by_path.items() if counts[name]}
        return {
            "name": name, "route": "cuda", "source": f"pixelsplat_tpu_torch/csrc/{source}", "replaces": replaces,
            "launches": sum(per_path.values()), "launches_by_path": per_path, **numbers,
        }

    main_model = results[RE10K]  # the production model's inputs give the record's times
    copy_main, copy_transposed = tools["copy_rows"][:2]  # the 16-bit table, contiguous and transposed
    scale = tools["scale"]
    layout_keys = ("route", "ms", "library_ms", "device_ms", "library_device_ms", "host_us", "bound_ms")
    record = {
        "kernels": [
            entry(
                "composite_fwd", "composite_fwd.cu", "pixelsplat_tpu/ops/rasterizer/pallas_composite.py:281",
                max_abs_err=max([r["fwd_err"] for r in results.values()] + [experiments["fwd_err"], visualization["fwd_err"]]),
                ms=main_model["fwd"][0],
                plain_ms=main_model["fwd"][1], bound_ms=main_model["fwd"][2], bound_by=main_model["fwd"][3],
                longest_tile_ms=main_model["fwd"][4],
                library_ms=None, ms_by_model={m: r["fwd"][0] for m, r in results.items()},
                experiments_view0={m: dict(ms=x["k1_ms"], plain_ms=x["k1_plain_ms"], bound_ms=x["k1_bound"][0],
                                           bound_by=x["k1_bound"][1]) for m, x in experiments["scenes"].items()},
                **depth_numbers(training["depth_fwd"]),
                visualization=visualization["k1"],
                paper=dict(densest=paper["k1"], figures=paper["figures"]),
                alpha_cuts={f: {k: c[k] for k in ("pixels_beyond", "tiles_n_proc_differ", "max_abs_err")}
                            for f, c in paper["alpha_cuts"].items()},
            ),
            entry(
                "composite_bwd", "composite_bwd.cu", "pixelsplat_tpu/ops/rasterizer/pallas_backward.py:234",
                max_abs_err=max([r["bwd_abs_err"] for r in results.values()] + [experiments["bwd_abs_err"]]),
                # Relative to each d_table column's largest |gradient|, the check's measure; both
                # errors are over all rows, those of explained threshold pairs included.
                max_rel_err=max([r["bwd_err"] for r in results.values()] + [experiments["bwd_err"]]),
                threshold_tiles=sum(r["bwd_tiles"] for r in results.values()) + experiments["bwd_tiles"],
                ms=main_model["bwd"][0],
                plain_ms=main_model["bwd"][1], bound_ms=main_model["bwd"][2], bound_by=main_model["bwd"][3],
                longest_tile_ms=main_model["bwd"][4],
                library_ms=None, ms_by_model={m: r["bwd"][0] for m, r in results.items()},
                **depth_numbers(training["depth_bwd"]), depth_max_rel_err=training["depth_bwd"][5],
                experiments_view0={m: dict(ms=x["k2_ms"], plain_ms=x["k2_plain_ms"], bound_ms=x["k2_bound"][0],
                                           bound_by=x["k2_bound"][1]) for m, x in experiments["steps"].items()},
                alpha_cuts={f: {k: c[k] for k in ("bwd_rows_beyond", "bwd_max_rel_err")}
                            for f, c in paper["alpha_cuts"].items()},
            ),
            entry(
                "copy_rows", "copy_rows.cu", "tools/bench_segment_sum.py:112",
                max_abs_err=max(r["max_abs_err"] for r in tools["copy_rows"]), ms=copy_main["ms"],
                plain_ms=copy_main["library_ms"], bound_ms=copy_main["bound_ms"], bound_by="bytes",
                library_ms=copy_main["library_ms"], device_ms=copy_main["device_ms"],
                library_device_ms=copy_main["library_device_ms"], host_us=copy_main["host_us"],
                ms_transposed=copy_transposed["ms"],
                library_ms_transposed=copy_transposed["library_ms"],
                layouts={r["label"]: {k: r[k] for k in layout_keys} for r in tools["copy_rows"]},
                edge_routes={r["label"]: r["route"] for r in tools["copy_edges"]},
            ),
            entry(
                "composite_fwd_ablation", "composite_fwd_ablation.cu", "tools/bench_kernel_ablation.py:309",
                max_abs_err=tools["full_err"], ms=tools["variant_ms"]["full"], plain_ms=tools["full_plain_ms"],
                bound_ms=tools["full_bound"][0], bound_by=tools["full_bound"][1], library_ms=None,
                ms_by_variant=tools["variant_ms"],
            ),
            entry(
                "smoke_scale", "smoke_scale.cu", "tools/pallas_smoke.py:10",
                max_abs_err=max(smoke["scale_max_err"], scale["max_abs_err"]), ms=scale["ms"],
                plain_ms=scale["plain_ms"], bound_ms=scale["bound_ms"], bound_by="bytes",
                library_ms=scale["library_ms"], device_ms=scale["device_ms"],
                library_device_ms=scale["library_device_ms"], host_us=scale["host_us"],
            ),
        ]
    }
    main_prep = prep["models"][RE10K]
    for stage, launches in zip(("project", "bin", "occupancy"), prep["scene_launches"]):
        t = main_prep["times"][stage]
        record["kernels"].append({
            "name": f"project_bin.{stage}", "route": "cuda", "source": "pixelsplat_tpu_torch/csrc/project_bin.cu",
            "replaces": "no Pallas kernel: pixelsplat_tpu/ops/rasterizer/projection.py, binning.py (plain array code)",
            "launches": launches, "launches_by_path": {"re10k scene": launches}, "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": "bytes", "library_ms": None,
            "ms_by_model": {m: r["times"][stage]["ms"] for m, r in prep["models"].items()},
        })
    c7 = conv7["scenes"]
    record["kernels"].append({
        "name": "conv7", "route": "cuda", "source": "pixelsplat_tpu_torch/csrc/conv7.cu",
        "replaces": "no Pallas kernel: pixelsplat_tpu/model/encoder/epipolar/epipolar_transformer.py "
                    "upscale_refinement (XLA convolutions)",
        "launches": conv7["scene_launches"], "launches_by_path": {"re10k scene": conv7["scene_launches"]},
        **{k: c7[RE10K]["scene"][k] for k in ("ms", "bound_ms", "plain_ms", "library_ms", "library_best_ms")},
        "bound_by": "operations (3xTF32, 165 TFLOP/s)",
        "max_rel_rms_err": max(v["errors"]["k9"] for r in c7.values() for v in r["launches"].values()),
        "by_scene": {name: {**r["scene"], "launches": {k: {m: v[m] for m in ("ms", "library_ms", "library_best_ms")}
                                                       for k, v in r["launches"].items()}}
                     for name, r in c7.items()},
    })
    lin = linear["scenes"]
    record["kernels"].append({
        "name": "linear_split", "route": "cuda", "source": "pixelsplat_tpu_torch/csrc/linear_split.cu",
        "replaces": "no Pallas kernel: pixelsplat_tpu/model/encoder/backbone/dino.py (XLA matrix products)",
        "launches": sum(linear["scene_launches"].values()), "launches_by_path": linear["scene_launches"],
        **{k: lin[RE10K]["scene"][k] for k in ("ms", "bound_ms", "library_ms")},
        "bound_by": "operations (3xTF32, 165 TFLOP/s)",
        "max_rel_rms_err": max(v["errors"]["k10"] for r in lin.values() for v in r["layers"].values()),
        "by_scene": {name: {**r["scene"], "layers": {k: {m: v[m] for m in ("ms", "library_ms", "width")}
                                                     for k, v in r["layers"].items()}}
                     for name, r in lin.items()},
    })
    c3 = conv3["record"]
    record["kernels"].append({
        "name": "conv3x3", "route": "cuda", "source": "pixelsplat_tpu_torch/csrc/conv3x3.cu",
        "replaces": "no Pallas kernel: the JAX package has no MVSplat encoder (cuDNN float32 convolutions)",
        "launches": conv3["scene_launches"], "launches_by_path": {"mvsplat scene": conv3["scene_launches"]},
        **{k: c3["scene"][k] for k in ("ms", "bound_ms", "plain_ms", "library_ms")},
        "bound_by": "operations (3xTF32, 165 TFLOP/s)",
        "max_rel_rms_err": max(s["errors"]["k11"] for s in c3["shapes"]),
        "by_shape": {s["shape"]: {m: s[m] for m in ("count", "ms", "bound_ms", "library_ms")} for s in c3["shapes"]},
    })
    for k in record["kernels"]:
        if k["launches"] == 0:
            fail(f"{k['name']} was launched no time on any path")
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
