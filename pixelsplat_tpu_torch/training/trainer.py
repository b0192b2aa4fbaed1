"""The trainer: the training loop and the evaluation protocol.

Port of `pixelsplat_tpu/training/trainer.py`: `TrainerCfg` and the
`Trainer` with `fit`, `validation_step` (with the extended visualization:
the Gaussian projections, the camera diagram, the encoder's figures and
the wobble and interpolation videos) and `test`.

`fit` takes optimizer steps (`ModelWrapper.make_train_step`, with
`accumulate_grad_batches` micro-batches per update) over the data module's
train stream, tells the step tracker every step (the bounded view sampler's
curriculum reads it, in forked workers too), logs the step's losses every
`log_every_n_steps`, validates on one batch every `val_check_interval`,
saves a checkpoint every `every_n_train_steps` and at the end, and resumes
from `resume_from` or `checkpointing.load`: parameters, Adam's moments and
the step. Its Benchmarker times every wait for a train batch ("data"), each
step ("step", ending in a device sync), each micro-batch's "forward" and
"backward" and the "optimizer" (device clock), each validation pass and
checkpoint save; `fit` writes the times to `output_dir/benchmark.json` and
the device's memory stats to `output_dir/peak_memory.json`, as `test` does
under its output path.

Across processes (`torch.distributed`, one process per GPU) every rank
runs every step on its own stream of the data module (built with the
rank and world size) and the step averages the gradients over the group;
only rank 0 logs, validates, saves checkpoints and writes `benchmark.json`
and `peak_memory.json`, as the JAX `fit` gates them on `process_index`.
`test` splits the scenes over the ranks by chunk, as the data module does,
and each rank writes its own scenes' PNGs and returns the summary of its
own scenes, as every process of the JAX `Trainer.test` does (no gather);
rank 0 writes the benchmark files.

Randomness. A step's depth-sampling uniforms come from one
`torch.Generator` on the wrapper's device, seeded `seed + 7` anew at every
`fit` (on rank r, `parallel.distributed.rank_seed(seed + 7, r)`: rank 0
draws what one process draws), resumed or not, as the JAX package splits
`PRNGKey(seed + 7)` once per step and folds the device's index into it;
validation encodes from a generator seeded with the step, as the
JAX package's `PRNGKey(step)`; the test protocol's uniforms come from a
generator seeded `seed + 31`, one draw per scene. The two packages draw
different numbers from the same seeds. The train stream is the data
module's: past its first pass, an inline stream goes on drawing from one
generator, where the JAX package's inline stream builds its dataset anew,
re-seeded, for every pass. The port's inline stream behaves as the JAX
package's worker processes do, and the shipped config trains with 16
workers.

The test protocol encodes each scene with the PROBABILISTIC encoder, as
the published metrics do, renders all of its target views in chunks of 32
at settings chosen from the scene's tile occupancy, scores PSNR, SSIM and
LPIPS (LPIPS only with pretrained weights on disk), saves the renders as
PNGs, and dumps the encoder and decoder times and the device's memory
stats.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, Optional

import numpy as np
import torch
from PIL import Image

from ..dataset.data_module import DataModule
from ..evaluation.lpips import get_lpips, load_lpips
from ..evaluation.metrics import compute_psnr, compute_ssim
from ..ops.rasterizer.projection import GaussiansSoA, pack_gaussians_soa
from ..parallel.distributed import is_rank_zero, rank_and_world, rank_seed
from ..utils.benchmarker import Benchmarker
from ..utils.local_logger import LocalLogger
from ..utils.step_tracker import StepTracker
from ..visualization.annotation import add_label
from ..visualization.layout import add_border, hcat, vcat
from .checkpoint import load_checkpoint, save_checkpoint
from .model_wrapper import CheckpointingCfg, ModelWrapper, TrainState, batch_to, effective_accumulate

# Directory under `test.output_path` that holds this package's results.
RESULTS_NAME = "pixelsplat_tpu"


@dataclass(frozen=True)
class TrainerCfg:
    max_steps: int = -1
    val_check_interval: int = 250
    gradient_clip_val: float = 0.5
    log_every_n_steps: int = 10
    # Split each batch into this many micro-batches whose mean gradient
    # makes one update (`ModelWrapper.make_train_step(accumulate=)`).
    accumulate_grad_batches: int = 1


def _strip_non_arrays(batch: dict) -> dict:
    """The batch without its leaves that are not arrays (scene names)."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, dict):
            out[k] = _strip_non_arrays(v)
        elif isinstance(v, (np.ndarray, torch.Tensor)):
            out[k] = v
    return out


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def wobble_cameras(batch: dict, num_frames: int) -> tuple[np.ndarray, np.ndarray]:
    """(extrinsics (n, 4, 4), intrinsics (n, 3, 3)) of the wobble video: a
    circle around the first context camera of batch element 0, its radius
    growing to a quarter of the context baseline."""
    from ..visualization.camera_trajectory.wobble import generate_wobble

    extr = _host(batch["context"]["extrinsics"][0])
    intr = _host(batch["context"]["intrinsics"][0])
    delta = float(np.linalg.norm(extr[0, :3, 3] - extr[-1, :3, 3]))
    t = np.linspace(0, 1, num_frames).astype(np.float32)
    return generate_wobble(extr[0], np.asarray(delta * 0.25), t), np.broadcast_to(intr[0], (num_frames, 3, 3))


def interpolation_cameras(batch: dict, num_frames: int) -> tuple[np.ndarray, np.ndarray]:
    """(extrinsics, intrinsics) of the interpolation video: from the first
    context camera of batch element 0 to its last."""
    from ..visualization.camera_trajectory.interpolation import interpolate_extrinsics, interpolate_intrinsics

    extr = _host(batch["context"]["extrinsics"][0])
    intr = _host(batch["context"]["intrinsics"][0])
    t = np.linspace(0, 1, num_frames).astype(np.float32)
    return interpolate_extrinsics(extr[0], extr[-1], t), interpolate_intrinsics(intr[0], intr[-1], t)


@torch.no_grad()
def render_frames(
    decoder,
    gaussians,  # Gaussians, batch element 0 rendered
    cameras: torch.Tensor,  # (n, 4, 4)
    intrinsics: torch.Tensor,  # (n, 3, 3)
    near: torch.Tensor,  # ()
    far: torch.Tensor,  # ()
    image_shape: tuple[int, int],
) -> tuple[torch.Tensor, list[int]]:
    """The frames of a video: batch element 0's Gaussians packed once and
    rendered through `decoder` one camera at a time (one compositing launch
    each). Returns ((n, 3, h, w) frames, dropped pairs per frame)."""
    soa = pack_gaussians_soa(gaussians.means[0], gaussians.covariances[0], gaussians.opacities[0],
                             harmonics=gaussians.harmonics[0])
    soa = GaussiansSoA(*(None if x is None else x[None] for x in soa))  # the batch axis the decoder reads
    frames, overflow = [], []
    for i in range(cameras.shape[0]):
        out = decoder(soa, cameras[None, i : i + 1], intrinsics[None, i : i + 1], near.reshape(1, 1),
                      far.reshape(1, 1), image_shape)
        frames.append(out.color[0, 0])
        overflow.append(out.overflow)
    return torch.stack(frames), [int(x) for x in torch.stack(overflow).cpu()]


class Trainer:
    def __init__(
        self,
        cfg: TrainerCfg,
        wrapper: ModelWrapper,
        data_module: DataModule,
        checkpointing: CheckpointingCfg,
        output_dir: Path,
        step_tracker: Optional[StepTracker] = None,
        logger: Optional[LocalLogger] = None,
        seed: int = 0,
    ):
        self.cfg = cfg
        self.wrapper = wrapper
        self.data_module = data_module
        self.checkpointing = checkpointing
        self.output_dir = Path(output_dir)
        self.step_tracker = step_tracker
        self.logger = logger or LocalLogger(self.output_dir / "local")
        self.seed = seed
        self.benchmarker = Benchmarker(wrapper.device)
        # The extended visualization's failures, each "artifact: error"
        # (training goes on past them), and what each validation drew.
        self.visualization_failures: list[str] = []
        self.visualization_log: list[dict] = []

    # ------------------------------------------------------------------
    def fit(self, resume_from: Optional[Path] = None) -> TrainState:
        """Train until `max_steps` (forever when negative); returns the
        final state."""
        wrapper = self.wrapper
        bench = self.benchmarker
        train_iter = iter(self.data_module.train_dataloader())
        with bench.time("data"):
            batch = next(train_iter)
        state = wrapper.init_state()
        if resume_from is None and self.checkpointing.load is not None:
            resume_from = Path(self.checkpointing.load)
        if resume_from is not None:
            state = wrapper.load_state_dict(state, load_checkpoint(resume_from))
            print(f"Resumed from {resume_from} at step {state.step}")

        rank, _ = rank_and_world()
        rank_zero = rank == 0
        accumulate = effective_accumulate(len(batch["context"]["image"]), self.cfg.accumulate_grad_batches)
        step_fn = wrapper.make_train_step(accumulate=accumulate, benchmarker=bench)
        generator = torch.Generator(device=wrapper.device).manual_seed(rank_seed(self.seed + 7, rank))
        every = self.checkpointing.every_n_train_steps
        step = state.step
        val_iter: Optional[Iterator] = None
        while self.cfg.max_steps < 0 or step < self.cfg.max_steps:
            with bench.time("step"):
                state, parts = step_fn(state, batch_to(_strip_non_arrays(batch), wrapper.device), generator=generator)
                bench.sync()
            step = state.step
            if self.step_tracker is not None:
                self.step_tracker.set_step(step)

            if rank_zero and step % self.cfg.log_every_n_steps == 0:
                host = {k: float(v) for k, v in parts.items()}
                self.logger.log_metrics(host, step=step)
                print(f"step {step}; " + "; ".join(f"{k}={v:.4f}" for k, v in host.items()))

            if rank_zero and every > 0 and step % every == 0:
                with bench.time("checkpoint"):
                    path = save_checkpoint(self.output_dir / "checkpoints", step, wrapper.state_dict(state))
                print(f"Saved checkpoint {path}")
                self.logger.log_model(path, step=step)

            if rank_zero and self.cfg.val_check_interval > 0 and step % self.cfg.val_check_interval == 0:
                if val_iter is None:
                    val_iter = iter(self.data_module.val_dataloader())
                try:
                    val_batch = next(val_iter)
                except StopIteration:
                    val_iter = None
                else:
                    with bench.time("validation"):
                        self.validation_step(state, val_batch, step)

            with bench.time("data"):
                batch = next(train_iter)

        if rank_zero:
            if not (every > 0 and step % every == 0):
                # The periodic save already wrote this step otherwise.
                with bench.time("checkpoint"):
                    save_checkpoint(self.output_dir / "checkpoints", step, wrapper.state_dict(state))
            bench.dump(self.output_dir / "benchmark.json")
            bench.dump_memory(self.output_dir / "peak_memory.json")
        return state

    # ------------------------------------------------------------------
    def validation_step(self, state: TrainState, batch: dict, step: int) -> dict:
        """Probabilistic and deterministic renders of the batch's target
        views: PSNR, SSIM (and LPIPS with pretrained weights) per variant,
        and the comparison grid (context | target | probabilistic |
        deterministic) through the logger; with
        `train.extended_visualization`, also `extended_visualization`."""
        wrapper = self.wrapper
        arrays = batch_to(_strip_non_arrays(batch), wrapper.device)
        target = arrays["target"]
        b, v, c, h, w = target["image"].shape
        encode = wrapper.make_eval_encode()

        colors, gaussians = {}, {}
        with torch.no_grad():
            for name, deterministic in (("probabilistic", False), ("deterministic", True)):
                generator = torch.Generator(device=wrapper.device).manual_seed(step)
                gaussians[name] = encode(arrays, deterministic, state.step, generator=generator)
                colors[name] = wrapper.decoder(
                    gaussians[name], target["extrinsics"], target["intrinsics"], target["near"], target["far"],
                    (h, w),
                ).color

            metrics = {}
            flat_gt = target["image"].reshape(b * v, c, h, w)
            lpips = load_lpips()  # pretrained weights only: never a metric from random ones
            if lpips is not None:
                lpips = lpips.eval().to(wrapper.device)
            for name, color in colors.items():
                flat = color.reshape(b * v, c, h, w)
                metrics[f"val/psnr_{name}"] = float(compute_psnr(flat_gt, flat).mean())
                metrics[f"val/ssim_{name}"] = float(compute_ssim(flat_gt, flat).mean())
                if lpips is not None:
                    metrics[f"val/lpips_{name}"] = float(lpips(flat_gt, flat).mean())
        self.logger.log_metrics(metrics, step=step)

        def row(images: torch.Tensor, label: str) -> np.ndarray:
            return add_label(hcat(*images.detach().cpu().numpy()), label)

        rows = [row(arrays["context"]["image"][0], "Context"), row(target["image"][0], "Target (GT)")]
        rows += [row(color[0], f"Target ({name})") for name, color in colors.items()]
        self.logger.log_image("comparison", add_border(vcat(*rows)), step=step)
        if wrapper.train_cfg.extended_visualization:
            self.extended_visualization(arrays, gaussians["deterministic"], step)
        print("validation;", "; ".join(f"{k}={x:.3f}" for k, x in metrics.items()))
        return metrics

    # ------------------------------------------------------------------
    def extended_visualization(self, arrays: dict, gaussians, step: int) -> dict:
        """The JAX validation's extended figures, each through the logger:
        "projections" (the deterministic Gaussians from three orthographic
        cameras), "cameras" (the frusta's XY projection), "encoder/<name>"
        for each encoder figure, "video/wobble" and "video/interpolation"
        (the deterministic Gaussians from moving cameras).

        As in the JAX package an error here does not end training; each
        artifact that fails is counted in `visualization_failures` and
        printed, and the others are still drawn. Returns what was drawn:
        the dropped pairs of each projection and video frame, the files,
        and the figures left out."""
        from ..model.encoder.visualization.encoder_visualizer_epipolar import EncoderVisualizerEpipolar
        from ..visualization.validation_in_3d import render_cameras, render_projections

        record: dict = {"step": step}

        def projections():
            result = render_projections(gaussians, 256)
            record["projection_overflow"] = result.overflow.sum(dim=0).tolist()
            record["projection_settings"] = result.settings
            images = _host(result.images[0])
            self.logger.log_image("projections", add_border(hcat(*images)), step=step)

        def cameras():
            self.logger.log_image("cameras", _host(render_cameras(arrays, 256)[0]), step=step)

        def encoder_figures():
            visualizer = EncoderVisualizerEpipolar(self.wrapper.encoder)
            generator = torch.Generator(device=self.wrapper.device).manual_seed(0)
            figures = visualizer.visualize(arrays["context"], step, generator=generator)
            for name, figure in figures.items():
                self.logger.log_image(f"encoder/{name}", figure, step=step)
            record["encoder_figures"] = sorted(figures)
            record["encoder_omitted"] = dict(visualizer.omitted)
            for name, reason in visualizer.omitted.items():
                print(f"validation: encoder/{name} left out: {reason}")

        def video(name, render):
            def run():
                record[f"{name}_file"], record[f"{name}_overflow"] = render(arrays, gaussians, step)
            return run

        for name, draw in (
            ("projections", projections), ("cameras", cameras), ("encoder", encoder_figures),
            ("video/wobble", video("wobble", self.render_video_wobble)),
            ("video/interpolation", video("interpolation", self.render_video_interpolation)),
        ):
            try:
                with torch.no_grad():
                    draw()
            except Exception as exc:  # a figure must not end training; counted and printed
                self.visualization_failures.append(f"{name}: {type(exc).__name__}: {exc}")
                print(f"validation: extended visualization {name} failed: {type(exc).__name__}: {exc}")
        self.visualization_log.append(record)
        return record

    def render_video_wobble(self, arrays: dict, gaussians, step: int, num_frames: int = 60):
        """A camera wobble around the first context view: (file, dropped
        pairs per frame)."""
        return self._render_video(arrays, gaussians, *wobble_cameras(arrays, num_frames), "wobble", step)

    def render_video_interpolation(self, arrays: dict, gaussians, step: int, num_frames: int = 30):
        """From the first context view to the last: (file, dropped pairs
        per frame)."""
        return self._render_video(arrays, gaussians, *interpolation_cameras(arrays, num_frames), "interpolation", step)

    def _render_video(self, arrays, gaussians, cameras, intrinsics, name, step):
        """The batch's deterministic Gaussians (`arrays` on the wrapper's
        device) rendered from each camera ((n, 4, 4) and (n, 3, 3) arrays)
        at the first context view's near and far, logged as a video."""
        device = self.wrapper.device
        frames, overflow = render_frames(
            self.wrapper.decoder, gaussians, torch.tensor(np.asarray(cameras), dtype=torch.float32, device=device),
            torch.tensor(np.asarray(intrinsics), dtype=torch.float32, device=device),
            arrays["context"]["near"][0, 0], arrays["context"]["far"][0, 0], tuple(arrays["context"]["image"].shape[-2:]),
        )
        return self.logger.log_video(f"video/{name}", _host(frames), step=step), overflow

    # ------------------------------------------------------------------
    def test(self, chunk_size: int = 32) -> dict:
        """The evaluation protocol at the wrapper's current weights; returns
        the summary (mean PSNR, SSIM and LPIPS over scenes, the number of
        scenes, and the (Gaussian, tile) pairs dropped at tile capacity)."""
        wrapper = self.wrapper
        device = wrapper.device
        # The protocol only renders, so the encoder emits the rasterizer's
        # structure-of-arrays layout directly.
        encode_fn = wrapper.make_eval_encode(pack_soa=True)
        decode_fn = wrapper.make_eval_decode()
        generator = torch.Generator(device=device).manual_seed(self.seed + 31)
        out_dir = Path(wrapper.test_cfg.output_path) / RESULTS_NAME

        lpips, lpips_pretrained = get_lpips()
        if lpips_pretrained:
            lpips = lpips.to(device)
        else:
            # Never report LPIPS from random VGG weights: the summary carries
            # lpips=None, so readers see the metric was unavailable, not zero.
            print(
                "WARNING: LPIPS weights not found; skipping the LPIPS metric "
                "(summary will carry lpips=null)."
            )
        all_metrics: dict[str, list[float]] = {"psnr": [], "ssim": [], "lpips": []}
        count = 0
        overflow_total = 0
        for batch in self.data_module.test_dataloader():
            scene = batch["scene"][0]
            arrays = batch_to(_strip_non_arrays(batch), device)
            b, v, _, h, w = arrays["target"]["image"].shape
            if b != 1:
                raise ValueError(f"the test protocol takes one scene per batch, not {b}")

            with self.benchmarker.time("encoder"):
                gaussians = encode_fn(arrays, False, 0, generator=generator)
                self.benchmarker.sync()

            colors = []
            with self.benchmarker.time("decoder", num_calls=v):
                # The dataset's cameras and bounds, as the JAX protocol renders
                # them (the data shim's bounds go to the encoder only).
                target = arrays["target"]
                render_settings = None
                if wrapper.test_cfg.adaptive_capacity:
                    # Probe the scene's tile occupancy once (a host sync,
                    # counted in the decoder's time) and render at the
                    # smallest sufficient capacity and pair budget.
                    render_settings = wrapper.choose_eval_settings(
                        gaussians, target["extrinsics"], target["intrinsics"], target["near"], (h, w)
                    )
                for lo in range(0, v, chunk_size):
                    hi = min(lo + chunk_size, v)
                    color, chunk_overflow = decode_fn(
                        gaussians,
                        target["extrinsics"][:, lo:hi],
                        target["intrinsics"][:, lo:hi],
                        target["near"][:, lo:hi],
                        target["far"][:, lo:hi],
                        (h, w),
                        render_settings,
                    )
                    self.benchmarker.sync()
                    colors.append(color)
                    overflow_total += int(chunk_overflow)
            color = torch.cat(colors, dim=1)[0]  # (v, 3, h, w)

            with torch.no_grad():
                gt = arrays["target"]["image"][0]
                all_metrics["psnr"].append(float(compute_psnr(gt, color).mean()))
                all_metrics["ssim"].append(float(compute_ssim(gt, color).mean()))
                if lpips_pretrained:
                    all_metrics["lpips"].append(float(lpips(gt, color).mean()))

            color_dir = out_dir / scene / "color"
            color_dir.mkdir(parents=True, exist_ok=True)
            images = (color.clamp(0, 1) * 255).to(torch.uint8).permute(0, 2, 3, 1).cpu().numpy()
            for idx, img in zip(np.asarray(batch["target"]["index"][0]), images):
                Image.fromarray(img).save(color_dir / f"{idx:0>6}.png")
            count += 1

        if is_rank_zero():
            self.benchmarker.dump(out_dir / "benchmark.json")
            self.benchmarker.dump_memory(out_dir / "peak_memory.json")
        summary: dict = {k: float(np.mean(x)) for k, x in all_metrics.items() if x}
        if not lpips_pretrained:
            summary["lpips"] = None
        summary["num_scenes"] = count
        # The protocol requires zero dropped pairs: any overflow means the
        # metrics were computed on images with Gaussians silently missing
        # (raise RenderSettings.capacity and rerun).
        summary["overflow_pairs"] = overflow_total
        if overflow_total:
            print(
                f"WARNING: rasterizer dropped {overflow_total} (gaussian, tile) pairs at tile "
                "capacity during evaluation; metrics are not protocol-clean."
            )
        print("test;", summary)
        return summary
