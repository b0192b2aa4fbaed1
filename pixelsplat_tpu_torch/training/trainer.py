"""The trainer: the evaluation protocol's loop.

Port of `pixelsplat_tpu/training/trainer.py`: `TrainerCfg`, the `Trainer`
and `Trainer.test`. The test protocol encodes each scene with the
PROBABILISTIC encoder, as the published metrics do, renders all of its
target views in chunks of 32 at settings chosen from the scene's tile
occupancy, scores PSNR, SSIM and LPIPS (LPIPS only with pretrained
weights on disk), saves the renders as PNGs, and dumps the encoder and
decoder times and the device's memory stats. `fit` and validation come in
a later slice.

The depth samples' uniforms come from a `torch.Generator` on the wrapper's
device seeded `seed + 31`, one draw per scene; the JAX package splits
`PRNGKey(seed + 31)` once per scene, so the two draw different numbers.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np
import torch
from PIL import Image

from ..dataset.data_module import DataModule
from ..evaluation.lpips import get_lpips
from ..evaluation.metrics import compute_psnr, compute_ssim
from ..utils.benchmarker import Benchmarker
from ..utils.local_logger import LocalLogger
from ..utils.step_tracker import StepTracker
from .model_wrapper import CheckpointingCfg, ModelWrapper, batch_to

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
