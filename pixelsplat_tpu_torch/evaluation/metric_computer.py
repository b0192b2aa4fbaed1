"""Offline metrics: each method's rendered PNGs against the ground truth.

Port of `pixelsplat_tpu/evaluation/metric_computer.py`: for each scene,
load every configured method's frames (`<path>/<scene>/color/<index>.png`),
score PSNR, SSIM and LPIPS against the ground-truth target views, keep the
per-view scores, and optionally write side-by-side comparisons.

LPIPS is scored only with its exported pretrained weights on disk, as in
`Trainer.test`: without them the scores carry no LPIPS (the JAX package
scores random VGG weights here and warns).
"""

from __future__ import annotations

from typing import Iterable, Optional, Union

import numpy as np
import torch

from ..utils.image_io import load_image, save_image
from ..visualization.annotation import add_label
from ..visualization.layout import add_border, hcat
from .evaluation_cfg import EvaluationCfg
from .lpips import load_lpips
from .metrics import compute_psnr, compute_ssim


class MetricComputer:
    def __init__(self, cfg: EvaluationCfg, device: Union[str, torch.device] = "cpu"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.scores: dict[str, dict[str, list[float]]] = {
            m.key: {"psnr": [], "lpips": [], "ssim": []} for m in cfg.methods
        }
        self.lpips = load_lpips()  # pretrained weights only
        self.lpips_pretrained = self.lpips is not None
        if self.lpips is not None:
            self.lpips = self.lpips.eval().to(self.device)

    @torch.no_grad()
    def process_scene(self, scene: str, target_images: np.ndarray, indices: Iterable[int]) -> Optional[dict]:
        """Score one scene's frames; `target_images` is the (v, 3, h, w)
        ground truth of the frames `indices`. Returns every method's running
        means, or None (scoring nothing) when a method lacks a frame."""
        cfg = self.cfg
        indices = list(indices)

        all_images = {}
        for method in cfg.methods:
            images = []
            for idx in indices:
                path = method.path / scene / f"color/{idx:0>6}.png"
                if not path.exists():
                    print(f'Skipping "{scene}" (missing {path}).')
                    return None
                images.append(load_image(path))
            all_images[method.key] = np.stack(images)

        gt = torch.as_tensor(np.asarray(target_images, np.float32), device=self.device)
        for method in cfg.methods:
            hat = torch.as_tensor(all_images[method.key], device=self.device)
            scores = self.scores[method.key]
            scores["psnr"].extend(compute_psnr(gt, hat).cpu().tolist())
            scores["ssim"].extend(compute_ssim(gt, hat).cpu().tolist())
            if self.lpips is not None:
                scores["lpips"].extend(self.lpips(gt, hat).reshape(-1).cpu().tolist())

        if cfg.side_by_side_path is not None:
            for i, idx in enumerate(indices):
                columns = [add_label(np.asarray(target_images[i]), "Ground Truth")]
                columns += [add_label(all_images[m.key][i], m.name) for m in cfg.methods]
                save_image(add_border(hcat(*columns)), cfg.side_by_side_path / scene / f"{idx:0>6}.png")

        return self.summary()

    def print_preview(self) -> None:
        rows = []
        for method in self.cfg.methods:
            s = self.scores[method.key]
            rows.append(
                f"{method.name:>24} | "
                + " | ".join(f"{k}: {np.mean(v):.3f}" if v else f"{k}: -" for k, v in s.items())
            )
        print("\n".join(rows))

    def summary(self) -> dict:
        """Each method's mean of every metric scored so far."""
        return {
            m.key: {k: float(np.mean(v)) for k, v in self.scores[m.key].items() if v}
            for m in self.cfg.methods
        }
