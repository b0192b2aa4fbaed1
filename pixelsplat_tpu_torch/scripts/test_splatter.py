"""Rasterizer smoke script: one hand-set Gaussian on a spin orbit.

    python -m pixelsplat_tpu_torch.scripts.test_splatter [out_dir] [num_frames]

Port of `pixelsplat_tpu/scripts/test_splatter.py`: a single anisotropic
Gaussian with hand-set degree-4 SH coefficients, rendered at 256x256 from
`num_frames` (12) cameras spinning around it through `render`, one forward
compositing launch per frame; the frames show the splatting and the SH
rotation. Writes PNGs to `out_dir` (outputs/test_splatter). Runs on the
card unless `main` is called with `device="cpu"`.
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Union

import numpy as np
import torch

from ..ops.rasterizer import RenderSettings, render
from ..training.model_wrapper import resolve_device
from ..utils.image_io import save_image
from ..visualization.camera_trajectory.spin import generate_spin

SETTINGS = RenderSettings(capacity=16, big_capacity=4, chunk=16)


def render_frames(num_frames: int, device: torch.device) -> torch.Tensor:
    """(num_frames, 3, 256, 256) renders of the Gaussian on the orbit."""
    # One Gaussian at the origin with an anisotropic covariance and SH
    # coefficients that light different directions differently.
    means = torch.zeros((1, 3), device=device)
    scale = torch.tensor([0.4, 0.2, 0.1], device=device)
    covs = (torch.diag(scale) ** 2)[None]
    opac = torch.tensor([1.0], device=device)
    sh = torch.zeros((1, 3, 25), device=device)
    sh[:, :, 0] = torch.tensor([0.6, 0.2, 0.2], device=device)  # reddish DC
    sh[:, 0, 3] = 0.8  # x-dependent red
    sh[:, 2, 1] = 0.8  # y-dependent blue
    sh[:, 1, 6] = 0.5  # degree-2 green

    cameras = generate_spin(num_frames, elevation=20.0, radius=3.0)
    intr = torch.tensor([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1.0]], device=device)
    frames = []
    for c2w in cameras:
        # Through world-to-camera and back, as the JAX script does.
        c2w = torch.as_tensor(np.linalg.inv(np.linalg.inv(c2w)), device=device)
        image = render(
            c2w[None], intr[None], torch.full((1,), 0.5, device=device), torch.full((1,), 50.0, device=device),
            (256, 256), torch.zeros((1, 3), device=device), means[None], covs[None], sh[None], opac[None],
            settings=SETTINGS,
        )
        frames.append(image[0])
    return torch.stack(frames)


def main(argv: list[str], device: Union[str, torch.device] = "cuda") -> torch.Tensor:
    """Render and write the frames; returns them, on the CPU."""
    device = resolve_device(device)
    out_dir = Path(argv[0]) if argv else Path("outputs/test_splatter")
    num_frames = int(argv[1]) if len(argv) > 1 else 12
    frames = render_frames(num_frames, device).cpu()
    for i, frame in enumerate(frames.numpy()):
        save_image(frame, out_dir / f"frame_{i:0>3}.png")
    print(f"Wrote {num_frames} frames to {out_dir}")
    return frames


if __name__ == "__main__":
    main(sys.argv[1:])
