"""Video export: frame stacks -> MP4 through ffmpeg when it is on PATH,
else a GIF through PIL.

Port of `pixelsplat_tpu/utils/video.py`; the choice between the two is
the JAX package's own rule.
"""

from __future__ import annotations

import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
from PIL import Image


def _to_uint8_frames(frames: np.ndarray) -> list[np.ndarray]:
    """frames: (t, 3, h, w) float [0,1] -> list of (h, w, 3) uint8."""
    out = []
    for f in np.asarray(frames):
        img = (np.clip(f, 0, 1) * 255).astype(np.uint8).transpose(1, 2, 0)
        out.append(img)
    return out


def save_gif(frames: np.ndarray, path: Path, fps: int = 30) -> None:
    frames_u8 = _to_uint8_frames(frames)
    path = Path(path)
    path.parent.mkdir(exist_ok=True, parents=True)
    images = [Image.fromarray(f) for f in frames_u8]
    images[0].save(
        path,
        save_all=True,
        append_images=images[1:],
        duration=max(int(1000 / fps), 1),
        loop=0,
    )


def save_video(frames: np.ndarray, path: Path, fps: int = 30) -> Path:
    """Save an MP4 through ffmpeg when it is on PATH, else a GIF beside
    `path`; returns the file written."""
    path = Path(path)
    if shutil.which("ffmpeg") is None:
        gif = path.with_suffix(".gif")
        save_gif(frames, gif, fps)
        return gif
    path.parent.mkdir(exist_ok=True, parents=True)
    with tempfile.TemporaryDirectory() as tmp:
        for i, f in enumerate(_to_uint8_frames(frames)):
            Image.fromarray(f).save(Path(tmp) / f"{i:0>5}.png")
        subprocess.run(
            [
                "ffmpeg", "-y", "-loglevel", "error",
                "-framerate", str(fps),
                "-i", f"{tmp}/%05d.png",
                "-pix_fmt", "yuv420p",
                str(path),
            ],
            check=True,
        )
    return path
