"""Local logger: scalars to JSONL, images to PNG, videos to MP4 or GIF.

Port of `pixelsplat_tpu/utils/local_logger.py`.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import numpy as np
from PIL import Image

from .video import save_video

LOG_PATH = Path("outputs/local")


class LocalLogger:
    def __init__(self, path: Path = LOG_PATH):
        self.path = Path(path)
        self.path.mkdir(exist_ok=True, parents=True)
        self._scalar_file = (self.path / "metrics.jsonl").open("a")

    def log_metrics(self, metrics: dict, step: Optional[int] = None) -> None:
        record = {"step": step, **{k: float(v) for k, v in metrics.items()}}
        self._scalar_file.write(json.dumps(record) + "\n")
        self._scalar_file.flush()

    def log_image(self, key: str, image: np.ndarray, step: Optional[int] = None) -> None:
        """image: (3, h, w) or (h, w, 3) float [0,1] or uint8."""
        img = np.asarray(image)
        if img.ndim == 3 and img.shape[0] in (1, 3):
            img = img.transpose(1, 2, 0)
        if img.dtype != np.uint8:
            img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        if img.shape[-1] == 1:
            img = img[..., 0]
        directory = self.path / key
        directory.mkdir(exist_ok=True, parents=True)
        Image.fromarray(img).save(directory / f"{step or 0:0>6}.png")

    def log_video(self, key: str, frames: np.ndarray, step: Optional[int] = None, fps: int = 30) -> Path:
        """frames: (t, 3, h, w) float [0,1]; an MP4 through ffmpeg when it is
        on PATH, else a GIF (`utils/video.py`). Returns the file written."""
        return save_video(np.asarray(frames), self.path / key / f"{step or 0:0>6}.mp4", fps=fps)

    def log_model(self, checkpoint_path, step: Optional[int] = None) -> None:
        """Nothing to do locally: the checkpoint already lives on disk."""
