"""RE10K / ACID chunked-dataset reader.

Port of `pixelsplat_tpu/dataset/dataset_re10k.py`. It iterates the `.torch`
chunk files under `root/<stage>/` (each a `torch.save`d list of {key,
cameras (n, 18), images: [JPEG bytes]}; `index.json` maps scenes to
chunks), decodes the 18-float poses into normalized intrinsics and OpenCV
camera-to-world extrinsics, applies the view sampler, the FOV, shape and
baseline filters, the baseline-1 world rescale and the host-side
augmentation and crop shims. ACID ships in the same format.

Examples are numpy arrays; batching and device transfer happen later.
Where a chunk has a `.psz` sibling (`scripts/transcode_chunks.py`) and the
native loader builds (`native/`), the chunk is read from it: memory-mapped
poses and multithreaded libjpeg decodes of only the frames the view sampler
picks. Otherwise the `.torch` file is read, as the JAX reader does; the
route is chosen per chunk in the process that reads it.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from functools import cached_property
from io import BytesIO
from pathlib import Path
from typing import Callable, Iterator, Literal, Optional

import numpy as np
import torch
from PIL import Image

from .dataset import DatasetCfgCommon
from .shims.augmentation_shim import apply_augmentation_shim
from .shims.crop_shim import apply_crop_shim
from .types import Stage
from .view_sampler import ViewSampler


def open_native(chunk_path: Path):
    """A `NativeChunk` of `chunk_path`'s `.psz` sibling, or None where the
    `.torch` file is to be read: no sibling, the native loader unavailable
    in this process, or a sibling it cannot open."""
    psz = Path(chunk_path).with_suffix(".psz")
    if not psz.exists():
        return None
    from ..native import NativeChunk, native_available

    if not native_available():
        return None
    try:
        return NativeChunk(psz)
    except OSError:  # the loader refused the file
        return None


def chunk_route(chunk_path: Path) -> Literal["psz", "torch"]:
    """The file a reader in this process takes for `chunk_path`."""
    native = open_native(chunk_path)
    if native is None:
        return "torch"
    native.close()
    return "psz"


@dataclass(frozen=True)
class DatasetRE10kCfg(DatasetCfgCommon):
    name: Literal["re10k"] = "re10k"
    roots: tuple[Path, ...] = ()
    baseline_epsilon: float = 1e-3
    max_fov: float = 100.0
    make_baseline_1: bool = True
    augment: bool = True


def _fov_degrees(intrinsics: np.ndarray) -> np.ndarray:
    """Field of view (degrees) per view from normalized intrinsics."""
    inv = np.linalg.inv(intrinsics)

    def angle(a, b):
        va = inv @ np.asarray(a, np.float32)
        vb = inv @ np.asarray(b, np.float32)
        va /= np.linalg.norm(va, axis=-1, keepdims=True)
        vb /= np.linalg.norm(vb, axis=-1, keepdims=True)
        return np.degrees(np.arccos(np.clip((va * vb).sum(-1), -1, 1)))

    fov_x = angle([0, 0.5, 1], [1, 0.5, 1])
    fov_y = angle([0.5, 0, 1], [0.5, 1, 1])
    return np.stack([fov_x, fov_y], axis=-1)


class DatasetRE10k:
    """One worker's share of a stage's examples, in the stage's order: the
    test stage keeps the chunk order and gives worker i every chunk whose
    position is i modulo the number of workers; train and val shuffle
    chunks and their scenes with the worker's generator."""

    near: float = 0.1
    far: float = 1000.0

    def __init__(
        self,
        cfg: DatasetRE10kCfg,
        stage: Stage,
        view_sampler: ViewSampler,
        seed: int = 0,
        worker_id: int = 0,
        num_workers: int = 1,
    ) -> None:
        self.cfg = cfg
        self.stage = stage
        self.view_sampler = view_sampler
        self.rng = np.random.default_rng(seed + worker_id)
        self.worker_id = worker_id
        self.num_workers = num_workers

        self.chunks: list[Path] = []
        for root in cfg.roots:
            root = Path(root) / self.data_stage
            self.chunks.extend(sorted(p for p in root.iterdir() if p.suffix == ".torch"))
        if self.cfg.overfit_to_scene is not None:
            chunk_path = self.index[self.cfg.overfit_to_scene]
            self.chunks = [chunk_path] * len(self.chunks)

    # ------------------------------------------------------------------
    def __iter__(self) -> Iterator[dict]:
        chunks = list(self.chunks)
        if self.stage in ("train", "val"):
            perm = self.rng.permutation(len(chunks))
            chunks = [chunks[i] for i in perm]
        if self.stage == "test" and self.num_workers > 1:
            chunks = [c for i, c in enumerate(chunks) if i % self.num_workers == self.worker_id]

        for chunk_path in chunks:
            native = open_native(chunk_path)
            if native is not None:
                yield from self._iter_native(native)
                continue
            chunk = self._load_chunk(chunk_path)
            if self.cfg.overfit_to_scene is not None:
                item = [x for x in chunk if x["key"] == self.cfg.overfit_to_scene]
                if len(item) != 1:
                    raise ValueError(f"{chunk_path} holds {len(item)} scenes {self.cfg.overfit_to_scene!r}")
                chunk = item * len(chunk)
            if self.stage in ("train", "val"):
                perm = self.rng.permutation(len(chunk))
                chunk = [chunk[i] for i in perm]

            for example in chunk:
                out = self._process_example(example)
                if out is not None:
                    yield out

    # ------------------------------------------------------------------
    def _load_chunk(self, path: Path) -> list[dict]:
        return torch.load(path, map_location="cpu", weights_only=False)

    def _iter_native(self, native) -> Iterator[dict]:
        """A `.psz` chunk's examples, in the order and with the draws of the
        `.torch` route: the same permutation of the chunk's scenes, and an
        overfit scene repeated over the chunk."""
        order = list(range(len(native)))
        if self.cfg.overfit_to_scene is not None:
            match = [i for i in order if native.key(i) == self.cfg.overfit_to_scene]
            order = match * len(order) if match else order
        if self.stage in ("train", "val"):
            order = [order[i] for i in self.rng.permutation(len(order))]
        for i in order:
            extrinsics, intrinsics = self.convert_poses(native.poses(i))

            def get_images(indices, i=i):
                frames = native.decode_frames(i, [int(x) for x in indices])
                return frames.astype(np.float32).transpose(0, 3, 1, 2) / 255.0

            out = self._assemble(native.key(i), extrinsics, intrinsics, get_images)
            if out is not None:
                yield out
        native.close()

    def _process_example(self, example: dict) -> Optional[dict]:
        cameras = np.asarray(example["cameras"], dtype=np.float32)
        extrinsics, intrinsics = self.convert_poses(cameras)
        scene = example["key"]

        def get_images(indices):
            return self.convert_images([example["images"][int(i)] for i in indices])

        return self._assemble(scene, extrinsics, intrinsics, get_images)

    def _assemble(
        self,
        scene: str,
        extrinsics: np.ndarray,
        intrinsics: np.ndarray,
        get_images: Callable[[np.ndarray], np.ndarray],
    ) -> Optional[dict]:
        try:
            context_indices, target_indices = self.view_sampler.sample(
                scene, extrinsics, intrinsics, self.rng
            )
        except ValueError:
            return None  # not enough frames, or no index entry

        if (_fov_degrees(intrinsics) > self.cfg.max_fov).any():
            return None

        try:
            context_images = get_images(context_indices)
            target_images = get_images(target_indices)
        except (IndexError, ValueError):
            return None

        # Shape filter (raw chunks are 360x640).
        if context_images.shape[1:] != (3, 360, 640) or target_images.shape[1:] != (3, 360, 640):
            print(
                f"Skipped bad example {scene}. Context shape was "
                f"{context_images.shape} and target shape was {target_images.shape}."
            )
            return None

        # Baseline-1 world normalization.
        context_extrinsics = extrinsics[context_indices]
        if context_extrinsics.shape[0] == 2 and self.cfg.make_baseline_1:
            a, b = context_extrinsics[:, :3, 3]
            scale = float(np.linalg.norm(a - b))
            if scale < self.cfg.baseline_epsilon:
                print(f"Skipped {scene} because of insufficient baseline {scale:.6f}")
                return None
            extrinsics = extrinsics.copy()
            extrinsics[:, :3, 3] /= scale
        else:
            scale = 1.0

        def bound(value: float, n: int) -> np.ndarray:
            return np.full((n,), value / scale, dtype=np.float32)

        def views(indices: np.ndarray, images: np.ndarray) -> dict:
            return {
                "extrinsics": extrinsics[indices],
                "intrinsics": intrinsics[indices],
                "image": images,
                "near": bound(self.near, len(indices)),
                "far": bound(self.far, len(indices)),
                "index": np.asarray(indices, dtype=np.int64),
            }

        out = {
            "context": views(context_indices, context_images),
            "target": views(target_indices, target_images),
            "scene": scene,
        }
        if self.stage == "train" and self.cfg.augment:
            out = apply_augmentation_shim(out, self.rng)
        return apply_crop_shim(out, tuple(self.cfg.image_shape))

    # ------------------------------------------------------------------
    def convert_poses(self, poses: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """18-float rows -> (c2w extrinsics (n,4,4), normalized K (n,3,3))."""
        b = poses.shape[0]
        intrinsics = np.tile(np.eye(3, dtype=np.float32), (b, 1, 1))
        fx, fy, cx, cy = poses[:, 0], poses[:, 1], poses[:, 2], poses[:, 3]
        intrinsics[:, 0, 0] = fx
        intrinsics[:, 1, 1] = fy
        intrinsics[:, 0, 2] = cx
        intrinsics[:, 1, 2] = cy

        w2c = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
        w2c[:, :3] = poses[:, 6:].reshape(b, 3, 4)
        return np.linalg.inv(w2c), intrinsics

    def convert_images(self, images: list) -> np.ndarray:
        """JPEG byte tensors -> (n, 3, h, w) float32 in [0, 1]."""
        out = []
        for image in images:
            raw = np.asarray(image, dtype=np.uint8).tobytes()
            img = Image.open(BytesIO(raw))
            out.append((np.asarray(img, dtype=np.float32) / 255.0).transpose(2, 0, 1))
        return np.stack(out)

    # ------------------------------------------------------------------
    @property
    def data_stage(self) -> Stage:
        if self.cfg.overfit_to_scene is not None:
            return "test"
        if self.stage == "val":
            return "test"
        return self.stage

    @cached_property
    def index(self) -> dict[str, Path]:
        merged: dict[str, Path] = {}
        data_stages = [self.data_stage]
        if self.cfg.overfit_to_scene is not None:
            data_stages = ["test", "train"]
        for data_stage in data_stages:
            for root in self.cfg.roots:
                root = Path(root)
                with (root / data_stage / "index.json").open("r") as f:
                    index = json.load(f)
                index = {k: root / data_stage / v for k, v in index.items()}
                if set(merged) & set(index):
                    raise ValueError(f"scenes {sorted(set(merged) & set(index))} appear in two indices")
                merged.update(index)
        return merged

    def __len__(self) -> int:
        return len(self.index)
