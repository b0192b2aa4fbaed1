"""Write the RE10K fixture chunk: two scenes of 8 frames at 360x640.

    python -m pixelsplat_tpu_torch.scripts.make_fixture_chunk [--out build/fixtures/re10k]

The port's counterpart of `tools/make_fixture_chunk.py`, which wrote the
checked-in `tests/fixtures/re10k`. The layout is that of the real RE10K
chunks: a `torch.save`d list of per-scene dicts

    {"url": str,
     "timestamps": int64 tensor (n,),
     "cameras": float32 tensor (n, 18),
     "images": [uint8 1-D tensors of JPEG bytes, ...],
     "key": str}

in `<out>/test/000000.torch`, with `<out>/test/index.json` mapping each
scene key to that file and the fixture's evaluation index beside `<out>`
(`<out>/../evaluation_index_fixture.json`). The content is deterministic:
smooth synthetic photographs saved as JPEG at quality 88 with PIL, and
cameras on a gentle arc from scipy's `Rotation`. The same PIL and JPEG
library reproduce the checked-in files byte for byte; another JPEG
encoder version changes only the JPEG bytes. `compare_fixtures` holds two
fixture roots against each other.
"""

from __future__ import annotations

import argparse
import io
import json
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
DEFAULT_OUT = ROOT / "build" / "fixtures" / "re10k"
CHECKED_IN = ROOT / "tests" / "fixtures" / "re10k"

N_FRAMES = 8
RAW_H, RAW_W = 360, 640
SCENES = ("fixture_scene_a", "fixture_scene_b")
JPEG_QUALITY = 88
EVALUATION_INDEX = {
    "fixture_scene_a": {"context": [0, 5], "target": [1, 3, 4]},
    "fixture_scene_b": {"context": [1, 6], "target": [2, 4, 5]},
}


def frame(scene_idx: int, t: float) -> np.ndarray:
    """A smooth synthetic photograph (uint8, RAW_H x RAW_W x 3): a gradient
    sky and five coloured discs that shift with the camera parameter t."""
    y, x = np.mgrid[0:RAW_H, 0:RAW_W].astype(np.float32)
    img = np.zeros((RAW_H, RAW_W, 3), np.float32)
    img[..., 0] = 0.35 + 0.4 * y / RAW_H
    img[..., 1] = 0.45 + 0.3 * x / RAW_W
    img[..., 2] = 0.65 - 0.3 * y / RAW_H
    for k in range(5):
        cx = (0.15 + 0.18 * k) * RAW_W - 60.0 * t * (1 + 0.3 * k)
        cy = (0.3 + 0.12 * ((k * 2 + scene_idx) % 5)) * RAW_H
        r = 28.0 + 9.0 * k
        mask = ((x - cx) ** 2 + (y - cy) ** 2) < r * r
        img[mask] = np.array(
            [0.9 - 0.15 * k, 0.2 + 0.15 * k, 0.3 + 0.1 * ((k + scene_idx) % 3)], np.float32
        )
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def cameras(scene_idx: int) -> np.ndarray:
    """(n, 18) rows: fx fy cx cy 0 0, then w2c[:3, :4] row-major."""
    from scipy.spatial.transform import Rotation

    cams = np.zeros((N_FRAMES, 18), np.float32)
    fx = 0.92 + 0.02 * scene_idx
    cams[:, 0] = fx
    cams[:, 1] = fx * RAW_W / RAW_H  # square pixels
    cams[:, 2] = 0.5
    cams[:, 3] = 0.5
    for i in range(N_FRAMES):
        t = i / (N_FRAMES - 1)
        # Translate along x, bob in y, yaw a few degrees.
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, :3] = Rotation.from_euler(
            "yxz", [6.0 * t - 3.0, 1.5 * np.sin(t * np.pi), 0.0], degrees=True
        ).as_matrix()
        c2w[0, 3] = 0.55 * t
        c2w[1, 3] = 0.05 * np.sin(t * 2 * np.pi)
        c2w[2, 3] = 0.1 * t
        cams[i, 6:] = np.linalg.inv(c2w).astype(np.float32)[:3].reshape(-1)
    return cams


def make_fixture(out: Path = DEFAULT_OUT) -> Path:
    """Write the fixture under `out` (never into the checked-in one);
    returns the chunk's path."""
    import torch
    from PIL import Image

    out = Path(out).resolve()
    fixtures = CHECKED_IN.parent
    if any(p == fixtures or fixtures in p.parents for p in (out, out.parent)):
        raise ValueError(f"{out}: the checked-in fixtures are not rewritten; write elsewhere")
    stage = out / "test"
    stage.mkdir(parents=True, exist_ok=True)
    chunk = []
    for s, scene in enumerate(SCENES):
        images = []
        for i in range(N_FRAMES):
            buf = io.BytesIO()
            Image.fromarray(frame(s, i / (N_FRAMES - 1))).save(buf, format="JPEG", quality=JPEG_QUALITY)
            images.append(torch.from_numpy(np.frombuffer(buf.getvalue(), np.uint8).copy()))
        chunk.append({
            "url": f"https://www.youtube.com/watch?v=fixture{s}",
            "timestamps": torch.arange(N_FRAMES, dtype=torch.int64) * 33366,
            "cameras": torch.from_numpy(cameras(s)),
            "images": images,
            "key": scene,
        })
    path = stage / "000000.torch"
    torch.save(chunk, path)
    with (stage / "index.json").open("w") as f:
        json.dump({scene: path.name for scene in SCENES}, f, indent=2)
    with (out.parent / "evaluation_index_fixture.json").open("w") as f:
        json.dump(EVALUATION_INDEX, f, indent=2)
    return path


def compare_fixtures(a: Path, b: Path = CHECKED_IN) -> dict:
    """Two fixture roots' `test/` chunks side by side: whether the scene
    keys, urls, timestamps and cameras are equal bit for bit, the share of
    JPEGs that are byte-identical, and the decoded frames' largest mean and
    largest per-pixel absolute difference (in 8-bit levels)."""
    import torch
    from PIL import Image

    def load(root):
        return torch.load(Path(root) / "test" / "000000.torch", weights_only=True)

    def decode(jpeg):
        return np.asarray(Image.open(io.BytesIO(jpeg.numpy().tobytes())).convert("RGB"), np.int16)

    chunk_a, chunk_b = load(a), load(b)
    same_meta = len(chunk_a) == len(chunk_b) and all(
        x["key"] == y["key"] and x["url"] == y["url"] and torch.equal(x["timestamps"], y["timestamps"])
        and x["cameras"].dtype == y["cameras"].dtype and torch.equal(x["cameras"], y["cameras"])
        and len(x["images"]) == len(y["images"])
        for x, y in zip(chunk_a, chunk_b)
    )
    identical, frames, mean_levels, max_levels = 0, 0, 0.0, 0
    for x, y in zip(chunk_a, chunk_b):
        for ja, jb in zip(x["images"], y["images"]):
            frames += 1
            identical += int(torch.equal(ja, jb))
            diff = np.abs(decode(ja) - decode(jb))
            mean_levels = max(mean_levels, float(diff.mean()))
            max_levels = max(max_levels, int(diff.max()))
    index_a, index_b = (json.loads((Path(r) / "test" / "index.json").read_text()) for r in (a, b))
    return dict(
        same_metadata=same_meta, same_index=index_a == index_b, frames=frames,
        identical_share=identical / max(frames, 1), max_mean_levels=mean_levels, max_levels=max_levels,
    )


def main(argv=None) -> Path:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", type=Path, default=DEFAULT_OUT)
    args = parser.parse_args(argv)
    path = make_fixture(args.out)
    size = sum(f.stat().st_size for f in path.parent.iterdir())
    print(f"fixture written to {path.parent} ({size / 1024:.0f} KiB)")
    return path


if __name__ == "__main__":
    main()
