"""Write a `.psz` chunk (the native loader's container) beside each `.torch` one.

    python -m pixelsplat_tpu_torch.scripts.transcode_chunks <dataset_root>/<stage>

Port of `tools/transcode_chunks.py`, byte for byte the same files: a
`.psz` holds, little endian, the magic 0x5053505A, the version and the
number of examples; a directory entry per example (its offset, key length
and frame count); then per example its key, its (n, 18) float32 camera
rows, n + 1 u64 offsets of its JPEG blobs relative to the example, and the
blobs (`native/chunk_loader.cpp`). Chunks that already have one are
skipped. The dataset reads a `.psz` sibling through the native loader when
it can build.
"""

from __future__ import annotations

import struct
import sys
from pathlib import Path

import numpy as np
import torch

MAGIC = 0x5053505A
VERSION = 1


def transcode(torch_path: Path, out_path: Path) -> None:
    chunk = torch.load(torch_path, map_location="cpu", weights_only=False)
    payloads = []
    for example in chunk:
        key = example["key"].encode()
        poses = np.ascontiguousarray(np.asarray(example["cameras"], np.float32))
        blobs = [np.asarray(image, np.uint8).tobytes() for image in example["images"]]
        offsets = np.zeros(len(blobs) + 1, np.uint64)
        offset = len(key) + poses.nbytes + offsets.nbytes
        for i, blob in enumerate(blobs):
            offsets[i] = offset
            offset += len(blob)
        offsets[len(blobs)] = offset
        payloads.append((key, poses, offsets, blobs, offset))

    with out_path.open("wb") as f:
        f.write(struct.pack("<III", MAGIC, VERSION, len(chunk)))
        offset = 12 + len(chunk) * 16  # header and directory
        for key, poses, _, _, size in payloads:
            f.write(struct.pack("<QII", offset, len(key), poses.shape[0]))
            offset += size
        for key, poses, offsets, blobs, _ in payloads:
            f.write(key)
            f.write(poses.tobytes())
            f.write(offsets.tobytes())
            for blob in blobs:
                f.write(blob)


def main(argv: list[str]) -> None:
    root = Path(argv[0])
    for torch_path in sorted(root.glob("*.torch")):
        out = torch_path.with_suffix(".psz")
        if out.exists():
            continue
        transcode(torch_path, out)
        print(f"{torch_path.name} -> {out.name}")


if __name__ == "__main__":
    main(sys.argv[1:])
