"""ctypes binding of the native (C++ / libjpeg) `.psz` chunk loader.

Port of `pixelsplat_tpu/native/__init__.py` with its own copy of the
source (`chunk_loader.cpp`). The library is built on first use, never at
import, with `g++ -O3 -shared -fPIC -std=c++17 ... -ljpeg -lpthread` into
`build/native/libchunk_loader-<hash>.so` at the root of the checkout (the
hash covers the source and the flags, so an edited source rebuilds and a
built one loads at once), and loaded in the process that reads a chunk: a
DataLoader worker loads it after the fork. Where it cannot build (no g++,
no `jpeglib.h` or libjpeg), `native_available()` is false, `build_error()`
holds the compiler's message, and the dataset reads the `.torch` chunk,
as the JAX reader does; a process tries the build once. `NativeChunk` opens one `.psz` file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from ..kernel_build import declare

SOURCE = Path(__file__).resolve().parent / "chunk_loader.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-ljpeg", "-lpthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(FLAGS + LIBS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libchunk_loader-{digest}.so"


def build_library() -> Path:
    """Compile the loader unless already built; raises RuntimeError with the
    compiler's output when it cannot."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Compile to a private name and rename, so that concurrent builds never
    # load a half-written library.
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
    os.close(fd)
    cmd = ["g++", *FLAGS, str(SOURCE), "-o", tmp, *LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as exc:
        os.unlink(tmp)
        raise RuntimeError(f"{' '.join(cmd)}: {exc}") from exc
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    global _lib, _error
    with _lock:
        if _lib is not None:
            return _lib
        if _error is not None:  # failed once in this process: no g++ per chunk
            raise RuntimeError(_error)
        try:
            lib = ctypes.CDLL(str(build_library()))
        except (RuntimeError, OSError) as exc:
            _error = str(exc)
            raise
        c_int, c_void, ptr = ctypes.c_int32, ctypes.c_void_p, ctypes.POINTER
        declare(lib, (
            ("psz_open", [ctypes.c_char_p], c_void),
            ("psz_close", [c_void], None),
            ("psz_num_examples", [c_void]),
            ("psz_num_frames", [c_void, c_int]),
            ("psz_key", [c_void, c_int, ctypes.c_char_p, c_int]),
            ("psz_poses", [c_void, c_int, ptr(ctypes.c_float)]),
            ("psz_decode_frames", [c_void, c_int, ptr(c_int), c_int, c_int, c_int, ptr(ctypes.c_uint8), c_int]),
        ))
        _lib, _error = lib, None
        return lib


def native_available() -> bool:
    """Whether the loader builds and loads in this process."""
    try:
        _load()
        return True
    except (RuntimeError, OSError):
        return False


def build_error() -> Optional[str]:
    """The compiler's (or the dynamic loader's) message of the last failed
    attempt in this process, or None."""
    return _error


class NativeChunk:
    """A memory-mapped `.psz` chunk with multithreaded JPEG decoding."""

    def __init__(self, path: Path, raw_shape: tuple[int, int] = (360, 640)):
        self._lib = _load()
        self._handle = self._lib.psz_open(str(path).encode())
        if not self._handle:
            raise IOError(f"failed to open {path}")
        self.raw_shape = raw_shape

    def __len__(self) -> int:
        return self._lib.psz_num_examples(self._handle)

    def num_frames(self, example: int) -> int:
        return self._lib.psz_num_frames(self._handle, example)

    def key(self, example: int) -> str:
        buf = ctypes.create_string_buffer(256)
        self._lib.psz_key(self._handle, example, buf, 256)
        return buf.value.decode()

    def poses(self, example: int) -> np.ndarray:
        """(n_frames, 18) float32 camera rows."""
        out = np.empty((self.num_frames(example), 18), np.float32)
        self._lib.psz_poses(self._handle, example, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        return out

    def decode_frames(self, example: int, frame_indices: Sequence[int], n_threads: int = 4) -> np.ndarray:
        """(n, h, w, 3) uint8 RGB of the given frames, decoded on `n_threads`
        threads; raises ValueError for a bad index or an unexpected size."""
        h, w = self.raw_shape
        idx = np.asarray(frame_indices, np.int32)
        out = np.empty((len(idx), h, w, 3), np.uint8)
        status = self._lib.psz_decode_frames(
            self._handle, example, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(idx), h, w,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n_threads,
        )
        if status != 0:
            raise ValueError(f"native decode failed with status {status}")
        return out

    def close(self) -> None:
        if self._handle:
            self._lib.psz_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
