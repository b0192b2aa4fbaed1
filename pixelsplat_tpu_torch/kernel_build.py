"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface and compiles on its own
into `build/kernels/lib<name>-<hash>.so` at the root of the checkout, for
Hopper (`sm_90a`). The file name carries a hash of the source, of the
`csrc/` headers it includes and of the flags, so an edited source or header
rebuilds and a built one loads at once. Nothing
here runs at import time: a library is built on the first call that needs
it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def _with_includes(path: Path, seen: set[Path]) -> bytes:
    """The file's bytes followed by those of every `#include "..."` it
    names under csrc/, recursively, each once."""
    seen.add(path)
    data = path.read_bytes()
    for header in _INCLUDE.findall(data.decode()):
        included = (path.parent / header).resolve()
        if included not in seen and included.exists():
            data += _with_includes(included, seen)
    return data


def library_path(name: str) -> Path:
    source = _with_includes((CSRC / f"{name}.cu").resolve(), set())
    digest = hashlib.sha256(source + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> tuple[Path, str]:
    """Compile csrc/<name>.cu unless already built; returns (path, nvcc log)."""
    out = library_path(name)
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Compile to a private name and rename, so concurrent builds never
    # load a half-written library.
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


def kernel_names() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all() -> dict[str, tuple[Path, str]]:
    """Build every kernel, one nvcc process per source, all at once."""
    names = kernel_names()
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        return dict(zip(names, pool.map(build, names)))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built on first use."""
    with _lock:
        if name not in _loaded:
            path, _ = build(name)
            _loaded[name] = ctypes.CDLL(str(path))
        return _loaded[name]
