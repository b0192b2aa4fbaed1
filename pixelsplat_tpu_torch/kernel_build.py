"""Build the port's CUDA kernels with nvcc, load them with ctypes, and
launch them.

Each `csrc/<name>.cu` exposes a plain C interface and compiles on its own
into `build/kernels/lib<name>-<hash>.so` at the root of the checkout, for
Hopper (`sm_90a`). The file name carries a hash of the source, of the
`csrc/` headers it includes and of the flags, so an edited source or header
rebuilds and a built one loads at once. Nothing
here runs at import time: a library is built on the first call that needs
it. `declare` types a library's entry points and `launch` is the one path
every wrapper calls them through.
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

import torch

from .utils import tracing

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}  # by source path
# Sources that build together, one nvcc process each, on the first load of
# any of them from csrc/ that is not built yet (the first group that names
# it): a pixelSplat evaluation scene needs K10 and K9 in the encoder, an
# MVSplat one K11, then both projection, binning and K1 in the render, so no
# compile waits for another, and neither model's scene builds the other's
# encoder kernels.
BUILT_TOGETHER = (("linear_split", "conv7", "composite_fwd", "project_bin"),
                  ("conv3x3", "composite_fwd", "project_bin"))


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


def library_path(name: str, csrc: Path | None = None) -> Path:
    source = _with_includes((Path(csrc or CSRC) / f"{name}.cu").resolve(), set())
    digest = hashlib.sha256(source + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str, csrc: Path | None = None) -> tuple[Path, str]:
    """Compile <csrc>/<name>.cu unless already built; returns (path, nvcc
    log). Another `csrc` (an earlier checkout's, to compare kernels) builds
    under the same name with its own hash."""
    csrc = Path(csrc or CSRC)
    out = library_path(name, csrc)
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Compile to a private name and rename, so concurrent builds never
    # load a half-written library.
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(csrc / f"{name}.cu")]
    with tracing.span("setup.kernel_build"):
        proc = subprocess.run(cmd, capture_output=True, text=True)
    tracing.count("kernel_builds")
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


def kernel_names() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_many(names) -> dict[str, tuple[Path, str]]:
    """Build the named kernels that are not built yet, one nvcc process per
    source, all at once."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        return dict(zip(names, pool.map(build, names)))


def build_all() -> dict[str, tuple[Path, str]]:
    """Build every kernel, one nvcc process per source, all at once."""
    return build_many(kernel_names())


def load(name: str, csrc: Path | None = None) -> ctypes.CDLL:
    """The loaded library of <csrc>/<name>.cu (csrc/ by default), built on
    first use, with the sources `BUILT_TOGETHER` with it where it is not
    built yet."""
    csrc = Path(csrc or CSRC)
    key = f"{csrc.resolve()}/{name}"
    with _lock:
        if key not in _loaded:
            if csrc.resolve() == CSRC and not library_path(name).exists():
                build_many(next((group for group in BUILT_TOGETHER if name in group), (name,)))
            path, _ = build(name, csrc)
            _loaded[key] = ctypes.CDLL(str(path))
        return _loaded[key]


def declare(lib: ctypes.CDLL, signatures) -> ctypes.CDLL:
    """`lib` with the entry points of `signatures`, `(symbol, argtypes)`
    pairs, declared: each returns an int (a kernel's entry point the error
    code of its launches), or the restype a third element gives."""
    for symbol, argtypes, *restype in signatures:
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = restype[0] if restype else ctypes.c_int
    return lib


# Bound once, since the launch path reads them on every call (None where
# PyTorch was built without CUDA, so no tensor can reach them).
_cuda_get_device = getattr(torch._C, "_cuda_getDevice", None)
_cuda_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def current_raw_stream(index: int) -> int:
    """The raw handle of the current stream of CUDA device `index`, read
    without building a `torch.cuda.Stream` (the call Triton's launcher
    makes); equal to `torch.cuda.current_stream(index).cuda_stream`."""
    return _cuda_raw_stream(index)


def launch(name: str, entry, device: int, *args) -> None:
    """Call a kernel's C entry point, `entry(*args, stream)`, on the current
    stream of CUDA device index `device` (inside a CUDA graph capture, the
    capturing stream), entering a device guard only when that is not the
    current device, and raise if the entry point returns an error code.
    It builds no `torch.cuda.Stream`; the entry point's types are declared
    once, when its library is loaded (`declare`)."""
    if device == _cuda_get_device():
        err = entry(*args, _cuda_raw_stream(device))
    else:
        with torch.cuda.device(device):
            err = entry(*args, _cuda_raw_stream(device))
    if err:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
