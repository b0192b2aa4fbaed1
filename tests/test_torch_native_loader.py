"""The port's `.psz` route against the JAX package's, on the CPU: the
native loader (`pixelsplat_tpu_torch/native`, its own copy of the C++
source) against the JAX package's binding, the port's `.psz` writer against
`tools/transcode_chunks.py` byte for byte, and the dataset's examples on the
`.psz` route against the JAX dataset's `.psz` route, bit for bit, with the
same shuffle. Both routes decode with libjpeg; the `.torch` route decodes
with PIL's, within 1/255 of it (the JAX package's own bound,
`tests/test_native_loader.py`).
"""

import io
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from pixelsplat_tpu import native as jx_native
from pixelsplat_tpu.dataset import view_sampler as jx_samplers
from pixelsplat_tpu_torch import native as pt_native
from pixelsplat_tpu_torch.dataset import dataset_re10k as pt_dataset
from pixelsplat_tpu_torch.dataset import view_sampler as pt_samplers
from pixelsplat_tpu_torch.scripts.transcode_chunks import transcode

import test_dataset as jx_dataset_tests
from test_torch_dataset import EVAL_OVERRIDES, FIXTURE, ROOT, assert_examples_equal, data_modules, dataset_pair

sys.path.insert(0, str(ROOT))
from tools.transcode_chunks import transcode as tool_transcode  # noqa: E402

RAW = (48, 64)  # small raw frames for the loader's own cases


@pytest.fixture(scope="module")
def loaders(tmp_path_factory):
    """Both packages' native loaders, built on first use. The JAX one builds
    into a private path, so that this file never races the JAX package's
    own test, in another worker, for its library file."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jx_native, "_LIB", tmp_path_factory.mktemp("jax_native") / "libchunk_loader.so")
        mp.setattr(jx_native, "_lib", None)
        if not pt_native.native_available():
            pytest.skip(f"the port's native loader does not build here: {pt_native.build_error()}")
        if not jx_native.native_available():
            pytest.skip("the JAX package's native loader does not build here")
        yield


@pytest.fixture(scope="module")
def small_chunk(tmp_path_factory):
    """Two scenes of 5 and 3 random JPEG frames at 48x64, as a `.torch`
    chunk; and the frames PIL decodes from them."""
    root = tmp_path_factory.mktemp("chunks")
    rng = np.random.default_rng(80)
    chunk, originals = [], {}
    for s, n in enumerate((5, 3)):
        cameras = rng.normal(size=(n, 18)).astype(np.float32)
        images, frames = [], []
        for _ in range(n):
            buf = io.BytesIO()
            Image.fromarray(rng.uniform(0, 255, (*RAW, 3)).astype(np.uint8)).save(buf, format="JPEG", quality=95)
            blob = np.frombuffer(buf.getvalue(), np.uint8)
            images.append(torch.tensor(blob))
            frames.append(np.asarray(Image.open(io.BytesIO(blob.tobytes()))))
        chunk.append({"key": f"scene{s}", "cameras": torch.tensor(cameras), "images": images})
        originals[f"scene{s}"] = (cameras, frames)
    path = root / "000000.torch"
    torch.save(chunk, path)
    return path, originals


@pytest.mark.parametrize("which", ["synthetic", "fixture"])
def test_writer_matches_the_tool_byte_for_byte(which, small_chunk, tmp_path):
    source = small_chunk[0] if which == "synthetic" else FIXTURE / "re10k" / "test" / "000000.torch"
    transcode(source, tmp_path / "port.psz")
    tool_transcode(source, tmp_path / "tool.psz")
    got, want = (tmp_path / "port.psz").read_bytes(), (tmp_path / "tool.psz").read_bytes()
    assert got[:4] == (0x5053505A).to_bytes(4, "little") and len(got) > 12
    assert got == want


def test_importing_builds_nothing():
    """Importing the binding, the dataset and the writer compiles nothing:
    the library builds on first use, in the process that reads a chunk."""
    code = (
        "import subprocess\n"
        "def refuse(*a, **k): raise AssertionError('built at import')\n"
        "subprocess.run = subprocess.Popen = refuse\n"
        "import pixelsplat_tpu_torch.native as n, pixelsplat_tpu_torch.dataset.dataset_re10k\n"
        "import pixelsplat_tpu_torch.scripts.transcode_chunks\n"
        "assert n._lib is None and n.build_error() is None\n"
        "print(n.library_path())\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT)},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    built = Path(proc.stdout.strip())
    assert built.parent == ROOT / "build" / "native" and built.name.startswith("libchunk_loader-")


def test_unbuildable_library_reports_the_compiler_and_reads_torch(monkeypatch, tmp_path):
    """Where g++ fails, `native_available()` is false, `build_error()` holds
    the compiler's message, and a chunk with a `.psz` sibling is read from
    its `.torch` file."""
    monkeypatch.setattr(pt_native, "_lib", None)
    monkeypatch.setattr(pt_native, "_error", None)
    monkeypatch.setattr(pt_native, "SOURCE", tmp_path / "broken.cpp")
    (tmp_path / "broken.cpp").write_text("#include <no_such_header_here.h>\n")
    monkeypatch.setattr(pt_native, "BUILD_DIR", tmp_path / "build")
    assert not pt_native.native_available()
    assert "no_such_header_here.h" in pt_native.build_error()
    (tmp_path / "broken.cpp").write_text("int fixed_now;\n")
    assert not pt_native.native_available()  # one attempt per process, not one per chunk
    chunk = tmp_path / "000000.torch"
    shutil.copy(FIXTURE / "re10k" / "test" / "000000.torch", chunk)
    chunk.with_suffix(".psz").write_bytes(b"")
    assert pt_dataset.chunk_route(chunk) == "torch"


def test_unreadable_psz_sibling_reads_torch(loaders, tmp_path):
    """A `.psz` sibling the loader cannot open (not the container's magic)
    leaves the chunk to its `.torch` file."""
    chunk = tmp_path / "000000.torch"
    shutil.copy(FIXTURE / "re10k" / "test" / "000000.torch", chunk)
    chunk.with_suffix(".psz").write_bytes(b"not a psz container, only some bytes")
    with pytest.raises(OSError):
        pt_native.NativeChunk(chunk.with_suffix(".psz"))
    assert pt_dataset.open_native(chunk) is None and pt_dataset.chunk_route(chunk) == "torch"


def test_native_chunk_matches_jax(loaders, small_chunk, tmp_path):
    """Keys, frame counts, poses and decodes equal to the JAX binding's (the
    same libjpeg), and within 1 of PIL's decode of the same JPEG."""
    psz = tmp_path / "chunk.psz"
    transcode(small_chunk[0], psz)
    got, want = pt_native.NativeChunk(psz, raw_shape=RAW), jx_native.NativeChunk(psz, raw_shape=RAW)
    assert len(got) == len(want) == 2
    for i, key in enumerate(("scene0", "scene1")):
        cameras, frames = small_chunk[1][key]
        assert got.key(i) == want.key(i) == key
        assert got.num_frames(i) == want.num_frames(i) == len(frames)
        np.testing.assert_array_equal(got.poses(i), want.poses(i))
        np.testing.assert_array_equal(got.poses(i), cameras)
        decoded = got.decode_frames(i, list(range(len(frames))), n_threads=2)
        np.testing.assert_array_equal(decoded, want.decode_frames(i, list(range(len(frames))), n_threads=2))
        for j, ref in enumerate(frames):
            assert np.abs(decoded[j].astype(int) - ref.astype(int)).max() <= 1
    # A subset in any order; a bad index and a wrong expected size raise.
    assert got.decode_frames(0, [2, 0], n_threads=1).shape == (2, *RAW, 3)
    with pytest.raises(ValueError):
        got.decode_frames(0, [99])
    with pytest.raises(ValueError):
        pt_native.NativeChunk(psz, raw_shape=(8, 8)).decode_frames(0, [0])
    got.close()
    want.close()


@pytest.fixture(scope="module")
def psz_root(tmp_path_factory):
    """The synthetic train and test chunks of `test_torch_dataset.py` (360x640
    JPEG frames), each with a `.psz` sibling written by the port."""
    root = tmp_path_factory.mktemp("re10k_psz")
    rng = np.random.default_rng(0)
    for stage, chunks in {"train": [["a", "b"]], "test": [["c", "d"], ["e", "f"]]}.items():
        d = root / stage
        d.mkdir()
        index = {}
        for i, scenes in enumerate(chunks):
            path = d / f"{i:06d}.torch"
            torch.save(jx_dataset_tests.make_chunk(scenes, rng), path)
            transcode(path, path.with_suffix(".psz"))
            index.update({s: path.name for s in scenes})
        json.dump(index, (d / "index.json").open("w"))
    return root


def bounded(pkg):
    return pkg.ViewSamplerBoundedCfg(
        num_context_views=2, num_target_views=2, min_distance_between_context_views=3,
        max_distance_between_context_views=6,
    )


@pytest.mark.parametrize("stage,overfit", [("train", None), ("test", None), ("train", "c")])
def test_psz_route_equals_jax_psz_route(loaders, psz_root, stage, overfit):
    """Every example of a stage on the `.psz` route, port against JAX, bit
    for bit: the train stage's shuffle of chunks and scenes and its
    augmentation draw alike, and `overfit_to_scene` repeats the scene."""
    jds, pds = dataset_pair(psz_root, (bounded(jx_samplers), bounded(pt_samplers)), stage, seed=81,
                            overfit_to_scene=overfit)
    assert all(pt_dataset.chunk_route(c) == "psz" for c in pds.chunks)
    want, got = list(jds), list(pds)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert_examples_equal(g, w, f"{stage}/{g['scene']}")
    if overfit is not None:
        assert {g["scene"] for g in got} == {overfit}
    assert jds.rng.random() == pds.rng.random()  # the generators drew alike


def test_fixture_batches_on_both_routes(loaders, tmp_path):
    """The evaluation protocol's batches of the repo's fixture: on the `.psz`
    route equal to the JAX package's `.psz` route bit for bit, and within
    1/255 of the `.torch` route's images (PIL's libjpeg against the
    system's), cameras equal."""
    root = tmp_path / "re10k"
    shutil.copytree(FIXTURE / "re10k", root)
    chunk = root / "test" / "000000.torch"
    transcode(chunk, chunk.with_suffix(".psz"))
    assert pt_dataset.chunk_route(chunk) == "psz"
    assert pt_dataset.chunk_route(FIXTURE / "re10k" / "test" / "000000.torch") == "torch"
    overrides = [o for o in EVAL_OVERRIDES if not o.startswith("dataset.roots")]
    inline = ["data_loader.test.num_workers=0"]
    jdm, pdm = data_modules(overrides + [f"dataset.roots=[{root}]"] + inline)
    got, want = list(pdm.test_dataloader()), list(jdm.test_dataloader())
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert_examples_equal(g, w, g["scene"][0])
    _, pdm_torch = data_modules(EVAL_OVERRIDES + inline)
    for g, t in zip(got, pdm_torch.test_dataloader()):
        assert g["scene"] == t["scene"]
        for side in ("context", "target"):
            diff = np.abs(g[side]["image"] - t[side]["image"])
            assert diff.max() <= 1 / 255 + 1e-7, f"{g['scene']} {side}: {diff.max() * 255:.3f} / 255"
            for key in ("extrinsics", "intrinsics", "near", "far", "index"):
                np.testing.assert_array_equal(g[side][key], t[side][key])
