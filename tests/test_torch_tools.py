"""The kernel tools of the port (`scripts/kernel_smoke.py`,
`bench_segment_sum.py`, `bench_kernel_ablation.py` and the wrappers behind
them) on the CPU.

The three TPU tools they replace (`tools/pallas_smoke.py`,
`tools/bench_segment_sum.py`, `tools/bench_kernel_ablation.py`) run their
kernels on a TPU while they are imported, so they cannot be imported here.
These tests hold the port against the JAX functions those tools call
(`_xla_composite_core`, `pallas_composite_core` in interpret mode,
`segment_sum_rows`) and against numpy. On the CPU each wrapper runs its
kernel's plain version; the kernels themselves run only on a CUDA device,
where `chip_smoke.py` holds them against the same plain versions.
"""

import re
import subprocess
import sys
import os
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelsplat_tpu.ops.rasterizer import composite as jx_composite
from pixelsplat_tpu.ops.rasterizer.pallas_composite import pallas_composite_core
from pixelsplat_tpu.ops.rasterizer.tile_gather import segment_sum_rows
from pixelsplat_tpu_torch import kernel_build
from pixelsplat_tpu_torch.ops import kernel_tools
from pixelsplat_tpu_torch.ops.rasterizer import composite_ablation
from pixelsplat_tpu_torch.ops.rasterizer import composite_kernel as pt_kernel
from pixelsplat_tpu_torch.scripts import (
    bench_kernel_ablation,
    bench_segment_sum,
    bench_tool_kernels,
    check_alpha_threshold,
    kernel_smoke,
)
from pixelsplat_tpu_torch.utils import tracing

from test_torch_encoder import t
from test_torch_rasterizer import composite_case

ROOT = Path(__file__).resolve().parent.parent


# ---------------------------------------------------------------------------
# y = 2 x and the row-major copy: plain versions against numpy


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: next to the other test processes, more threads
    only contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("shape", [(256, 256), (7,), (3, 5, 2)])
def test_smoke_scale_plain_and_cpu_dispatch(shape):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    before = tracing.counter("smoke_scale_launches")
    got = kernel_tools.smoke_scale(t(x))
    np.testing.assert_array_equal(got.numpy(), x * 2)  # exact: a power of two
    assert torch.equal(got, kernel_tools.smoke_scale_plain(t(x)))
    assert tracing.counter("smoke_scale_launches") == before  # no kernel on a CPU tensor


@pytest.mark.parametrize("dtype", [np.int16, np.float32, np.float64], ids=["2B", "4B", "8B"])
@pytest.mark.parametrize("layout", ["contiguous", "transposed", "strided"])
def test_copy_rows_plain_and_cpu_dispatch(dtype, layout):
    rng = np.random.default_rng(1)
    base = (rng.normal(size=(37, 24)) * 1000).astype(dtype)
    if layout == "contiguous":
        x = t(base)
    elif layout == "transposed":
        x = t(np.ascontiguousarray(base.T)).t()  # same values, column-major
        assert x.stride() == (1, 37)
    else:
        x = t(np.repeat(np.repeat(base, 2, axis=0), 3, axis=1))[::2, ::3]
        assert x.stride() == (144, 3)
    before = tracing.counter("copy_rows_launches")
    got = kernel_tools.copy_rows(x)
    assert got.is_contiguous() and got.data_ptr() != x.data_ptr()
    np.testing.assert_array_equal(got.numpy(), np.ascontiguousarray(base))  # bit-exact
    assert torch.equal(got, kernel_tools.copy_rows_plain(x))
    assert tracing.counter("copy_rows_launches") == before


def test_copy_rows_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="2-D"):
        kernel_tools.copy_rows(torch.zeros((2, 3, 4)))
    with pytest.raises(ValueError, match="2, 4 or 8 bytes"):
        kernel_tools.copy_rows(torch.zeros((2, 3), dtype=torch.uint8))


# The copy kernel's route for each layout `bench_tool_kernels` times
# (built at n = 384 rows, no multiple of a 256-row tile) and for each edge
# layout it checks on the card.
TIMED_ROUTES = ["flat", "column_major", "column_major", "column_major", "general"]
EDGE_ROUTES = {
    "f64 (1001, 5) contiguous": "flat",
    "f64 (1001, 5) transposed": "column_major",
    "f32 (777, 1) contiguous": "flat",
    "f32 (777, 1) column view": "column_major",
    "int16 (1001, 24) row-major, 2 bytes off a 16-byte boundary": "general",
    "int16 (1001, 24) column-major, 2 bytes off": "column_major",
    "f32 (300, 200) transposed, in column groups": "column_major",
    "f32 (5, 3) column-major": "column_major",
}


@pytest.fixture(scope="module")
def copy_cases():
    timed = bench_tool_kernels.copy_layouts("cpu", n=384)
    return {**{i: x for i, x in enumerate(timed.values())}, **bench_tool_kernels.edge_layouts("cpu")}


@pytest.mark.parametrize(
    "key,route",
    [*enumerate(TIMED_ROUTES), *EDGE_ROUTES.items()],
    ids=[f"timed{i}" for i in range(len(TIMED_ROUTES))] + list(EDGE_ROUTES),
)
def test_copy_rows_route(copy_cases, key, route):
    x = copy_cases[key]
    aligned_out = torch.empty(x.shape, dtype=x.dtype).data_ptr()
    assert aligned_out % 16 == 0
    assert kernel_tools.copy_rows_route(tuple(x.shape), x.stride(), x.element_size(), x.data_ptr(), aligned_out) == route
    before = tracing.counter("copy_rows_launches")
    got = kernel_tools.copy_rows(x)
    assert got.is_contiguous() and bench_tool_kernels.same_bits(got, x.clone())
    assert tracing.counter("copy_rows_launches") == before


def test_copy_rows_timed_layouts_are_the_benchs():
    """The five timed layouts: the segment-sum bench's 16-bit table both
    ways, its `d_rows` and `csum` tables as `segment_sum_sorted` makes
    them, and a view with padded rows."""
    n, f = 384, 12
    layouts = list(bench_tool_kernels.copy_layouts("cpu", n=n).values())
    assert [tuple(x.shape) for x in layouts] == [(n, 24), (n, 24), (n, f), (n + 1, f), (n, f - 1)]
    assert [x.stride() for x in layouts] == [(24, 1), (1, n), (1, n), (1, n + 1), (f, 1)]
    d_rows, ids = bench_segment_sum.bench_inputs("cpu", n=n, f=f)
    seen = []
    got = kernel_tools.segment_sum_sorted(d_rows, ids, 50, anchor=lambda t: seen.append(t) or t)
    assert torch.equal(got, kernel_tools.segment_sum_sorted(d_rows, ids, 50))
    assert [(tuple(t.shape), t.stride()) for t in seen] == [((n, f), (1, n)), ((n + 1, f), (1, n + 1))]
    assert torch.equal(layouts[2], d_rows) and torch.equal(layouts[3][1:], d_rows)


@pytest.mark.parametrize(
    "shape,strides,itemsize,in_ptr,out_ptr,route",
    [
        ((8, 4), (4, 1), 4, 256, 512, "flat"),
        ((8, 4), (4, 1), 4, 260, 512, "general"),  # input off a 16-byte boundary
        ((8, 4), (1, 8), 4, 260, 512, "column_major"),  # column starts need not be aligned
        ((8, 4), (1, 4), 4, 256, 512, "general"),  # columns overlap: stride1 < n
        ((8, 4), (0, 1), 4, 256, 512, "general"),  # stride 0
        ((8, 4), (8, 1), 8, 256, 512, "general"),  # padded rows
        ((8, 4), (4, 1), 2, 256, 520, "general"),  # output off a 16-byte boundary
    ],
)
def test_copy_rows_route_by_numbers(shape, strides, itemsize, in_ptr, out_ptr, route):
    assert kernel_tools.copy_rows_route(shape, strides, itemsize, in_ptr, out_ptr) == route


@pytest.mark.parametrize("which", ["smoke_scale", "copy_rows", "segment_sum_atomic", "composite_core_ablation"])
def test_tool_wrappers_take_cpu_or_cuda_only(which):
    """No quiet plain-version path for a tensor that is not on the CPU."""
    x = torch.zeros((4, 12), device="meta")
    ints = torch.zeros((4,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        if which == "segment_sum_atomic":
            kernel_tools.segment_sum_atomic(x, ints, 3)
        elif which == "composite_core_ablation":
            composite_ablation.composite_core_ablation("full", x, ints, ints, ints, 1, 128)
        else:
            getattr(kernel_tools, which)(x)


# ---------------------------------------------------------------------------
# The compositor without early exit (the ablation's `full`)


def params_of_lists(table, flat, block_start, counts, chunk=128):
    """The (T, F, Kpad) per-tile parameter array `_xla_composite_core`
    takes, gathered from the port's table and flat lists."""
    n_blocks = int(np.max((counts + chunk - 1) // chunk))
    idx = np.full((len(counts), n_blocks * chunk), table.shape[0] - 1, np.int64)
    for tile, (start, n) in enumerate(zip(block_start, counts)):
        idx[tile, :n] = flat[start * chunk : start * chunk + n]
    return table[idx].transpose(0, 2, 1)


def test_plain_no_exit_compositor_matches_xla_core():
    """`composite_core_plain(early_exit=False)` against the JAX package's
    exact scan, on lists where the early-exiting version stops tile 0 after
    its first chunk: without the exit both composite every chunk."""
    table, flat, block_start, counts = composite_case()
    acc_j, trans_j = jx_composite._xla_composite_core(
        jnp.asarray(params_of_lists(table, flat, block_start, counts)), jnp.asarray(counts), 2
    )
    args = (t(table), t(flat), t(block_start), t(counts), 2, 128)
    acc_p, trans_p, n_p = pt_kernel.composite_core_plain(*args, early_exit=False)
    assert n_p.tolist() == [3, 2, 0, 1]
    # The same running products in f32; exp and the 256-term sums may round apart.
    np.testing.assert_allclose(acc_p.numpy(), np.asarray(acc_j).transpose(0, 2, 1), atol=2e-6)
    np.testing.assert_allclose(trans_p.numpy(), np.asarray(trans_j), atol=2e-6)
    # With the exit, tile 0 stops two chunks early and keeps T < 1e-4 there.
    acc_e, trans_e, n_e = pt_kernel.composite_core_plain(*args)
    assert n_e.tolist() == [1, 2, 0, 1]
    assert float((acc_e - acc_p).abs().max()) <= 1e-4
    # The wrapper's two plain variants on the CPU, and no plain version for a stub.
    for name, want in (("full", (acc_p, trans_p, n_p)), ("exit_vote", (acc_e, trans_e, n_e))):
        got = composite_ablation.composite_core_ablation(name, *args)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), name
    with pytest.raises(ValueError, match="no plain version"):
        composite_ablation.composite_core_ablation("-colors", *args)
    with pytest.raises(ValueError, match="unknown variant"):
        composite_ablation.composite_core_ablation("-split3", *args)


def test_plain_no_exit_compositor_matches_pallas_interpret_where_no_tile_exits():
    table, flat, block_start, counts = composite_case()
    table[:300, 5] = 0.02  # tile 0 made faint: no tile's T falls below 1e-4
    tiles_x, chunk = 2, 128
    idx = jnp.concatenate([jnp.asarray(flat), jnp.full((8 * chunk,), table.shape[0] - 1, jnp.int32)])
    params_u = jx_composite._gather_params_u16(jnp.asarray(table), idx, chunk)
    acc_j, trans_j, n_j = pallas_composite_core(
        params_u, jnp.asarray(counts), jnp.asarray(block_start), tiles_x, 4, interpret=True
    )
    acc_p, trans_p, n_p = pt_kernel.composite_core_plain(
        t(table), t(flat), t(block_start), t(counts), tiles_x, chunk, early_exit=False
    )
    assert n_p.tolist() == np.asarray(n_j).tolist() == [3, 2, 0, 1]
    assert float(trans_p[0].max()) > 1e-4
    # The Pallas kernel's own tolerance against the XLA scan
    # (tests/test_pallas_interpret.py): its prefix products are
    # exp-of-log-sums on split matmuls.
    np.testing.assert_allclose(acc_p.numpy(), np.asarray(acc_j), atol=2e-4)
    np.testing.assert_allclose(trans_p.numpy(), np.asarray(trans_j), atol=2e-4)


def test_kernel_smoke_input_is_the_tools_input():
    """`kernel_smoke.smoke_tile_inputs` holds `tools/pallas_smoke.py`'s
    arrays (same seed, same draws in the same order) in the port's table +
    list contract: composited, they give what the JAX package's scan gives
    on the tool's (T, F, K) array."""
    tiles, slots = kernel_smoke.SMOKE_TILES, kernel_smoke.SMOKE_SLOTS
    rng = np.random.default_rng(0)
    params = np.zeros((tiles, 12, slots), np.float32)
    params[:, 0] = rng.uniform(0, 64, (tiles, slots))
    params[:, 1] = rng.uniform(0, 16, (tiles, slots))
    params[:, 2] = params[:, 4] = 0.5
    params[:, 5] = rng.uniform(0.1, 0.6, (tiles, slots))
    params[:, 6:9] = rng.uniform(0, 1, (tiles, 3, slots))
    table, flat, block_start, counts = kernel_smoke.smoke_tile_inputs("cpu")
    np.testing.assert_array_equal(params_of_lists(table.numpy(), flat.numpy(), block_start.numpy(), counts.numpy()), params)
    acc_j, trans_j = jx_composite._xla_composite_core(jnp.asarray(params), jnp.asarray(counts.numpy()), 4)
    acc_p, trans_p, _ = pt_kernel.composite_core(table, flat, block_start, counts, kernel_smoke.SMOKE_TILES_X)
    np.testing.assert_allclose(acc_p.numpy(), np.asarray(acc_j).transpose(0, 2, 1), atol=2e-6)
    np.testing.assert_allclose(trans_p.numpy(), np.asarray(trans_j), atol=2e-6)
    result = kernel_smoke.run_smoke("cpu")  # both checks through the plain versions
    assert result == {"mean": 2.0, "scale_max_err": 0.0, "composite_max_err": 0.0}


def test_ablation_variants_name_the_headers_masks():
    """`composite_ablation.VARIANTS` and the masks in the shared header
    agree, and the .cu instantiates exactly the variants the table names."""
    header = (kernel_build.CSRC / "composite_fwd_body.cuh").read_text()
    masks = {name: int(value) for name, value in re.findall(r"constexpr unsigned (kDrop\w+) = (\d+)u;", header)}
    assert masks == {
        "kDropGather": composite_ablation.DROP_GATHER,
        "kDropPower": composite_ablation.DROP_POWER,
        "kDropExpPower": composite_ablation.DROP_EXP_POWER,
        "kDropTransmittance": composite_ablation.DROP_TRANSMITTANCE,
        "kDropColours": composite_ablation.DROP_COLOURS,
        "kDropEverything": composite_ablation.DROP_EVERYTHING,
    }
    assert composite_ablation.DROP_EVERYTHING == sum(v for k, v in masks.items() if k != "kDropEverything")
    source = (kernel_build.CSRC / "composite_fwd_ablation.cu").read_text()
    launched = re.findall(r"LAUNCH_VARIANT\((?:composite::)?(\w+), (true|false)\)", source)
    instantiated = {(masks.get(drop, 0), vote == "true") for drop, vote in launched if drop != "DROP"}
    assert instantiated == set(composite_ablation.VARIANTS.values())
    assert list(composite_ablation.VARIANTS)[:2] == ["full", "exit_vote"]
    # Both kernels take their device code from the one header.
    for name in ("composite_fwd.cu", "composite_fwd_ablation.cu"):
        text = (kernel_build.CSRC / name).read_text()
        assert '#include "composite_fwd_body.cuh"' in text and "composite_tile<" in text
        assert "expf(" not in text  # the arithmetic lives in the header only


def test_tool_scene_lists_small():
    """The ablation bench's scene at a small size: lists without overflow,
    on which `full` and `exit_vote` agree with their plain versions."""
    table, tiles, tiles_x = bench_kernel_ablation.tool_scene_lists("cpu", g=6000, image_shape=(64, 64))
    assert table.shape == (6001, 12) and tiles_x == 4 and int(tiles.overflow) == 0
    assert int(tiles.counts.max()) > 128  # more than one chunk somewhere
    lists = (table, tiles.flat, tiles.block_start, tiles.counts)
    _, _, n_full = composite_ablation.composite_core_ablation("full", *lists, tiles_x)
    assert torch.equal(n_full, (tiles.counts + 127) // 128)


def test_alpha_threshold_lists_crowd_the_threshold():
    """`check_alpha_threshold`'s lists: 256 tiles of two full chunks. The
    `threshold` family puts many (slot, pixel) pairs within 1 % of alpha =
    1/255 while T stays near 1; `clamp` puts every pixel's own Gaussian
    within 1e-5 of op exp(power) = 0.99; `power_cut` puts hundreds of
    pairs within 1e-6 below power = 0 (and a few rounded above it). On the
    CPU the wrappers run the plain versions, so the check finds nothing."""
    crowded = {
        "threshold": lambda power, raw: ((raw * 255 - 1).abs() < 0.01).sum() > 100,
        "clamp": lambda power, raw: ((raw / check_alpha_threshold.MAX_ALPHA - 1).abs() < 1e-5).sum() == 256,
        "power_cut": lambda power, raw: ((power > -1e-6) & (power <= 0)).sum() > 100 and (power > 0).any(),
    }
    assert tuple(crowded) == check_alpha_threshold.FAMILIES
    for family, is_crowded in crowded.items():
        table, flat, block_start, counts = check_alpha_threshold.crowded_lists(0, "cpu", family)
        assert table.shape == (256 * 256 + 1, 12) and not bool(table[-1].any())
        assert counts.tolist() == [256] * 256 and block_start.tolist() == list(range(0, 512, 2))
        acc, trans, n_proc = pt_kernel.composite_core_plain(table, flat, block_start, counts, 16, 128)
        assert n_proc.tolist() == [2] * 256, family  # no tile exits early
        assert float(trans.min()) > (0.1 if family == "threshold" else 1e-3), family
        rows = table[flat[:256].long()]  # tile 0's Gaussians
        px = torch.arange(256) % 16
        py = torch.arange(256) // 16
        dx, dy = px[None] - rows[:, 0, None], py[None] - rows[:, 1, None]
        power = -0.5 * (rows[:, 2, None] * dx * dx + rows[:, 4, None] * dy * dy) - rows[:, 3, None] * dx * dy
        alpha = rows[:, 5, None] * torch.exp(power)
        assert is_crowded(power, alpha), family
        # The check itself, forward and backward, on 16 of the tiles for the
        # new families (the plain backward takes seconds per 256 tiles).
        assert check_alpha_threshold.check(1, "cpu", family, tiles_x=16 if family == "threshold" else 4) == dict(
            pixels_beyond=0, tiles_n_proc_differ=0, max_abs_err=0.0, bwd_rows_beyond=0, bwd_max_rel_err=0.0
        ), family


# ---------------------------------------------------------------------------
# Segment sums


@pytest.mark.parametrize("n,rows", [(4096, 1001), (2048, 3000)], ids=["dense", "sparse"])
def test_segment_sum_variants_match_jax(n, rows):
    d_rows, ids = bench_segment_sum.bench_inputs("cpu", n=n, f=12, rows=rows)
    assert d_rows.stride() == (1, n)  # the column-major table the tool's transpose gives
    want = np.asarray(segment_sum_rows(jnp.asarray(d_rows.numpy()), jnp.asarray(ids.numpy()), rows))
    scale = np.abs(want).max()
    for name, fn in bench_segment_sum.variants(d_rows, ids, rows).items():
        got = fn()
        assert got.shape == (rows, 12), name
        # The tool's own tolerance (tools/bench_segment_sum.py:201-203): f32
        # sums in another order; the sorted ways difference two prefix sums.
        assert float(np.abs(got.numpy() - want).max()) <= 1e-5 * scale, name
    errors = bench_segment_sum.check_variants(bench_segment_sum.variants(d_rows, ids, rows))
    assert errors["index_add"] == 0.0 and max(errors.values()) <= bench_segment_sum.RTOL


def test_u16_table_views():
    d_rows, _ = bench_segment_sum.bench_inputs("cpu", n=256, f=12, rows=10)
    contiguous, transposed = bench_segment_sum.u16_table(d_rows)
    assert contiguous.shape == transposed.shape == (256, 24) and contiguous.element_size() == 2
    assert contiguous.stride() == (24, 1) and transposed.stride() == (1, 256)
    assert torch.equal(contiguous, transposed)
    assert torch.equal(kernel_tools.copy_rows(transposed), contiguous)


# ---------------------------------------------------------------------------
# Importing builds nothing


def test_tool_scripts_import_without_building(tmp_path):
    code = (
        "import importlib\n"
        "from pixelsplat_tpu_torch import kernel_build\n"
        "for n in ('kernel_smoke', 'bench_segment_sum', 'bench_tool_kernels', 'bench_kernel_ablation', 'eval_scene', 'train_scene', 'profile_scene', 'check_project_bin', 'bench_conv7', 'bench_linear', 'bench_conv3x3'):\n"
        "    importlib.import_module('pixelsplat_tpu_torch.scripts.' + n)\n"
        "importlib.import_module('pixelsplat_tpu_torch.ops.kernel_tools')\n"
        "importlib.import_module('pixelsplat_tpu_torch.ops.rasterizer.composite_ablation')\n"
        "import sys; assert 'jax' not in sys.modules and 'pixelsplat_tpu' not in sys.modules\n"
        "assert not kernel_build._loaded\n"
        "print(sorted(kernel_build.kernel_names()))\n"
    )
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "PATH": str(tmp_path), "PYTHONPATH": str(ROOT)}
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == str(
        ["composite_bwd", "composite_fwd", "composite_fwd_ablation", "conv3x3", "conv7", "copy_rows", "linear_split",
         "project_bin", "smoke_scale"]
    )
    assert not list(tmp_path.iterdir())


# ---------------------------------------------------------------------------
# One launch path


def test_only_kernel_build_reads_the_stream_or_declares_return_types():
    """Every kernel wrapper launches through `kernel_build.launch` and types
    its entry points with `kernel_build.declare`: no other module of the
    package reads a stream handle or sets a `restype`, but for the bench's
    check that the launch path's handle is PyTorch's."""
    package = ROOT / "pixelsplat_tpu_torch"
    found = sorted(str(p.relative_to(package)) for p in package.rglob("*.py")
                   if re.search(r"cuda_stream|restype", p.read_text()))
    assert found == ["kernel_build.py", "scripts/bench_tool_kernels.py"]
    check = bench_tool_kernels.raw_stream_matches
    assert "cuda_stream" in check.__code__.co_names


@pytest.mark.parametrize("current", [0, 1], ids=["current_device", "other_device"])
@pytest.mark.parametrize("err", [0, 700])
def test_launch_passes_the_stream_last_and_raises_on_an_error(monkeypatch, current, err):
    """`launch` calls the entry point with its arguments and then the
    device's current raw stream, guards the device only where it is not the
    current one, and raises on a non-zero code."""
    guarded = []

    class Guard:
        def __init__(self, index):
            guarded.append(index)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(kernel_build, "_cuda_get_device", lambda: current)
    monkeypatch.setattr(kernel_build, "_cuda_raw_stream", lambda index: 1000 + index)
    monkeypatch.setattr(torch.cuda, "device", Guard)
    calls = []

    def entry(*args):
        calls.append(args)
        return err

    if err:
        with pytest.raises(RuntimeError, match=f"k launch failed: cudaError {err}"):
            kernel_build.launch("k", entry, 1, 7, None)
    else:
        kernel_build.launch("k", entry, 1, 7, None)
    assert calls == [(7, None, 1001)]
    assert guarded == ([] if current == 1 else [1])


def test_declare_types_each_entry_point():
    """`declare` gives each named entry point its argument types and an int
    return, or the return type a third element names."""
    import ctypes

    lib = ctypes.CDLL(None)  # the C library: `abs` and `labs` stand in for entry points
    assert kernel_build.declare(lib, (("abs", [ctypes.c_int]), ("labs", [ctypes.c_long], ctypes.c_long))) is lib
    assert lib.abs.argtypes == [ctypes.c_int] and lib.abs.restype is ctypes.c_int
    assert lib.labs.restype is ctypes.c_long and lib.labs(-(2**40)) == 2**40
