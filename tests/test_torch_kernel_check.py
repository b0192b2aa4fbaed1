"""`scripts/check_composite_bwd.py`: the comparison that holds the backward
compositing kernel to its plain version and accepts a disagreement only
when it is traced to a (slot, pixel) pair within rounding of a threshold.

No CUDA kernel runs on the CPU, so the kernel's part is played by the
plain versions evaluated in float64 and cast back: another rounding of the
same function, as the kernel is. The inputs place one pair where float32
and float64 fall on opposite sides of a threshold. Tolerance: 1e-4 of each
column's largest |gradient|, the tolerance the on-card check uses; the two
roundings otherwise agree to ~1e-6.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pixelsplat_tpu_torch.ops.rasterizer import composite_kernel as ck
from pixelsplat_tpu_torch.scripts import check_composite_bwd as check

CHUNK, TILES_X, RTOL = 128, 2, 1e-4
G, SLOT, PIXEL = 200, 7, 37  # the pair: tile 0's slot 7, pixel (x 5, y 2)
SHARED = 120  # a Gaussian that tiles 0 and 1 both list; slot 20 of tile 1


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Many small tensor operations: threads only contend with the other
    test processes' for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def fwd64(table, flat, block_start, counts, tiles_x, chunk):
    acc, trans, n_proc = ck.composite_core_plain(table.double(), flat, block_start, counts, tiles_x, chunk)
    return acc.float(), trans.float(), n_proc


def bwd64(table, flat, block_start, counts, n_proc, trans, g_acc, g_trans, tiles_x, chunk):
    return ck.composite_bwd_plain(
        table.double(), flat, block_start, counts, n_proc, trans.double(), g_acc.double(), g_trans.double(),
        tiles_x, chunk,
    )[1].float()


def make_inputs(table):
    """One view's backward inputs over a 32x32 image: tile 0 lists Gaussians
    0..149, tile 1 100..199, tile 2 none, tile 3 50..99."""
    rng = np.random.default_rng(5)
    lists = [np.arange(0, 150), np.arange(100, 200), np.arange(0), np.arange(50, 100)]
    flat, block_start = [], []
    for ids in lists:
        block_start.append(len(flat) // CHUNK)
        flat.extend(list(ids) + [G] * (-len(ids) % CHUNK))
    flat.extend([G] * CHUNK)
    tiles = SimpleNamespace(
        flat=torch.tensor(flat, dtype=torch.int32), block_start=torch.tensor(block_start, dtype=torch.int32),
        counts=torch.tensor([len(ids) for ids in lists], dtype=torch.int32),
    )
    table = torch.as_tensor(table)
    _, trans, n_proc = fwd64(table, tiles.flat, tiles.block_start, tiles.counts, TILES_X, CHUNK)
    g_acc = torch.as_tensor(rng.normal(size=(4, 8, 256)).astype(np.float32))
    g_trans = torch.as_tensor(rng.normal(size=(4, 256)).astype(np.float32))
    return dict(table=table, tiles=tiles, n_proc=n_proc, trans=trans, g_acc=g_acc, g_trans=g_trans,
                tiles_x=TILES_X, chunk=CHUNK)


def base_table():
    rng = np.random.default_rng(3)
    table = np.zeros((G + 1, 12), np.float32)
    table[:G, 0] = rng.uniform(0, 32, G)
    table[:G, 1] = rng.uniform(0, 32, G)
    table[:G, 2] = rng.uniform(0.02, 0.3, G)
    table[:G, 3] = rng.uniform(-0.01, 0.01, G)
    table[:G, 4] = rng.uniform(0.02, 0.3, G)
    table[:G, 5] = rng.uniform(0.05, 0.3, G)
    table[:G, 6:9] = rng.uniform(0, 1, (G, 3))
    return table


def candidates(threshold, gaussian=SLOT, tile=0):
    """Tables that put the pair (`gaussian`, PIXEL of `tile`) ever closer to
    `threshold`; float32 and float64 disagree about some of them."""
    table = base_table()
    px, py = 16 * tile + PIXEL % 16, PIXEL // 16
    if threshold == "raw = 1/255":
        table[gaussian, :2] = (px + 2.5, py - 1.5)
        dx, dy = np.float64(px) - table[gaussian, 0], np.float64(py) - table[gaussian, 1]
        a, b, c = (np.float64(table[gaussian, j]) for j in (2, 3, 4))
        opacity = np.float32(ck.MIN_ALPHA / np.exp(-0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy))
        for ulps in range(-6, 7):
            out = table.copy()
            out[gaussian, 5] = opacity + ulps * np.spacing(opacity)
            yield out
    else:  # power = 0: a degenerate conic, -0.5 (dx - dy)^2, its axis 2^-21 off the pixel's diagonal:
        # float64 gives -1e-13 along it, float32 the rounding of the three terms, of either sign
        table[SLOT, 2:6] = (1.0, -1.0, 1.0, 0.5)
        for k in range(12):
            out = table.copy()
            out[SLOT, 0] = px - 3.3 - 0.013 * k
            out[SLOT, 1] = py - 3.3 - 0.013 * k + 2.0**-21
            yield out


def disagreeing_inputs(threshold, **where):
    for table in candidates(threshold, **where):
        inp = make_inputs(table)
        if not check.compare(inp, RTOL, max_tiles=0, fwd=fwd64, bwd=bwd64)["ok"]:
            return inp
    raise AssertionError(f"no candidate puts float32 and float64 on opposite sides of {threshold}")


@pytest.mark.parametrize("threshold", ["raw = 1/255", "power = 0"])
def test_a_pair_at_a_threshold_is_found_and_explained(threshold):
    inp = disagreeing_inputs(threshold)
    result = check.compare(inp, RTOL, fwd=fwd64, bwd=bwd64)
    assert result["max_rel_err"] > RTOL  # reported over all rows, nothing taken out
    assert result["ok"] and result["residual_rel_err"] <= RTOL
    (tile,) = result["tiles"]
    assert tile["tile"] == 0 and tile["explained"] and tile["before"] > RTOL >= tile["after"]
    closest = tile["pairs"][0]
    assert (closest["gaussian"], closest["threshold"]) == (SLOT, threshold)
    assert closest["units"] <= check.NEAR_UNITS
    if threshold == "raw = 1/255":
        assert (closest["slot"], closest["pixel"]) == (SLOT, PIXEL)
    assert any("explained" in line for line in check.report(result))


def test_the_tile_at_fault_is_found_among_those_that_list_the_row(monkeypatch):
    """Tile 0 lists the Gaussian too and is tried first; alone it agrees."""
    inp = disagreeing_inputs("raw = 1/255", gaussian=SHARED, tile=1)
    tried, explain_tile = [], check.explain_tile
    monkeypatch.setattr(check, "explain_tile", lambda i, tile, *a: tried.append(tile) or explain_tile(i, tile, *a))
    result = check.compare(inp, RTOL, fwd=fwd64, bwd=bwd64)
    assert tried == [0, 1]
    (tile,) = result["tiles"]
    assert result["ok"] and tile["tile"] == 1 and tile["explained"]
    closest = tile["pairs"][0]
    assert (closest["slot"], closest["gaussian"], closest["pixel"]) == (SHARED - 100, SHARED, PIXEL)


def test_agreeing_versions_need_no_explanation():
    result = check.compare(make_inputs(base_table()), RTOL, fwd=fwd64, bwd=bwd64)
    assert result["ok"] and not result["tiles"] and result["max_rel_err"] < 1e-5


@pytest.mark.parametrize("fault", ["scaled column", "one tile's rows", "a row far from any threshold"])
def test_a_wrong_kernel_is_not_excused(fault):
    """Also with a real threshold pair in the inputs, which must not cover
    for the fault."""

    def wrong(*args):
        d = bwd64(*args)
        if fault == "scaled column":
            d[:, 5] *= 1.001
        elif fault == "one tile's rows":
            d[100:200] *= 1.01
        else:
            d[60, 0] += 1e-3 * d[:, 0].abs().max()
        return d

    for inp in (make_inputs(base_table()), disagreeing_inputs("raw = 1/255")):
        result = check.compare(inp, RTOL, fwd=fwd64, bwd=wrong)
        assert not result["ok"]
        assert result["max_rel_err"] > RTOL
