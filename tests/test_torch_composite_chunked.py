"""The chunk-parallel backward compositor's algorithm, on the CPU.

The CUDA backward kernel (`csrc/composite_bwd.cu`) splits each tile's
sweep by chunk: pass A gives per (chunk, pixel) L = sum log1p(-alpha) and
U = sum alpha tau cg (tau the transmittance from the chunk's start), a scan
per tile turns them back to front into the seeds E (log T after the chunk)
and S (S after the chunk), and pass B sweeps each chunk alone from its
seeds, in linear space (T before a slot is T after it over 1 - alpha, from
T = exp(E) after the chunk's last slot). Here that algorithm is written out
in plain PyTorch and held against
`composite_bwd_plain` and against the Pallas backward kernel in interpret
mode, on the same numpy inputs. The block -> tile map it runs on is
`composite_kernel.chunk_block_map_plain`, the plain twin of the kernel's
map, which is held against a loop over the tiles. Last, the wrappers still
refuse what the kernels do not take.
"""

import numpy as np
import pytest
import torch

from pixelsplat_tpu_torch.ops.rasterizer import composite_kernel as pt_kernel

import test_torch_backward as bwd
import test_torch_rasterizer as rast

CHUNK = bwd.CHUNK
TILES_X = bwd.TILES_X
# Chunked sweep against the one-tile sweep, of each column's largest
# |gradient|: the same f32 formulas, with T at a chunk's start taken as
# exp(E - L) and S summed as exp(E - L) * U per chunk instead of slot by slot.
RTOL = 1e-5
# On a tile whose T_end is clamped to 1e-30 the rebuilt T runs up to ~1e38:
# the plain sweep's exp(x) at |x| ~ 88, where one float32 ulp of x is 7.6e-6,
# carries that relative error, while the chunked sweep multiplies T from
# exp(E) by 1 / (1 - alpha) and stays closer to the exact value.
RTOL_BELOW_CLAMP = 1e-4


def t(x):
    return torch.as_tensor(np.array(x))


def make_lists_in_order(lists, g, order):
    """Flat chunk-aligned lists (sentinel `g` in the tails and one spare
    block at the end) with the tiles laid out in memory in `order`."""
    flat, block_start = [], [0] * len(lists)
    for tile in order:
        ids = lists[tile]
        block_start[tile] = len(flat) // CHUNK
        flat.extend(list(ids) + [g] * (-(-len(ids) // CHUNK) * CHUNK - len(ids)))
    flat.extend([g] * CHUNK)
    counts = np.asarray([len(ids) for ids in lists], np.int32)
    return np.asarray(flat, np.int32), np.asarray(block_start, np.int32), counts


def case(name):
    """(table, flat, block_start, counts) on four 16x16 tiles."""
    if name in ("full_lists", "early_exit", "empty_and_sentinel_tails", "shared_gaussians"):
        return bwd.bwd_case(name)[:4]
    if name == "transmittance_below_clamp":
        return rast.composite_case()
    rng = np.random.default_rng(31)
    g = 520
    table = bwd.random_table(rng, g, opacity=(0.02, 0.2))
    lists = [np.arange(0, 200), np.arange(200, 456), np.arange(456, 520), np.arange(0, 300)]
    if name == "budget_dropped":
        # Tile 1 did not fit the pair budget: binning.py gives it no entries
        # and points it past the end, so block_start is not sorted.
        lists[1] = np.arange(0)
        flat, block_start, counts = make_lists_in_order(lists, g, [0, 1, 2, 3])
        block_start[1] = len(flat) // CHUNK
        return table, flat, block_start, counts
    if name == "tiles_out_of_order":
        return (table, *make_lists_in_order(lists, g, [3, 1, 0, 2]))
    raise KeyError(name)


CASES = ["full_lists", "early_exit", "empty_and_sentinel_tails", "shared_gaussians", "budget_dropped",
         "tiles_out_of_order", "transmittance_below_clamp"]


def chunked_bwd(table, flat, block_start, counts, n_proc, trans, g_acc, g_trans, tiles_x, chunk):
    """The CUDA backward's algorithm in plain PyTorch: map, pass A, scan,
    pass B. Returns (d_slots (n_blocks * chunk, 12), d_table, block_map)."""
    n_blocks = flat.numel() // chunk
    block_map = pt_kernel.chunk_block_map_plain(block_start, counts, n_proc, n_blocks, chunk)
    owned = torch.nonzero(block_map >= 0).flatten()
    tile = block_map[owned].long()
    slot_idx = owned[:, None] * chunk + torch.arange(chunk)[None]  # (B, C)
    r = table[flat[slot_idx].long()]  # (B, C, 12)
    pix_x, pix_y = pt_kernel._pixel_centres(counts.numel(), tiles_x, 16, table)
    mx, my, ca, cb, cc, op = (r[..., j, None] for j in range(6))
    dx = pix_x[tile][:, None, :] - mx  # (B, C, P)
    dy = pix_y[tile][:, None, :] - my
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    expp = torch.exp(power)
    raw = op * expp
    live = (power <= 0) & (raw >= pt_kernel.MIN_ALPHA)
    alpha = torch.where(live, torch.clamp(raw, max=pt_kernel.MAX_ALPHA), 0.0)
    passes = live & (raw < pt_kernel.MAX_ALPHA)
    g = g_acc[tile, :6, :]  # (B, 6, P)
    cg = torch.einsum("bcx,bxp->bcp", r[..., 6:], g)
    la = torch.log1p(-alpha)

    # Pass A, from each chunk's rows alone.
    big_l = la.sum(dim=1)  # (B, P)
    tau = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha[:, :-1]], dim=1), dim=1)
    big_u = (alpha * tau * cg).sum(dim=1)

    # The scan: per tile, back to front, (L, U) -> (E, S).
    seed_e, seed_s = torch.empty_like(big_l), torch.empty_like(big_u)
    row_of = {int(b): i for i, b in enumerate(owned)}
    for tt in range(counts.numel()):
        mine = sorted((int(b) for b in owned[tile == tt]), reverse=True)
        log_t = torch.log(torch.clamp(trans[tt], min=pt_kernel.MIN_TRANS))
        s_run = g_trans[tt] * trans[tt]
        for b in mine:
            i = row_of[b]
            seed_e[i], seed_s[i] = log_t, s_run
            log_t = log_t - big_l[i]
            s_run = s_run + torch.exp(log_t) * big_u[i]

    # Pass B: each chunk from its seeds; suffix sums along the chunk.
    def suffix_inclusive(x):
        return torch.flip(torch.cumsum(torch.flip(x, dims=(1,)), dim=1), dims=(1,))

    # As the kernel does: T before slot i is T after the chunk times
    # 1 / (1 - alpha_j) for the chunk's slots j >= i, multiplied in from the
    # back (so it overflows where the log-space rebuild does).
    inv = torch.where(live, 1.0 / (1.0 - alpha), 1.0)
    from_back = torch.cat([torch.exp(seed_e)[:, None, :], torch.flip(inv, dims=(1,))], dim=1)
    t_i = torch.flip(torch.cumprod(from_back, dim=1)[:, 1:], dims=(1,))
    w = alpha * t_i
    u = w * cg
    s_i = seed_s[:, None, :] + suffix_inclusive(u) - u
    d_alpha = torch.where(passes, t_i * cg - s_i * inv, 0.0)
    d_power = torch.where(passes, d_alpha * raw, 0.0)
    d_chunk = torch.stack(
        [
            ((ca * dx + cb * dy) * d_power).sum(-1),
            ((cc * dy + cb * dx) * d_power).sum(-1),
            (-0.5 * dx * dx * d_power).sum(-1),
            (-dx * dy * d_power).sum(-1),
            (-0.5 * dy * dy * d_power).sum(-1),
            torch.where(passes, d_alpha * expp, 0.0).sum(-1),
            *torch.einsum("bxp,bcp->xbc", g, w),
        ],
        dim=-1,
    )  # (B, C, 12)
    d_slots = torch.zeros((n_blocks * chunk, pt_kernel.ROW), dtype=table.dtype)
    d_slots[slot_idx.flatten()] = d_chunk.reshape(-1, pt_kernel.ROW)
    ids = flat[: n_blocks * chunk].long()
    real = ids < table.shape[0] - 1
    d_table = torch.zeros_like(table)
    d_table.index_add_(0, ids[real], d_slots[real])
    return d_slots, d_table, block_map


def run_case(name):
    table, flat, block_start, counts = case(name)
    g_acc, g_trans = bwd.cotangents(7, len(counts))
    args = (t(table), t(flat), t(block_start), t(counts))
    _, trans, n_proc = pt_kernel.composite_core_plain(*args, TILES_X, CHUNK)
    rest = (n_proc, trans, t(g_acc), t(g_trans), TILES_X, CHUNK)
    plain = pt_kernel.composite_bwd_plain(*args, *rest)
    chunked = chunked_bwd(*args, *rest)
    return (table, flat, block_start, counts, g_acc, g_trans), n_proc, trans, plain, chunked


def assert_columns_close(got, want, rtol, what):
    for col in range(pt_kernel.ROW):
        scale = np.abs(want[:, col]).max() + 1e-12
        np.testing.assert_allclose(got[:, col] / scale, want[:, col] / scale, atol=rtol, err_msg=f"{what}, column {col}")


@pytest.mark.parametrize("name", [c for c in CASES if c != "transmittance_below_clamp"])
def test_chunked_sweep_matches_plain_and_pallas(name):
    inputs, n_proc, trans, (d_slots_p, d_table_p), (d_slots_c, d_table_c, _) = run_case(name)
    table, flat, block_start, counts, g_acc, g_trans = inputs
    if name == "early_exit":
        assert n_proc.tolist() == [1, 2, 0, 1]  # tile 0 stops after 1 of its 3 chunks
    if name == "budget_dropped":
        assert int(block_start[1]) * CHUNK == len(flat) and n_proc[1] == 0
    # Clear of the thresholds where the gradient jumps, so both sides see
    # the same live pairs.
    args = (t(table), t(flat), t(block_start), t(counts))
    assert int(pt_kernel.near_threshold_pairs(*args, n_proc, TILES_X, CHUNK, margin=1e-5).sum()) == 0

    assert bool(torch.isfinite(d_slots_c).all())
    assert_columns_close(d_slots_c.numpy(), d_slots_p.numpy(), RTOL, "per slot, against the plain sweep")
    assert_columns_close(d_table_c.numpy(), d_table_p.numpy(), RTOL, "d_table, against the plain sweep")
    assert np.abs(d_table_c.numpy()[-1]).max() == 0.0  # the sentinel row

    # The Pallas kernel in interpret mode, on the slots some tile composited;
    # its n_proc must be the plain forward's, which the sweep replays.
    _, _, n_proc_j, d_slots_j = bwd.pallas_forward_backward(table, flat, block_start, counts, g_acc, g_trans)
    assert n_proc_j.tolist() == n_proc.tolist()
    done = np.zeros(len(flat), bool)
    for s, n, k in zip(block_start, counts, n_proc.tolist()):
        if n:
            done[s * CHUNK : (s + min(k, -(-n // CHUNK))) * CHUNK] = True
    assert_columns_close(d_slots_c.numpy()[done], d_slots_j[: len(flat)][done], RTOL, "against Pallas")
    assert np.abs(d_slots_c.numpy()[~done]).max(initial=0.0) == 0.0


def test_chunked_sweep_transmittance_below_clamp():
    """Tile 0's final T is below the 1e-30 clamp, so the rebuilt T overflows
    at the front of its chunk on both sides. The Gaussians whose rows the
    plain sweep leaves non-finite are non-finite in the chunked sweep too,
    and every finite row agrees."""
    _, n_proc, trans, (d_slots_p, d_table_p), (d_slots_c, d_table_c, _) = run_case("transmittance_below_clamp")
    assert float(trans[0].max()) < 1e-30
    bad_p = ~torch.isfinite(d_table_p).all(dim=1)
    bad_c = ~torch.isfinite(d_table_c).all(dim=1)
    assert bool(bad_p.any())
    assert torch.equal(bad_p, bad_c)
    slots_bad_p = ~torch.isfinite(d_slots_p).all(dim=1)
    assert torch.equal(slots_bad_p, ~torch.isfinite(d_slots_c).all(dim=1))
    assert_columns_close(d_table_c[~bad_p].numpy(), d_table_p[~bad_p].numpy(), RTOL_BELOW_CLAMP, "finite rows")


def map_by_loop(block_start, counts, n_proc, n_blocks, chunk):
    out = [-1] * n_blocks
    for tile, (s, n, k) in enumerate(zip(block_start.tolist(), counts.tolist(), n_proc.tolist())):
        for c in range(min(k, -(-n // chunk))):
            if 0 <= s + c < n_blocks:
                out[s + c] = tile
    return out


@pytest.mark.parametrize("name", CASES)
def test_chunk_block_map_plain(name):
    table, flat, block_start, counts = case(name)
    _, _, n_proc = pt_kernel.composite_core_plain(t(table), t(flat), t(block_start), t(counts), TILES_X, CHUNK)
    n_blocks = len(flat) // CHUNK
    for n in (n_proc, torch.full_like(n_proc, 99)):  # n_proc past the lists is cut to them
        got = pt_kernel.chunk_block_map_plain(t(block_start), t(counts), n, n_blocks, CHUNK)
        assert got.dtype == torch.int32 and got.shape == (n_blocks,)
        assert got.tolist() == map_by_loop(block_start, counts, n, n_blocks, CHUNK)
    # Every composited chunk has exactly one block, and no block two tiles.
    got = pt_kernel.chunk_block_map_plain(t(block_start), t(counts), n_proc, n_blocks, CHUNK)
    want_chunks = torch.minimum(n_proc.long(), (t(counts).long() + CHUNK - 1) // CHUNK)
    assert torch.equal(torch.bincount(got[got >= 0].long(), minlength=len(counts)), want_chunks)


def bwd_args(**change):
    """Valid CPU inputs of the backward wrapper for 2 tiles, with `change`
    applied."""
    args = dict(
        table=torch.zeros((5, 12)), flat=torch.zeros((256,), dtype=torch.int32),
        block_start=torch.zeros((2,), dtype=torch.int32), counts=torch.zeros((2,), dtype=torch.int32),
        n_proc=torch.zeros((2,), dtype=torch.int32), trans=torch.ones((2, 256)),
        g_acc=torch.zeros((2, 8, 256)), g_trans=torch.zeros((2, 256)), tiles_x=2, chunk=128,
    )
    args.update(change)
    return args


@pytest.mark.parametrize(
    "change, match",
    [
        (dict(table=torch.zeros((5, 12), dtype=torch.float64)), "float32"),
        (dict(table=torch.zeros((5, 9))), r"\(rows, 12\)"),
        (dict(flat=torch.zeros((256,), dtype=torch.int64)), "int32"),
        (dict(counts=torch.zeros((3,), dtype=torch.int32)), "one entry per tile"),
        (dict(chunk=256), "chunks of 1..128"),
        (dict(n_proc=torch.zeros((2,), dtype=torch.int64)), "n_proc"),
        (dict(trans=torch.ones((2, 255))), "trans"),
        (dict(g_acc=torch.zeros((2, 6, 256))), "g_acc"),
        (dict(g_trans=torch.zeros((2, 256), dtype=torch.float64)), "g_trans"),
        (dict(g_acc=torch.zeros((2, 256, 8)).transpose(1, 2)), "contiguous"),
    ],
)
def test_backward_wrapper_rejects_what_the_kernel_does_not_take(change, match):
    """The CUDA path's checks, which run before the library is loaded."""
    with pytest.raises(ValueError, match=match):
        pt_kernel._launch_bwd(**bwd_args(**change))


@pytest.mark.parametrize(
    "change, match",
    [
        (dict(table=torch.zeros((5, 12), dtype=torch.float16)), "float32"),
        (dict(block_start=torch.zeros((2, 1), dtype=torch.int32)), "1-D int32"),
        (dict(chunk=0), "chunks of 1..128"),
        (dict(table=torch.zeros((5, 24))[:, ::2]), "contiguous"),
    ],
)
def test_forward_wrapper_rejects_what_the_kernel_does_not_take(change, match):
    a = bwd_args(**change)
    with pytest.raises(ValueError, match=match):
        pt_kernel._launch(a["table"], a["flat"], a["block_start"], a["counts"], a["tiles_x"], a["chunk"])
