"""The port's backward compositing against the JAX package's, on the CPU.

`composite_bwd_plain` (the plain version of the CUDA backward kernel) is
held slot by slot against the Pallas backward kernel in interpret mode,
`CompositePacked` against finite differences in float64, and the port's
`render` gradients against `jax.grad` of the JAX `render`. Inputs are made
with numpy from a seed; each tolerance is stated where it is used.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelsplat_tpu.ops.rasterizer import composite as jx_composite
from pixelsplat_tpu.ops.rasterizer.pallas_backward import pallas_composite_bwd
from pixelsplat_tpu.ops.rasterizer.pallas_composite import NPROC_CH, TRANS_CH, pallas_composite_core
from pixelsplat_tpu_torch.ops.rasterizer import composite as pt_composite
from pixelsplat_tpu_torch.ops.rasterizer import composite_kernel as pt_kernel
from pixelsplat_tpu_torch.utils import tracing

import test_torch_rasterizer as rast

jx_render = importlib.import_module("pixelsplat_tpu.ops.rasterizer.render")
pt_render = importlib.import_module("pixelsplat_tpu_torch.ops.rasterizer.render")

CHUNK = 128
TILES_X = 2


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: next to the other test processes, more threads
    only contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def t(x):
    return torch.as_tensor(np.array(x))


def make_lists(rng, lists, g):
    """Flat chunk-aligned tile lists (sentinel `g` in the chunk tails and in
    one spare block) from per-tile id arrays."""
    flat, block_start = [], []
    for ids in lists:
        block_start.append(len(flat) // CHUNK)
        n_blocks = -(-len(ids) // CHUNK)
        flat.extend(list(ids) + [g] * (n_blocks * CHUNK - len(ids)))
    flat.extend([g] * CHUNK)
    counts = np.asarray([len(ids) for ids in lists], np.int32)
    return np.asarray(flat, np.int32), np.asarray(block_start, np.int32), counts


def random_table(rng, g, opacity=(0.1, 0.6)):
    """(g + 1, 12) rows over a 32x32 image: means anywhere, conics of
    Gaussians a few pixels wide, three colours; the last row the sentinel."""
    table = np.zeros((g + 1, 12), np.float32)
    table[:g, 0] = rng.uniform(0, 32, g)
    table[:g, 1] = rng.uniform(0, 32, g)
    table[:g, 2] = rng.uniform(0.02, 0.3, g)
    table[:g, 3] = rng.uniform(-0.01, 0.01, g)
    table[:g, 4] = rng.uniform(0.02, 0.3, g)
    table[:g, 5] = rng.uniform(*opacity, g)
    table[:g, 6:9] = rng.uniform(0, 1, (g, 3))
    return table


def bwd_case(name):
    """(table, flat, block_start, counts, expected n_proc) for four 16x16
    tiles of a 32x32 image."""
    rng = np.random.default_rng(17)
    if name == "full_lists":
        # Whole chunks of moderate Gaussians; every chunk is composited.
        g = 768
        table = random_table(rng, g, opacity=(0.02, 0.2))
        lists = [np.arange(0, 256), np.arange(256, 384), np.arange(384, 640), np.arange(640, 768)]
        n_proc = [2, 1, 2, 1]
    elif name == "early_exit":
        # Tile 0: 3 chunks of wide Gaussians of alpha ~0.12 over the whole
        # tile: T ~ 0.88^128 ~ 1e-7 after the first chunk, below the 1e-4
        # exit and far above the 1e-30 clamp; chunks 2 and 3 get zeros.
        g = 600
        table = random_table(rng, g)
        table[:384, 0] = rng.uniform(4, 12, 384)
        table[:384, 1] = rng.uniform(4, 12, 384)
        table[:384, 2] = table[:384, 4] = 0.002
        table[:384, 3] = 0.0
        table[:384, 5] = rng.uniform(0.1, 0.16, 384)
        lists = [np.arange(0, 384), np.arange(384, 520), np.arange(0), np.arange(520, 600)]
        n_proc = [1, 2, 0, 1]
    elif name == "empty_and_sentinel_tails":
        # An empty tile, and partial chunks whose tails are sentinel slots.
        g = 300
        table = random_table(rng, g)
        lists = [np.arange(0), np.arange(0, 50), np.arange(50, 199), np.arange(199, 300)]
        n_proc = [0, 1, 2, 1]
    elif name == "shared_gaussians":
        # The same Gaussians in several tiles' lists: d_table sums them.
        g = 200
        rng = np.random.default_rng(20)  # a seed that keeps clear of the thresholds
        table = random_table(rng, g, opacity=(0.01, 0.05))
        table[:g, 2] = table[:g, 4] = rng.uniform(0.005, 0.02, g)  # wide
        lists = [np.arange(0, 200), np.arange(0, 200), np.arange(100, 200), np.arange(0, 100)]
        n_proc = [2, 2, 1, 1]
    else:
        raise KeyError(name)
    return (table, *make_lists(rng, lists, g), n_proc)


def pallas_forward_backward(table, flat, block_start, counts, g_acc, g_trans):
    """Interpret-mode Pallas forward and backward on the u16 gather of the
    table, as `_composite_packed_fwd/_bwd` call them; per-slot gradients
    come back as (n_blocks * chunk, 12)."""
    # The sentinel margin of 8 chunks behind the lists (composite.py:267-269).
    idx = jnp.concatenate([jnp.asarray(flat), jnp.full((8 * CHUNK,), table.shape[0] - 1, jnp.int32)])
    params_u = jx_composite._gather_params_u16(jnp.asarray(table), idx, CHUNK)
    acc, trans, n_proc = pallas_composite_core(
        params_u, jnp.asarray(counts), jnp.asarray(block_start), TILES_X, 4, interpret=True
    )
    packed_g = jnp.asarray(g_acc).at[:, NPROC_CH, :].set(trans).at[:, TRANS_CH, :].set(jnp.asarray(g_trans))
    d_params = pallas_composite_bwd(
        params_u, n_proc, jnp.asarray(block_start), packed_g, TILES_X, 4,
        counts=jnp.asarray(counts), interpret=True,
    )  # (n_blocks, 12, chunk); blocks no tile owns are never written
    d_slots = np.asarray(d_params).transpose(0, 2, 1).reshape(-1, 12)
    return np.asarray(acc), np.asarray(trans), np.asarray(n_proc), d_slots


def cotangents(seed, num_tiles):
    rng = np.random.default_rng(seed)
    g_acc = rng.normal(size=(num_tiles, 8, 256)).astype(np.float32)
    g_acc[:, 3:] = 0.0  # three colours
    g_trans = rng.normal(size=(num_tiles, 256)).astype(np.float32)
    return g_acc, g_trans


def owned_slots(block_start, counts, flat_len):
    """Mask of the flat slots that belong to some tile's chunks."""
    mask = np.zeros(flat_len, bool)
    for s, n in zip(block_start, counts):
        mask[s * CHUNK : (s + -(-n // CHUNK)) * CHUNK] = True
    return mask


@pytest.mark.parametrize(
    "name", ["full_lists", "early_exit", "empty_and_sentinel_tails", "shared_gaussians"]
)
def test_composite_bwd_plain_matches_pallas_interpret(name):
    table, flat, block_start, counts, want_n_proc = bwd_case(name)
    g_acc, g_trans = cotangents(3, len(counts))
    _, trans_j, n_proc_j, d_slots_j = pallas_forward_backward(table, flat, block_start, counts, g_acc, g_trans)
    assert n_proc_j.tolist() == want_n_proc

    args = (t(table), t(flat), t(block_start), t(counts))
    _, trans_p, n_proc_p = pt_kernel.composite_core_plain(*args, TILES_X, CHUNK)
    assert n_proc_p.tolist() == want_n_proc
    # The scene keeps clear of the thresholds where the gradient jumps.
    assert int(pt_kernel.near_threshold_pairs(*args, n_proc_p, TILES_X, CHUNK, margin=1e-5).sum()) == 0
    d_slots, d_table = pt_kernel.composite_bwd_plain(
        *args, n_proc_p, trans_p, t(g_acc), t(g_trans), TILES_X, CHUNK
    )
    d_slots = d_slots.numpy()

    owned = owned_slots(block_start, counts, len(flat))
    got, want = d_slots[owned], d_slots_j[: len(flat)][owned]
    # Relative to each column's largest gradient, as the Pallas kernel's
    # own test against XLA autodiff states it (test_pallas_interpret.py:
    # 122-128), but 20x tighter: both sides evaluate the same formulas in
    # f32, and differ in the order of the suffix sums (triangular matmuls
    # against cumulative sums) and in exp/log1p.
    for col in range(9):
        scale = np.abs(want[:, col]).max() + 1e-9
        np.testing.assert_allclose(got[:, col] / scale, want[:, col] / scale, atol=2.5e-4, err_msg=f"column {col}")
    assert np.abs(got[:, 9:]).max() == 0.0  # unused colour columns

    # Chunks the forward did not composite, sentinel slots and slots no
    # tile owns carry exactly zero.
    for tile, (s, n, done) in enumerate(zip(block_start, counts, want_n_proc)):
        beyond = d_slots[(s + done) * CHUNK : (s + -(-n // CHUNK)) * CHUNK]
        assert np.abs(beyond).max(initial=0.0) == 0.0, f"tile {tile}"
        assert np.abs(d_slots_j[(s + done) * CHUNK : (s + -(-n // CHUNK)) * CHUNK]).max(initial=0.0) == 0.0
    assert np.abs(d_slots[~owned]).max(initial=0.0) == 0.0

    # d_table is the per-Gaussian sum of the real slots.
    want_table = np.zeros_like(table)
    real = flat < table.shape[0] - 1
    np.add.at(want_table, flat[real], d_slots[: len(flat)][real])
    np.testing.assert_allclose(d_table.numpy(), want_table, rtol=1e-5, atol=1e-6 * np.abs(want_table).max())
    assert np.abs(d_table.numpy()[-1]).max() == 0.0  # the sentinel row


def test_composite_bwd_transmittance_below_clamp():
    """A tile whose final T underflows the backward's 1e-30 clamp: the
    rebuilt T_i = exp(log 1e-30 - suffix) is then not the forward's T_i, on
    both sides alike (pallas_backward.py:111). Here 128 slots of alpha 0.98
    give T_end = 0 in f32 and the rebuilt T overflows for the front slots."""
    table, flat, block_start, counts = rast.composite_case()
    g_acc, g_trans = cotangents(5, len(counts))
    _, trans_j, n_proc_j, d_slots_j = pallas_forward_backward(table, flat, block_start, counts, g_acc, g_trans)
    args = (t(table), t(flat), t(block_start), t(counts))
    _, trans_p, n_proc_p = pt_kernel.composite_core_plain(*args, TILES_X, CHUNK)
    assert float(trans_p[0].max()) < 1e-30 and float(trans_j[0].max()) < 1e-30
    d_slots, d_table = pt_kernel.composite_bwd_plain(
        *args, n_proc_p, trans_p, t(g_acc), t(g_trans), TILES_X, CHUNK
    )
    tile0 = slice(0, CHUNK)  # tile 0's one composited chunk
    got, want = d_slots.numpy()[tile0], d_slots_j[tile0]
    # Neither side gives a usable gradient for that chunk. The rebuilt T
    # overflows for its front slots; the Pallas kernel's triangular matmuls
    # then spread NaN over every slot of the chunk's geometry columns, while
    # the port's running sums keep the slots behind the overflow finite
    # (and as wrong: they are built on T_end = 1e-30, not on the forward's).
    assert not np.isfinite(want[:, :6]).any()
    front = ~np.isfinite(got).all(axis=1)
    assert front.any() and front[0] and not front[-1]
    assert (np.diff(front.astype(int)) <= 0).all()  # a run from the chunk's front
    np.testing.assert_array_equal(np.isfinite(got[:, 6:9]), np.isfinite(want[:, 6:9]))
    # The other tiles are untouched by it: the same tolerance as above.
    rest = slice(3 * CHUNK, len(flat) - CHUNK)
    for col in range(9):
        scale = np.abs(d_slots_j[rest, col]).max() + 1e-9
        np.testing.assert_allclose(
            d_slots.numpy()[rest, col] / scale, d_slots_j[rest, col] / scale, atol=2.5e-4
        )


def test_composite_bwd_dispatch_on_cpu():
    """On CPU tensors the wrapper runs the plain version and launches nothing."""
    table, flat, block_start, counts, _ = bwd_case("empty_and_sentinel_tails")
    g_acc, g_trans = cotangents(4, len(counts))
    args = (t(table), t(flat), t(block_start), t(counts))
    _, trans, n_proc = pt_kernel.composite_core(*args, TILES_X, CHUNK)
    before = tracing.counter("k2_launches")
    got = pt_kernel.composite_bwd(*args, n_proc, trans, t(g_acc), t(g_trans), TILES_X, CHUNK)
    want = pt_kernel.composite_bwd_plain(*args, n_proc, trans, t(g_acc), t(g_trans), TILES_X, CHUNK)[1]
    assert torch.equal(got, want)
    assert tracing.counter("k2_launches") == before


def test_composite_packed_gradcheck_float64():
    """`CompositePacked` against finite differences in float64, on a scene
    where no tile exits early (so the forward is smooth in the table) and
    no pair sits near a threshold."""
    rng = np.random.default_rng(23)
    g = 24
    table = random_table(rng, g).astype(np.float64)
    table[:g, 0] = rng.uniform(2, 30, g)
    lists = [np.arange(0, 24), np.arange(5, 20), np.arange(0), np.arange(10, 24)]
    flat, block_start, counts = make_lists(rng, lists, g)
    tb = t(table).requires_grad_(True)
    rest = (t(flat), t(block_start), t(counts), TILES_X, CHUNK, 16)
    _, _, n_proc = pt_composite.CompositePacked.apply(tb, *rest)
    assert n_proc.tolist() == [1, 1, 0, 1]
    assert int(pt_kernel.near_threshold_pairs(tb.detach(), *rest[:3], n_proc, TILES_X, CHUNK, margin=1e-4).sum()) == 0

    # Fixed random projections of the outputs keep the Jacobian to 16 rows.
    w_acc = t(rng.normal(size=(4, 3, 256)))
    w_trans = t(rng.normal(size=(4, 256)))

    def fn(table_in):
        acc, trans, _ = pt_composite.CompositePacked.apply(table_in, *rest)
        return (acc[:, :3] * w_acc).sum(-1), (trans * w_trans).sum(-1)

    assert torch.autograd.gradcheck(fn, (tb,), eps=1e-6, atol=1e-6, rtol=1e-4, nondet_tol=0.0)


def test_composite_tiles_gradient_reaches_projected_fields():
    """`composite_tiles` goes through the autograd function on the CPU too:
    a gradient reaches every differentiable field of the projected
    Gaussians, and none comes through the early-exited chunks."""
    means, covs, colors, opac = rast.make_scene(3, g=120)
    proj = rast.to_port(rast.jax_projected(means, covs, opac, colors=colors))
    fields = {k: getattr(proj, k).clone().requires_grad_(True)
              for k in ("mean_x", "mean_y", "conic_a", "conic_b", "conic_c", "opacity", "color")}
    proj = proj._replace(**fields)
    from pixelsplat_tpu_torch.ops.rasterizer import binning as pt_binning

    tiles = pt_binning.bin_gaussians(proj, rast.IMAGE, capacity=256, span=2, big_capacity=32, chunk=64)
    image = pt_composite.composite_tiles(proj, tiles, rast.IMAGE, torch.tensor([0.1, 0.2, 0.3]), chunk=64)
    assert image.grad_fn is not None
    (image**2).sum().backward()
    for name, x in fields.items():
        assert x.grad is not None and bool(torch.isfinite(x.grad).all()), name
        assert float(x.grad.abs().max()) > 0, name


# ---------------------------------------------------------------------------
# render gradients against jax.grad of the JAX render


def render_grads(means, covs, feats, opac, settings_kw, use_sh, extr=None, near=1.0, weights=None):
    """d(sum(image * weights))/d(means, covs, feats, opac) on both sides."""
    extr = np.eye(4, dtype=np.float32) if extr is None else extr
    cams = (extr[None], rast.K[None], np.full(1, near, np.float32), np.full(1, 100.0, np.float32))
    bg = np.asarray([[0.1, 0.2, 0.3]], np.float32)
    if weights is None:
        weights = np.random.default_rng(0).uniform(0.5, 1.5, (1, 3, *rast.IMAGE)).astype(np.float32)

    def loss_j(m, c, f, o):
        img = jx_render.render(
            *(jnp.asarray(a) for a in cams), rast.IMAGE, jnp.asarray(bg), m[None], c[None], f[None], o[None],
            scale_invariant=True, use_sh=use_sh, settings=jx_render.RenderSettings(**settings_kw),
        )
        return jnp.sum(img * jnp.asarray(weights))

    g_j = jax.grad(loss_j, argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in (means, covs, feats, opac)))
    leaves = [t(a).requires_grad_(True) for a in (means, covs, feats, opac)]
    img = pt_render.render(
        *(t(a) for a in cams), rast.IMAGE, t(bg), *(x[None] for x in leaves),
        scale_invariant=True, use_sh=use_sh, settings=pt_render.RenderSettings(**settings_kw),
    )
    (img * t(weights)).sum().backward()
    return [np.asarray(g) for g in g_j], [x.grad.numpy() for x in leaves]


# JAX on the CPU differentiates its XLA scan, which composites every chunk;
# the port's backward walks the chunks the forward composited and rebuilds T
# through exp(log T_end - suffix). On scenes where no tile exits early the
# two are the same function, evaluated in f32 in another order: each
# gradient agrees to 1e-4 of its tensor's largest entry.
GRAD_RTOL = 1e-4


@pytest.mark.parametrize("seed", [0, 1])
def test_render_gradients_match_jax_grad(seed):
    means, covs, colors, opac = rast.make_scene(seed, g=150)
    g_j, g_p = render_grads(means, covs, colors, opac, dict(capacity=512, big_capacity=64, chunk=64), use_sh=False)
    for name, a, b in zip(("means", "covariances", "colours", "opacities"), g_j, g_p):
        assert np.abs(a).max() > 0, name
        np.testing.assert_allclose(b, a, atol=GRAD_RTOL * np.abs(a).max(), rtol=0, err_msg=name)


def test_render_gradients_sh_match_jax_grad():
    """Degree-2 harmonics, a moved camera and chunk 128."""
    rng = np.random.default_rng(31)
    g = 120
    means, covs, _, opac = rast.make_scene(33, g=g)
    sh = rng.normal(size=(g, 3, 9)).astype(np.float32) * 0.2
    extr = np.eye(4, dtype=np.float32)
    extr[:3, 3] = [0.1, 0.05, -0.2]
    g_j, g_p = render_grads(
        means, covs, sh, opac, dict(capacity=4096, big_capacity=256, chunk=128), use_sh=True, extr=extr, near=0.5
    )
    for name, a, b in zip(("means", "covariances", "harmonics", "opacities"), g_j, g_p):
        assert np.abs(a).max() > 0, name
        np.testing.assert_allclose(b, a, atol=GRAD_RTOL * np.abs(a).max(), rtol=0, err_msg=name)


def test_render_gradients_finite_behind_camera_and_zero_opacity():
    """Gaussians behind the camera, on the camera plane, at zero opacity and
    with a degenerate covariance are masked out of the image; their masked
    branches (1/z, 1/det, log opacity, the SH direction) must hand back
    zeros, not NaN, to every input."""
    rng = np.random.default_rng(41)
    g = 60
    means, covs, _, opac = rast.make_scene(43, g=g)
    sh = rng.normal(size=(g, 3, 9)).astype(np.float32) * 0.2
    means[:10, 2] = -rng.uniform(0.5, 4.0, 10)  # behind the camera
    means[10, 2] = 0.0  # on the camera plane
    means[11] = 0.0  # at the camera centre: the SH direction has no length
    opac[12:20] = 0.0
    covs[20:24] = 0.0  # degenerate covariance
    g_j, g_p = render_grads(means, covs, sh, opac, dict(capacity=512, big_capacity=64, chunk=64), use_sh=True)
    for name, a, b in zip(("means", "covariances", "harmonics", "opacities"), g_j, g_p):
        assert np.isfinite(b).all(), name
        assert np.isfinite(a).all(), name
        np.testing.assert_allclose(b, a, atol=GRAD_RTOL * np.abs(a).max(), rtol=0, err_msg=name)
    for grads in g_p:
        assert np.abs(grads[:12]).max() == 0.0  # the culled Gaussians take no gradient
