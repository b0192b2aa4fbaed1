"""The port's rasterizer against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both sides. Each
tolerance is stated where it is used, with its reason.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelsplat_tpu.ops.rasterizer import adaptive as jx_adaptive
from pixelsplat_tpu.ops.rasterizer import binning as jx_binning
from pixelsplat_tpu.ops.rasterizer import composite as jx_composite
from pixelsplat_tpu.ops.rasterizer import projection as jx_projection
from pixelsplat_tpu.ops.rasterizer.pallas_composite import pallas_composite_core
from pixelsplat_tpu_torch.ops.rasterizer import adaptive as pt_adaptive
from pixelsplat_tpu_torch.ops.rasterizer import binning as pt_binning
from pixelsplat_tpu_torch.ops.rasterizer import composite as pt_composite
from pixelsplat_tpu_torch.ops.rasterizer import composite_kernel as pt_kernel
from pixelsplat_tpu_torch.ops.rasterizer import projection as pt_projection
from pixelsplat_tpu_torch.utils import tracing

# The packages export `render` the function under the submodule's name.
jx_render = importlib.import_module("pixelsplat_tpu.ops.rasterizer.render")
pt_render = importlib.import_module("pixelsplat_tpu_torch.ops.rasterizer.render")

IMAGE = (32, 48)
K = np.array([[1.0, 0.0, 0.5], [0.0, 1.0, 0.5], [0.0, 0.0, 1.0]], np.float32)


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


def make_scene(seed, g=200, spread=1.0, z_range=(2.0, 8.0), cov_scale=0.05):
    """Random Gaussians with distinct depths (no two within 1e-3 relative,
    far above the 2^-14 relative resolution of the packed depth keys)."""
    rng = np.random.default_rng(seed)
    z = rng.permutation(np.linspace(*z_range, g))
    means = np.stack(
        [rng.uniform(-spread, spread, g), rng.uniform(-spread, spread, g), z], axis=-1
    ).astype(np.float32)
    axes = rng.normal(size=(g, 3, 3)).astype(np.float32) * cov_scale
    covs = axes @ axes.transpose(0, 2, 1) + 1e-4 * np.eye(3, dtype=np.float32)
    colors = rng.uniform(0, 1, (g, 3)).astype(np.float32)
    opac = rng.uniform(0.2, 0.9, g).astype(np.float32)
    return means, covs, colors, opac


def jax_projected(means, covs, opac, colors=None, harmonics=None, extr=None):
    extr = np.eye(4, dtype=np.float32) if extr is None else extr
    return jx_projection.project_gaussians(
        jnp.asarray(extr), jnp.asarray(K), IMAGE, jnp.asarray(means), jnp.asarray(covs),
        jnp.asarray(opac),
        harmonics=None if harmonics is None else jnp.asarray(harmonics),
        colors_precomp=None if colors is None else jnp.asarray(colors),
    )


def to_port(projected):
    """A JAX ProjectedGaussians as the port's, so binning is tested alone."""
    return pt_projection.ProjectedGaussians(*(t(v) for v in projected))


# ---------------------------------------------------------------------------
# Projection


@pytest.mark.parametrize("shared", [False, True])
def test_project_gaussians_soa(shared):
    rng = np.random.default_rng(3)
    v_, s_, r_ = 2, 3, 40
    g = v_ * s_ * r_
    means, covs, _, opac = make_scene(4, g=g)
    d_sh = 25
    extr = np.eye(4, dtype=np.float32)
    extr[:3, 3] = [0.2, -0.1, -0.5]
    if shared:
        harm = rng.normal(size=(3, d_sh, v_, 1, r_)).astype(np.float32) * 0.3
    else:
        harm = rng.normal(size=(3, d_sh, g)).astype(np.float32) * 0.3
    cov6 = np.stack([covs[:, 0, 0], covs[:, 0, 1], covs[:, 0, 2], covs[:, 1, 1], covs[:, 1, 2], covs[:, 2, 2]])
    planes = (means[:, 0], means[:, 1], means[:, 2], cov6, opac)
    jx = jx_projection.project_gaussians_soa(
        jnp.asarray(extr), jnp.asarray(K), IMAGE,
        jx_projection.GaussiansSoA(*(jnp.asarray(p) for p in planes), harmonics=jnp.asarray(harm)),
    )
    pt = pt_projection.project_gaussians_soa(
        t(extr), t(K), IMAGE,
        pt_projection.GaussiansSoA(*(t(p) for p in planes), harmonics=t(harm)),
    )
    for name, a, b in zip(jx._fields, jx, pt):
        a, b = np.asarray(a), b.numpy()
        if a.dtype == bool:
            assert (a == b).all(), name
        else:
            # f32 arithmetic in another order: a few ulps of the values'
            # magnitudes (conics reach ~1e2, means ~1e2 pixels).
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5, err_msg=name)


def test_pack_gaussians_soa():
    means, covs, colors, opac = make_scene(5, g=30)
    sh = np.random.default_rng(5).normal(size=(30, 3, 4)).astype(np.float32)
    jx = jx_projection.pack_gaussians_soa(jnp.asarray(means), jnp.asarray(covs), jnp.asarray(opac), harmonics=jnp.asarray(sh))
    pt = pt_projection.pack_gaussians_soa(t(means), t(covs), t(opac), harmonics=t(sh))
    for name, a, b in zip(jx._fields, jx, pt):
        if a is None:
            assert b is None, name
        else:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)


# ---------------------------------------------------------------------------
# Binning


def assert_tiles_equal(jx, pt):
    np.testing.assert_array_equal(pt.flat.numpy(), np.asarray(jx.flat))
    np.testing.assert_array_equal(pt.block_start.numpy(), np.asarray(jx.block_start))
    np.testing.assert_array_equal(pt.counts.numpy(), np.asarray(jx.counts))
    assert int(pt.overflow) == int(jx.overflow)


BIN_CASES = {
    # name: (scene kwargs, bin kwargs)
    "plain": (dict(seed=0), dict(capacity=512, span=3, big_capacity=64, chunk=64)),
    "span2_chunk128": (dict(seed=1), dict(capacity=256, span=2, big_capacity=32, chunk=128)),
    "capacity_overflow": (dict(seed=2, g=400, spread=0.3), dict(capacity=16, span=2, big_capacity=8, chunk=16)),
    "budget_overflow": (dict(seed=3, g=300), dict(capacity=256, span=2, big_capacity=16, chunk=32, pair_budget=256)),
    "wide_keys": (dict(seed=4), dict(capacity=512, span=2, big_capacity=64, chunk=64, force_wide_keys=True)),
    "big_list": (dict(seed=6, g=60, cov_scale=0.4), dict(capacity=128, span=1, big_capacity=8, chunk=32)),
}


@pytest.mark.parametrize("case", sorted(BIN_CASES))
def test_bin_gaussians_exact(case):
    scene_kw, bin_kw = BIN_CASES[case]
    means, covs, colors, opac = make_scene(**scene_kw)
    proj = jax_projected(means, covs, opac, colors=colors)
    jx = jx_binning.bin_gaussians(proj, IMAGE, **bin_kw)
    pt = pt_binning.bin_gaussians(to_port(proj), IMAGE, **bin_kw)
    assert_tiles_equal(jx, pt)
    if case.endswith("overflow") or case == "big_list":
        assert int(jx.overflow) > 0  # the case really overflows


def test_bin_gaussians_forced_ties():
    """Equal depths tie in the keys: each tile keeps the same Gaussians,
    and the port's lists stay ordered by depth key."""
    means, covs, colors, opac = make_scene(7, g=200)
    means[:, 2] = np.repeat(np.linspace(3.0, 6.0, 10), 20).astype(np.float32)
    proj = jax_projected(means, covs, opac, colors=colors)
    kw = dict(capacity=512, span=2, big_capacity=16, chunk=64)
    jx = jx_binning.bin_gaussians(proj, IMAGE, **kw)
    pt = pt_binning.bin_gaussians(to_port(proj), IMAGE, **kw)
    np.testing.assert_array_equal(pt.block_start.numpy(), np.asarray(jx.block_start))
    np.testing.assert_array_equal(pt.counts.numpy(), np.asarray(jx.counts))
    assert int(pt.overflow) == int(jx.overflow)
    depth = np.asarray(proj.depth)
    key = np.maximum(depth, 0).view(np.int32) >> 9  # 22 depth bits at 6 tiles
    flat_j, flat_p = np.asarray(jx.flat), pt.flat.numpy()
    n_tied = 0
    for s, n in zip(pt.block_start.numpy(), pt.counts.numpy()):
        ids_j = flat_j[s * 64 : s * 64 + n]
        ids_p = flat_p[s * 64 : s * 64 + n]
        assert sorted(ids_j) == sorted(ids_p)
        assert (np.diff(key[ids_p]) >= 0).all()
        n_tied += int((np.diff(key[ids_p]) == 0).sum())
    assert n_tied > 0  # the scene really has ties


def test_tile_occupancy_and_choose_settings():
    means, covs, colors, opac = make_scene(8, g=300)
    proj = jax_projected(means, covs, opac, colors=colors)
    for kw in (dict(span=2, big_capacity=16, chunk=64), dict(span=3, big_capacity=4, chunk=128)):
        jx = jx_binning.tile_occupancy(proj, IMAGE, **kw)
        pt = pt_binning.tile_occupancy(to_port(proj), IMAGE, **kw)
        assert [int(v) for v in pt] == [int(v) for v in jx]

    b = 3
    extr = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    extr[:, 0, 3] = [-0.3, 0.0, 0.3]
    args = (extr, np.tile(K, (b, 1, 1)), np.full(b, 1.5, np.float32),
            np.tile(means, (b, 1, 1)), np.tile(covs, (b, 1, 1, 1)), np.tile(opac, (b, 1)))
    jx = jx_adaptive.choose_settings(
        *(jnp.asarray(a) for a in args), IMAGE, settings=jx_render.RenderSettings(capacity=4096, big_capacity=64)
    )
    settings = pt_render.RenderSettings(capacity=4096, big_capacity=64)
    extr_t, intr_t, near_t, means_t, covs_t, opac_t = (t(a) for a in args)
    occupancy = pt_adaptive.probe(
        extr_t, intr_t, near_t, pt_projection.aos_planes(means_t, covs_t, opac_t), IMAGE, settings
    )
    pt = pt_adaptive.choose_settings(occupancy, settings, means.shape[0], IMAGE)
    assert (pt.capacity, pt.pair_budget, pt.span, pt.chunk) == (jx.capacity, jx.pair_budget, jx.span, jx.chunk)


# ---------------------------------------------------------------------------
# Compositing core against the Pallas kernel in interpret mode


def composite_case():
    """Four 16x16 tiles of a 32x32 image with hand-made lists:
    tile 0: 3 chunks of wide opaque Gaussians (exits after its first chunk);
    tile 1: 2 chunks of faint ones (composites both);
    tile 2: empty; tile 3: a partial chunk."""
    rng = np.random.default_rng(11)
    g = 600
    table = np.zeros((g + 1, 12), np.float32)
    table[:, 0] = rng.uniform(0, 32, g + 1)
    table[:, 1] = rng.uniform(0, 32, g + 1)
    table[:, 2] = rng.uniform(0.05, 0.5, g + 1)
    table[:, 3] = rng.uniform(-0.02, 0.02, g + 1)
    table[:, 4] = rng.uniform(0.05, 0.5, g + 1)
    table[:, 5] = rng.uniform(0.1, 0.6, g + 1)
    table[:, 6:9] = rng.uniform(0, 1, (g + 1, 3))
    # Tile 0 (pixels x, y in [0, 16)): ids 0..299 wide and nearly opaque.
    table[:300, 0] = rng.uniform(4, 12, 300)
    table[:300, 1] = rng.uniform(4, 12, 300)
    table[:300, 2] = table[:300, 4] = 0.002
    table[:300, 3] = 0.0
    table[:300, 5] = 0.98
    # Tile 1: faint ids 300..549.
    table[300:550, 5] = rng.uniform(0.005, 0.03, 250)
    table[g] = 0.0
    counts = np.asarray([300, 250, 0, 50], np.int32)
    lists = [np.arange(300), np.arange(300, 550), np.arange(0), np.arange(550, 600)]
    chunk = 128
    flat, block_start = [], []
    for ids in lists:
        block_start.append(len(flat) // chunk)
        n_blocks = -(-len(ids) // chunk)
        flat.extend(list(ids) + [g] * (n_blocks * chunk - len(ids)))
    flat.extend([g] * chunk)  # spare block
    return table, np.asarray(flat, np.int32), np.asarray(block_start, np.int32), counts


def test_composite_core_plain_matches_pallas_interpret():
    table, flat, block_start, counts = composite_case()
    tiles_x, chunk = 2, 128
    # The Pallas path gathers with a sentinel margin of 8 chunks behind the
    # lists (composite.py:267-269) for its lookahead DMA.
    idx = jnp.concatenate([jnp.asarray(flat), jnp.full((8 * chunk,), table.shape[0] - 1, jnp.int32)])
    params_u = jx_composite._gather_params_u16(jnp.asarray(table), idx, chunk)
    max_blocks = 4
    acc_j, trans_j, n_j = pallas_composite_core(
        params_u, jnp.asarray(counts), jnp.asarray(block_start), tiles_x, max_blocks, interpret=True
    )
    acc_p, trans_p, n_p = pt_kernel.composite_core_plain(
        t(table), t(flat), t(block_start), t(counts), tiles_x, chunk
    )
    # The same tolerance as the Pallas kernel's own test against the XLA
    # scan (tests/test_pallas_interpret.py): the kernel's prefix products
    # are exp-of-log-sums on split matmuls, the port's running products.
    np.testing.assert_allclose(acc_p.numpy(), np.asarray(acc_j), atol=2e-4)
    np.testing.assert_allclose(trans_p.numpy(), np.asarray(trans_j), atol=2e-4)
    assert n_p.tolist() == np.asarray(n_j).tolist() == [1, 2, 0, 1]
    assert float(trans_p[0].max()) < 1e-4 and float(trans_p[1].min()) > 1e-4


def test_composite_core_dispatch_on_cpu():
    """On CPU tensors the wrapper runs the plain version and launches nothing."""
    table, flat, block_start, counts = composite_case()
    before = tracing.counter("k1_launches")
    got = pt_kernel.composite_core(t(table), t(flat), t(block_start), t(counts), 2, 128)
    want = pt_kernel.composite_core_plain(t(table), t(flat), t(block_start), t(counts), 2, 128)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert tracing.counter("k1_launches") == before


def test_pack_columns():
    means, covs, colors, opac = make_scene(9, g=50)
    proj = jax_projected(means, covs, opac, colors=colors)
    np.testing.assert_array_equal(
        pt_composite.pack_columns(to_port(proj)).numpy(), np.asarray(jx_composite.pack_columns(proj))
    )


# ---------------------------------------------------------------------------
# Full render against JAX render (the scenes of tests/test_rasterizer.py)


def render_both(means, covs, feats, opac, settings_kw, use_sh=False, bg=(0.1, 0.2, 0.3), extr=None, near=1.0):
    extr = np.eye(4, dtype=np.float32) if extr is None else extr
    args = (extr[None], K[None], np.full(1, near, np.float32), np.full(1, 100.0, np.float32))
    tail = (np.asarray(bg, np.float32)[None], means[None], covs[None], feats[None], opac[None])
    jx = jx_render.render(
        *(jnp.asarray(a) for a in args), IMAGE, *(jnp.asarray(a) for a in tail),
        scale_invariant=True, use_sh=use_sh, settings=jx_render.RenderSettings(**settings_kw),
        return_overflow=True,
    )
    pt = pt_render.render(
        *(t(a) for a in args), IMAGE, *(t(a) for a in tail),
        scale_invariant=True, use_sh=use_sh, settings=pt_render.RenderSettings(**settings_kw),
        return_overflow=True,
    )
    return [np.asarray(v) for v in jx], [v.numpy() for v in pt]


# JAX on the CPU composites every chunk (its XLA scan), while the port
# stops a tile once every pixel's T < 1e-4: the images may differ by up to
# 1e-4 x the largest colour (1.0 here), plus f32 rounding, so 5e-4.
RENDER_ATOL = 5e-4


@pytest.mark.parametrize("seed", [0, 1])
def test_render_matches_jax(seed):
    means, covs, colors, opac = make_scene(seed)
    (img_j, ovf_j), (img_p, ovf_p) = render_both(
        means, covs, colors, opac, dict(capacity=512, big_capacity=64, chunk=64)
    )
    np.testing.assert_allclose(img_p, img_j, atol=RENDER_ATOL)
    assert ovf_p.tolist() == ovf_j.tolist()


def test_render_big_gaussian_matches_jax():
    means = np.array([[0.0, 0.0, 3.0]], np.float32)
    covs = np.eye(3, dtype=np.float32)[None]
    colors = np.array([[1.0, 0.0, 0.0]], np.float32)
    opac = np.array([0.9], np.float32)
    (img_j, _), (img_p, _) = render_both(
        means, covs, colors, opac, dict(capacity=64, big_capacity=8, chunk=32), bg=(0, 0, 0)
    )
    assert img_p.max() > 0.1
    np.testing.assert_allclose(img_p, img_j, atol=RENDER_ATOL)


def test_render_sh_dense_opaque_matches_jax():
    """Degree-4 SH colours, an opaque crowd whose tiles exit after their
    first chunks, chunk 128 (the compositing kernel's configuration), a
    moved camera and more big Gaussians than the big list holds."""
    rng = np.random.default_rng(12)
    g = 2000
    means, covs, _, opac = make_scene(13, g=g, cov_scale=0.25, spread=1.2)
    opac[:] = 0.95
    sh = rng.normal(size=(g, 3, 25)).astype(np.float32) * 0.2
    extr = np.eye(4, dtype=np.float32)
    extr[:3, 3] = [0.1, 0.05, -0.2]
    (img_j, ovf_j), (img_p, ovf_p) = render_both(
        means, covs, sh, opac, dict(capacity=4096, big_capacity=256, chunk=128),
        use_sh=True, extr=extr, near=0.5,
    )
    # Colours here exceed 1 (SH + 0.5 is clamped below only): scale the bound.
    atol = RENDER_ATOL * max(1.0, float(np.abs(img_j).max()))
    np.testing.assert_allclose(img_p, img_j, atol=atol)
    assert ovf_p.tolist() == ovf_j.tolist()
    assert ovf_j[0] > 0
