"""The epipolar-transformer modules of the port against the JAX package's,
one by one, on the CPU.

Inputs are made by numpy from a seed. Weights are made by numpy on the
port's modules (reference torch parameter names) and carried to the Flax
modules with the JAX package's own converters (`interop/torch_import.py`).
Sizes are small: 8x8 feature maps, 4 samples per line, 1-2 layers, 2 heads
x 16, 4 octaves. Each tolerance is stated where it is used.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelsplat_tpu.geometry import epipolar_lines as jx_lines
from pixelsplat_tpu.geometry import projection as jx_proj
from pixelsplat_tpu.interop import torch_import
from pixelsplat_tpu.model import encodings as jx_encodings
from pixelsplat_tpu.model.encoder.epipolar import conversions as jx_conversions
from pixelsplat_tpu.model.encoder.epipolar import epipolar_sampler as jx_sampler
from pixelsplat_tpu.model.encoder.epipolar import epipolar_transformer as jx_et
from pixelsplat_tpu.model.encoder.epipolar import image_self_attention as jx_isa
from pixelsplat_tpu.model.transformer import transformer as jx_transformer
from pixelsplat_tpu.ops import grid_sample as jx_grid
from pixelsplat_tpu.utils import pairings as jx_pairings
from pixelsplat_tpu_torch.geometry import epipolar_lines as pt_lines
from pixelsplat_tpu_torch.geometry import projection as pt_proj
from pixelsplat_tpu_torch.interop import from_jax
from pixelsplat_tpu_torch.model import encodings as pt_encodings
from pixelsplat_tpu_torch.model.encoder.epipolar import conversions as pt_conversions
from pixelsplat_tpu_torch.model.encoder.epipolar import epipolar_sampler as pt_sampler
from pixelsplat_tpu_torch.model.encoder.epipolar import epipolar_transformer as pt_et
from pixelsplat_tpu_torch.model.encoder.epipolar import image_self_attention as pt_isa
from pixelsplat_tpu_torch.model.transformer import transformer as pt_transformer
from pixelsplat_tpu_torch.ops import grid_sample as pt_grid
from pixelsplat_tpu_torch.utils import pairings as pt_pairings

from test_torch_encoder import close, randomize, t

F32_EPS = float(np.finfo(np.float32).eps)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: next to the other test processes, more threads
    only contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def j(x):
    return jnp.asarray(x)


def cameras(rng, n, spread=0.6):
    """n cameras looking roughly along +z from positions `spread` apart,
    with small random rotations, and normalized intrinsics."""
    extr = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    for i in range(n):
        axis = rng.normal(size=3)
        angle = 0.15 * rng.normal()
        k = axis / np.linalg.norm(axis)
        kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        extr[i, :3, :3] = np.eye(3) + np.sin(angle) * kx + (1 - np.cos(angle)) * kx @ kx
        extr[i, :3, 3] = [spread * i + 0.05 * rng.normal(), 0.1 * rng.normal(), 0.05 * rng.normal()]
    intr = np.tile(np.array([[0.9, 0, 0.5], [0, 1.1, 0.5], [0, 0, 1]], np.float32), (n, 1, 1))
    intr[:, 0, 0] += 0.05 * rng.normal(size=n).astype(np.float32)
    return extr, intr


# ---------------------------------------------------------------------------
# 1. positional encoding


@pytest.mark.parametrize("octaves", [2, 4, 10])
def test_positional_encoding(octaves):
    samples = np.random.default_rng(0).uniform(0, 1, (5, 7, 2)).astype(np.float32)
    want = np.asarray(jx_encodings.positional_encoding(j(samples), octaves))
    got = pt_encodings.positional_encoding(t(samples), octaves)
    assert got.shape == want.shape == (5, 7, 2 * octaves * 2)
    assert pt_encodings.positional_encoding_d_out(2, octaves) == jx_encodings.positional_encoding_d_out(2, octaves)
    # Layout (dim, octave, phase). Octave o's argument reaches 2 pi 2^o
    # (3217 at o = 9), where one f32 ulp of the argument is eps * 2 pi 2^o;
    # XLA may fuse sample * frequency + phase into one rounding where torch
    # rounds twice, and the two sin argument reductions may differ by
    # another ulp. So each octave is held to 4 ulps of its own argument.
    diff = np.abs(got.numpy() - want).reshape(5, 7, 2, octaves, 2)
    for o in range(octaves):
        assert diff[:, :, :, o].max() <= 4 * F32_EPS * 2 * np.pi * 2**o + 1e-6, o
    module = pt_encodings.PositionalEncoding(octaves)
    assert torch.equal(module(t(samples)), got) and module.d_out(2) == got.shape[-1]


# ---------------------------------------------------------------------------
# 2. pairings


@pytest.mark.parametrize("n", [2, 3, 5])
def test_heterogeneous_index_tables(n):
    for name in ("generate_heterogeneous_index", "generate_heterogeneous_index_transpose"):
        got, want = getattr(pt_pairings, name)(n), getattr(jx_pairings, name)(n)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# 3. the rest of geometry/projection.py


def test_project_and_world2cam():
    rng = np.random.default_rng(1)
    extr, intr = cameras(rng, 4)
    points = rng.uniform(-2, 2, (6, 4, 3)).astype(np.float32) + np.array([0, 0, 3], np.float32)
    points[0, 0] = [0.1, 0.2, extr[0, 2, 3]]  # on camera 0's zero-depth plane
    points[1, 1, 2] = -4.0  # behind its camera
    xy_j, front_j = jx_proj.project(j(points), j(extr), j(intr))
    xy_p, front_p = pt_proj.project(t(points), t(extr), t(intr))
    np.testing.assert_array_equal(front_p.numpy(), np.asarray(front_j))
    # f32 4x4 and 3x3 products in another order; the zero-depth point
    # divides by eps and lands near 1e6, hence the relative part.
    np.testing.assert_allclose(xy_p.numpy(), np.asarray(xy_j), rtol=1e-4, atol=1e-5)
    hom = np.concatenate([points, np.ones_like(points[..., :1])], -1)
    np.testing.assert_allclose(
        pt_proj.transform_world2cam(t(hom), t(extr)).numpy(),
        np.asarray(jx_proj.transform_world2cam(j(hom), j(extr))), atol=1e-5,
    )
    # The perspective divide's inf and NaN handling: z = -eps gives +-inf -> +-1e8, 0/0 -> 0.
    eps = float(torch.finfo(torch.float32).eps)
    odd = np.array([[1.0, -1.0, -eps], [0.0, 0.0, -eps], [1.0, 2.0, 4.0]], np.float32)
    got = pt_proj.project_camera_space(t(odd), t(intr[0]))
    want = np.asarray(jx_proj.project_camera_space(j(odd), j(intr[0])))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    assert abs(want[0, 0]) > 1e7


def test_intersect_rays_and_solve3x3():
    rng = np.random.default_rng(2)
    o_x = rng.normal(size=(9, 3)).astype(np.float32)
    o_y = rng.normal(size=(9, 3)).astype(np.float32)
    d_x = rng.normal(size=(9, 3)).astype(np.float32)
    d_y = rng.normal(size=(9, 3)).astype(np.float32)
    d_x /= np.linalg.norm(d_x, axis=-1, keepdims=True)
    d_y /= np.linalg.norm(d_y, axis=-1, keepdims=True)
    d_y[0] = d_x[0]  # parallel: all-inf result
    d_y[1] = d_x[1] + 1e-4 * d_y[1]  # nearly parallel, inside eps
    d_y[1] /= np.linalg.norm(d_y[1])
    want = np.asarray(jx_proj.intersect_rays(j(o_x), j(d_x), j(o_y), j(d_y)))
    got = pt_proj.intersect_rays(t(o_x), t(d_x), t(o_y), t(d_y)).numpy()
    assert (want[:2] == 1e10).all() and (got[:2] == 1e10).all()
    # Cramer's rule in f32: the same expression tree, products possibly fused on one side.
    np.testing.assert_allclose(got[2:], want[2:], rtol=1e-4, atol=1e-5)
    # Broadcasting, as get_depth calls it.
    got_b = pt_proj.intersect_rays(t(o_x[2]), t(d_x[2]), t(o_y[2:, None]), t(d_y[2:, None]))
    assert got_b.shape == (7, 1, 3)

    a = rng.normal(size=(5, 3, 3)).astype(np.float32)
    a[0] = 0.0  # singular: det clamps to eps = 1e-20, kept as the JAX package writes it
    b = rng.normal(size=(5, 3)).astype(np.float32)
    want = np.asarray(jx_proj._solve3x3(j(a), j(b)))
    got = pt_proj._solve3x3(t(a), t(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got[1:], np.linalg.solve(a[1:].astype(np.float64), b[1:, :, None])[..., 0], rtol=1e-3, atol=1e-4)


# ---------------------------------------------------------------------------
# 4. epipolar lines


def assert_segments_equal(got, want, what=""):
    """`project_rays` results: masks equal; where the segment overlaps the
    image, endpoints to 1e-5 absolute plus 1e-4 relative (f32 camera
    transforms and a division, in another order). Elsewhere the fields are
    meaningless (inf or NaN on both sides) and only their kind is held."""
    ov = np.asarray(want.overlaps_image)
    np.testing.assert_array_equal(got.overlaps_image.numpy(), ov, err_msg=what)
    for name in ("t_min", "t_max", "xy_min", "xy_max"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g[ov], w[ov], rtol=1e-4, atol=1e-5, err_msg=f"{what} {name}")
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=f"{what} {name} NaN")
        np.testing.assert_array_equal(np.isposinf(g), np.isposinf(w), err_msg=f"{what} {name} +inf")
        np.testing.assert_array_equal(np.isneginf(g), np.isneginf(w), err_msg=f"{what} {name} -inf")


@pytest.mark.parametrize("bounded", [True, False], ids=["near_far", "none"])
def test_project_rays_matches_jax(bounded):
    rng = np.random.default_rng(3)
    extr, intr = cameras(rng, 3)
    xy = rng.uniform(0, 1, (40, 2)).astype(np.float32)
    o_j, d_j = jx_proj.get_world_rays(j(xy), j(extr[0]), j(intr[0]))
    o_p, d_p = pt_proj.get_world_rays(t(xy), t(extr[0]), t(intr[0]))
    kw_j = dict(near=j(np.float32(0.5)), far=j(np.float32(20.0))) if bounded else {}
    kw_p = dict(near=torch.tensor(0.5), far=torch.tensor(20.0)) if bounded else {}
    want = jx_lines.project_rays(o_j, d_j, j(extr[1:, None]), j(intr[1:, None]), **kw_j)
    got = pt_lines.project_rays(o_p, d_p, t(extr[1:, None]), t(intr[1:, None]), **kw_p)
    assert got.xy_min.shape == (2, 40, 2)
    assert 0 < int(np.asarray(want.overlaps_image).sum())
    assert_segments_equal(got, want)


def test_project_rays_special_cases_match_jax():
    """The cases of tests/test_epipolar_lines.py and the ones the case
    analysis lives on, on both sides: a ray behind the camera, a ray from
    the camera's own centre, an origin on the zero-depth plane, a ray
    parallel to the image plane, and rays that meet no border validly."""
    intr = np.array([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1]], np.float32)
    cam = np.eye(4, dtype=np.float32)
    origins = np.array(
        [
            [0.0, 0.0, -10.0],  # behind, pointing further behind: every border t negative
            [0.0, 0.0, 0.0],  # at the camera
            [0.3, 0.0, 0.0],  # on the zero-depth plane, not at the camera
            [-5.0, 0.0, 2.0],  # parallel to the image plane: crosses the frame
            [0.0, 0.0, 1.0],  # along the optical axis: every border division is x/0
            [0.0, 5.0, -1.0],  # behind and moving sideways: no valid border
            [-1.0, 0.1, 1.0],  # an ordinary ray of a camera one unit to the left
        ],
        np.float32,
    )
    directions = np.array(
        [[0, 0, -1], [0.1, 0.1, 1], [0, 0, 1], [1, 0, 0], [0, 0, 1], [1, 0, 0], [0.2, 0, 1]], np.float32
    )
    directions /= np.linalg.norm(directions, axis=-1, keepdims=True)
    for kw_j, kw_p, what in (
        ({}, {}, "unbounded"),
        (dict(near=j(np.float32(1.0)), far=j(np.float32(50.0))),
         dict(near=torch.tensor(1.0), far=torch.tensor(50.0)), "bounded"),
    ):
        want = jx_lines.project_rays(j(origins), j(directions), j(cam), j(intr), **kw_j)
        got = pt_lines.project_rays(t(origins), t(directions), t(cam), t(intr), **kw_p)
        assert_segments_equal(got, want, what)
        ov = got.overlaps_image.tolist()
        assert not ov[0] and not ov[5], what
    assert got.overlaps_image.tolist()[6]


def test_compare_projections_picks_the_first_of_ties():
    """All four border intersections invalid: every t becomes +inf (min) or
    -inf (max), and the selected xy must be intersection 0's, as
    `jnp.argmin` picks it. `torch.argmin` makes no such promise."""
    rng = np.random.default_rng(4)
    n = 64
    ts = rng.normal(size=(4, n)).astype(np.float32)
    xys = rng.normal(size=(4, n, 2)).astype(np.float32)
    valid = rng.uniform(size=(4, n)) < 0.4
    valid[:, :16] = False  # no valid border at all
    ts[1, 16:24] = ts[2, 16:24]  # exact ties among valid ones
    valid[1:3, 16:24] = True
    ts[3, 24:28] = np.nan
    for reduction in ("min", "max"):
        want = jx_lines._compare_projections(
            [jx_lines.PointProjection(j(ts[i]), j(xys[i]), j(valid[i])) for i in range(4)], reduction
        )
        got = pt_lines._compare_projections(
            [pt_lines.PointProjection(t(ts[i]), t(xys[i]), t(valid[i])) for i in range(4)], reduction
        )
        np.testing.assert_array_equal(got.t.numpy(), np.asarray(want.t))
        np.testing.assert_array_equal(got.xy.numpy(), np.asarray(want.xy))
        np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
        np.testing.assert_array_equal(got.xy.numpy()[:16], xys[0, :16])
        assert not got.valid[:16].any()


def test_get_depth_and_lift_to_3d():
    rng = np.random.default_rng(5)
    extr, intr = cameras(rng, 2, spread=1.0)
    points = rng.uniform(-0.5, 0.5, (12, 3)).astype(np.float32) + np.array([0.5, 0, 3], np.float32)
    origin = extr[0, :3, 3]
    direction = points - origin
    norm = np.linalg.norm(direction, axis=-1, keepdims=True)
    direction = direction / norm
    xy_b, _ = jx_proj.project(j(points), j(extr[1]), j(intr[1]))
    args_j = (j(origin), j(direction), xy_b, j(extr[1]), j(intr[1]))
    args_p = (t(origin), t(direction), t(xy_b), t(extr[1]), t(intr[1]))
    want = np.asarray(jx_lines.get_depth(*args_j))
    got = pt_lines.get_depth(*args_p).numpy()
    # A 3x3 least-squares solve per ray pair in f32.
    np.testing.assert_allclose(got, want, rtol=1e-4)
    np.testing.assert_allclose(got, norm[:, 0], rtol=1e-3)
    np.testing.assert_allclose(
        pt_lines.lift_to_3d(*args_p).numpy(), np.asarray(jx_lines.lift_to_3d(*args_j)), rtol=1e-4, atol=1e-4
    )


# ---------------------------------------------------------------------------
# 5. grid sampling


def test_grid_sample_matches_jax():
    rng = np.random.default_rng(6)
    n, h, w, c = 3, 6, 5, 4
    images = rng.normal(size=(n, h, w, c)).astype(np.float32)
    coords = rng.uniform(-1.3, 1.3, (n, 7, 9, 2)).astype(np.float32)  # some outside
    want = np.asarray(jx_grid.grid_sample_nhwc_flat(j(images), j(coords)))
    got = pt_grid.grid_sample_nhwc_flat(t(images), t(coords))
    assert got.shape == (n, 7, 9, c)
    # Four taps and a lerp in f32, weights built in another order.
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    # Per-image: image i is sampled at coords[i] only.
    alone = pt_grid.grid_sample_nhwc_flat(t(images[1:2]), t(coords[1:2]))
    np.testing.assert_allclose(alone.numpy(), got[1:2].numpy(), atol=1e-7)


def test_grid_sample_border_taps():
    """Coordinates that sit on, or within rounding of, a pixel centre or
    the image's edge: `floor` may pick different taps on the two sides, but
    the weights make the result continuous, so it shows as ~1e-6, never as
    a jump; and a tap outside the image adds zero (the `inside` mask)."""
    rng = np.random.default_rng(7)
    h, w, c = 4, 8, 3
    images = rng.normal(size=(1, h, w, c)).astype(np.float32)
    # Pixel index k sits at normalized (2k + 1) / size - 1.
    xs = np.array([(2 * k + 1) / w - 1 for k in range(-1, w + 1)], np.float32)
    ys = np.array([(2 * k + 1) / h - 1 for k in range(-1, h + 1)], np.float32)
    grid = np.stack(np.meshgrid(xs, ys, indexing="xy"), -1)[None]  # (1, h+2, w+2, 2)
    nudged = np.nextafter(grid, np.float32(2.0) * np.sign(rng.normal(size=grid.shape)).astype(np.float32))
    edges = np.array([[[-1.0, -1.0], [1.0, 1.0], [-1.0, 0.3], [0.2, 1.0], [-1.0 - 1e-7, 0.0]]], np.float32)
    for coords in (grid, nudged, edges[:, None]):
        want = np.asarray(jx_grid.grid_sample_nhwc_flat(j(images), j(coords)))
        got = pt_grid.grid_sample_nhwc_flat(t(images), t(coords)).numpy()
        np.testing.assert_allclose(got, want, atol=2e-6)
    on_centres = pt_grid.grid_sample_nhwc_flat(t(images), t(grid)).numpy()[0]
    np.testing.assert_allclose(on_centres[1:-1, 1:-1], images[0], atol=1e-6)  # exact pixels
    assert np.abs(on_centres[0]).max() == 0 and np.abs(on_centres[:, 0]).max() == 0  # one pixel outside
    corner = pt_grid.grid_sample_nhwc_flat(t(images), t(edges[:, None, :1])).numpy()[0, 0, 0]
    np.testing.assert_allclose(corner, 0.25 * images[0, 0, 0], atol=1e-6)  # three of four taps outside


# ---------------------------------------------------------------------------
# 6. transformer


def attention_params(module, selfatt):
    return torch_import.convert_attention(module.state_dict(), "", selfatt)


@pytest.mark.parametrize(
    "selfatt,heads,dim_head",
    [(True, 2, 16), (False, 2, 16), (True, 1, 24), (False, 1, 24)],
    ids=["self", "cross", "self_one_head_no_out", "cross_one_head_no_out"],
)
def test_attention(selfatt, heads, dim_head):
    dim, kv_dim = 24, 24
    rng = np.random.default_rng(8)
    module = randomize(pt_transformer.Attention(dim, heads, dim_head, selfatt=selfatt, kv_dim=kv_dim), seed=9)
    project_out = not (heads == 1 and dim_head == dim)
    assert ("to_out.0.weight" in module.state_dict()) is project_out
    x = rng.normal(size=(3, 5, dim)).astype(np.float32)
    z = None if selfatt else rng.normal(size=(3, 7, kv_dim)).astype(np.float32)
    want = jx_transformer.Attention(dim, heads=heads, dim_head=dim_head, selfatt=selfatt, kv_dim=kv_dim).apply(
        {"params": attention_params(module, selfatt)}, j(x), z=None if z is None else j(z)
    )
    with torch.no_grad():
        got = module(t(x), z=None if z is None else t(z))
    # The port keeps the JAX package's reassociated cross attention
    # ((q Wk^T) z^T, (attn z) Wv), so both modes are the same sums up to
    # the order inside each matrix product.
    close(got, want, 2e-6)
    if not selfatt:
        # The reassociation against forming k and v (to_kv(z)): the same
        # math, another summation order.
        with torch.no_grad():
            k, v = module.to_kv(t(z)).chunk(2, dim=-1)
            q = module._split_heads(module.to_q(t(x)))
            attn = torch.softmax(q @ module._split_heads(k).transpose(-1, -2) * module.scale, dim=-1)
            formed = module.to_out((attn @ module._split_heads(v)).transpose(1, 2).reshape(3, 5, -1))
        close(got, formed.numpy(), 5e-6)


def test_feed_forward_and_transformer():
    dim, depth, heads, dim_head, mlp = 24, 2, 2, 16, 40
    rng = np.random.default_rng(10)
    x = rng.normal(size=(2, 6, dim)).astype(np.float32)
    z = rng.normal(size=(2, 9, dim)).astype(np.float32)
    ff = randomize(pt_transformer.FeedForward(dim, mlp), seed=11)
    want = jx_transformer.FeedForward(dim, mlp).apply(
        {"params": torch_import.convert_feed_forward(ff.state_dict(), "")}, j(3 * x)
    )
    with torch.no_grad():
        close(ff(t(3 * x)), want, 2e-6)  # erf GELU on both sides
    for selfatt in (True, False):
        module = randomize(
            pt_transformer.Transformer(dim, depth, heads, dim_head, mlp, selfatt=selfatt, kv_dim=dim), seed=12
        )
        params = torch_import.convert_transformer(module.state_dict(), "", depth, selfatt=selfatt)
        want = jx_transformer.Transformer(dim, depth, heads, dim_head, mlp, selfatt=selfatt, kv_dim=dim).apply(
            {"params": params}, j(x), z=None if selfatt else j(z)
        )
        with torch.no_grad():
            got = module(t(x), z=None if selfatt else t(z))
        close(got, want, 5e-6, f"selfatt={selfatt}")


# ---------------------------------------------------------------------------
# 7. conversions


def test_depth_to_relative_disparity():
    rng = np.random.default_rng(13)
    near = rng.uniform(0.5, 2, (3, 1)).astype(np.float32)
    far = rng.uniform(50, 200, (3, 1)).astype(np.float32)
    depth = rng.uniform(0.5, 200, (3, 9)).astype(np.float32)
    depth[:, 0], depth[:, 1] = near[:, 0], far[:, 0]
    got = pt_conversions.depth_to_relative_disparity(t(depth), t(near), t(far)).numpy()
    want = np.asarray(jx_conversions.depth_to_relative_disparity(j(depth), j(near), j(far)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[:, 0], 0.0, atol=1e-6)
    np.testing.assert_allclose(got[:, 1], 1.0, atol=1e-6)
    back = pt_conversions.relative_disparity_to_depth(t(got), t(near), t(far)).numpy()
    np.testing.assert_allclose(back, depth, rtol=2e-3)  # far depths lose digits in disparity


# ---------------------------------------------------------------------------
# 8. epipolar sampler


def sampler_inputs(rng, b, v, h, w, c, spread=0.6):
    extr, intr = zip(*(cameras(rng, v, spread) for _ in range(b)))
    return dict(
        images=rng.normal(size=(b, v, h, w, c)).astype(np.float32),
        extrinsics=np.stack(extr),
        intrinsics=np.stack(intr),
        near=np.full((b, v), 0.8, np.float32),
        far=np.full((b, v), 30.0, np.float32),
    )


@pytest.mark.parametrize("v,spread", [(2, 0.6), (3, 0.6), (2, 40.0)], ids=["v2", "v3", "v2_no_overlap"])
def test_epipolar_sampler(v, spread):
    rng = np.random.default_rng(14 + v)
    inp = sampler_inputs(rng, 2, v, 6, 8, 5, spread)
    if spread > 1:  # the second camera far away and turned round: most rays miss it
        inp["extrinsics"][:, 1, :3, :3] = np.diag([-1.0, 1.0, -1.0]).astype(np.float32)
    want = jax.jit(lambda kw: jx_sampler.sample_along_epipolar_lines(**kw, num_samples=4))(
        {k: j(x) for k, x in inp.items()}
    )
    got = pt_sampler.sample_along_epipolar_lines(**{k: t(x) for k, x in inp.items()}, num_samples=4)
    assert got._fields == want._fields
    assert got.features.shape == (2, v, v - 1, 48, 4, 5)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    if spread > 1:
        assert not bool(got.valid.all())
        assert float(got.features[~got.valid].abs().max()) == 0.0  # zeroed rays
    else:
        assert bool(got.valid.any())
    for name in want._fields:
        if name == "valid":
            continue
        g, w_ = getattr(got, name), np.asarray(getattr(want, name))
        assert np.isfinite(w_).all() and bool(torch.isfinite(g).all()), name  # nan_to_num and the overlap mask
        # xy: the segment endpoints to ~1e-5 (test_project_rays_matches_jax);
        # features: bilinear taps of O(1) maps at those xy, 8 pixels across,
        # so an xy error of 1e-5 shows as ~1e-4.
        close(g, w_, 2e-4 if name == "features" else 2e-5, name)


# ---------------------------------------------------------------------------
# 9. image self-attention, and the ConvTranspose flip


ISA = dict(patch_size=2, num_octaves=4, num_layers=2, num_heads=2, d_token=24, d_dot=16, d_mlp=32)


def test_image_self_attention():
    rng = np.random.default_rng(20)
    module = randomize(pt_isa.ImageSelfAttention(pt_isa.ImageSelfAttentionCfg(**ISA), 12, 12), seed=21)
    params = torch_import.convert_image_self_attention(module.state_dict(), "", ISA["num_layers"])
    image = rng.normal(size=(3, 8, 6, 12)).astype(np.float32)
    want = jx_isa.ImageSelfAttention(jx_isa.ImageSelfAttentionCfg(**ISA), 12).apply({"params": params}, j(image))
    with torch.no_grad():
        got = module(t(image))
    assert got.shape == (3, 8, 6, 12)
    close(got, want, 1e-5)  # two convs and two transformer layers in f32


def test_conv_transpose_round_trip_needs_the_flip():
    """Flax's ConvTranspose is torch's ConvTranspose2d with the kernel
    flipped in space. `from_jax` must undo the flip that `torch_import`
    applies: a round trip through both is the identity, the Flax module
    then computes what the port computes, and without the flip it does not."""
    import flax.linen as nn

    rng = np.random.default_rng(22)
    conv = randomize(torch.nn.ConvTranspose2d(5, 7, 4, 4), seed=23)
    sd = {f"up.{k}": v for k, v in conv.state_dict().items()}
    flax_params = torch_import.convert_conv_transpose(sd, "up")
    back = {}
    from_jax._conv_transpose(back, "up", flax_params)
    assert back.keys() == sd.keys()
    for k in sd:
        assert torch.equal(back[k], sd[k]), k

    x = rng.normal(size=(2, 3, 3, 5)).astype(np.float32)
    flax_conv = nn.ConvTranspose(7, kernel_size=(4, 4), strides=(4, 4), padding="VALID")
    want = np.asarray(flax_conv.apply({"params": flax_params}, j(x)))
    loaded = torch.nn.ConvTranspose2d(5, 7, 4, 4)
    loaded.load_state_dict({k[3:]: v for k, v in back.items()})
    with torch.no_grad():
        got = loaded(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    # Left unflipped (the plain conv mapping), the result is wrong by O(1).
    unflipped = dict(flax_params, kernel=np.asarray(flax_params["kernel"])[::-1, ::-1])
    wrong = np.asarray(flax_conv.apply({"params": unflipped}, j(x)))
    assert np.abs(wrong - got).max() > 0.1


# ---------------------------------------------------------------------------
# 10. the epipolar transformer


ET = dict(num_octaves=4, num_layers=2, num_heads=2, num_samples=4, d_dot=16, d_mlp=32, downscale=4)
D_IN = 12


def epipolar_transformer_params(sd, cfg):
    """The epipolar transformer's Flax subtree from a port state_dict, by
    the JAX package's converters (as `convert_encoder` composes them)."""
    depth = cfg.self_attention.num_layers

    def ff_converter(sd_, fn_prefix):
        return {
            "self_attention": torch_import.convert_image_self_attention(sd_, f"{fn_prefix}.self_attention", depth)
        }

    out = {
        "transformer": torch_import.convert_transformer(
            sd, "transformer", cfg.num_layers, selfatt=False, ff_converter=ff_converter
        ),
        "depth_proj": torch_import.convert_linear(sd, "depth_encoding.1"),
        "downscaler": torch_import.convert_conv(sd, "downscaler"),
        "upscaler": torch_import.convert_conv_transpose(sd, "upscaler"),
        "refine1": torch_import.convert_conv(sd, "upscale_refinement.0"),
        "refine2": torch_import.convert_conv(sd, "upscale_refinement.2"),
    }
    if "view_embeddings.weight" in sd:
        out["view_embeddings"] = {"embedding": np.asarray(sd["view_embeddings.weight"])}
    return out


@pytest.mark.parametrize("v,shuffle", [(2, False), (3, True), (3, False)], ids=["v2", "v3_shuffled", "v3_plain_order"])
def test_epipolar_transformer(v, shuffle):
    rng = np.random.default_rng(30 + v)
    pcfg = pt_et.EpipolarTransformerCfg(self_attention=pt_isa.ImageSelfAttentionCfg(**ISA), **ET)
    jcfg = jx_et.EpipolarTransformerCfg(self_attention=jx_isa.ImageSelfAttentionCfg(**ISA), **ET)
    module = randomize(pt_et.EpipolarTransformer(pcfg, D_IN, num_context_views=v), seed=31)
    assert ("view_embeddings.weight" in module.state_dict()) is (v > 2)
    params = epipolar_transformer_params(module.state_dict(), pcfg)
    inp = sampler_inputs(rng, 1, v, 32, 32, D_IN)
    features = inp.pop("images")
    cams = [inp[k] for k in ("extrinsics", "intrinsics", "near", "far")]

    # The permutation is drawn once, in JAX, and handed to both sides: the
    # JAX module draws it from this key, the port takes the order itself.
    key = jax.random.PRNGKey(2)
    order = np.asarray(jax.random.permutation(key, v - 1))
    if shuffle:
        assert order.tolist() != list(range(v - 1))  # this key shuffles
    want, sampling_j = jax.jit(
        lambda p, f, c: jx_et.EpipolarTransformer(jcfg, D_IN, num_context_views=v).apply(
            {"params": p}, f, *c, shuffle_rng=key if shuffle else None
        )
    )(params, j(features), [j(c) for c in cams])
    with torch.no_grad():
        got, sampling_p = module(t(features), *(t(c) for c in cams), view_order=t(order) if shuffle else None)
    assert got.shape == (1, v, 32, 32, D_IN)
    # Sampling (2e-4 of the features, above), two cross-attention layers
    # each with a two-layer image self-attention, and three convolutions.
    close(got, want, 2e-4)
    close(sampling_p.xy_sample, sampling_j.xy_sample, 2e-5)
    if shuffle:
        with torch.no_grad():
            plain, _ = module(t(features), *(t(c) for c in cams))
        assert float((plain - got).abs().max()) > 1e-3  # the order matters


def test_epipolar_transformer_without_downscale_or_depth_encoding():
    rng = np.random.default_rng(40)
    kw = dict(ET, downscale=0, num_octaves=0, num_layers=1)
    pcfg = pt_et.EpipolarTransformerCfg(self_attention=pt_isa.ImageSelfAttentionCfg(**ISA), **kw)
    jcfg = jx_et.EpipolarTransformerCfg(self_attention=jx_isa.ImageSelfAttentionCfg(**ISA), **kw)
    module = randomize(pt_et.EpipolarTransformer(pcfg, D_IN), seed=41)
    sd = module.state_dict()
    assert not any(k.startswith(("downscaler", "upscaler", "depth_encoding")) for k in sd)
    depth = ISA["num_layers"]
    params = {
        "transformer": torch_import.convert_transformer(
            sd, "transformer", 1, selfatt=False,
            ff_converter=lambda s, p: {
                "self_attention": torch_import.convert_image_self_attention(s, f"{p}.self_attention", depth)
            },
        )
    }
    inp = sampler_inputs(rng, 1, 2, 8, 8, D_IN)
    features = inp.pop("images")
    cams = [inp[k] for k in ("extrinsics", "intrinsics", "near", "far")]
    want, _ = jax.jit(lambda p, f, c: jx_et.EpipolarTransformer(jcfg, D_IN).apply({"params": p}, f, *c))(
        params, j(features), [j(c) for c in cams]
    )
    with torch.no_grad():
        got, _ = module(t(features), *(t(c) for c in cams))
    close(got, want, 1e-4)
