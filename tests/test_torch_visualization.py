"""The port's visualization modules against the JAX package's, on the CPU:
colour maps (and matplotlib's own lookup), layout, the drawing primitives,
the camera trajectories, the validation's Gaussian projections and camera
diagram, the PLY writer, the video writer and the two smoke scripts.

Inputs are made by numpy from seeds; the JAX side runs on the CPU (its
rasterizer through its XLA scan), the port through the plain versions of
its kernels.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from matplotlib import colormaps
from PIL import Image

from pixelsplat_tpu.model import ply_export as jx_ply
from pixelsplat_tpu.model.types import Gaussians as JxGaussians
from pixelsplat_tpu.ops import rasterizer as jx_render
from pixelsplat_tpu.scripts import test_splatter as jx_splatter
from pixelsplat_tpu.scripts import visualize_epipolar_lines as jx_lines_script
from pixelsplat_tpu.visualization import color_map as jx_color_map
from pixelsplat_tpu.visualization import colors as jx_colors
from pixelsplat_tpu.visualization import layout as jx_layout
from pixelsplat_tpu.visualization import validation_in_3d as jx_3d
from pixelsplat_tpu.visualization.camera_trajectory import interpolation as jx_interp
from pixelsplat_tpu.visualization.camera_trajectory import spin as jx_spin
from pixelsplat_tpu.visualization.camera_trajectory import wobble as jx_wobble
from pixelsplat_tpu.visualization.drawing import cameras as jx_cameras
from pixelsplat_tpu.visualization.drawing import coordinate_conversion as jx_conv
from pixelsplat_tpu.visualization.drawing import lines as jx_lines
from pixelsplat_tpu.visualization.drawing import points as jx_points
from pixelsplat_tpu_torch.model import ply_export as pt_ply
from pixelsplat_tpu_torch.model.types import Gaussians as PtGaussians
from pixelsplat_tpu_torch.ops.rasterizer import adaptive as pt_adaptive
from pixelsplat_tpu_torch.ops.rasterizer.projection import aos_planes
from pixelsplat_tpu_torch.ops.rasterizer.render import RenderSettings as PtRenderSettings
from pixelsplat_tpu_torch.scripts import test_splatter as pt_splatter
from pixelsplat_tpu_torch.scripts import visualize_epipolar_lines as pt_lines_script
from pixelsplat_tpu_torch.utils import video as pt_video
from pixelsplat_tpu_torch.utils.local_logger import LocalLogger
from pixelsplat_tpu_torch.visualization import color_map as pt_color_map
from pixelsplat_tpu_torch.visualization import colors as pt_colors
from pixelsplat_tpu_torch.visualization import layout as pt_layout
from pixelsplat_tpu_torch.visualization import validation_in_3d as pt_3d
from pixelsplat_tpu_torch.visualization.camera_trajectory import interpolation as pt_interp
from pixelsplat_tpu_torch.visualization.camera_trajectory import spin as pt_spin
from pixelsplat_tpu_torch.visualization.camera_trajectory import wobble as pt_wobble
from pixelsplat_tpu_torch.visualization.drawing import cameras as pt_cameras
from pixelsplat_tpu_torch.visualization.drawing import coordinate_conversion as pt_conv
from pixelsplat_tpu_torch.visualization.drawing import lines as pt_lines
from pixelsplat_tpu_torch.visualization.drawing import points as pt_points
from pixelsplat_tpu_torch.visualization.drawing import types as pt_types

# Drawing and projections: f32 of the same formulas, summed in another order.
DRAW_ATOL = 1e-5
PROJECTION_ATOL = 1e-5
TRAJECTORY_ATOL = 1e-6


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


# ---------------------------------------------------------------------------
# Colour maps, colours and layout


def bin_edges() -> np.ndarray:
    """Every edge k/256 of the lookup, the floats on either side of it, and
    values outside [0, 1]."""
    edges = np.arange(257, dtype=np.float32) / 256
    below = np.nextafter(edges, np.float32(-1))
    above = np.nextafter(edges, np.float32(2))
    return np.concatenate([edges, below, above, np.float32([-0.5, 1.5, -np.inf, np.inf])]).astype(np.float32)


@pytest.mark.parametrize("name", ["inferno", "turbo"])
def test_color_map_matches_matplotlib_and_jax(name):
    x = bin_edges()
    got = pt_color_map.apply_color_map(x, name)
    want = colormaps[name](np.clip(x, 0.0, 1.0))[..., :3].astype(np.float32)
    assert got.dtype == np.float32 and got.shape == (len(x), 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jx_color_map.apply_color_map(x, name))
    image = np.random.default_rng(0).uniform(-0.1, 1.1, (2, 5, 7)).astype(np.float32)
    np.testing.assert_array_equal(
        pt_color_map.apply_color_map_to_image(image, name), jx_color_map.apply_color_map_to_image(image, name)
    )
    # The carried table is matplotlib's.
    np.testing.assert_array_equal(pt_color_map.color_map_table(name), np.asarray(colormaps[name].colors, np.float32))


def test_color_map_nan_and_unknown_map():
    got = pt_color_map.apply_color_map(np.float32([np.nan, 0.5]), "turbo")
    want = colormaps["turbo"](np.float32([np.nan, 0.5]))[..., :3].astype(np.float32)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match=r"'viridis'.*\['inferno', 'turbo'\]"):
        pt_color_map.apply_color_map(np.zeros(3), "viridis")


def test_color_map_2d_and_distinct_colors():
    rng = np.random.default_rng(1)
    x, y = rng.uniform(-0.2, 1.2, (2, 6, 5)).astype(np.float32)
    np.testing.assert_array_equal(pt_color_map.apply_color_map_2d(x, y), jx_color_map.apply_color_map_2d(x, y))
    assert [pt_colors.get_distinct_color(i) for i in range(45)] == [jx_colors.get_distinct_color(i) for i in range(45)]


def test_layout_overlay_and_resize():
    rng = np.random.default_rng(2)
    main = rng.uniform(0, 1, (3, 20, 30)).astype(np.float32)
    over = rng.uniform(0, 1, (3, 12, 9)).astype(np.float32)
    for offsets in (((2, 3), (0, 0)), ((15, 25), (1, 2))):
        np.testing.assert_array_equal(pt_layout.overlay(main, over, *offsets), jx_layout.overlay(main, over, *offsets))
    for kwargs in (dict(shape=(11, 7)), dict(width=13), dict(height=9)):
        np.testing.assert_array_equal(pt_layout.resize(main, **kwargs), jx_layout.resize(main, **kwargs))
    grey = main[:1]
    np.testing.assert_array_equal(pt_layout.resize(grey, width=8), jx_layout.resize(grey, width=8))


# ---------------------------------------------------------------------------
# Drawing primitives on a 64x64 canvas


def canvas(seed=3):
    return np.random.default_rng(seed).uniform(0, 1, (3, 64, 64)).astype(np.float32)


@pytest.mark.parametrize("cap", ["butt", "round", "square"])
@pytest.mark.parametrize("per_segment", [False, True])
def test_draw_lines_matches_jax(cap, per_segment):
    rng = np.random.default_rng(4)
    start = rng.uniform(-5, 70, (6, 2)).astype(np.float32)
    end = rng.uniform(-5, 70, (6, 2)).astype(np.float32)
    start[0] = end[0]  # a zero-length segment
    color = rng.uniform(0, 1, (6, 3)).astype(np.float32) if per_segment else (0.2, 0.9, 0.2)
    image = canvas()
    want = np.asarray(jx_lines.draw_lines(image, start, end, color, 3.0, cap=cap))
    got = pt_lines.draw_lines(t(image), start, end, color, 3.0, cap=cap)
    assert got.shape == (3, 64, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=DRAW_ATOL)
    assert np.abs(want - image).max() > 0.1  # something was drawn


def test_draw_lines_rejects_unknown_cap():
    with pytest.raises(ValueError, match="unknown cap"):
        pt_lines.draw_lines(t(canvas()), np.zeros((1, 2)), np.ones((1, 2)), 0.0, 1.0, cap="arrow")


@pytest.mark.parametrize("inner_radius", [0.0, 2.0])
@pytest.mark.parametrize("color", ["grey", "rgb", "per_point"])
def test_draw_points_matches_jax(inner_radius, color):
    rng = np.random.default_rng(5)
    points = rng.uniform(0, 64, (9, 2)).astype(np.float32)
    points[1] = points[0]  # two points on one spot: the first one's colour
    color = {"grey": 0.0, "rgb": (1.0, 0.2, 0.2), "per_point": rng.uniform(0, 1, (9, 3)).astype(np.float32)}[color]
    image = canvas(6)
    want = np.asarray(jx_points.draw_points(image, points, color, 4.0, inner_radius=inner_radius))
    got = pt_points.draw_points(t(image), points, color, 4.0, inner_radius=inner_radius)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=DRAW_ATOL)


def camera_rig(seed=7, n=4):
    """n cameras on a rough arc, looking roughly at the origin."""
    rng = np.random.default_rng(seed)
    extr = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    for i in range(n):
        angle = 0.4 * i + rng.uniform(-0.1, 0.1)
        c, s = np.cos(angle), np.sin(angle)
        extr[i, :3, :3] = np.float32([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        extr[i, :3, 3] = -3.0 * extr[i, :3, 2] + rng.uniform(-0.2, 0.2, 3)
    intr = np.tile(np.float32([[1.1, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1]]), (n, 1, 1))
    return extr, intr


@pytest.mark.parametrize("bounds", [False, True])
def test_draw_cameras_matches_jax(bounds):
    extr, intr = camera_rig()
    color = np.float32([[0.2, 0.6, 1.0], [0.2, 0.6, 1.0], [1.0, 0.3, 0.2], [1.0, 0.3, 0.2]])
    near = np.float32([0.5, 0.6, 0.5, 0.7]) if bounds else None
    far = np.float32([2.0, 2.5, 3.0, 2.2]) if bounds else None
    want = np.asarray(jx_cameras.draw_cameras(64, extr, intr, color, near, far))
    got = pt_cameras.draw_cameras(64, t(extr), t(intr), t(color), None if near is None else t(near),
                                  None if far is None else t(far))
    assert got.shape == (3, 3, 64, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=DRAW_ATOL)
    assert (want < 0.99).any(axis=(1, 2, 3)).all()  # each projection shows lines


def test_frustum_corners_and_aabb_match_jax():
    extr, intr = camera_rig(8)
    depth = np.float32([0.5, 1.0, 2.0, 0.1])
    want = jx_cameras.unproject_frustum_corners(jnp.asarray(extr), jnp.asarray(intr), jnp.asarray(depth))
    got = pt_cameras.unproject_frustum_corners(t(extr), t(intr), t(depth))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    lo, hi = np.float32([-1, 0, 2]), np.float32([3, 0.5, 2.5])
    for g, w in zip(pt_cameras.compute_equal_aabb_with_margin(t(lo), t(hi)),
                    jx_cameras.compute_equal_aabb_with_margin(jnp.asarray(lo), jnp.asarray(hi))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


def test_coordinate_conversion_and_sanitizers():
    xy = np.random.default_rng(9).uniform(0, 1, (5, 2)).astype(np.float32)
    got, want = pt_conv.generate_conversions((48, 64)), jx_conv.generate_conversions((48, 64))
    np.testing.assert_array_equal(got.to_pixel(t(xy)).numpy(), np.asarray(want.to_pixel(jnp.asarray(xy))))
    np.testing.assert_array_equal(got.from_pixel(t(xy)).numpy(), np.asarray(want.from_pixel(jnp.asarray(xy))))
    assert pt_types.sanitize_vector((1.0, 2.0)).shape == (1, 2)
    assert pt_types.sanitize_scalar(3.0, batch=4).tolist() == [3.0] * 4
    assert pt_types.sanitize_color(0.5).tolist() == [0.5] * 3


# ---------------------------------------------------------------------------
# Camera trajectories


def test_wobble_matches_jax():
    extr, _ = camera_rig(10, n=2)
    t_ = np.linspace(0, 1, 60).astype(np.float32)
    got = pt_wobble.generate_wobble(extr[0], np.asarray(0.3), t_)
    want = jx_wobble.generate_wobble(extr[0], np.asarray(0.3), t_)
    assert got.shape == (60, 4, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=TRAJECTORY_ATOL)
    batched = pt_wobble.generate_wobble(extr, np.float32([0.1, 0.2]), t_[:5])
    np.testing.assert_allclose(batched, jx_wobble.generate_wobble(extr, np.float32([0.1, 0.2]), t_[:5]),
                               rtol=0, atol=TRAJECTORY_ATOL)


@pytest.mark.parametrize("case", ["converging", "parallel"])
def test_interpolation_matches_jax(case):
    extr, intr = camera_rig(11, n=2)
    if case == "parallel":
        extr[1, :3, :3] = extr[0, :3, :3]
        extr[1, :3, 3] = extr[0, :3, 3] + np.float32([0.5, 0.0, 0.1])
    intr[1, 0, 0] = 1.4
    t_ = np.linspace(0, 1, 30).astype(np.float32)
    got = pt_interp.interpolate_extrinsics(extr[0], extr[1], t_)
    want = jx_interp.interpolate_extrinsics(extr[0], extr[1], t_)
    assert got.shape == (30, 4, 4) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=TRAJECTORY_ATOL)
    np.testing.assert_allclose(got[0], extr[0], atol=1e-4)  # it starts at the first camera
    np.testing.assert_allclose(got[-1], extr[1], atol=1e-4)  # and ends at the second
    np.testing.assert_allclose(pt_interp.interpolate_intrinsics(intr[0], intr[1], t_),
                               jx_interp.interpolate_intrinsics(intr[0], intr[1], t_), rtol=0, atol=TRAJECTORY_ATOL)


def test_spin_matches_jax():
    got = pt_spin.generate_spin(12, elevation=20.0, radius=3.0)
    want = jx_spin.generate_spin(12, elevation=20.0, radius=3.0)
    assert got.shape == (12, 4, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=TRAJECTORY_ATOL)


# ---------------------------------------------------------------------------
# The validation's 3D views


def projection_scene(seed=12, b=2, g=300):
    """A small scene per batch element: Gaussians in a slab, degree-4 SH.
    Seen from each side their depths are distinct: each coordinate is a
    permuted even grid, its step (>= 0.004) above the depth keys'
    resolution at the orthographic cameras' distance (~2e-3), so both
    packages sort every tile's list alike."""
    rng = np.random.default_rng(seed)
    grid = np.linspace(-1, 1, g)
    means = np.stack(
        [np.stack([rng.permutation(grid) for _ in range(3)], axis=-1) for _ in range(b)]
    ).astype(np.float32) * np.float32([1.0, 0.6, 2.0])
    axes = rng.normal(size=(b, g, 3, 3)).astype(np.float32) * 0.03
    covs = axes @ np.swapaxes(axes, -1, -2) + 1e-4 * np.eye(3, dtype=np.float32)
    sh = rng.normal(size=(b, g, 3, 25)).astype(np.float32) * 0.2
    sh[..., 0] += 1.0
    opac = rng.uniform(0.2, 0.9, (b, g)).astype(np.float32)
    return means, covs, sh, opac


def jax_dropped(scene, resolution, settings=pt_3d.PROJECTION_SETTINGS) -> list[int]:
    """The pairs the JAX package's renderer drops from each projection of
    `scene` at `settings` (its own count), summed over the batch: the three
    views of every batch element in one render."""
    cameras = pt_3d.projection_cameras(t(scene[0]))
    e, k, n, f = jx_render.orthographic_frustum(
        *(jnp.asarray(torch.cat([getattr(c, name) for c in cameras]).numpy())
          for name in ("extrinsics", "width", "width", "near", "far"))
    )
    means, covs, sh, opac = (jnp.tile(jnp.asarray(x), (3,) + (1,) * (x.ndim - 1)) for x in scene)
    _, overflow = jax.jit(
        lambda *args: jx_render.render(
            *args[:4], (resolution, resolution), jnp.zeros((means.shape[0], 3)), *args[4:], scale_invariant=False,
            settings=jx_render.RenderSettings(**dataclasses.asdict(settings)), return_overflow=True,
        )
    )(e, k, n, f, means, covs, sh, opac)
    return np.asarray(overflow).reshape(3, -1).sum(axis=1).tolist()


def test_render_projections_matches_jax():
    scene = projection_scene()
    want = np.asarray(jx_3d.render_projections(JxGaussians(*(jnp.asarray(x) for x in scene)), 32))
    got = pt_3d.render_projections(PtGaussians(*(t(x) for x in scene)), 32)
    assert got.images.shape == want.shape == (2, 3, 3, 32, 32)
    assert got.overflow.tolist() == [[0, 0, 0]] * 2
    assert all(s == pt_3d.PROJECTION_SETTINGS for s in got.settings)  # the JAX settings hold this scene
    np.testing.assert_allclose(got.images.numpy(), want, rtol=0, atol=PROJECTION_ATOL)
    assert (want.max(axis=(2, 3, 4)) > 0.1).all()  # every view shows the scene
    assert jax_dropped(scene, 32) == [0, 0, 0]  # the JAX side drops nothing either


def test_projection_cameras_match_jax():
    """The JAX function's cameras, read from what it hands to
    `render_orthographic`."""
    scene = projection_scene(13, b=2)
    seen = []

    def spy(extrinsics, width, height, near, far, *args, **kwargs):
        seen.append([np.asarray(x) for x in (extrinsics, width, near, far)])
        return jnp.zeros((extrinsics.shape[0], 3, 8, 8))

    original = jx_3d.render_orthographic
    jx_3d.render_orthographic = spy
    try:
        jx_3d.render_projections(JxGaussians(*(jnp.asarray(x) for x in scene)), 8)
    finally:
        jx_3d.render_orthographic = original
    got = pt_3d.projection_cameras(t(scene[0]))
    assert len(got) == len(seen) == 3
    for camera, want in zip(got, seen):
        for g, w in zip((camera.extrinsics, camera.width, camera.near, camera.far), want):
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-6)


def test_projections_grow_lists_the_jax_settings_cannot_hold():
    """At a tile capacity too small for the scene the JAX settings drop
    pairs; the port grows the lists, drops none, and renders what
    settings large enough from the start render."""
    arrays = projection_scene(14, b=1, g=400)
    scene = PtGaussians(*(t(x) for x in arrays))
    small = PtRenderSettings(capacity=32, big_capacity=8, chunk=32)
    roomy_settings = PtRenderSettings(capacity=4096, big_capacity=512, chunk=32)
    assert min(jax_dropped(arrays, 32, small)) > 0
    assert jax_dropped(arrays, 32, roomy_settings) == [0, 0, 0]
    got = pt_3d.render_projections(scene, 32, settings=small)
    assert got.overflow.tolist() == [[0, 0, 0]]
    assert all(s.capacity > small.capacity for s in got.settings)
    roomy = pt_3d.render_projections(scene, 32, settings=roomy_settings)
    assert all(s == roomy_settings for s in roomy.settings)
    np.testing.assert_allclose(got.images.numpy(), roomy.images.numpy(), rtol=0, atol=1e-6)


def test_sufficient_settings_keeps_settings_that_hold():
    scene = projection_scene(15, b=1, g=50)
    camera = pt_3d.projection_cameras(t(scene[0]))[0]
    from pixelsplat_tpu_torch.ops.rasterizer.render import orthographic_frustum

    e, k, n, _ = orthographic_frustum(camera.extrinsics, camera.width, camera.width, camera.near, camera.far)
    settings = PtRenderSettings(capacity=2048, big_capacity=128)
    planes = aos_planes(t(scene[0]), t(scene[1]), t(scene[3]))
    occupancy = pt_adaptive.probe(e, k, n, planes, (32, 32), settings, scale_invariant=False)
    assert pt_adaptive.sufficient_settings(occupancy, settings, scene[0].shape[1], (32, 32)) is settings


def test_render_cameras_matches_jax():
    extr, intr = camera_rig(16)
    batch = {
        "context": {"extrinsics": extr[None, :2], "intrinsics": intr[None, :2], "near": np.float32([[0.5, 0.6]]),
                    "far": np.float32([[2.0, 2.5]])},
        "target": {"extrinsics": extr[None, 2:], "intrinsics": intr[None, 2:], "near": np.float32([[0.5, 0.7]]),
                   "far": np.float32([[3.0, 2.2]])},
    }
    want = np.asarray(jx_3d.render_cameras(jax.tree_util.tree_map(jnp.asarray, batch), 64))
    got = pt_3d.render_cameras(jax.tree_util.tree_map(t, batch), 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=DRAW_ATOL)


# ---------------------------------------------------------------------------
# PLY and video files


def test_export_ply_bytes_equal_jax(tmp_path):
    rng = np.random.default_rng(17)
    g = 257
    extr, _ = camera_rig(18, n=1)
    means = rng.normal(size=(g, 3)).astype(np.float32)
    scales = rng.uniform(1e-3, 0.1, (g, 3)).astype(np.float32)
    rotations = rng.normal(size=(g, 4)).astype(np.float32)
    rotations /= np.linalg.norm(rotations, axis=-1, keepdims=True)
    harmonics = rng.normal(size=(g, 3, 25)).astype(np.float32)
    opacities = rng.uniform(0, 1, g).astype(np.float32)
    args = (extr[0], means, scales, rotations, harmonics, opacities)
    jx_ply.export_ply(*args, tmp_path / "jax.ply")
    pt_ply.export_ply(*(t(x) for x in args), tmp_path / "port" / "port.ply")  # tensors in, parents made
    want = (tmp_path / "jax.ply").read_bytes()
    assert (tmp_path / "port" / "port.ply").read_bytes() == want
    header = want.split(b"end_header\n")[0].decode()
    assert "format binary_little_endian 1.0" in header and f"element vertex {g}" in header
    assert len(want) - len(header) - len(b"end_header\n") == g * 17 * 4  # xyz, normals, DC, opacity, scale, rot


def frames(n=5, h=12, w=16, seed=19):
    return np.random.default_rng(seed).uniform(0, 1, (n, 3, h, w)).astype(np.float32)


def test_save_video_writes_a_gif_without_ffmpeg(tmp_path, monkeypatch):
    monkeypatch.setattr(pt_video.shutil, "which", lambda name: None)
    clip = frames()
    path = pt_video.save_video(clip, tmp_path / "v" / "clip.mp4", fps=10)
    assert path == tmp_path / "v" / "clip.gif" and path.is_file()
    with Image.open(path) as gif:
        assert gif.n_frames == len(clip) and gif.size == (16, 12)
        assert gif.info["duration"] == 100 and gif.info["loop"] == 0
        decoded = []
        for i in range(gif.n_frames):
            gif.seek(i)
            decoded.append(np.asarray(gif.convert("RGB"), np.float32) / 255)
    # A GIF holds a 256-colour palette per frame: each pixel comes back
    # within a palette step of its 8-bit value.
    expected = (np.clip(clip, 0, 1) * 255).astype(np.uint8).transpose(0, 2, 3, 1) / 255
    assert np.abs(np.stack(decoded) - expected).mean() < 0.03


def test_save_video_calls_ffmpeg_when_present(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(pt_video.shutil, "which", lambda name: "/usr/bin/ffmpeg")

    def run(argv, check):
        pngs = sorted(Path(argv[argv.index("-i") + 1]).parent.iterdir())
        calls.append((argv, [p.name for p in pngs]))
        Path(argv[-1]).write_bytes(b"mp4")

    monkeypatch.setattr(pt_video.subprocess, "run", run)
    path = pt_video.save_video(frames(3), tmp_path / "clip.mp4", fps=30)
    assert path == tmp_path / "clip.mp4" and path.read_bytes() == b"mp4"
    (argv, pngs), = calls
    assert argv[0] == "ffmpeg" and argv[argv.index("-framerate") + 1] == "30" and pngs == [
        "00000.png", "00001.png", "00002.png"]


def test_local_logger_logs_videos(tmp_path, monkeypatch):
    monkeypatch.setattr(pt_video.shutil, "which", lambda name: None)
    logger = LocalLogger(tmp_path / "local")
    path = logger.log_video("video/wobble", frames(4), step=3)
    assert path == tmp_path / "local" / "video" / "wobble" / "000003.gif" and path.is_file()


# ---------------------------------------------------------------------------
# The smoke scripts


def read_pngs(directory: Path) -> dict:
    return {p.name: np.asarray(Image.open(p), np.int16) for p in sorted(directory.iterdir())}


def test_test_splatter_matches_jax(tmp_path):
    jx_splatter.main([str(tmp_path / "jax"), "3"])
    got = pt_splatter.main([str(tmp_path / "port"), "3"], device="cpu")
    assert got.shape == (3, 3, 256, 256) and float(got.max()) > 0.5
    want, png = read_pngs(tmp_path / "jax"), read_pngs(tmp_path / "port")
    assert sorted(png) == sorted(want) == ["frame_000.png", "frame_001.png", "frame_002.png"]
    for name in want:  # 8-bit files of renders that agree to RENDER_ATOL
        assert np.abs(png[name] - want[name]).max() <= 1, name


def test_visualize_epipolar_lines_matches_jax(tmp_path):
    jx_lines_script.main([str(tmp_path / "jax")])
    got = pt_lines_script.main([str(tmp_path / "port")], device="cpu")
    want, png = read_pngs(tmp_path / "jax"), read_pngs(tmp_path / "port")
    assert sorted(png) == sorted(want) and len(want) == len(got) >= 1
    for name in want:
        assert np.abs(png[name] - want[name]).max() <= 1, name
