"""The port's paper figures and tables (`pixelsplat_tpu_torch/paper/*`) and
`scripts/dump_launch_configs.py` against the JAX package's, on the CPU.

The model is `re10k` cut to `tests/test_parity_runbook.py::SMALL_OVERRIDES`
(a ResNet-18 trunk, 64x64 images) on the repo's fixture scene. The same
weights reach both packages: numpy-seeded on a port encoder, converted to
the Flax tree by the JAX package's `convert_encoder`. The JAX encoder runs
once, jitted, and a stand-in hands an encode to the JAX figure scripts
(`load_model` patched), so each script runs as written around it.

Pure numpy and layout code (tables, SVG, grids, compositing, the orbit
pose, the frustum mask, the subdivided pdf, the density volume) agrees
exactly or within 1e-6; the overlays, drawn with the drawing primitives,
within those primitives' 1e-5. The two encoders' outputs, and the
attention figure's stacked maps, agree within 1e-4 of each field's
largest entry. Figure renders agree within 1e-4, their PNGs within one
8-bit level, with at most 0.01 % of a figure's values excused, and only
in tiles whose lists hold a depth-key tie (`tied_pixels`: either sort may
order them) or, for a depth map, where the two values fall on different
entries of the colour map. SVG text is identical but for the embedded PNGs
(compared decoded) and the coordinates (within 1e-4).

The whole point-cloud and sampling scripts are marked `slow`: the JAX
decoder's and rasterizer's compiles take about a minute on the CPU. There
the JAX script is handed the port encoder's output, so what they compare
is the figure code; the encoders are held to each other unmarked.
"""

import base64
import dataclasses
import io
import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from pixelsplat_tpu.config import load_config as jx_load_config
from pixelsplat_tpu.interop import torch_import as jx_import
from pixelsplat_tpu.model.decoder import get_decoder as jx_get_decoder
from pixelsplat_tpu.model.encoder import get_encoder as jx_get_encoder
from pixelsplat_tpu.ops import rasterizer as jx_render
from pixelsplat_tpu.paper import common as jx_common
from pixelsplat_tpu.paper import generate_ablation_image_comparison as jx_ablation
from pixelsplat_tpu.paper import generate_attention_figure as jx_attention
from pixelsplat_tpu.paper import generate_benchmark_table as jx_bench_table
from pixelsplat_tpu.paper import generate_comparison_table as jx_comparison_table
from pixelsplat_tpu.paper import generate_epipolar_sampling_figure as jx_epipolar
from pixelsplat_tpu.paper import generate_image_comparison as jx_comparison
from pixelsplat_tpu.paper import generate_point_cloud_figure as jx_point_cloud
from pixelsplat_tpu.paper import generate_sampling_figure as jx_sampling
from pixelsplat_tpu.paper import table as jx_table
from pixelsplat_tpu.scripts import dump_launch_configs as jx_launches
from pixelsplat_tpu_torch.config import load_config as pt_load_config
from pixelsplat_tpu_torch.model.encoder.encoder_epipolar import EncoderEpipolar as PtEncoder
from pixelsplat_tpu_torch.paper import common as pt_common
from pixelsplat_tpu_torch.paper import generate_ablation_image_comparison as pt_ablation
from pixelsplat_tpu_torch.paper import generate_attention_figure as pt_attention
from pixelsplat_tpu_torch.paper import generate_benchmark_table as pt_bench_table
from pixelsplat_tpu_torch.paper import generate_comparison_table as pt_comparison_table
from pixelsplat_tpu_torch.paper import generate_epipolar_sampling_figure as pt_epipolar
from pixelsplat_tpu_torch.paper import generate_image_comparison as pt_comparison
from pixelsplat_tpu_torch.paper import generate_point_cloud_figure as pt_point_cloud
from pixelsplat_tpu_torch.paper import generate_sampling_figure as pt_sampling
from pixelsplat_tpu_torch.paper import table as pt_table
from pixelsplat_tpu_torch.scripts import dump_launch_configs as pt_launches
from pixelsplat_tpu_torch.training.checkpoint import save_checkpoint

import test_torch_encoder as enc_helpers
from test_parity_runbook import EVAL_INDEX, FIXTURE_ROOT, SMALL_OVERRIDES

SCENE, C0, C1 = "fixture_scene_a", 0, 5
EXACT_ATOL = 1e-6
# The overlays are drawn with the drawing primitives, which
# `test_torch_visualization.py` holds to 1e-5 (DRAW_ATOL): an antialiased
# coverage is 0.5 minus a distance of up to tens of pixels, whose last bit
# alone is 2e-6.
DRAW_ATOL = 1e-5
FIGURE_ATOL = 1e-4
FRAC_EXCUSED = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: next to the other test processes, more threads
    only contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class Excused:
    """Values beyond their tolerance, counted over all of a figure's arrays
    (values of pixels `tied` marks left out); `check` holds the count to
    FRAC_EXCUSED of the values compared."""

    def __init__(self):
        self.off = self.size = 0
        self.where = []

    def floats(self, got, want, atol=FIGURE_ATOL, what="", tied=None):
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        assert got.shape == want.shape, what
        off = ~np.isclose(got, want, rtol=0, atol=atol)
        if tied is not None:
            off &= ~np.broadcast_to(tied, off.shape)
        self.count(off, what, float(np.abs(got - want).max()))

    def pngs(self, got: Path, want: Path, tied=None):
        """Saved 8-bit images: within one level."""
        a = np.asarray(Image.open(got), np.int16)
        b = np.asarray(Image.open(want), np.int16)
        assert a.shape == b.shape, (got, a.shape, b.shape)
        off = np.abs(a - b) > 1
        if tied is not None:
            off &= ~tied[..., None]
        self.count(off, got.name, float(np.abs(a - b).max()))

    def count(self, off, what, worst):
        self.off += int(off.sum())
        self.size += off.size
        if off.any():
            self.where.append(f"{what}: {int(off.sum())} of {off.size} (max |d| {worst:.3g})")

    def check(self):
        assert self.off <= FRAC_EXCUSED * self.size, f"{self.off} of {self.size} values off: {self.where}"


def close_but_few(got, want, atol=FIGURE_ATOL, what="", tied=None):
    """Within `atol` on all but FRAC_EXCUSED of the values."""
    excused = Excused()
    excused.floats(got, want, atol, what, tied)
    excused.check()


# ---------------------------------------------------------------------------
# The model, its checkpoint and the scene


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("paper")
    overrides = ["+experiment=re10k", "mode=test", *SMALL_OVERRIDES, f"dataset.roots=[{FIXTURE_ROOT}]"]
    pcfg, jcfg = pt_load_config(overrides), jx_load_config(overrides)
    assert dataclasses.asdict(pcfg.model) == dataclasses.asdict(jcfg.model)
    encoder = enc_helpers.randomize(PtEncoder(pcfg.model.encoder), seed=47).eval()
    checkpoint = save_checkpoint(tmp / "checkpoints", 0, {"params": encoder.state_dict(), "step": 0})
    params = jx_import.convert_encoder(encoder.state_dict(), jcfg.model.encoder)
    example = pt_common.load_scene(pcfg.dataset, SCENE, [C0, C1], [C0, C1])
    return dict(tmp=tmp, pcfg=pcfg, jcfg=jcfg, encoder=encoder, params=params, example=example,
                overrides=[*overrides[2:], f"checkpointing.load={checkpoint}"])


@pytest.fixture(scope="module")
def jax_encode(model):
    """The JAX encoder's deterministic encode of the scene, jitted: the
    Gaussians, the sown intermediates and the visualization dump."""
    jx_encoder, _ = jx_get_encoder(model["jcfg"].model.encoder)

    def run(params, context):
        dump = {}
        gaussians, state = jx_encoder.apply(
            {"params": params}, context, jnp.asarray(0), True, visualization_dump=dump, mutable=["intermediates"]
        )
        return gaussians, state, dump

    context = {k: jnp.asarray(v) for k, v in model["example"]["context"].items()}
    return jax.jit(run)(model["params"], context)


class JaxEncoderStandIn:
    """What a JAX figure script's `encoder.apply` returns for the scene."""

    def __init__(self, example, gaussians, state, dump):
        self.image = np.asarray(example["context"]["image"])
        self.gaussians, self.state, self.dump = gaussians, state, dump

    def apply(self, variables, context, step, deterministic, visualization_dump=None, mutable=None):
        assert deterministic
        np.testing.assert_array_equal(np.asarray(context["image"]), self.image)
        if visualization_dump is not None:
            visualization_dump.update(self.dump)
        return (self.gaussians, self.state) if mutable else self.gaussians


def patch_jax_model(monkeypatch, module, model, encoded):
    """`module.load_model` returns a stand-in encoder that gives `encoded`
    ((Gaussians, state, dump) as the JAX encoder returns them)."""
    stand_in = JaxEncoderStandIn(model["example"], *encoded)
    decoder = jx_get_decoder(model["jcfg"].model.decoder)
    monkeypatch.setattr(module, "load_model", lambda cfg: (stand_in, decoder, {"params": model["params"]}))


def port_encoded_for_jax(model) -> tuple:
    """The port encoder's encode of the scene in the JAX encoder's form:
    (Gaussians, the sown pdf and offsets, the dump's scales and
    rotations)."""
    from pixelsplat_tpu.model.types import Gaussians as JxGaussians

    gaussians, dump, captured = pt_point_cloud.encode_scene(model["encoder"], model["example"], "cpu")
    state = {"intermediates": {"depth_predictor": {k: (jnp.asarray(captured[k].numpy()),) for k in ("pdf", "offset")}}}
    dump = {k: jnp.asarray(dump[k].numpy()) for k in ("scales", "rotations")}
    return JxGaussians(*(jnp.asarray(x.numpy()) for x in gaussians)), state, dump


def test_jax_and_port_encodes_agree(model, jax_encode):
    """What the figures start from, on the same weights: the Gaussians, the
    depth pdf and offsets and the dump, within 1e-4 of each field's
    largest entry (f32 through the encoder in another order)."""
    got, got_state, got_dump = port_encoded_for_jax(model)
    want, want_state, want_dump = jax_encode
    pairs = [(getattr(got, k), getattr(want, k), k) for k in want._fields]
    inter = want_state["intermediates"]
    pairs += [(got_state["intermediates"]["depth_predictor"][k][0], jx_sampling._find_sown(inter, k), k)
              for k in ("pdf", "offset")]
    pairs += [(got_dump[k], want_dump[k], k) for k in ("scales", "rotations")]
    for g, w, name in pairs:
        g, w = np.asarray(g), np.asarray(w)
        scale = max(1e-6, float(np.abs(w).max()))
        close_but_few(g / scale, w / scale, what=name)


def test_load_scene_and_metrics_config_equal_jax(model, tmp_path):
    want = jx_common.load_scene(model["jcfg"].dataset, SCENE, [C0, C1], [C0, C1])
    got = model["example"]
    assert got["scene"] == list(want["scene"])
    for side in ("context", "target"):
        assert got[side].keys() == want[side].keys()
        for k in want[side]:
            np.testing.assert_array_equal(got[side][k], want[side][k], err_msg=f"{side}/{k}")
    overrides = ["+experiment=re10k", f"dataset.roots=[{FIXTURE_ROOT}]"]
    for evaluation in ("re10k", "ablation", "re10k_3_view"):
        pt_root, pt_eval = pt_common.load_metrics_config(overrides, evaluation)
        jx_root, jx_eval = jx_common.load_metrics_config(overrides, evaluation)
        assert dataclasses.asdict(pt_eval) == dataclasses.asdict(jx_eval)
        assert dataclasses.asdict(pt_root.dataset) == dataclasses.asdict(jx_root.dataset)


# ---------------------------------------------------------------------------
# Tables, SVG and grids: exact


def table_methods(rng):
    methods = []
    for i in range(5):
        values = {"psnr": float(rng.uniform(20, 30)), "ssim": float(rng.uniform(0.7, 0.9))}
        if i != 2:
            values["lpips"] = float(rng.uniform(0.1, 0.3))
        if i == 3:
            values["ssim"] = float("nan")
        methods.append((f"Method {i}", values))
    return methods


def test_latex_tables_equal_jax(tmp_path, capsys):
    rng = np.random.default_rng(3)
    methods = table_methods(rng)
    for best, second in ((True, True), (True, False), (False, False)):
        metrics = [
            (module.Metric("PSNR", "psnr", "higher", 2), module.Metric("SSIM", "ssim"), module.Metric("LPIPS", "lpips", "lower"))
            for module in (pt_table, jx_table)
        ]
        assert pt_table.make_latex_table(methods, metrics[0], best, second) == jx_table.make_latex_table(
            methods, metrics[1], best, second
        )

    metrics_json = tmp_path / "metrics.json"
    metrics_json.write_text(json.dumps({name: values for name, values in methods if "lpips" in values}))
    for label, module in (("port", pt_comparison_table), ("jax", jx_comparison_table)):
        module.main([str(metrics_json), str(tmp_path / f"comparison_{label}.tex")])
    assert (tmp_path / "comparison_port.tex").read_text() == (tmp_path / "comparison_jax.tex").read_text()

    runs = []
    for i in range(2):
        run = tmp_path / f"run{i}"
        run.mkdir()
        (run / "benchmark.json").write_text(json.dumps({"encoder": rng.uniform(0, 1, 3).tolist(),
                                                        "decoder": rng.uniform(0, 1, 6).tolist()}))
        (run / "peak_memory.json").write_text(json.dumps({"peak_bytes_in_use": int(rng.integers(1e9, 9e9))}))
        runs.append(f"m{i}={run}")
    for label, module in (("port", pt_bench_table), ("jax", jx_bench_table)):
        module.main([*runs, str(tmp_path / f"benchmark_{label}.tex")])
    assert (tmp_path / "benchmark_port.tex").read_text() == (tmp_path / "benchmark_jax.tex").read_text()
    assert "encoder (ms)" in (tmp_path / "benchmark_port.tex").read_text()


def test_svg_figure_and_encode_image_equal_jax(tmp_path):
    rng = np.random.default_rng(4)
    image = rng.uniform(size=(3, 8, 8)).astype(np.float32)
    np.testing.assert_array_equal(pt_common.to_uint8(image), jx_common.to_uint8(image))
    assert pt_common.encode_image(image) == jx_common.encode_image(image)
    texts = []
    for module in (pt_common, jx_common):
        fig = module.SvgFigure(100, 50)
        fig.add_image(image, 0, 0, 50, 50)
        fig.add_line(0, 0, 10, 10, color="#ff0000", width=2.0)
        fig.add_circle(5, 5, 3)
        fig.add_text("hello", 10, 20)
        fig.add_text("&#8734;", size=10, transform="translate(1, 2) rotate(30)")
        fig.add_rect(20, 10, x=1, y=2, rx=1.0)
        fig.add_rect(20, 10, transform="rotate(5)")
        out = tmp_path / f"{module.__name__}.svg"
        fig.save(out)
        texts.append(out.read_text())
    assert texts[0] == texts[1]
    assert texts[0].startswith("<svg") and "</svg>" in texts[0] and "hello" in texts[0]


def test_comparison_grids_layout_equal_jax(tmp_path):
    rng = np.random.default_rng(0)

    def img():
        return rng.uniform(size=(3, 16, 16)).astype(np.float32)

    rows = [[img(), img(), img(), img(), None] for _ in range(2)]
    rows3 = [[img()] * 3 + [img(), img()]]
    ablation_rows = [[img(), None, img()]]
    texts = {}
    for label, grid, ablation in (("port", pt_comparison, pt_ablation), ("jax", jx_comparison, jx_ablation)):
        grid.generate_image_grid(rows, ["Ours", "Baseline"], tmp_path / f"{label}.svg", num_context=2)
        grid.generate_image_grid(rows3, ["Ours"], tmp_path / f"{label}3.svg", num_context=3)
        ablation.generate_ablation_grid(ablation_rows, ["A", "B", "C"], tmp_path / f"{label}_ablation.svg")
        texts[label] = [(tmp_path / f"{label}{s}.svg").read_text() for s in ("", "3", "_ablation")]
    assert texts["port"] == texts["jax"]
    assert [t.count("<image") for t in texts["port"]] == [10, 5, 3]


def fixture_evaluation(tmp_path: Path, frames: Path) -> str:
    """A config/evaluation overlay for the fixture: one method whose
    frames are `frames`, both fixture scenes highlighted. Returned as the
    overlay's path without `.yaml`, which both packages accept."""
    index = json.loads(EVAL_INDEX.read_text())
    highlighted = "\n".join(f"    - scene: {s}\n      target_index: {e['target'][0]}" for s, e in index.items())
    path = tmp_path / "fixture_evaluation.yaml"
    path.write_text(
        f"dataset:\n  view_sampler:\n    index_path: {EVAL_INDEX}\n"
        f"evaluation:\n  methods:\n    - name: Ours\n      key: ours\n      path: {frames}\n"
        f"    - name: Missing\n      key: missing\n      path: {tmp_path / 'nowhere'}\n"
        f"  side_by_side_path: null\n  animate_side_by_side: false\n  highlighted:\n{highlighted}\n"
    )
    return str(path.with_suffix(""))


def test_comparison_figures_on_the_fixture_equal_jax(tmp_path):
    """`collect_rows` and the three figure scripts' grids over the fixture's
    scenes, with one method's frames on disk and one missing."""
    index = json.loads(EVAL_INDEX.read_text())
    rng = np.random.default_rng(5)
    frames = tmp_path / "frames"
    for scene, entry in index.items():
        path = frames / scene / "color" / f"{entry['target'][0]:0>6}.png"
        path.parent.mkdir(parents=True)
        Image.fromarray(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)).save(path)
    evaluation = fixture_evaluation(tmp_path, frames)
    overrides = [f"dataset.roots=[{FIXTURE_ROOT}]", "dataset.image_shape=[64,64]"]
    for num_context in (2, 3):
        got, got_names = pt_comparison.collect_rows(["re10k"], overrides, evaluation, num_context)
        want, want_names = jx_comparison.collect_rows(["re10k"], overrides, evaluation, num_context)
        assert got_names == want_names == ["Ours", "Missing"]
        assert len(got) == len(want) == len(index)
        for row_got, row_want in zip(got, want):
            assert len(row_got) == len(row_want) == num_context + 3
            assert row_got[-1] is None and row_want[-1] is None
            for a, b in zip(row_got[:-1], row_want[:-1]):
                np.testing.assert_array_equal(a, b)
    texts = {}
    for label, module in (("port", pt_ablation), ("jax", jx_ablation)):
        out = tmp_path / f"ablation_{label}.svg"
        module.main(["--output", str(out), "--evaluation", evaluation, *overrides])
        texts[label] = out.read_text()
    assert texts["port"] == texts["jax"] and texts["port"].count("<image") == 2 * 2


# ---------------------------------------------------------------------------
# Compositing, overlays and geometry helpers: exact


def test_composite_depth_layers_matches_jax():
    rng = np.random.default_rng(6)
    h, w = 12, 10
    layers = [
        (rng.uniform(size=(3, h, w)), rng.uniform(size=(3, h, w)), rng.uniform(0, 5, (3, h, w)))
        for _ in range(4)
    ]
    layers = [tuple(x.astype(np.float32) for x in layer) for layer in layers]
    # A layer of no alpha at depth 1e10 in places, as the overlays leave it.
    layers[1][1][:, :4] = 0.0
    layers[1][2][:, :4] = 1e10
    canvas = rng.uniform(size=(3, h, w)).astype(np.float32)
    want = jx_common.composite_depth_layers(layers, canvas)
    got = pt_common.composite_depth_layers(layers, canvas)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=EXACT_ATOL)


def render_camera(far=6.0, angle=40.0, resolution=48):
    """An orbit camera around a seeded rig and its orthographic frustum."""
    rng = np.random.default_rng(7)
    context = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    context[1, :3, 3] = rng.normal(size=3).astype(np.float32) * 0.3
    pose = jx_point_cloud._orbit_pose(context[0], angle, far)
    frustum = jx_render.orthographic_frustum(
        jnp.asarray(pose)[None], jnp.asarray([far * 2.0]), jnp.asarray([far * 2.0]), jnp.asarray([0.0]),
        jnp.asarray([far]),
    )
    return context, pose, np.asarray(frustum[0][0]), np.asarray(frustum[1][0]), resolution


def test_orbit_pose_matches_jax():
    rng = np.random.default_rng(8)
    for _ in range(4):
        extrinsics = np.eye(4, dtype=np.float32)
        extrinsics[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32)
        extrinsics[:3, 3] = rng.normal(size=3).astype(np.float32)
        angle, far = float(rng.uniform(0, 180)), float(rng.uniform(5, 40))
        got = pt_point_cloud._orbit_pose(extrinsics, angle, far)
        want = jx_point_cloud._orbit_pose(extrinsics, angle, far)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_frustum_lines_and_line_overlay_layers_match_jax():
    context, _, view_extrinsics, view_intrinsics, resolution = render_camera()
    intrinsics = np.tile(np.float32([[0.9, 0, 0.5], [0, 0.9, 0.5], [0, 0, 1]]), (2, 1, 1))
    depth = np.float32([0.75, 0.75])
    got_lines = pt_common.frustum_lines(context, intrinsics, depth)
    want_lines = jx_common.frustum_lines(context, intrinsics, depth)
    assert len(got_lines) == len(want_lines) == 16
    for (a, b), (c, d) in zip(got_lines, want_lines):
        np.testing.assert_allclose(a, c, rtol=0, atol=EXACT_ATOL)
        np.testing.assert_allclose(b, d, rtol=0, atol=EXACT_ATOL)
    assert len(pt_common.frustum_lines(context, intrinsics, depth, max_views=1)) == 8

    args = (want_lines, view_extrinsics, view_intrinsics, (resolution, resolution), 2.0, (0.1, 0.2, 0.3), 0.5)
    got = pt_common.line_overlay_layers(*args)
    want = jx_common.line_overlay_layers(*args)
    assert len(got) == len(want) == 16
    for (gc, ga, gd), (wc, wa, wd) in zip(got, want):
        np.testing.assert_array_equal(gc.numpy(), wc)
        np.testing.assert_allclose(ga.numpy(), wa, rtol=0, atol=DRAW_ATOL)
        # Depths: 1e10 (1 - coverage) + distance x coverage, so a coverage
        # within DRAW_ATOL moves a depth by up to 1e10 x DRAW_ATOL; where a
        # point covers the pixel fully, the f32 distance itself.
        gd, wd = gd.numpy(), wd
        np.testing.assert_allclose(gd, wd, rtol=1e-6, atol=1e10 * DRAW_ATOL)
        covered = wd < 1e5
        np.testing.assert_allclose(gd[covered], wd[covered], rtol=1e-6, atol=0)
    assert any(float(a.max()) > 0.5 for _, a, _ in got)  # the lines are in view
    assert sum(int((d < 1e5).sum()) for _, _, d in want) > 100


def test_frustum_mask_and_subdivided_pdf_match_jax():
    rng = np.random.default_rng(9)
    corners = np.float32([[-1, -1, 4], [1, -1, 4], [1, 1, 4], [-1, 1, 4]]) + rng.normal(size=(4, 3)).astype(np.float32) * 0.1
    origin = np.float32([0.05, -0.02, 0.0])
    points = rng.uniform(-2, 5, (64, 32, 3)).astype(np.float32)
    got = pt_sampling._frustum_mask(points, corners, origin)
    want = jx_sampling._frustum_mask(points, corners, origin)
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < want.size

    pdf = rng.uniform(size=(6, 5, 8)).astype(np.float32)
    offset = rng.uniform(size=(6, 5, 8)).astype(np.float32)
    offset[0, 0, :2] = [0.0, 1.0]  # both ends of the clip
    got = pt_sampling._subdivided_pdf(torch.as_tensor(pdf), torch.as_tensor(offset))
    want = jx_sampling._subdivided_pdf(pdf, offset)
    np.testing.assert_array_equal(got.numpy(), want)


def record_composites(monkeypatch, module, store):
    """Record the layers each composite of `module` receives."""
    original = module.composite_depth_layers

    def recording(layers, canvas):
        store.append([tuple(np.asarray(x) for x in layer) for layer in layers])
        return original(layers, canvas)

    monkeypatch.setattr(module, "composite_depth_layers", recording)


def test_density_volume_matches_jax_on_a_small_grid(model, jax_encode, monkeypatch, tmp_path):
    """The density layer of the sampling figure (24x24 rays, 512 samples
    each), both packages fed the port's captured pdf and offsets. The JAX
    volume is a closure of its script's `main`, so the script runs with its
    renders, overlays and writes stood in for."""
    with torch.no_grad(), model["encoder"].capture_intermediates() as captured:
        model["encoder"]({k: torch.as_tensor(v) for k, v in model["example"]["context"].items()}, 0, True)
    state = {"intermediates": {"depth_predictor": {"pdf": (jnp.asarray(captured["pdf"].numpy()),),
                                                   "offset": (jnp.asarray(captured["offset"].numpy()),)}}}
    patch_jax_model(monkeypatch, jx_sampling, model, (jax_encode[0], state, jax_encode[2]))
    monkeypatch.setattr(jx_sampling, "render_orthographic", lambda **kw: jnp.zeros((1, 3, 24, 24)))
    monkeypatch.setattr(jx_sampling, "line_overlay_layers", lambda *a, **k: [])
    monkeypatch.setattr(jx_sampling, "save_image", lambda image, path: None)
    jax_layers = []
    record_composites(monkeypatch, jx_sampling, jax_layers)
    # A far plane of 1 (the scene is scaled to a unit baseline, near 0.25)
    # spans most of the disparity buckets.
    argv = ["--scene", f"{SCENE}:{C0}:{C1}:1.0", "--resolution", "24", "--samples-per-ray", "512"]
    jx_sampling.main([*argv, "--output", str(tmp_path / "jax"), *model["overrides"]])
    _, want_density, want_depth = jax_layers[1][0]

    port_layers = []
    record_composites(monkeypatch, pt_sampling, port_layers)
    pt_sampling.main([*argv, "--output", str(tmp_path / "port"), "--device", "cpu", *model["overrides"]])
    _, got_density, got_depth = port_layers[1][0]
    np.testing.assert_allclose(got_density, want_density, rtol=0, atol=EXACT_ATOL)
    np.testing.assert_allclose(got_depth, want_depth, rtol=1e-6, atol=EXACT_ATOL)
    hit = want_depth[0] < 1e20
    assert 0 < hit.sum() < hit.size  # some rays reach a pdf value of 0.05, some do not


# ---------------------------------------------------------------------------
# The figures' render settings: the JAX package's where they hold, grown
# where they would drop pairs


def orthographic_scene(pose, far, seed=10, g=150):
    """Gaussians in front of the orbit camera `pose`, seen within its
    `2 far` wide view. Their camera-space depths are a permuted even grid
    whose step (>= 0.033) is over twice the depth keys' resolution at the
    orthographic camera's distance (2^-19 x ~6,900 = 0.013 at 48x48), so
    no two Gaussians tie and both packages sort every tile's list alike."""
    rng = np.random.default_rng(seed)
    cam = np.stack([rng.uniform(-0.8 * far, 0.8 * far, g), rng.uniform(-0.8 * far, 0.8 * far, g),
                    rng.permutation(np.linspace(0.5, far - 0.5, g))], axis=-1).astype(np.float32)
    means = (cam @ pose[:3, :3].T + pose[:3, 3])[None].astype(np.float32)
    a = rng.normal(size=(1, g, 3, 3)).astype(np.float32) * 0.25
    covariances = a @ np.swapaxes(a, -1, -2) + 1e-2 * np.eye(3, dtype=np.float32)
    harmonics = rng.normal(size=(1, g, 3, 25)).astype(np.float32) * 0.3
    opacities = rng.uniform(0.2, 0.9, (1, g)).astype(np.float32)
    return means, covariances.astype(np.float32), harmonics, opacities


def tied_pixels(extrinsics, intrinsics, near, means, covariances, opacities, image_shape, settings,
                scale_invariant) -> np.ndarray:
    """Pixels (h, w) of the tiles whose lists hold two Gaussians of one
    depth key in this view: binning.py quantizes depth to the top
    `depth_bits` of its f32 pattern, and either package's sort may put
    such Gaussians in any order."""
    from pixelsplat_tpu_torch.ops.rasterizer.projection import pack_gaussians_soa
    from pixelsplat_tpu_torch.ops.rasterizer.render import project_and_bin

    soa = pack_gaussians_soa(means, covariances, opacities, colors_precomp=means.new_zeros((means.shape[0], 1)))
    projected, tiles = project_and_bin(extrinsics, intrinsics, near, soa, image_shape=image_shape,
                                       scale_invariant=scale_invariant, settings=settings)
    h, w = image_shape
    tiles_x, tiles_y = -(-w // 16), -(-h // 16)
    depth_bits = 31 - (tiles_x * tiles_y + 1).bit_length()
    keys = torch.clamp(projected.depth, min=0).view(torch.int32).numpy() >> (31 - depth_bits)
    flat, chunk = tiles.flat.numpy(), settings.chunk
    mask = np.zeros((tiles_y, tiles_x), bool)
    for tile, (start, count) in enumerate(zip(tiles.block_start.tolist(), tiles.counts.tolist())):
        ids = flat[start * chunk : start * chunk + count]
        mask[tile // tiles_x, tile % tiles_x] = bool((np.diff(keys[ids]) == 0).any())
    return np.kron(mask, np.ones((16, 16), bool))[:h, :w]


def tied_tiles(record: dict) -> np.ndarray:
    """`tied_pixels` of an orthographic view (an `OrthographicPasses.record`)."""
    from pixelsplat_tpu_torch.ops.rasterizer.render import orthographic_frustum

    means, covariances, _, opacities = record["scene"]
    e, k, n, _ = orthographic_frustum(*record["camera"].values())
    return tied_pixels(e[0], k[0], n[0], means[0], covariances[0], opacities[0], record["image_shape"],
                       record["settings"], scale_invariant=False)


def dropped_at(record: dict, settings) -> int:
    """The pairs `settings` drop from an orthographic view (an
    `OrthographicPasses.record`): the view binned at them, as
    `chip_smoke.py` counts what the JAX settings would drop."""
    from pixelsplat_tpu_torch.ops.rasterizer.projection import pack_gaussians_soa
    from pixelsplat_tpu_torch.ops.rasterizer.render import orthographic_frustum, project_and_bin

    means, covariances, _, opacities = record["scene"]
    e, k, n, _ = orthographic_frustum(*record["camera"].values())
    soa = pack_gaussians_soa(means[0], covariances[0], opacities[0], colors_precomp=means.new_zeros((means.shape[1], 1)))
    _, tiles = project_and_bin(e[0], k[0], n[0], soa, image_shape=record["image_shape"], scale_invariant=False,
                               settings=settings)
    return int(tiles.overflow)


def jax_passes(scene, pose, far, resolution, settings):
    """The JAX script's three passes (alpha, colour, premultiplied depth)
    and the pairs its settings drop from the view."""
    means, covariances, harmonics, opacities = (jnp.asarray(x) for x in scene)
    camera = dict(extrinsics=jnp.asarray(pose)[None], width=jnp.asarray([far * 2.0]), height=jnp.asarray([far * 2.0]),
                  near=jnp.asarray([0.0]), far=jnp.asarray([far]))
    settings = jx_render.RenderSettings(**dataclasses.asdict(settings))

    def render(colors, use_sh):
        return np.asarray(jx_render.render_orthographic(
            **camera, image_shape=(resolution, resolution), background_color=jnp.zeros((1, 3)),
            gaussian_means=means, gaussian_covariances=covariances, gaussian_sh_coefficients=colors,
            gaussian_opacities=opacities, use_sh=use_sh, settings=settings,
        )[0])

    e, k, n, f = jx_render.orthographic_frustum(*camera.values())
    depth_vals = np.linalg.norm(scene[0][0] - np.asarray(e[0])[:3, 3], axis=-1)
    passes = (render(jnp.ones_like(harmonics[..., 0]), False), render(harmonics, True),
              render(jnp.asarray(np.repeat(depth_vals[None, :, None], 3, axis=2)), False))
    _, dropped = jx_render.render(e, k, n, f, (resolution, resolution), jnp.zeros((1, 3)), means, covariances,
                                  harmonics, opacities, scale_invariant=False, settings=settings, return_overflow=True)
    return passes, int(np.asarray(dropped).sum())


def port_passes(scene, pose, far, resolution, settings):
    passes = pt_point_cloud.OrthographicPasses(*scene, pose, far, resolution, settings, "cpu")
    color, alpha, depth = passes.layers(scene[0])
    with np.errstate(invalid="ignore"):
        premultiplied = np.where(depth == 1e10, 0.0, depth * alpha)
    return (alpha, color, premultiplied), passes


def test_figure_passes_equal_jax_where_its_settings_hold():
    _, pose, _, _, resolution = render_camera(far=6.0)
    scene = orthographic_scene(pose, 6.0)
    settings = pt_point_cloud.figure_settings(pt_load_config(["+experiment=re10k"]).model.decoder.render, None)
    assert (settings.capacity, settings.big_capacity) == (4096, 512)
    want, jax_dropped = jax_passes(scene, pose, 6.0, resolution, settings)
    got, passes = port_passes(scene, pose, 6.0, resolution, settings)
    assert jax_dropped == 0 and passes.settings == settings  # the JAX settings hold this view
    assert dropped_at(passes.record, settings) == 0 and passes.record["dropped"] == [0, 0, 0]
    assert not tied_tiles(passes.record).any()
    for name, g, w in zip(("alpha", "colour", "depth"), got, want):
        scale = max(1.0, float(np.abs(w).max()))
        close_but_few(g / scale, w / scale, what=name)
    assert float(want[0].max()) > 0.5  # the view shows the scene


def test_figure_passes_grow_what_the_jax_settings_cannot_hold():
    _, pose, _, _, resolution = render_camera(far=6.0)
    scene = orthographic_scene(pose, 6.0, seed=11)
    small = pt_point_cloud.figure_settings(pt_load_config(["+experiment=re10k"]).model.decoder.render, 32)
    assert (small.capacity, small.big_capacity) == (32, 32)
    _, jax_dropped = jax_passes(scene, pose, 6.0, resolution, small)
    got, passes = port_passes(scene, pose, 6.0, resolution, small)
    assert jax_dropped > 0
    assert dropped_at(passes.record, small) == jax_dropped  # the port's count is what the JAX render drops
    assert passes.settings.capacity > small.capacity and passes.record["dropped"] == [0, 0, 0]
    roomy = pt_point_cloud.figure_settings(small, 4096)
    want, roomy_dropped = jax_passes(scene, pose, 6.0, resolution, roomy)
    assert roomy_dropped == 0 and not tied_tiles(passes.record).any()
    for name, g, w in zip(("alpha", "colour", "depth"), got, want):
        scale = max(1.0, float(np.abs(w).max()))
        close_but_few(g / scale, w / scale, what=name)


# ---------------------------------------------------------------------------
# The model-driven figures


def svg_parts(text: str):
    """(text with numbers and embedded PNGs taken out, numbers, PNGs)."""
    images = re.findall(r"data:image/png;base64,([A-Za-z0-9+/=]+)", text)
    text = re.sub(r"data:image/png;base64,[A-Za-z0-9+/=]+", "IMAGE", text)
    numbers = [float(x) for x in re.findall(r"-?\d+\.?\d*(?:e[-+]?\d+)?", text)]
    skeleton = re.sub(r"-?\d+\.?\d*(?:e[-+]?\d+)?", "N", text)
    pngs = [np.asarray(Image.open(io.BytesIO(base64.b64decode(x)))) for x in images]
    return skeleton, numbers, pngs


def assert_svgs_match(got: Path, want: Path, atol=FIGURE_ATOL):
    g_skeleton, g_numbers, g_pngs = svg_parts(got.read_text())
    w_skeleton, w_numbers, w_pngs = svg_parts(want.read_text())
    assert g_skeleton == w_skeleton
    np.testing.assert_allclose(g_numbers, w_numbers, rtol=0, atol=atol)
    assert len(g_pngs) == len(w_pngs) > 0
    for a, b in zip(g_pngs, w_pngs):
        np.testing.assert_array_equal(a, b)


def test_attention_figure_matches_jax(model, jax_encode, monkeypatch, tmp_path):
    patch_jax_model(monkeypatch, jx_attention, model, jax_encode)
    argv = ["--scene", f"{SCENE}:{C0}:{C1}", "--layer", "0", "--head", "1", "--query", "0.4,0.4",
            "--query", "0.6,0.55", "--query", "0.1,0.9", *model["overrides"]]
    jx_attention.main(["--output", str(tmp_path / "jax.svg"), *argv])
    got = pt_attention.main(["--output", str(tmp_path / "port.svg"), "--device", "cpu", *argv])
    want = jx_attention._collect_cross_attention(jax_encode[1])
    assert got.shape == want.shape  # (layer, tokens, head, 1, samples)
    num_layers, tokens, heads = want.shape[:3]
    for layer in range(num_layers):
        for head in range(heads):
            for token in (0, tokens // 3, tokens - 1):
                np.testing.assert_allclose(got[layer, token, head], want[layer, token, head], rtol=0, atol=FIGURE_ATOL)
    close_but_few(got, want)
    # The SVG colours come from the attention of one layer and head: its
    # hex digits may round differently where a weight sits on a boundary.
    assert_svgs_match(tmp_path / "port.svg", tmp_path / "jax.svg", atol=1.0 + FIGURE_ATOL)


def test_epipolar_sampling_figure_matches_jax(model, tmp_path):
    argv = ["--scene", f"{SCENE}:{C0}:{C1}", "--ray", "0.45,0.5", f"dataset.roots=[{FIXTURE_ROOT}]"]
    jx_epipolar.main(["--output", str(tmp_path / "jax.svg"), *argv])
    pt_epipolar.main(["--output", str(tmp_path / "port.svg"), "--device", "cpu", *argv])
    text = (tmp_path / "port.svg").read_text()
    assert text.count("<image") == 2 and "Ray" in text and text.count("&#8734;") == 1
    assert_svgs_match(tmp_path / "port.svg", tmp_path / "jax.svg")


@pytest.mark.slow
def test_point_cloud_figure_matches_jax(model, monkeypatch, tmp_path):
    """The whole scripts, the JAX one handed the port encoder's output (the
    encoders agree on the same weights: `test_jax_and_port_encodes_agree`),
    so what differs is the figure code's."""
    patch_jax_model(monkeypatch, jx_point_cloud, model, port_encoded_for_jax(model))
    jax_layers, port_layers = [], []
    record_composites(monkeypatch, jx_point_cloud, jax_layers)
    record_composites(monkeypatch, pt_point_cloud, port_layers)
    mapped = {"jax": [], "port": []}
    for label, module in (("jax", jx_point_cloud), ("port", pt_point_cloud)):
        original = module.apply_color_map_to_image
        monkeypatch.setattr(module, "apply_color_map_to_image",
                            lambda x, name, store=mapped[label], f=original: store.append(np.array(x)) or f(x, name))
    # At a tile capacity where the JAX settings drop nothing (at the
    # decoder's 4,096 they drop 512 pairs of this view).
    argv = ["--scene", f"{SCENE}:{C0}:{C1}:30.0:60", "--resolution", "64", "--capacity", "8192", *model["overrides"]]
    jx_point_cloud.main(["--output", str(tmp_path / "jax"), *argv])
    (record,) = pt_point_cloud.main(["--output", str(tmp_path / "port"), "--device", "cpu", *argv])
    passes = record["orthographic"][0]
    assert dropped_at(passes, passes["jax_settings"]) == 0
    assert passes["dropped"] == [0, 0, 0] and record["decoder"]["dropped"] == 0
    (jc, ja, jd), (pc, pa, pd) = jax_layers[0][0], port_layers[0][0]
    tied = tied_tiles(passes)
    assert tied.mean() < 1  # not every tile holds a tie
    floats, pngs = Excused(), Excused()
    floats.floats(pa, ja, what="alpha")
    floats.floats(pc, jc, what="colour", tied=tied)
    # Straight-alpha depth, premultiplied back, relative to the far plane.
    floats.floats(np.where(pd == 1e10, 0, pd * pa) / 30.0, np.where(jd == 1e10, 0, jd * ja) / 30.0,
                  what="depth", tied=tied)
    names = sorted(p.name for p in (tmp_path / "jax").glob("*.png"))
    assert names == sorted(p.name for p in (tmp_path / "port").glob("*.png")) and len(names) == 3
    pngs.pngs(tmp_path / "port" / names[0], tmp_path / "jax" / names[0], tied)
    # The context views' depth maps (log depth normalized by quantiles),
    # then their turbo PNGs where both fall on the same entry of the map.
    gaussians, _, _ = pt_point_cloud.encode_scene(model["encoder"], model["example"], "cpu")
    context = {k: torch.as_tensor(v[0]) for k, v in model["example"]["context"].items()}
    for view, (got, want) in enumerate(zip(mapped["port"], mapped["jax"])):
        tied = tied_pixels(context["extrinsics"][view], context["intrinsics"][view], context["near"][view],
                           gaussians.means[0], gaussians.covariances[0], gaussians.opacities[0], got.shape,
                           record["decoder"]["settings"], scale_invariant=True)
        floats.floats(got, want, what=f"depth map {view}", tied=tied)
        other_entry = np.floor(np.clip(got, 0, 1) * 256) != np.floor(np.clip(want, 0, 1) * 256)
        pngs.pngs(tmp_path / "port" / names[1 + view], tmp_path / "jax" / names[1 + view], other_entry | tied)
    floats.check()
    pngs.check()
    ply = sorted((tmp_path / "port").rglob("gaussians.ply"))
    assert len(ply) == 1 and ply[0].stat().st_size > 0


@pytest.mark.slow
def test_sampling_figure_matches_jax(model, monkeypatch, tmp_path):
    """As the point-cloud figure's test."""
    patch_jax_model(monkeypatch, jx_sampling, model, port_encoded_for_jax(model))
    argv = ["--scene", f"{SCENE}:{C0}:{C1}:30.0", "--resolution", "48", "--samples-per-ray", "32",
            "--capacity", "8192", *model["overrides"]]
    jx_sampling.main(["--output", str(tmp_path / "jax"), *argv])
    (record,) = pt_sampling.main(["--output", str(tmp_path / "port"), "--device", "cpu", *argv])
    assert dropped_at(record, record["jax_settings"]) == 0 and record["dropped"] == [0, 0, 0]
    pngs = Excused()
    pngs.pngs(tmp_path / "port" / "gaussians.png", tmp_path / "jax" / "gaussians.png", tied_tiles(record))
    pngs.pngs(tmp_path / "port" / "density.png", tmp_path / "jax" / "density.png")
    pngs.check()


def test_dump_launch_configs_mirror_jax(capsys):
    jax_port = {name: cmd.replace("pixelsplat_tpu.", "pixelsplat_tpu_torch.") for name, cmd in jx_launches.LAUNCHES.items()}
    assert {k: v for k, v in pt_launches.LAUNCHES.items() if k in jax_port} == jax_port
    extra = set(pt_launches.LAUNCHES) - set(jax_port)
    assert extra == {"train re10k (8 GPUs)"} and pt_launches.LAUNCHES["train re10k (8 GPUs)"].startswith("torchrun ")
    text = pt_launches.render()
    for name, cmd in pt_launches.LAUNCHES.items():
        assert f"# {name}\n{cmd}\n\n" in text
