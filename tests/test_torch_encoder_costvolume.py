"""MVSplat's cost-volume encoder (`model/encoder/encoder_costvolume.py`)
against the benchmark's plain reference (`benchmark/reference/costvolume.py`)
on seeded random weights at a small size, and two checks that go through
neither: the plane sweep's geometry on a fronto-parallel plane, and the
window attention's masks. Also the `mvsplat` preset and the encoder choice.

The tests marked `cuda` run at the `mvsplat.eval` cell's widths on the card
and import nothing of the JAX package:

    python -m pytest tests/test_torch_encoder_costvolume.py -m cuda --noconftest -p no:cacheprovider
"""

from __future__ import annotations

import dataclasses
import math

import pytest
import torch

from benchmark import weights as wts
from benchmark.reference import costvolume as ref
from pixelsplat_tpu_torch import config as pt_config
from pixelsplat_tpu_torch.model.encoder.costvolume.backbone_multiview import (
    shifted_window_mask,
    window_attention,
)
from pixelsplat_tpu_torch.model.encoder.encoder_costvolume import EncoderCostVolume
from pixelsplat_tpu_torch.model.encoder.encoder_epipolar import EncoderEpipolar
from pixelsplat_tpu_torch.model.encoder.common.gaussian_adapter import GaussianAdapter
from pixelsplat_tpu_torch.ops.rasterizer.binning import count_big
from pixelsplat_tpu_torch.ops.rasterizer.projection import (
    GaussiansSoA,
    pack_gaussians_soa,
    project_gaussians_soa_plain,
    rescaled,
)
from pixelsplat_tpu_torch.training.model_wrapper import ModelWrapper
from pixelsplat_tpu_torch.utils import tracing

SEED = 2**31 + 23
SIZE = 64


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tracing.enable(False)
    tracing.reset()
    yield
    torch.set_num_threads(threads)
    tracing.enable(False)
    tracing.reset()


def tiny_cfg(views: int):
    """`mvsplat()` at a test's size: every structural setting as published
    (128 -> 32 features, 128 -> 8 candidates, U-Nets at 16 / 8 channels)."""
    encoder, _ = pt_config.mvsplat()
    return dataclasses.replace(
        encoder, d_feature=32, num_depth_candidates=8, costvolume_unet_feat_dim=16, depth_unet_feat_dim=8,
        num_context_views=views,
    )


def context(views: int, dtype=torch.float32) -> dict:
    """Noise images on cameras along x at baseline 1, near 1 and far 100."""
    g = torch.Generator().manual_seed(views)
    e = torch.eye(4).repeat(1, views, 1, 1)
    e[:, :, 0, 3] = torch.linspace(0, 1, views)
    k = torch.tensor([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1]]).repeat(1, views, 1, 1)
    ctx = {"image": torch.rand(1, views, 3, SIZE, SIZE, generator=g), "extrinsics": e, "intrinsics": k,
           "near": torch.ones(1, views), "far": torch.full((1, views), 100.0)}
    return {name: t.to(dtype) for name, t in ctx.items()}


def pair(views: int):
    """The program's encoder and the reference, holding the same seeded weights."""
    cfg = tiny_cfg(views)
    program = EncoderCostVolume(cfg).eval()
    reference = ref.Encoder(dataclasses.asdict(cfg)).eval()
    state = wts.encoder_weights(wts.shapes_of(program), SEED, "cpu")
    program.load_state_dict(state, strict=True)
    reference.load_state_dict(state, strict=True)
    return program, reference


def rel_rms(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.sqrt(((a - b) ** 2).mean()) / torch.sqrt((b**2).mean()))


def as_aos(soa: GaussiansSoA, views: int) -> tuple:
    """SoA planes ((v, srf, spp, r) order, one surface and sample) in the
    AoS (v, r) order."""
    b, g = soa.mean_x.shape
    means = torch.stack([soa.mean_x, soa.mean_y, soa.mean_z], dim=-1)
    cov = torch.zeros(b, g, 3, 3, dtype=means.dtype)
    for row, (i, j) in enumerate(((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))):
        cov[:, :, i, j] = cov[:, :, j, i] = soa.cov[:, row]
    harm = soa.harmonics[:, :, :, :, 0].permute(0, 3, 4, 1, 2).reshape(b, g, 3, -1)
    return means, cov, harm, soa.opacity


def compare(views: int, pack_soa: bool, dtype) -> dict:
    program, reference = pair(views)
    program.to(dtype)
    reference.to(dtype)
    ctx = context(views, dtype)
    with torch.no_grad():
        got = program(ctx, 0, False, pack_soa=pack_soa)
        want = reference(ctx, 0, None, None)
    if pack_soa:
        got = as_aos(got, views)
    names = ("means", "covariances", "harmonics", "opacities")
    assert all(g.shape == w.shape for g, w in zip(got, want))
    return {name: rel_rms(g, w) for name, g, w in zip(names, got, want)}


@pytest.mark.parametrize("pack_soa", [False, True], ids=["aos", "soa"])
@pytest.mark.parametrize("views", [2, 3])
def test_port_matches_the_reference_in_float64(views, pack_soa):
    """The same arithmetic in other orders: in float64 the two agree to
    1e-13 (means, covariances, opacities) and 5e-10 (harmonics, whose SH
    rotation's fixed directions are float32 constants in the program)."""
    gaps = compare(views, pack_soa, torch.float64)
    assert max(gaps.values()) <= 1e-8, gaps


@pytest.mark.parametrize("pack_soa", [False, True], ids=["aos", "soa"])
@pytest.mark.parametrize("views", [2, 3])
def test_port_matches_the_reference_in_float32(views, pack_soa):
    """In float32: harmonics and opacities within 1e-5 (each side reads
    about 1e-6 against float64). Means and covariances within 1e-4: they
    scale with depth = 1 / clamp(disparity + delta, 1 / far, 1 / near), and
    random weights give deltas of order one beside disparities down to
    1 / far = 0.01, so float32's rounding of the disparity is amplified up
    to a hundredfold; each side reads 2-4e-5 against float64 at these
    inputs, and the two sides' errors add."""
    gaps = compare(views, pack_soa, torch.float32)
    assert gaps["harmonics"] <= 1e-5 and gaps["opacities"] <= 1e-5, gaps
    assert gaps["means"] <= 1e-4 and gaps["covariances"] <= 1e-4, gaps


# The plane sweep's geometry, without the reference.

PLANE_VIEWS_H, PLANE_VIEWS_W, CHANNELS, CANDIDATES = 16, 32, 128, 8
NEAR, FAR = 1.0, 100.0
TRUE_CANDIDATE, SHIFT_PIXELS = 3, 2
TRUE_DISPARITY = 1 / FAR + TRUE_CANDIDATE / (CANDIDATES - 1) * (1 / NEAR - 1 / FAR)


def plane_scene():
    """Features of a textured fronto-parallel plane at depth d seen by two
    cameras along x, d at the 4th of 8 disparity candidates over [1/100, 1]
    and the baseline such that the plane shifts by 2 feature pixels between
    the views: the second view's features are the first's moved 2 pixels
    left, random across 128 channels and the pixels (a wrong candidate's
    correlation then stays many standard deviations below the match's)."""
    focal = 0.5  # normalized: 16 feature pixels across 32
    baseline = SHIFT_PIXELS / (focal * PLANE_VIEWS_W * TRUE_DISPARITY)
    texture = torch.randn(CHANNELS, PLANE_VIEWS_H, PLANE_VIEWS_W + SHIFT_PIXELS, generator=torch.Generator().manual_seed(3))
    first = texture[:, :, :PLANE_VIEWS_W]
    second = texture[:, :, SHIFT_PIXELS:]
    features = torch.stack([first, second])[None]  # (1, 2, c, h, w)
    extrinsics = torch.eye(4).repeat(1, 2, 1, 1)
    extrinsics[0, 1, 0, 3] = baseline
    intrinsics = torch.tensor([[focal, 0, 0.5], [0, focal * PLANE_VIEWS_W / PLANE_VIEWS_H, 0.5], [0, 0, 1]]).repeat(1, 2, 1, 1)
    return features, extrinsics, intrinsics, torch.full((1, 2), NEAR), torch.full((1, 2), FAR)


def test_plane_sweep_peaks_at_the_plane_depth():
    """Away from the borders, where every candidate's sample lies inside the
    other view, the correlation of each view peaks at the candidate of the
    plane's disparity; in the program and in the reference alike."""
    features, extrinsics, intrinsics, near, far = plane_scene()
    cfg = dataclasses.replace(tiny_cfg(2), d_feature=CHANNELS, num_depth_candidates=CANDIDATES)
    program = EncoderCostVolume(cfg).eval()
    with torch.no_grad():
        volume, _ = program.depth_predictor.cost_volume(features, intrinsics, extrinsics, near, far)
        want, _ = ref.Encoder(dataclasses.asdict(cfg)).cost_volume(
            list(features[0]), extrinsics[0], intrinsics[0], near[0], far[0]
        )
    margin = math.ceil(SHIFT_PIXELS * (1 / NEAR) / TRUE_DISPARITY) + 1  # the largest candidate's shift
    for name, vol in (("program", volume), ("reference", torch.stack(want))):
        best = vol[:, :CANDIDATES].argmax(dim=1)  # (v, h, w)
        # The first view finds the plane 2 pixels left in the second, the second 2 right in the first.
        assert (best[0, :, margin:] == TRUE_CANDIDATE).all(), name
        assert (best[1, :, :-margin] == TRUE_CANDIDATE).all(), name


# The window attention, without the reference.


def test_window_attention_at_one_split_is_full_attention():
    g = torch.Generator().manual_seed(4)
    q = torch.randn(2, 8, 8, 16, generator=g)
    k, v = torch.randn(2, 2, 8, 8, 16, generator=g), torch.randn(2, 2, 8, 8, 16, generator=g)
    got = window_attention(q, k, v, 1, False, None)
    flat_k, flat_v = k.reshape(2, -1, 16), v.reshape(2, -1, 16)
    weights = torch.softmax(q.reshape(2, -1, 16) @ flat_k.transpose(1, 2) / 4.0, dim=-1)
    assert torch.allclose(got, (weights @ flat_v).reshape(2, 8, 8, 16), atol=1e-6)


def partners(h: int, w: int, splits: int, shift: bool) -> torch.Tensor:
    """(h w, h w): whether two pixels may attend to each other: the same
    window of the (rolled) grid and, when shifted, the same region of it."""
    wh, ww = h // splits, w // splits
    y, x = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    if shift:  # position in the grid rolled by half a window up and left
        y, x = (y - wh // 2) % h, (x - ww // 2) % w
    window = (y // wh) * splits + x // ww
    if shift:
        region = ((y >= h - wh).long() + (y >= h - wh // 2).long()) * 3 + (x >= w - ww).long() + (x >= w - ww // 2).long()
    else:
        region = torch.zeros_like(window)
    key = (window * 9 + region).reshape(-1)
    return key[:, None] == key[None, :]


@pytest.mark.parametrize("shift", [False, True], ids=["windows", "shifted"])
def test_window_attention_stays_in_its_window_and_region(shift):
    """At split 2, changing the keys and values a pixel may not attend to
    leaves its output as it was (up to the e^-100 the shift mask leaves);
    changing one it may attend to changes it."""
    h = w = 8
    g = torch.Generator().manual_seed(5)
    q = torch.randn(1, h, w, 8, generator=g)
    k, v = torch.randn(1, 2, h, w, 8, generator=g), torch.randn(1, 2, h, w, 8, generator=g)
    mask = shifted_window_mask(h, w, 2, "cpu")
    allowed = partners(h, w, 2, shift)
    base = window_attention(q, k, v, 2, shift, mask).reshape(h * w, 8)
    for pixel in range(0, h * w, 7):
        outside = ~allowed[pixel]
        k2, v2 = k.clone(), v.clone()
        k2.view(1, 2, h * w, 8)[:, :, outside] += torch.randn(1, 2, int(outside.sum()), 8, generator=g)
        v2.view(1, 2, h * w, 8)[:, :, outside] += 10.0
        out = window_attention(q, k2, v2, 2, shift, mask).reshape(h * w, 8)
        assert torch.allclose(out[pixel], base[pixel], atol=1e-6), pixel
        partner = int(allowed[pixel].nonzero()[-1])
        v3 = v.clone()
        v3.view(1, 2, h * w, 8)[:, 1, partner] += 10.0
        assert not torch.allclose(window_attention(q, k, v3, 2, shift, mask).reshape(h * w, 8)[pixel], base[pixel])


# The preset, the encoder choice and the tracer.


def test_mvsplat_preset_holds_the_published_widths():
    encoder, decoder = pt_config.mvsplat()
    assert (encoder.name, encoder.d_feature, encoder.num_depth_candidates) == ("costvolume", 128, 128)
    assert (encoder.costvolume_unet_feat_dim, encoder.costvolume_unet_channel_mult, encoder.costvolume_unet_attn_res) == (
        128, (1, 1, 1), (4,)
    )
    assert (encoder.depth_unet_feat_dim, encoder.depth_unet_channel_mult, encoder.depth_unet_attn_res) == (
        32, (1, 1, 1, 1, 1), (16,)
    )
    assert (encoder.gaussians_per_pixel, encoder.num_surfaces, encoder.gaussian_adapter.sh_degree) == (1, 1, 4)
    assert (encoder.gaussian_adapter.gaussian_scale_min, encoder.gaussian_adapter.gaussian_scale_max) == (0.5, 15.0)
    assert (encoder.downscale_factor, encoder.shim_patch_size, encoder.multiview_trans_attn_split) == (4, 4, 2)
    assert (encoder.num_context_views, encoder.compute_dtype) == (2, None)
    render = dataclasses.replace(pt_config.re10k()[1].render, span=3, pair_budget=1_277_952)
    assert decoder == dataclasses.replace(pt_config.re10k()[1], render=render)
    # The set pair budget is the worst case of a 2-view 256 x 256 scene.
    assert render.pair_budget == render.span**2 * 2 * 256 * 256 + 16 * 16 * (render.big_capacity + render.chunk)
    with torch.device("meta"):
        assert sum(p.numel() for p in EncoderCostVolume(encoder).parameters()) == 12_028_502  # MVSplat's "12M"


def test_mvsplat_gaussians_fit_the_render_span():
    """The largest Gaussians MVSplat's adapter can make (every scale at its
    maximum, full opacity), at near, middle and far depths, seen from the
    evaluation rig's targets along x: none spans more than the preset's 3
    tiles on an axis, so none goes to the big list; at span 2 some would."""
    encoder, decoder = pt_config.mvsplat()
    adapter = GaussianAdapter(encoder.gaussian_adapter)
    h = w = 256
    ys, xs = torch.meshgrid(torch.arange(2, h, 5.0), torch.arange(2, w, 5.0), indexing="ij")
    xy = torch.stack([xs, ys], -1).reshape(-1, 2) / torch.tensor([w, h])
    depths = torch.tensor([1.0, 3.0, 100.0]).repeat_interleave(xy.shape[0])
    xy = xy.repeat(3, 1)
    g = xy.shape[0]
    intrinsics = torch.tensor([[1.0, 0.0, 0.5], [0.0, 1.0, 0.5], [0.0, 0.0, 1.0]])
    raw = torch.zeros(g, adapter.d_in)
    raw[:, :3] = 30.0  # sigmoid 1: the largest scale on every axis
    raw[:, 3] = 1.0
    adapted = adapter(torch.eye(4), intrinsics, xy, depths, torch.ones(g), raw, (h, w))
    soa = pack_gaussians_soa(adapted.means, adapted.covariances, adapted.opacities, harmonics=adapted.harmonics)
    largest = {}
    for x in (0.0, 0.5, 1.0):
        target = torch.eye(4)
        target[0, 3] = x
        e, scene = rescaled(target, soa, torch.tensor(1.0))
        projected = project_gaussians_soa_plain(e, intrinsics, (h, w), scene)
        assert int(projected.valid.sum()) > g // 2
        for span in (decoder.render.span, 2):
            largest[span] = largest.get(span, 0) + int(count_big(projected, (h, w), 16, span))
        # A radius of 15 or less covers at most 31 pixels: 3 tiles of 16.
        assert float(projected.radius_x.max()) <= 15 and float(projected.radius_y.max()) <= 15
    assert decoder.render.span == 3 and largest[3] == 0 and largest[2] > 0


def test_model_wrapper_builds_the_encoder_its_configuration_names():
    with torch.device("meta"):
        mvsplat = ModelWrapper(*pt_config.mvsplat(), device="meta")
        re10k = ModelWrapper(*pt_config.re10k(), device="meta")
    assert type(mvsplat.encoder) is EncoderCostVolume and type(re10k.encoder) is EncoderEpipolar
    views = {"image": torch.zeros(1, 2, 3, 72, 78), "intrinsics": torch.eye(3).repeat(1, 2, 1, 1),
             "near": torch.ones(1, 2), "far": torch.full((1, 2), 100.0)}
    shimmed = mvsplat.data_shim({"context": views, "target": views})
    assert shimmed["context"]["image"].shape[-2:] == (64, 64)  # centre-cropped to a multiple of 4 x 4
    assert torch.equal(shimmed["context"]["far"], views["far"])  # no bounds shim
    with pytest.raises(ValueError, match="float32"):
        EncoderCostVolume(dataclasses.replace(pt_config.mvsplat()[0], compute_dtype="bfloat16"))


@pytest.mark.parametrize("views", [2, 3])
def test_stages_are_spanned_and_the_taps_counted(views):
    program, _ = pair(views)
    tracing.enable(True)
    with torch.no_grad():
        program(context(views), 0, False, pack_soa=True)
    found = tracing.read()
    stages = ("backbone", "mv_transformer", "costvolume", "cv_refine", "depth_refine", "heads")
    assert {k: v["calls"] for k, v in found["spans"].items() if k.startswith("encoder.")} == {
        f"encoder.{s}": 1 for s in stages
    }
    assert found["counters"]["costvolume_taps"] == views * (views - 1) * 8 * (SIZE // 4) ** 2
    assert found["counters"]["gaussians"] == views * SIZE * SIZE


# On the card, at the cell's widths.


@pytest.mark.cuda
def test_card_graphs_equal_eager_at_the_cell_widths():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from benchmark import generator, port, spec
    from pixelsplat_tpu_torch.training.model_wrapper import batch_to

    cell = spec.load_cell("mvsplat.eval")
    port.set_precision(cell.config)
    wrapper = port.build(cell.config, SEED, "cuda")
    units = generator.make_units({**cell.traffic, "pool": 2}, cell.config, SEED, "cuda")
    for unit in units + units:  # the second pass replays
        ctx = wrapper.data_shim(batch_to(unit.batch, "cuda"))["context"]
        with torch.no_grad():
            eager = wrapper.encoder(ctx, 0, False, pack_soa=True, visualization_dump={})
            graphed = wrapper.encoder(ctx, 0, False, pack_soa=True)
        torch.cuda.synchronize()
        assert all(x is None and y is None or torch.equal(x, y) for x, y in zip(graphed, eager))
    assert tracing.counter("encoder_graph_captures") == 1 and tracing.counter("encoder_graph_scenes") == 4
