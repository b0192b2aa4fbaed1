"""The port's encoder visualizer against the JAX package's, on the CPU, at
the tiny spec of `tests/test_encoder_visualizer.py` (ResNet-18 trunk of 3
stages, d_feature 16, 4 depth buckets, an epipolar transformer of 2
cross-attention layers of 2 heads on 4 samples at downscale 2, 2 Gaussians
per pixel, 2 context views at 32x32).

Weights are made by numpy from a seed on the port's encoder and carried
to the Flax tree by the JAX package's converter; the JAX sampler's
uniforms are recorded and handed to the port. What the JAX encoder sows
(`intermediates`: the epipolar cross-attention maps, the depth pdf) and
dumps (depths, scales, rotations) is held against what the port captures.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelsplat_tpu.interop import torch_import
from pixelsplat_tpu.model.encoder.backbone.resnet import BackboneResnetCfg as JxBackboneCfg
from pixelsplat_tpu.model.encoder.encoder_epipolar import EncoderEpipolar as JxEncoder
from pixelsplat_tpu.model.encoder.encoder_epipolar import EncoderEpipolarCfg as JxEncoderCfg
from pixelsplat_tpu.model.encoder.epipolar import depth_predictor_monocular as jx_depth_module
from pixelsplat_tpu.model.encoder.epipolar.epipolar_transformer import EpipolarTransformerCfg as JxEtCfg
from pixelsplat_tpu.model.encoder.epipolar.image_self_attention import ImageSelfAttentionCfg as JxIsaCfg
from pixelsplat_tpu.model.encoder.visualization import encoder_visualizer_epipolar as jx_vis
from pixelsplat_tpu.model.types import Gaussians as JxGaussians
from pixelsplat_tpu_torch.interop import from_jax
from pixelsplat_tpu_torch.model.encoder.backbone.resnet import BackboneResnetCfg as PtBackboneCfg
from pixelsplat_tpu_torch.model.encoder.encoder_epipolar import EncoderEpipolar as PtEncoder
from pixelsplat_tpu_torch.model.encoder.encoder_epipolar import EncoderEpipolarCfg as PtEncoderCfg
from pixelsplat_tpu_torch.model.encoder.epipolar.epipolar_transformer import EpipolarTransformerCfg as PtEtCfg
from pixelsplat_tpu_torch.model.encoder.epipolar.image_self_attention import ImageSelfAttentionCfg as PtIsaCfg
from pixelsplat_tpu_torch.model.encoder.visualization import encoder_visualizer_epipolar as pt_vis
from pixelsplat_tpu_torch.model.types import Gaussians as PtGaussians

import test_torch_encoder as enc_helpers

H = W = 32
# f32 through the tiny encoder in another summation order, relative to
# each tensor's largest entry (test_torch_encoder.py's measure).
CAPTURE_RTOL = 1e-4
# Figures drawn from the same inputs: the same f32 drawing formulas.
FIGURE_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tiny_cfg(backbone_cfg, et_cfg, isa_cfg, encoder_cfg):
    return encoder_cfg(
        d_feature=16,
        num_monocular_samples=4,
        backbone=backbone_cfg(model="resnet18", num_layers=3, d_out=16),
        epipolar_transformer=et_cfg(
            self_attention=isa_cfg(patch_size=4, num_octaves=2, num_layers=1, num_heads=2, d_token=8, d_dot=8,
                                   d_mlp=16),
            num_octaves=2, num_layers=2, num_heads=2, num_samples=4, d_dot=8, d_mlp=16, downscale=2,
        ),
        gaussians_per_pixel=2,
    )


def make_context():
    rng = np.random.default_rng(0)
    extr = np.tile(np.eye(4, dtype=np.float32), (1, 2, 1, 1))
    extr[0, 1, 0, 3] = 0.4
    return {
        "image": rng.uniform(0, 1, (1, 2, 3, H, W)).astype(np.float32),
        "extrinsics": extr,
        "intrinsics": np.tile(np.float32([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1.0]]), (1, 2, 1, 1)),
        "near": np.full((1, 2), 0.5, np.float32),
        "far": np.full((1, 2), 100.0, np.float32),
    }


def torch_context(context):
    return {k: torch.as_tensor(v) for k, v in context.items()}


@pytest.fixture(scope="module")
def encoders():
    jcfg = tiny_cfg(JxBackboneCfg, JxEtCfg, JxIsaCfg, JxEncoderCfg)
    pcfg = tiny_cfg(PtBackboneCfg, PtEtCfg, PtIsaCfg, PtEncoderCfg)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(pcfg)
    source = enc_helpers.randomize(PtEncoder(pcfg), seed=23)
    flax_params = torch_import.convert_encoder(source.state_dict(), jcfg)
    port = from_jax.load_from_jax(PtEncoder(pcfg).eval(), flax_params)
    return JxEncoder(jcfg), {"params": flax_params}, port


@pytest.fixture(scope="module")
def jax_run(encoders):
    """The JAX visualizer's own encode (`visualize`'s apply call), with the
    sampler's uniforms recorded."""
    jx_encoder, params, _ = encoders
    recorded = []
    original = jx_depth_module.sample_discrete_distribution

    def recording(key, pdf, num_samples):
        u = jax.random.uniform(key, (*pdf.shape[:-1], num_samples), dtype=pdf.dtype)
        jax.debug.callback(lambda x: recorded.append(np.array(x)), u)
        return original(key, pdf, num_samples)

    context = make_context()
    jx_depth_module.sample_discrete_distribution = recording
    try:
        dump = {}
        gaussians, state = jx_encoder.apply(
            params, jax.tree_util.tree_map(jnp.asarray, context), jnp.asarray(0), False, visualization_dump=dump,
            rngs={"sample": jax.random.PRNGKey(0)}, mutable=["intermediates"],
        )
        jax.block_until_ready(gaussians)
    finally:
        jx_depth_module.sample_discrete_distribution = original
    assert len(recorded) == 1 and recorded[0].shape == (1, 2, H * W, 1, 2)
    visualizer = jx_vis.EncoderVisualizerEpipolar(jx_vis.EncoderVisualizerEpipolarCfg(), jx_encoder,
                                                  params)
    return dict(context=context, dump=dump, state=state, gaussians=gaussians, u=recorded[0], visualizer=visualizer)


@pytest.fixture(scope="module")
def port_run(encoders, jax_run):
    _, _, port = encoders
    dump = {}
    context = torch_context(jax_run["context"])
    with torch.no_grad(), port.capture_intermediates() as captured:
        gaussians = port(context, 0, False, u=torch.as_tensor(jax_run["u"]), visualization_dump=dump)
    visualizer = pt_vis.EncoderVisualizerEpipolar(port)
    return dict(context=context, dump=dump, captured=captured, gaussians=gaussians, visualizer=visualizer)


def test_captured_attention_matches_the_sown_maps(jax_run, port_run):
    want = jax_run["visualizer"]._collect_attention(jax_run["state"])
    got = port_run["visualizer"]._collect_attention(port_run["captured"])
    # (layer, b*v*r, head, 1, samples * other views): 2 layers, 2 views of 16x16 rays.
    assert got.shape == want.shape == (2, 2 * 16 * 16, 2, 1, 4)
    enc_helpers.close(torch.as_tensor(got), want, CAPTURE_RTOL, "attention")
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-5)
    # Only the cross-attention: one map per layer, none of the image self-attention.
    assert [len(maps) for maps in port_run["captured"]["attention"]] == [1, 1]


def test_captured_pdf_and_dump_match_jax(jax_run, port_run):
    want_pdf = jax_run["visualizer"]._collect_pdf(jax_run["state"])
    got = port_run["captured"]
    assert got["pdf"].shape == want_pdf.shape == (1, 2, H * W, 1, 4)
    enc_helpers.close(got["pdf"], want_pdf, CAPTURE_RTOL, "pdf")
    want_offset = jax_run["state"]["intermediates"]["depth_predictor"]["offset"][0]
    enc_helpers.close(got["offset"], want_offset, CAPTURE_RTOL, "offset")
    for key in ("depth", "scales", "rotations"):
        enc_helpers.close(port_run["dump"][key], jax_run["dump"][key], CAPTURE_RTOL, key)
    sampling_j, sampling_p = jax_run["dump"]["sampling"], port_run["dump"]["sampling"]
    for name in ("xy_ray", "xy_sample", "xy_sample_near", "xy_sample_far"):
        enc_helpers.close(getattr(sampling_p, name), getattr(sampling_j, name), CAPTURE_RTOL, name)
    assert torch.equal(sampling_p.valid, torch.as_tensor(np.array(sampling_j.valid)))
    for name in JxGaussians._fields:
        enc_helpers.close(getattr(port_run["gaussians"], name), getattr(jax_run["gaussians"], name), CAPTURE_RTOL,
                          name)


def test_capture_is_off_outside_the_block(encoders, jax_run):
    _, _, port = encoders
    modules = [a.fn for a, _ in port.epipolar_transformer.transformer.layers] + [port.depth_predictor]
    assert all(m.capture is None for m in modules)
    with port.capture_intermediates():
        assert all(m.capture is not None for m in modules)
    assert all(m.capture is None for m in modules)
    with pytest.raises(RuntimeError, match="inside"):
        with port.capture_intermediates():
            raise RuntimeError("inside")
    assert all(m.capture is None for m in modules)


def assert_histograms_count(histograms, dump):
    """Every scale and every rotation of batch element 0 falls in a bin."""
    assert set(histograms) == {"log10_scale", "rotation_angle"}
    assert histograms["log10_scale"][0].sum() == dump["scales"][0].numel()
    assert histograms["rotation_angle"][0].sum() == dump["rotations"][0].numel() // 4
    assert all(len(counts) == pt_vis.HISTOGRAM_BINS for counts, _ in histograms.values())


def test_figure_set_is_the_jax_key_set(encoders, port_run):
    _, _, port = encoders
    visualizer = pt_vis.EncoderVisualizerEpipolar(port)
    figures = visualizer.visualize(port_run["context"], 0, generator=torch.Generator().manual_seed(0))
    # The JAX test's expected set (tests/test_encoder_visualizer.py), in `visualize`'s order.
    assert list(figures) == list(pt_vis.FIGURES) and visualizer.omitted == {}
    for name, figure in figures.items():
        assert figure.ndim == 3 and figure.shape[0] == 3, (name, figure.shape)
        assert np.isfinite(figure).all() and figure.min() >= 0.0 and figure.max() <= 1.0, name
    assert_histograms_count(visualizer.histograms, port_run["dump"])


def test_gaussian_stats_left_out_without_matplotlib(encoders, port_run, monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_matplotlib(name, *args, **kwargs):
        if name.split(".")[0] == "matplotlib":
            raise ImportError("No module named 'matplotlib'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    _, _, port = encoders
    visualizer = pt_vis.EncoderVisualizerEpipolar(port)
    figures = visualizer.visualize(port_run["context"], 0, generator=torch.Generator().manual_seed(0))
    assert list(figures) == [k for k in pt_vis.FIGURES if k != "gaussian_stats"]
    assert list(visualizer.omitted) == ["gaussian_stats"] and "matplotlib" in visualizer.omitted["gaussian_stats"]
    assert_histograms_count(visualizer.histograms, port_run["dump"])


def test_cheap_figures_match_jax(jax_run, port_run):
    """The depth and Gaussian figures of both visualizers drawn from the
    JAX encoder's outputs: the port's drawing against the JAX package's."""
    context_j = jax.tree_util.tree_map(jnp.asarray, jax_run["context"])
    jv, pv = jax_run["visualizer"], port_run["visualizer"]
    depth = jax_run["dump"]["depth"]
    want = jv._visualize_depth(context_j, depth)
    got = pv._visualize_depth(port_run["context"], torch.as_tensor(np.asarray(depth)))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    gaussians = jax_run["gaussians"]
    want = jv._visualize_gaussians(context_j, gaussians)
    got = pv._visualize_gaussians(port_run["context"], PtGaussians(*(torch.as_tensor(np.asarray(x)) for x in gaussians)))
    np.testing.assert_allclose(got, want, rtol=0, atol=FIGURE_ATOL)
    stats_want = jv._visualize_gaussian_stats(jax_run["dump"]["scales"], jax_run["dump"]["rotations"])
    histograms = pt_vis.gaussian_histograms(torch.as_tensor(np.asarray(jax_run["dump"]["scales"])),
                                            torch.as_tensor(np.asarray(jax_run["dump"]["rotations"])))
    np.testing.assert_array_equal(pv._visualize_gaussian_stats(histograms), stats_want)


@pytest.mark.slow
def test_every_figure_matches_jax(encoders, jax_run, port_run):
    """Each figure of the port's `visualize` against the JAX visualizer's
    (~75 s: the JAX drawing runs op by op). The JAX `visualize` encodes
    with the key `jax_run` recorded the uniforms of; the port gets them."""
    _, _, port = encoders
    want = jax_run["visualizer"].visualize(jax.tree_util.tree_map(jnp.asarray, jax_run["context"]), 0)
    got = pt_vis.EncoderVisualizerEpipolar(port).visualize(
        port_run["context"], 0, u=torch.as_tensor(jax_run["u"]))
    assert list(got) == list(want)
    for name in want:
        assert got[name].shape == want[name].shape, name
        diff = np.abs(got[name] - np.asarray(want[name]))
        # Colour-map lookups of values a rounding apart may fall in
        # neighbouring bins: at most 0.1 % of the values, by one bin. The
        # histograms' bins span the data's range, so a rounding moves a
        # bar's edge onto the next pixel column (the same data draw the
        # same figure: test_cheap_figures_match_jax).
        assert (diff > FIGURE_ATOL).mean() <= 1e-3, (name, float((diff > FIGURE_ATOL).mean()))
        assert name == "gaussian_stats" or diff.max() <= 0.05, (name, float(diff.max()))
