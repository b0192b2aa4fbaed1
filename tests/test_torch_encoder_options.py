"""The encoder's options beyond the production model, against the JAX
package on the CPU: the torchvision ResNet trunks (InstanceNorm, basic and
bottleneck blocks, `use_first_pool`, every `RESNET_SPECS` entry through the
weight converters), transmittance opacities, `predict_opacity`, the whole
encoder on its default ResNet backbone, the bf16 compute policy, and the
three modules kept for capability parity (`common/depth_predictor.py`,
`common/sampler.py`, `epipolar/distribution.py`).

Weights are made by numpy from a seed on the port's modules and carried to
the Flax modules by the JAX package's converters (`interop/torch_import.py`),
or made by Flax's shapes and carried to the port by `interop/from_jax.py`;
the JAX sampler's uniforms are recorded and handed to the port.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelsplat_tpu.config import load_config
from pixelsplat_tpu.interop import torch_import
from pixelsplat_tpu.model.decoder import get_decoder
from pixelsplat_tpu.model.encoder.backbone import resnet as jx_resnet
from pixelsplat_tpu.model.encoder.common import depth_predictor as jx_common_depth
from pixelsplat_tpu.model.encoder.common import sampler as jx_sampler
from pixelsplat_tpu.model.encoder.encoder_epipolar import EncoderEpipolar as JxEncoder
from pixelsplat_tpu.model.encoder.epipolar import depth_predictor_monocular as jx_depth
from pixelsplat_tpu.model.encoder.epipolar import distribution as jx_distribution
from pixelsplat_tpu.training import model_wrapper as jx_wrapper
from pixelsplat_tpu.training.optimizer import OptimizerCfg as JxOptimizerCfg
from pixelsplat_tpu_torch import config as pt_config
from pixelsplat_tpu_torch.interop import from_jax
from pixelsplat_tpu_torch.model.encoder.backbone import resnet as pt_resnet
from pixelsplat_tpu_torch.model.encoder.common import depth_predictor as pt_common_depth
from pixelsplat_tpu_torch.model.encoder.common import sampler as pt_sampler
from pixelsplat_tpu_torch.model.encoder.encoder_epipolar import EncoderEpipolar as PtEncoder
from pixelsplat_tpu_torch.model.encoder.epipolar import depth_predictor_monocular as pt_depth
from pixelsplat_tpu_torch.model.encoder.epipolar import distribution as pt_distribution
from pixelsplat_tpu_torch.training.model_wrapper import ModelWrapper as PtWrapper
from pixelsplat_tpu_torch.training.model_wrapper import batch_to
from pixelsplat_tpu_torch.utils import distributions as pt_dist

import test_torch_re10k as re10k_helpers
import test_torch_slice as slice_helpers
from test_torch_encoder import close, randomize, t

H = W = 64
EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: next to the other test processes, more threads
    only contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def images(seed, n=2, size=H):
    return np.random.default_rng(seed).uniform(0, 1, (1, n, 3, size, size)).astype(np.float32)


def jax_resnet_params(module: torch.nn.Module, model: str, num_layers: int) -> dict:
    """The port module's weights as the Flax BackboneResnet tree."""
    sd = {f"backbone.{k}": v for k, v in module.state_dict().items()}
    return torch_import.convert_resnet(sd, "backbone", model, num_layers)


# ---------------------------------------------------------------------------
# ResNet trunks


# Features, relative to their largest entry: f32 through the trunk's
# convolutions and InstanceNorms in another order. Measured against the
# port run in float64: resnet18's port and JAX features each lie 2.6e-6
# from it; resnet50's (16 blocks, the last stage normalizing 4x4 maps) lie
# 5-7e-5 from it and 6e-5 from each other.
TRUNK_RTOL = {"resnet18": 2e-5, "resnet50": 2e-4}


@pytest.mark.parametrize("model,first_pool", [("resnet18", False), ("resnet50", False), ("resnet50", True)])
def test_resnet_trunk_matches_jax(model, first_pool):
    """A torchvision trunk at full depth (5 layers: the stem and 4 stages,
    InstanceNorm), its projections and the pyramid sum, on 2 views of 64x64;
    with `use_first_pool` the 3x3 stride-2 max pool runs before stage 1, on
    128x128 views so that the last stage still normalizes 4x4 maps."""
    cfg_p = pt_resnet.BackboneResnetCfg("resnet", model, 5, first_pool, 32)
    port = randomize(pt_resnet.BackboneResnet(cfg_p), seed=60)
    assert not any("bn" in k or "downsample.1" in k for k in port.state_dict())  # parameter-free norms
    params = jax_resnet_params(port, model, 5)
    size = 2 * H if first_pool else H
    x = images(61, size=size)
    want = jx_resnet.BackboneResnet(jx_resnet.BackboneResnetCfg("resnet", model, 5, first_pool, 32)).apply(
        {"params": params}, jnp.asarray(x)
    )
    with torch.no_grad():
        got = port(t(x))
    assert got.shape == (1, 2, size, size, 32)
    close(got, want, TRUNK_RTOL[model], f"{model} first_pool={first_pool}")


def test_first_pool_changes_the_features():
    cfg = pt_resnet.BackboneResnetCfg("resnet", "resnet18", 5, False, 32)
    port = randomize(pt_resnet.BackboneResnet(cfg), seed=62)
    pooled = pt_resnet.BackboneResnet(dataclasses.replace(cfg, use_first_pool=True))
    pooled.load_state_dict(port.state_dict())
    with torch.no_grad():
        a, b = port(t(images(63))), pooled(t(images(63)))
    assert float((a - b).abs().max()) > 1e-2


@pytest.mark.parametrize("model", sorted(pt_resnet.RESNET_SPECS))
def test_every_resnet_spec_maps_both_ways(model):
    """Every trunk of `RESNET_SPECS`: a Flax parameter tree (shapes from
    Flax's init, distinct numpy values) loads strictly into the port, and
    the JAX package's `convert_resnet` maps the port's state_dict back to
    the same tree; the InstanceNorm trunks carry no norm entries."""
    num_layers = 4 if model == "dino_resnet50" else 5
    jcfg = jx_resnet.BackboneResnetCfg("resnet", model, num_layers, False, 16)
    shapes = jax.eval_shape(
        lambda: jx_resnet.BackboneResnet(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 1, 3, 32, 32)))
    )["params"]
    rng = np.random.default_rng(64)
    leaves, treedef = jax.tree_util.tree_flatten(shapes)
    tree = jax.tree_util.tree_unflatten(treedef, [rng.normal(size=x.shape).astype(np.float32) for x in leaves])
    sd: dict = {}
    from_jax._resnet(sd, "backbone", tree, model, num_layers)
    port = pt_resnet.BackboneResnet(pt_resnet.BackboneResnetCfg("resnet", model, num_layers, False, 16))
    port.load_state_dict({k[len("backbone."):]: v for k, v in sd.items()}, strict=True)
    back = jax_resnet_params(port, model, num_layers)
    flat_back = jax.tree_util.tree_flatten_with_path(back)[0]
    flat_want = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert [p for p, _ in flat_back] == [p for p, _ in flat_want]
    for (path, a), (_, b) in zip(flat_back, flat_want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(path))
    has_norm_params = any("running_var" in k for k in sd)
    assert has_norm_params is (model == "dino_resnet50")


# ---------------------------------------------------------------------------
# Transmittance opacities


def exclusive_cumsum(pdf):
    partial = np.cumsum(pdf, axis=-1)
    return np.concatenate([np.zeros_like(partial[..., :1]), partial[..., :-1]], axis=-1)


@pytest.mark.parametrize("deterministic,gpp", [(True, 32), (False, 3)])
def test_transmittance_depth_predictor(deterministic, gpp):
    """`use_transmittance`: opacity = pdf / (1 - exclusive cumsum(pdf) +
    1e-10) at the sampled bucket, with the same uniforms; deterministic
    top-32 takes every bucket, the tail included. 1 - partial cancels in
    the last buckets, so an f32 rounding of the cumsum (which torch and XLA
    may sum in another order) becomes a relative error of ~eps / (1 -
    partial): each opacity is held to 2e-5 of itself plus 64 eps / (1 -
    partial) of itself, partial read at its bucket, not to one tolerance
    for every entry."""
    b, v, r, c, s = 1, 2, 96, 32, 32
    net = randomize(pt_depth.DepthPredictorMonocular(c, s, 1, use_transmittance=True), seed=65)
    with torch.no_grad():
        net.projection[1].weight.mul_(4.0)  # peaky pdfs: little mass left in the last buckets
    params = {"projection": torch_import.convert_linear(net.state_dict(), "projection.1")}
    rng = np.random.default_rng(66)
    features = rng.normal(size=(b, v, r, c)).astype(np.float32)
    near, far = np.full((b, v), 1.0, np.float32), np.full((b, v), 50.0, np.float32)
    key = jax.random.PRNGKey(67)
    module = jx_depth.DepthPredictorMonocular(c, s, 1, True)
    (depth_j, opacity_j), state = module.apply(
        {"params": params}, jnp.asarray(features), jnp.asarray(near), jnp.asarray(far), deterministic, gpp,
        rng=key, mutable=["intermediates"],
    )
    pdf_j = np.asarray(state["intermediates"]["pdf"][0])
    u = None if deterministic else t(jax.random.uniform(key, (b, v, r, 1, gpp)))
    with torch.no_grad():
        depth_p, opacity_p = net(t(features), t(near), t(far), deterministic, gpp, u=u)
    np.testing.assert_allclose(depth_p.numpy(), np.asarray(depth_j), rtol=2e-5, atol=1e-6)
    # The sampled buckets, drawn from the JAX pdf by the port's sampler.
    if deterministic:
        index, _ = pt_dist.gather_discrete_topk(t(pdf_j), gpp)
    else:
        index, _ = pt_dist.sample_discrete_distribution(t(pdf_j), gpp, u=u)
    got, want = opacity_p.numpy(), np.asarray(opacity_j)
    left_at = np.take_along_axis(1.0 - exclusive_cumsum(pdf_j), index.numpy(), axis=-1)
    bound = want * (2e-5 + 64 * EPS32 / np.maximum(left_at, 1e-30))
    assert (np.abs(got - want) <= bound + 1e-12).all(), float(np.max(np.abs(got - want) / np.maximum(bound, 1e-30)))
    if gpp == s:
        assert (left_at < 1e-3).any()  # the cancelling tail was compared
    # Transmittance opacities are not the plain densities.
    plain = pt_depth.DepthPredictorMonocular(c, s, 1)
    plain.load_state_dict(net.state_dict())
    with torch.no_grad():
        _, densities = plain(t(features), t(near), t(far), deterministic, gpp, u=u)
    assert float((densities - opacity_p).abs().max()) > 1e-3


def test_transmittance_opacity_composites_back_to_the_pdf():
    """Front to back over the buckets, alpha_i = pdf_i / (1 - partial_i)
    gives each bucket the weight pdf_i: the reason for the option."""
    pdf = torch.softmax(torch.randn(5, 32, generator=torch.Generator().manual_seed(68)), dim=-1).double()
    alpha = pt_depth.transmittance_opacity(pdf)
    transmittance = torch.cumprod(torch.cat([torch.ones(5, 1, dtype=pdf.dtype), 1 - alpha[:, :-1]], -1), -1)
    torch.testing.assert_close(alpha * transmittance, pdf, rtol=1e-8, atol=1e-12)


# ---------------------------------------------------------------------------
# The three modules kept for capability parity


@pytest.mark.parametrize("deterministic", [True, False])
@pytest.mark.parametrize("use_transmittance", [False, True])
def test_common_depth_predictor(deterministic, use_transmittance):
    rng = np.random.default_rng(70)
    pdf = rng.dirichlet(np.ones(16), size=(3, 5)).astype(np.float32)  # (3, 5, 16)
    near, far = rng.uniform(0.5, 2, (3, 5)).astype(np.float32), rng.uniform(50, 100, (3, 5)).astype(np.float32)
    key = jax.random.PRNGKey(71)
    want = jx_common_depth.DepthPredictor(16, use_transmittance).apply(
        {}, jnp.asarray(pdf), jnp.asarray(near), jnp.asarray(far), deterministic, 3, rng=key
    )
    u = None if deterministic else t(jax.random.uniform(key, (3, 5, 3)))
    got = pt_common_depth.DepthPredictor(16, use_transmittance)(t(pdf), t(near), t(far), deterministic, 3, u=u)
    for name, g, w in zip(("depth", "opacity"), got, want):
        # f32 arithmetic in the same order; the cumsum's rounding over 16
        # buckets at most (see test_transmittance_depth_predictor).
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("deterministic", [True, False])
def test_common_sampler(deterministic):
    rng = np.random.default_rng(72)
    probabilities = rng.dirichlet(np.ones(8), size=(4, 6)).astype(np.float32)
    key = jax.random.PRNGKey(73)
    index_j, density_j = jx_sampler.sample(jnp.asarray(probabilities), 3, deterministic, key)
    u = None if deterministic else t(jax.random.uniform(key, (4, 6, 3)))
    index_p, density_p = pt_sampler.sample(t(probabilities), 3, deterministic, u=u)
    np.testing.assert_array_equal(index_p.numpy(), np.asarray(index_j))
    np.testing.assert_allclose(density_p.numpy(), np.asarray(density_j), rtol=1e-6)
    target = rng.normal(size=(4, 6, 8, 2, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        pt_sampler.gather(index_p, t(target)).numpy(), np.asarray(jx_sampler.gather(index_j, jnp.asarray(target)))
    )
    if not deterministic:
        with pytest.raises(ValueError):
            pt_sampler.sample(t(probabilities), 3, False)


@pytest.mark.parametrize("force", [False, True])
def test_distribution(force):
    net = randomize(pt_distribution.Distribution(12, 16), seed=74)
    params = {
        "to_q": torch_import.convert_linear(net.state_dict(), "to_q"),
        "to_k": torch_import.convert_linear(net.state_dict(), "to_k"),
    }
    rng = np.random.default_rng(75)
    features = rng.normal(size=(3, 4, 9, 12)).astype(np.float32)
    last = rng.uniform(size=(3, 4)) < 0.5 if force else None
    want = jx_distribution.Distribution(16).apply(
        {"params": params}, jnp.asarray(features), None if last is None else jnp.asarray(last)
    )
    with torch.no_grad():
        got = net(t(features), None if last is None else torch.as_tensor(last))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)
    if force:
        assert np.allclose(got.numpy()[last][:, -1], 1.0)


# ---------------------------------------------------------------------------
# The whole encoder on the default ResNet backbone, with predict_opacity

SLIM_RESNET50 = ("bottleneck", (1, 1, 1, 1))


def resnet_encoder_cfgs():
    """`config/model/encoder/epipolar.yaml` (the resnet50 InstanceNorm
    backbone, 5 layers) with `predict_opacity`, cut to the size of
    `test_torch_re10k.py`: d_out 64, one block per stage, the small
    epipolar transformer."""
    out = []
    for cfg in (load_config([]).model.encoder, pt_config.default_model()[0]):
        assert cfg.backbone.name == "resnet" and cfg.backbone.model == "resnet50"
        small = re10k_helpers.small(cfg)
        backbone = dataclasses.replace(cfg.backbone, d_out=64)
        out.append(dataclasses.replace(small, backbone=backbone, predict_opacity=True))
    return tuple(out)


@pytest.fixture(scope="module")
def resnet_models():
    with pytest.MonkeyPatch.context() as mp:
        for module in (jx_resnet, pt_resnet):
            mp.setitem(module.RESNET_SPECS, "resnet50", SLIM_RESNET50)
        jcfg, pcfg = resnet_encoder_cfgs()
        jdec_cfg = load_config([]).model.decoder
        _, pdec_cfg = pt_config.default_model()
        source = randomize(PtEncoder(pcfg), seed=76)
        flax_params = torch_import.convert_encoder(source.state_dict(), jcfg)
        assert "to_opacity" in flax_params and "bn1" not in flax_params["backbone"]
        jw = jx_wrapper.ModelWrapper(
            JxOptimizerCfg(), jx_wrapper.TrainCfg(), jx_wrapper.TestCfg(), jcfg, get_decoder(jdec_cfg), []
        )
        pw = PtWrapper(pcfg, pdec_cfg, device="cpu")
        from_jax.load_from_jax(pw.encoder, flax_params)
        yield jw, {"params": flax_params}, pw, mp


def test_resnet_encoder_round_trip(resnet_models):
    """A Flax parameter tree of the whole ResNet-backbone encoder (shapes
    from Flax's init, distinct numpy values) loads strictly into the port
    through `state_dict_from_jax`, and `convert_encoder` maps the port's
    state_dict back to the same tree, `to_opacity` included."""
    jw, _, pw, _ = resnet_models
    jcfg, pcfg = jw.encoder_cfg, pw.encoder_cfg
    context = {k: jnp.asarray(v) for k, v in slice_helpers.make_batch(0)["context"].items()}
    shapes = jax.eval_shape(lambda: JxEncoder(jcfg).init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}, context, jnp.asarray(0), True
    ))["params"]
    rng = np.random.default_rng(77)
    leaves, treedef = jax.tree_util.tree_flatten(shapes)
    tree = jax.tree_util.tree_unflatten(treedef, [rng.normal(size=x.shape).astype(np.float32) for x in leaves])
    encoder = from_jax.load_from_jax(PtEncoder(pcfg), tree)  # strict
    back = torch_import.convert_encoder(encoder.state_dict(), jcfg)
    flat_back = jax.tree_util.tree_flatten_with_path(back)[0]
    flat_want = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert [p for p, _ in flat_back] == [p for p, _ in flat_want]
    for (path, a), (_, b) in zip(flat_back, flat_want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(path))
    assert "to_opacity.1.weight" in encoder.state_dict()


# Gaussians, per field relative to its largest entry: the trunk's f32 (as
# TRUNK_RTOL) and the epipolar transformer's (test_torch_re10k.py).
RESNET_GAUSSIAN_RTOL = 5e-5


def test_resnet_encoder_deterministic_aos(resnet_models):
    """The encoder's default config, deterministic, public AoS Gaussians:
    `predict_opacity` scales every opacity by its pixel's sigmoid."""
    jw, params, pw, mp = resnet_models
    batch = slice_helpers.make_batch(1)
    g_j, _ = slice_helpers.jax_encode(jw, params, batch, True, False, mp)
    g_p = pw.make_eval_encode(pack_soa=False)(batch, True, 0)
    assert g_p.means.shape == (1, 2 * H * W, 3)
    for name in g_j._fields:
        close(getattr(g_p, name), getattr(g_j, name), RESNET_GAUSSIAN_RTOL, name)
    # Without the multiplier the opacities are larger: it really applies.
    plain = PtEncoder(dataclasses.replace(pw.encoder_cfg, predict_opacity=False))
    plain.load_state_dict({k: v for k, v in pw.encoder.state_dict().items() if not k.startswith("to_opacity")})
    with torch.no_grad():
        context = pw.data_shim(batch_to(batch, pw.device))["context"]
        unscaled = plain.eval()(context, 0, True)
    ratio = g_p.opacities / unscaled.opacities
    assert float(ratio.max()) < 1.0 and float(ratio.min()) > 0.0 and float(ratio.std()) > 1e-3


def test_resnet_encoder_probabilistic_soa(resnet_models):
    """The same encoder, probabilistic (gpp 3, the JAX sampler's uniforms),
    emitted straight into the rasterizer's SoA planes."""
    jw, params, pw, mp = resnet_models
    batch = slice_helpers.make_batch(2)
    g_j, u = slice_helpers.jax_encode(jw, params, batch, False, True, mp)
    g_p = pw.make_eval_encode(pack_soa=True)(batch, False, 0, u=torch.as_tensor(np.array(u)))
    assert g_p.mean_x.shape == (1, 2 * H * W * 3)
    for name in ("mean_x", "mean_y", "mean_z", "cov", "opacity", "harmonics"):
        close(getattr(g_p, name), getattr(g_j, name), RESNET_GAUSSIAN_RTOL, name)


# ---------------------------------------------------------------------------
# The bf16 compute policy


@pytest.fixture(scope="module")
def bf16_models():
    """`re10k` at the small size of `test_torch_re10k.py`, one set of
    weights, in f32 and in bf16 on both sides."""
    with pytest.MonkeyPatch.context() as mp:
        re10k_helpers.shrink_backbones(mp)
        jcfg, pcfg = re10k_helpers.small_cfgs()
        jdec_cfg = load_config(["+experiment=re10k"]).model.decoder
        _, pdec_cfg = pt_config.re10k()
        source = randomize(PtEncoder(pcfg), seed=78)
        flax_params = torch_import.convert_encoder(source.state_dict(), jcfg)
        sides = {}
        for policy in (None, "bfloat16"):
            jw = jx_wrapper.ModelWrapper(
                JxOptimizerCfg(), jx_wrapper.TrainCfg(), jx_wrapper.TestCfg(),
                dataclasses.replace(jcfg, compute_dtype=policy), get_decoder(jdec_cfg), [],
            )
            pw = PtWrapper(dataclasses.replace(pcfg, compute_dtype=policy), pdec_cfg, device="cpu")
            from_jax.load_from_jax(pw.encoder, flax_params)
            sides[policy] = (jw, pw)
        yield sides, {"params": flax_params}, mp


def encode_both(sides, params, mp, policy, batch):
    jw, pw = sides[policy]
    g_j, u = slice_helpers.jax_encode(jw, params, batch, False, False, mp)
    g_p = pw.make_eval_encode(pack_soa=False)(batch, False, 0, u=torch.as_tensor(np.array(u)))
    return g_j, g_p


def mean_abs(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).mean())


# The port's bf16 encoder against the JAX package's bf16 encoder, on the
# same weights and uniforms: each bf16 product rounds to 8 bits on both
# sides, but XLA's CPU and torch round at other points (XLA upcasts bf16
# elementwise ops to f32 and rounds after each; torch computes the GELU and
# softmax of a bf16 tensor in f32 and rounds once), so the two bf16 results
# differ about as much as either differs from f32. Measured on this input:
# mean |d opacity| 1.15e-4 and mean |d mean| 6.4e-4 (against 8.9e-5 and
# 4.6e-4 for the port's bf16 against its f32). Held to about 4x those,
# field-wide means, not the f32 parity tolerance per entry.
BF16_PARITY_OPACITY = 5e-4
BF16_PARITY_MEAN = 3e-3
# Each policy against its own f32 result: the JAX package's bounds.
BF16_SELF_OPACITY = 0.05
BF16_SELF_MEAN = 0.15


def test_bf16_encoder_matches_jax_bf16_and_its_own_f32(bf16_models):
    sides, params, mp = bf16_models
    batch = slice_helpers.make_batch(3)
    g32_j, g32_p = encode_both(sides, params, mp, None, batch)
    g16_j, g16_p = encode_both(sides, params, mp, "bfloat16", batch)
    for g in (g16_j, g16_p):
        assert np.asarray(g.means).dtype == np.float32 and np.isfinite(np.asarray(g.means)).all()
        assert np.isfinite(np.asarray(g.harmonics)).all()
    parity = (mean_abs(g16_p.opacities, g16_j.opacities), mean_abs(g16_p.means, g16_j.means))
    print(f"bf16 port vs JAX: mean |d opacity| {parity[0]:.3g}, mean |d mean| {parity[1]:.3g}")
    assert parity[0] < BF16_PARITY_OPACITY and parity[1] < BF16_PARITY_MEAN
    for name, g16, g32 in (("port", g16_p, g32_p), ("jax", g16_j, g32_j)):
        own = (mean_abs(g16.opacities, g32.opacities), mean_abs(g16.means, g32.means))
        print(f"{name} bf16 vs f32: mean |d opacity| {own[0]:.3g}, mean |d mean| {own[1]:.3g}")
        assert own[0] < BF16_SELF_OPACITY and own[1] < BF16_SELF_MEAN, name
        assert own[0] > 0.0  # the policy changed something
    # f32 on both sides still meets the f32 parity tolerance.
    for name in g32_j._fields:
        close(getattr(g32_p, name), getattr(g32_j, name), re10k_helpers.GAUSSIAN_RTOL, name)


def test_bf16_policy_runs_in_bf16_with_f32_parameters(bf16_models):
    """The layers the policy names compute in bf16 (the refinement
    convolutions, the ViT's projections, the ResNet branch's convolutions),
    the norms and the heads in f32; every parameter stays f32."""
    sides, _, _ = bf16_models
    _, pw = sides["bfloat16"]
    encoder = pw.encoder
    assert all(p.dtype == torch.float32 for p in encoder.parameters())
    seen = {}

    def watch(name):
        def hook(_module, _inputs, output):
            seen[name] = output.dtype
        return hook

    et = encoder.epipolar_transformer
    watched = {
        "refine1": et.upscale_refinement[0], "refine2": et.upscale_refinement[2], "downscaler": et.downscaler,
        "vit_qkv": encoder.backbone.dino.blocks[0].attn.qkv, "vit_norm": encoder.backbone.dino.norm,
        "resnet_conv": encoder.backbone.resnet_backbone.model.layer1[0].conv2,
        "resnet_norm": encoder.backbone.resnet_backbone.model.layer1[0].bn2,
        "skip": encoder.high_resolution_skip[0], "depth_head": encoder.depth_predictor.projection[1],
        "to_gaussians": encoder.to_gaussians[1],
    }
    handles = [m.register_forward_hook(watch(n)) for n, m in watched.items()]
    try:
        pw.make_eval_encode()(slice_helpers.make_batch(4), True, 0)
    finally:
        for h in handles:
            h.remove()
    bf16 = {"refine1", "refine2", "downscaler", "vit_qkv", "resnet_conv", "skip"}
    assert seen == {n: torch.bfloat16 if n in bf16 else torch.float32 for n in watched}
