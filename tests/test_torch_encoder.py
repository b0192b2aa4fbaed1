"""The port's encoder modules against the JAX package's, on the CPU.

Weights are made by numpy from a seed on the port's modules (reference
torch parameter names) and carried to the Flax modules with the JAX
package's own converters (`interop/torch_import.py`); inputs are made by
numpy too. The ViT is cut to a tiny spec (patch 8, dim 64, depth 2, 2
heads), added to both packages' `VIT_SPECS`; the ResNet-50 trunk keeps its
full widths.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelsplat_tpu.config import load_config
from pixelsplat_tpu.interop import torch_import
from pixelsplat_tpu.model.encoder.backbone import dino as jx_dino
from pixelsplat_tpu.model.encoder.backbone import resnet as jx_resnet
from pixelsplat_tpu.model.encoder.common import gaussian_adapter as jx_adapter
from pixelsplat_tpu.model.encoder.encoder_epipolar import EncoderEpipolar as JxEncoder
from pixelsplat_tpu.model.encoder.epipolar import conversions as jx_conversions
from pixelsplat_tpu.model.encoder.epipolar import depth_predictor_monocular as jx_depth
from pixelsplat_tpu.utils import distributions as jx_dist
from pixelsplat_tpu_torch import config as pt_config
from pixelsplat_tpu_torch.interop import from_jax
from pixelsplat_tpu_torch.model.encoder.backbone import dino as pt_dino
from pixelsplat_tpu_torch.model.encoder.backbone import resnet as pt_resnet
from pixelsplat_tpu_torch.model.encoder.common import gaussian_adapter as pt_adapter
from pixelsplat_tpu_torch.model.encoder.encoder_epipolar import EncoderEpipolar as PtEncoder
from pixelsplat_tpu_torch.model.encoder.epipolar import conversions as pt_conversions
from pixelsplat_tpu_torch.model.encoder.epipolar import depth_predictor_monocular as pt_depth
from pixelsplat_tpu_torch.utils import distributions as pt_dist

TINY = dict(patch=8, dim=64, depth=2, heads=2)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: next to the other test processes, more threads
    only contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def tiny_vit(monkeypatch):
    monkeypatch.setitem(jx_dino.VIT_SPECS, "tiny", TINY)
    monkeypatch.setitem(pt_dino.VIT_SPECS, "tiny", TINY)


def t(x):
    return torch.as_tensor(np.array(x))


def randomize(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Fill every parameter and buffer from a numpy seed, at scales that
    keep activations O(1) through the deep trunk."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, x in module.state_dict().items():
            shape = tuple(x.shape)
            if name.endswith("running_var"):
                v = rng.uniform(0.5, 1.5, shape)
            elif x.ndim >= 2 and not name.endswith(("cls_token", "pos_embed")):
                fan_in = int(np.prod(shape[1:]))
                v = rng.normal(size=shape) / np.sqrt(fan_in)
            elif name.endswith("weight"):  # norm scales
                v = 1.0 + 0.1 * rng.normal(size=shape)
            else:
                v = 0.1 * rng.normal(size=shape)
            x.copy_(torch.as_tensor(v, dtype=x.dtype))
    return module


def close(got: torch.Tensor, want, rel: float, what: str = ""):
    """|got - want| <= rel * max|want|: f32 sums taken in another order
    through deep stacks scale with the tensor's magnitude."""
    want = np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got.numpy(), want, atol=rel * float(np.abs(want).max()), rtol=0, err_msg=what)


# ---------------------------------------------------------------------------
# DINO ViT, including the bicubic position-embedding resize


@pytest.mark.parametrize("shape", [(28, 32), (28, 8), (28, 7), (5, 9)])
def test_pos_embed_resize_matches_jax_bicubic(shape):
    n_in, n_out = shape
    grid = np.random.default_rng(0).normal(size=(1, n_in, n_in, 16)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(grid), (1, n_out, n_out, 16), "bicubic")
    got = pt_dino.resize_pos_embed(t(grid), (n_out, n_out))
    # Weights built by the same f32 formula; the contraction order differs.
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("size", [64, 256])  # grid 8 (shrinks 28) and 32 (the production 28 -> 32)
def test_dino_vit(size):
    vit = randomize(pt_dino.DinoViT(pos_grid=28, **TINY), seed=1)
    sd = torch.nn.ModuleDict({"dino": vit}).state_dict()
    params = torch_import.convert_dino_vit(sd, "dino", TINY["depth"], TINY["dim"], TINY["heads"])
    images = np.random.default_rng(2).uniform(0, 1, (2, 3, size, size)).astype(np.float32)
    want = jx_dino.DinoViT(pos_grid=28, **TINY).apply({"params": params}, jnp.asarray(images))
    with torch.no_grad():
        got = vit(t(images))
    close(got, want, 2e-5)


def dino_backbone_params(sd):
    return {
        "dino": torch_import.convert_dino_vit(sd, "backbone.dino", TINY["depth"], TINY["dim"], TINY["heads"]),
        "resnet_backbone": torch_import.convert_resnet(sd, "backbone.resnet_backbone", "dino_resnet50", 4),
        "global_token_fc1": torch_import.convert_linear(sd, "backbone.global_token_mlp.0"),
        "global_token_fc2": torch_import.convert_linear(sd, "backbone.global_token_mlp.2"),
        "local_token_fc1": torch_import.convert_linear(sd, "backbone.local_token_mlp.0"),
        "local_token_fc2": torch_import.convert_linear(sd, "backbone.local_token_mlp.2"),
    }


def test_dino_resnet50_frozen_bn():
    cfg = pt_resnet.BackboneResnetCfg("resnet", "dino_resnet50", 4, False, 32)
    net = randomize(pt_resnet.BackboneResnet(cfg), seed=3)
    sd = torch.nn.ModuleDict({"r": net}).state_dict()
    params = torch_import.convert_resnet(sd, "r", "dino_resnet50", 4)
    images = np.random.default_rng(4).uniform(0, 1, (1, 2, 3, 64, 64)).astype(np.float32)
    want = jx_resnet.BackboneResnet(jx_resnet.BackboneResnetCfg("resnet", "dino_resnet50", 4, False, 32)).apply(
        {"params": params}, jnp.asarray(images)
    )
    with torch.no_grad():
        got = net(t(images))
    close(got, want, 1e-4)


def test_backbone_dino():
    net = randomize(pt_dino.BackboneDino(pt_dino.BackboneDinoCfg(model="tiny", d_out=32)), seed=5)
    params = dino_backbone_params(torch.nn.ModuleDict({"backbone": net}).state_dict())
    images = np.random.default_rng(6).uniform(0, 1, (1, 2, 3, 64, 64)).astype(np.float32)
    want = jx_dino.BackboneDino(jx_dino.BackboneDinoCfg(model="tiny", d_out=32)).apply(
        {"params": params}, jnp.asarray(images)
    )
    with torch.no_grad():
        got = net(t(images))
    close(got, want, 1e-4)


# ---------------------------------------------------------------------------
# Distributions, conversions, depth predictor and Gaussian adapter


def test_sample_discrete_distribution_with_given_u():
    rng = np.random.default_rng(30)
    pdf = rng.uniform(0, 1, (4, 5, 32)).astype(np.float32)
    key = jax.random.PRNGKey(31)
    index_j, density_j = jx_dist.sample_discrete_distribution(key, jnp.asarray(pdf), 3)
    u = jax.random.uniform(key, (4, 5, 3))  # the draw the JAX side makes from `key`
    index_p, density_p = pt_dist.sample_discrete_distribution(t(pdf), 3, u=t(u))
    np.testing.assert_array_equal(index_p.numpy(), np.asarray(index_j))
    np.testing.assert_allclose(density_p.numpy(), np.asarray(density_j), rtol=1e-6)
    # Without u, the uniforms come from the generator: the same seed, the same draw.
    a = pt_dist.sample_discrete_distribution(t(pdf), 3, generator=torch.Generator().manual_seed(1))
    b = pt_dist.sample_discrete_distribution(t(pdf), 3, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a[0], b[0])


def test_gather_discrete_topk_breaks_ties_like_argmax():
    pdf = np.asarray([[0.1, 0.3, 0.3, 0.3], [0.5, 0.1, 0.5, 0.2], [0.25, 0.25, 0.25, 0.25]], np.float32)
    index_j, density_j = jx_dist.gather_discrete_topk(jnp.asarray(pdf), 3)
    index_p, density_p = pt_dist.gather_discrete_topk(t(pdf), 3)
    assert index_p.tolist() == np.asarray(index_j).tolist() == [[1, 2, 3], [0, 2, 3], [0, 1, 2]]
    np.testing.assert_allclose(density_p.numpy(), np.asarray(density_j), rtol=1e-6)


def test_relative_disparity_to_depth():
    rng = np.random.default_rng(32)
    rel = rng.uniform(0, 1, (3, 7)).astype(np.float32)
    near = rng.uniform(0.5, 2, (3, 1)).astype(np.float32)
    far = rng.uniform(50, 200, (3, 1)).astype(np.float32)
    np.testing.assert_allclose(
        pt_conversions.relative_disparity_to_depth(t(rel), t(near), t(far)).numpy(),
        np.asarray(jx_conversions.relative_disparity_to_depth(jnp.asarray(rel), jnp.asarray(near), jnp.asarray(far))),
        rtol=1e-6,
    )


@pytest.mark.parametrize("deterministic", [True, False])
def test_depth_predictor(deterministic):
    b, v, r, c, s, gpp = 1, 2, 96, 32, 32, 3
    net = randomize(pt_depth.DepthPredictorMonocular(c, s, 1), seed=7)
    params = {"projection": torch_import.convert_linear(net.state_dict(), "projection.1")}
    rng = np.random.default_rng(8)
    features = rng.normal(size=(b, v, r, c)).astype(np.float32)
    near = np.full((b, v), 1.0, np.float32)
    far = np.full((b, v), 50.0, np.float32)
    key = jax.random.PRNGKey(9)
    want = jx_depth.DepthPredictorMonocular(c, s, 1, False).apply(
        {"params": params}, jnp.asarray(features), jnp.asarray(near), jnp.asarray(far),
        deterministic, gpp, rng=key,
    )
    # The JAX side draws its uniforms from `key`; the same draw goes to the port.
    u = None if deterministic else t(jax.random.uniform(key, (b, v, r, 1, gpp)))
    with torch.no_grad():
        got = net(t(features), t(near), t(far), deterministic, gpp, u=u)
    for name, g_, w_ in zip(("depth", "opacity"), got, want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), rtol=2e-5, atol=1e-6, err_msg=name)


def test_gaussian_adapter():
    rng = np.random.default_rng(10)
    b, v, r, spp = 1, 2, 20, 3
    cfg_kw = dict(gaussian_scale_min=0.5, gaussian_scale_max=15.0, sh_degree=4)
    d_in = 7 + 3 * 25
    extr = np.tile(np.eye(4, dtype=np.float32), (b, v, 1, 1))
    q, _ = np.linalg.qr(rng.normal(size=(v, 3, 3)))
    q[np.linalg.det(q) < 0, :, 0] *= -1
    extr[0, :, :3, :3] = q
    extr[0, :, :3, 3] = rng.normal(size=(v, 3))
    intr = np.tile(np.array([[1.1, 0, 0.5], [0, 0.9, 0.5], [0, 0, 1]], np.float32), (b, v, 1, 1))
    coords = rng.uniform(0, 1, (b, v, r, 1, 1, 2)).astype(np.float32)
    depths = rng.uniform(1, 10, (b, v, r, 1, spp)).astype(np.float32)
    opac = rng.uniform(0, 1, (b, v, r, 1, spp)).astype(np.float32)
    raw = rng.normal(size=(b, v, r, 1, 1, d_in)).astype(np.float32)
    cams = (extr[:, :, None, None, None], intr[:, :, None, None, None])
    want = jx_adapter.GaussianAdapter(jx_adapter.GaussianAdapterCfg(**cfg_kw))(
        *(jnp.asarray(a) for a in (*cams, coords, depths, opac, raw)), (32, 48)
    )
    got = pt_adapter.GaussianAdapter(pt_adapter.GaussianAdapterCfg(**cfg_kw))(
        *(t(a) for a in (*cams, coords, depths, opac, raw)), (32, 48)
    )
    for name in want._fields:
        # f32 elementwise arithmetic and 25x25 rotations in another order.
        close(getattr(got, name), getattr(want, name), 2e-6, name)


# ---------------------------------------------------------------------------
# Weight interop


def tiny_encoder_cfgs():
    jcfg = load_config(["+experiment=re10k_ablation_no_epipolar_transformer"]).model.encoder
    jcfg = dataclasses.replace(jcfg, d_feature=32, backbone=dataclasses.replace(jcfg.backbone, model="tiny", d_out=64))
    pcfg, _ = pt_config.re10k_ablation_no_epipolar_transformer()
    pcfg = dataclasses.replace(pcfg, d_feature=32, backbone=dataclasses.replace(pcfg.backbone, model="tiny", d_out=64))
    return jcfg, pcfg


def test_from_jax_round_trip():
    jcfg, pcfg = tiny_encoder_cfgs()
    rng = np.random.default_rng(11)
    context = {
        "image": jnp.asarray(rng.uniform(0, 1, (1, 2, 3, 64, 64)).astype(np.float32)),
        "extrinsics": jnp.tile(jnp.eye(4), (1, 2, 1, 1)),
        "intrinsics": jnp.tile(jnp.asarray([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1]]), (1, 2, 1, 1)),
        "near": jnp.ones((1, 2)),
        "far": jnp.full((1, 2), 100.0),
    }
    flax_params = jax.device_get(
        jax.eval_shape(lambda: JxEncoder(jcfg).init(
            {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}, context, jnp.asarray(0), True
        ))["params"]
    )
    # Shapes from Flax, values from numpy: every leaf distinct and nonzero.
    leaves, treedef = jax.tree_util.tree_flatten(flax_params)
    leaves = [rng.normal(size=leaf.shape).astype(np.float32) for leaf in leaves]
    flax_params = jax.tree_util.tree_unflatten(treedef, leaves)

    encoder = from_jax.load_from_jax(PtEncoder(pcfg), flax_params)
    back = torch_import.convert_encoder(encoder.state_dict(), jcfg)
    flat_back = jax.tree_util.tree_flatten_with_path(back)[0]
    flat_want = jax.tree_util.tree_flatten_with_path(flax_params)[0]
    assert [p for p, _ in flat_back] == [p for p, _ in flat_want]
    for (path, a), (_, b) in zip(flat_back, flat_want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(path))

    sd = from_jax.state_dict_from_jax(back, pcfg)
    assert sd.keys() == encoder.state_dict().keys()
    for k, v in encoder.state_dict().items():
        assert torch.equal(sd[k], v), k
