"""The production `re10k` model (with the epipolar transformer) as a whole
against the JAX package, on the CPU: weight interop, the encoder's
Gaussians and the evaluation scene (`test_torch_re10k_train.py` has the
training step).

The model is `config/experiment/re10k.yaml` cut to a small size: the ViT at
the tiny spec of `test_torch_encoder.py`, the ResNet-50 trunk at one block
per stage (its full depth is held by `test_torch_slice.py` and
`test_torch_train_step.py`), d_feature 32, and an epipolar
transformer of 1 cross-attention layer (2 heads x 16, 4 samples per line,
4 octaves, downscale 4) whose feed-forward is a 1-layer image
self-attention (patch 4, 2 heads x 16), on 2 context views at 64x64.
Weights are made by numpy from a seed, converted to the Flax tree by the
JAX package's `convert_encoder`, and loaded into the port through
`interop/from_jax.py`; the JAX sampler's uniforms are recorded and handed
to the port. On the CPU the JAX package composites with its XLA scan and
the port with the plain versions of its CUDA kernels.
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
from pixelsplat_tpu.model.encoder.backbone import dino as jx_dino
from pixelsplat_tpu.model.encoder.backbone import resnet as jx_resnet
from pixelsplat_tpu.model.encoder.encoder_epipolar import EncoderEpipolar as JxEncoder
from pixelsplat_tpu.ops.rasterizer import projection as jx_projection
from pixelsplat_tpu.training import model_wrapper as jx_wrapper
from pixelsplat_tpu.training.optimizer import OptimizerCfg as JxOptimizerCfg
from pixelsplat_tpu_torch import config as pt_config
from pixelsplat_tpu_torch.interop import from_jax
from pixelsplat_tpu_torch.model.encoder.backbone import dino as pt_dino
from pixelsplat_tpu_torch.model.encoder.backbone import resnet as pt_resnet
from pixelsplat_tpu_torch.model.encoder.encoder_epipolar import EncoderEpipolar as PtEncoder
from pixelsplat_tpu_torch.ops.rasterizer import projection as pt_projection
from pixelsplat_tpu_torch.training.model_wrapper import ModelWrapper as PtWrapper

import test_torch_encoder as enc_helpers
import test_torch_slice as slice_helpers

H = W = slice_helpers.H
SMALL_TRANSFORMER = dict(num_octaves=4, num_layers=1, num_heads=2, num_samples=4, d_dot=16, d_mlp=32, downscale=4)
SMALL_SELF_ATTENTION = dict(patch_size=4, num_octaves=4, num_layers=1, num_heads=2, d_token=32, d_dot=16, d_mlp=32)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: next to the other test processes, more threads
    only contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def small(cfg, num_context_views=2):
    """An encoder config (of either package) cut to the test's size."""
    et = cfg.epipolar_transformer
    et = dataclasses.replace(
        et, self_attention=dataclasses.replace(et.self_attention, **SMALL_SELF_ATTENTION), **SMALL_TRANSFORMER
    )
    return dataclasses.replace(
        cfg, d_feature=32, backbone=dataclasses.replace(cfg.backbone, model="tiny", d_out=64),
        epipolar_transformer=et, num_context_views=num_context_views,
    )


def small_cfgs(num_context_views=2):
    jcfg = load_config(["+experiment=re10k"]).model.encoder
    pcfg, _ = pt_config.re10k()
    assert jcfg.use_epipolar_transformer and pcfg.use_epipolar_transformer
    return small(jcfg, num_context_views), small(pcfg, num_context_views)


SLIM_TRUNK = ("bottleneck", (1, 1, 1, 1))


def shrink_backbones(mp):
    """The tiny ViT spec and a one-block-per-stage `dino_resnet50`, in both
    packages (the weight converters read the same tables)."""
    for dino, resnet in ((jx_dino, jx_resnet), (pt_dino, pt_resnet)):
        mp.setitem(dino.VIT_SPECS, "tiny", enc_helpers.TINY)
        mp.setitem(resnet.RESNET_SPECS, "dino_resnet50", SLIM_TRUNK)


@pytest.fixture(autouse=True)
def small_backbones(monkeypatch):
    shrink_backbones(monkeypatch)


# ---------------------------------------------------------------------------
# Configuration and weight interop


def test_re10k_config_matches_jax_experiment():
    want = load_config(["+experiment=re10k"])
    encoder, decoder = pt_config.re10k()
    assert dataclasses.asdict(encoder) == dataclasses.asdict(want.model.encoder)
    assert dataclasses.asdict(decoder) == dataclasses.asdict(want.model.decoder)
    et = encoder.epipolar_transformer
    assert (et.downscale, et.num_samples, et.num_layers, et.num_heads, et.d_dot, et.num_octaves) == (4, 32, 2, 4, 128, 10)
    assert et.self_attention.num_layers == 2

    got = pt_config.re10k_training()
    assert dataclasses.asdict(got.optimizer) == dataclasses.asdict(want.optimizer)
    assert dataclasses.asdict(got.train) == dataclasses.asdict(want.train)
    assert got.train.remat_encoder is True
    assert [dataclasses.asdict(c) for c in got.loss] == [dataclasses.asdict(c) for c in want.loss]
    assert got.gradient_clip_val == want.trainer.gradient_clip_val == 0.5
    assert got.accumulate_grad_batches == want.trainer.accumulate_grad_batches == 7
    assert set(pt_config.EXPERIMENTS) == {
        "re10k", "re10k_depth_loss", "re10k_ablation_no_epipolar_transformer", "acid", "re10k_3_view",
        "re10k_ablation_no_depth_encoding", "re10k_ablation_no_probabilistic_sampling",
    }
    assert pt_config.EXPERIMENTS["re10k_depth_loss"][0] is pt_config.re10k  # the same model


def test_full_width_re10k_encoder_builds(monkeypatch):
    monkeypatch.setitem(pt_resnet.RESNET_SPECS, "dino_resnet50", ("bottleneck", (3, 4, 6, 3)))
    encoder = PtEncoder(pt_config.re10k()[0])
    assert sum(p.numel() for p in encoder.parameters()) == 104_045_268
    names = [k for k in encoder.state_dict() if k.startswith("epipolar_transformer.")]
    assert len(names) == 82 and "epipolar_transformer.view_embeddings.weight" not in names
    assert encoder.epipolar_transformer.upscale_refinement[0].weight.shape == (256, 128, 7, 7)
    kv = encoder.epipolar_transformer.transformer.layers[1][0].fn.to_kv.weight
    assert kv.shape == (2 * 4 * 128, 128)


@pytest.mark.parametrize("views", [2, 3])
def test_from_jax_round_trip_with_transformer(views):
    """A JAX `re10k` parameter tree (shapes from Flax's own init, distinct
    numpy values in every leaf) loads strictly; `convert_encoder` maps the
    port's state_dict back to the same tree, leaf for leaf."""
    jcfg, pcfg = small_cfgs(views)
    rng = np.random.default_rng(50)
    context = {
        "image": jnp.zeros((1, views, 3, 64, 64)),
        "extrinsics": jnp.tile(jnp.eye(4), (1, views, 1, 1)),
        "intrinsics": jnp.tile(jnp.asarray([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1]]), (1, views, 1, 1)),
        "near": jnp.ones((1, views)),
        "far": jnp.full((1, views), 100.0),
    }
    shapes = jax.eval_shape(lambda: JxEncoder(jcfg).init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}, context, jnp.asarray(0), True
    ))["params"]
    leaves, treedef = jax.tree_util.tree_flatten(shapes)
    flax_params = jax.tree_util.tree_unflatten(
        treedef, [rng.normal(size=leaf.shape).astype(np.float32) for leaf in leaves]
    )
    assert ("view_embeddings" in flax_params["epipolar_transformer"]) is (views > 2)

    encoder = from_jax.load_from_jax(PtEncoder(pcfg), flax_params)  # strict
    back = torch_import.convert_encoder(encoder.state_dict(), jcfg)
    flat_back = jax.tree_util.tree_flatten_with_path(back)[0]
    flat_want = jax.tree_util.tree_flatten_with_path(flax_params)[0]
    assert [p for p, _ in flat_back] == [p for p, _ in flat_want]
    for (path, a), (_, b) in zip(flat_back, flat_want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(path))
    # Linear, so the same mapping carries gradients and Adam moments.
    doubled = from_jax.state_dict_from_jax(jax.tree.map(lambda x: 2 * x, flax_params), pcfg)
    for k, v in encoder.state_dict().items():
        assert torch.equal(doubled[k], 2 * v), k


# ---------------------------------------------------------------------------
# Encoder and evaluation scene


@pytest.fixture(scope="module")
def models():
    with pytest.MonkeyPatch.context() as mp:
        shrink_backbones(mp)
        jcfg, pcfg = small_cfgs()
        jdec_cfg = load_config(["+experiment=re10k"]).model.decoder
        _, pdec_cfg = pt_config.re10k()
        source = enc_helpers.randomize(PtEncoder(pcfg), seed=51)
        flax_params = torch_import.convert_encoder(source.state_dict(), jcfg)
        assert "epipolar_transformer" in flax_params
        jw = jx_wrapper.ModelWrapper(
            JxOptimizerCfg(), jx_wrapper.TrainCfg(), jx_wrapper.TestCfg(), jcfg, get_decoder(jdec_cfg), []
        )
        pw = PtWrapper(pcfg, pdec_cfg, device="cpu")
        from_jax.load_from_jax(pw.encoder, flax_params)
        yield jw, {"params": flax_params}, pw


# Gaussians, per field relative to its largest entry: the backbone's 2e-5
# (test_torch_slice.py) and as much again for the epipolar transformer
# (measured ~1e-5 at this size).
GAUSSIAN_RTOL = 5e-5


def assert_images_close(got, want, excused):
    """`test_torch_slice.assert_images_close`, with one more excuse. Outside
    the tiles whose lists differ by tied depth keys, every value agrees to
    5e-4 x the largest colour except at most 0.01 % of them, which may
    differ by up to 1/255 of it more: with Gaussians that agree to 1e-5,
    one (Gaussian, pixel) pair in a few million has its alpha within that
    of the 1/255 cut-off and is composited on one side only (two values at
    2e-3 and 1.3e-3 were seen in 36,864)."""
    scale = max(1.0, float(np.abs(want).max()))
    clean = want.copy()
    n_threshold = 0
    for v, tiles in enumerate(excused):
        mask = np.zeros((H // 16, W // 16), bool)
        for tile in tiles:
            mask[tile // (W // 16), tile % (W // 16)] = True
        mask = np.kron(mask, np.ones((16, 16), bool))
        diff = np.abs(got[0, v] - want[0, v])
        at_threshold = (diff > 5e-4 * scale) & ~mask[None]
        assert diff[at_threshold].max(initial=0) <= (5e-4 + 1 / 255) * scale, f"view {v}"
        n_threshold += int(at_threshold.sum())
        clean[0, v][at_threshold] = got[0, v][at_threshold]
    assert n_threshold <= 1e-4 * want.size, f"{n_threshold} values beyond 5e-4"
    slice_helpers.assert_images_close(got, clean, excused)


def test_re10k_eval_scene_probabilistic_soa(models, monkeypatch):
    jw, params, pw = models
    batch = slice_helpers.make_batch(0)
    g_j, u = slice_helpers.jax_encode(jw, params, batch, False, True, monkeypatch)
    assert u.shape == (1, 2, H * W, 1, 3)
    g_p = pw.make_eval_encode(pack_soa=True)(batch, False, 0, u=torch.as_tensor(np.array(u)))
    assert g_p.mean_x.shape == (1, 2 * H * W * 3)
    for name in ("mean_x", "mean_y", "mean_z", "cov", "opacity", "harmonics"):
        enc_helpers.close(getattr(g_p, name), getattr(g_j, name), GAUSSIAN_RTOL, name)

    s_j, img_j, ovf_j = slice_helpers.jax_render(jw, g_j, batch)
    s_p, img_p, ovf_p = slice_helpers.port_render(pw, g_p, batch)
    assert dataclasses.asdict(s_p) == dataclasses.asdict(s_j)
    assert ovf_p == ovf_j == 0 and img_p.shape == (1, 3, 3, H, W)
    soa_j = jx_projection.GaussiansSoA(*(None if x is None else x[0] for x in g_j))
    soa_p = pt_projection.GaussiansSoA(*(None if x is None else x[0] for x in g_p))
    excused = slice_helpers.tie_reordered_tiles(soa_j, soa_p, *slice_helpers.shimmed(jw, pw, batch), s_p)
    assert_images_close(img_p, img_j, excused)


def test_re10k_eval_scene_deterministic_aos(models, monkeypatch):
    jw, params, pw = models
    batch = slice_helpers.make_batch(1)
    g_j, _ = slice_helpers.jax_encode(jw, params, batch, True, False, monkeypatch)
    dump = {}
    with torch.no_grad():
        shimmed = pw.data_shim(slice_helpers.batch_to(batch, pw.device))
        g_p = pw.encoder(shimmed["context"], 0, True, visualization_dump=dump)
    assert g_p.means.shape == (1, 2 * H * W, 3)
    for name in g_j._fields:
        enc_helpers.close(getattr(g_p, name), getattr(g_j, name), GAUSSIAN_RTOL, name)
    # The sampling goes into the visualization dump, whole.
    assert dump["sampling"].features.shape == (1, 2, 1, 16 * 16, 4, 32)
    assert dump["depth"].shape == (1, 2, H, W, 1, 1) and dump["scales"].shape == (1, 2 * H * W, 3)

    s_j, img_j, ovf_j = slice_helpers.jax_render(jw, g_j, batch)
    s_p, img_p, ovf_p = slice_helpers.port_render(pw, g_p, batch)
    assert dataclasses.asdict(s_p) == dataclasses.asdict(s_j) and ovf_p == ovf_j == 0
    soa_j = jx_projection.pack_gaussians_soa(
        g_j.means[0], g_j.covariances[0], g_j.opacities[0], harmonics=g_j.harmonics[0]
    )
    soa_p = pt_projection.pack_gaussians_soa(
        g_p.means[0], g_p.covariances[0], g_p.opacities[0], harmonics=g_p.harmonics[0]
    )
    excused = slice_helpers.tie_reordered_tiles(soa_j, soa_p, *slice_helpers.shimmed(jw, pw, batch), s_p)
    assert_images_close(img_p, img_j, excused)


def test_transformer_changes_the_gaussians(models):
    """The same weights with `use_epipolar_transformer=False` give other
    Gaussians: the encoder really goes through the transformer."""
    _, _, pw = models
    batch = slice_helpers.make_batch(2)
    with torch.no_grad():
        context = pw.data_shim(slice_helpers.batch_to(batch, pw.device))["context"]
        with_t = pw.encoder(context, 0, True)
        ablation = PtEncoder(dataclasses.replace(pw.encoder_cfg, use_epipolar_transformer=False))
        ablation.load_state_dict(
            {k: v for k, v in pw.encoder.state_dict().items() if not k.startswith("epipolar_transformer.")}
        )
        without = ablation.eval()(context, 0, True)
    assert float((with_t.means - without.means).abs().max()) > 1e-2
