"""The evaluation scenes of two shipped experiments beyond `re10k` against
the JAX package, on the CPU: data shim -> `make_eval_encode`
(probabilistic, SoA) -> `choose_eval_settings` -> `make_eval_decode`, on 3
target views at 64x64.

- `re10k_3_view`: three context views, so the epipolar transformer carries
  view embeddings, dealt in the order the JAX encoder shuffles them
  (recorded and handed to the port as `view_order`);
- `re10k_ablation_no_probabilistic_sampling`: one Gaussian per pixel with
  transmittance opacities;
- `re10k_ablation_no_depth_encoding`: no depth encoding in the epipolar
  transformer's kv. (`acid` is `re10k`'s model: `test_torch_re10k.py`.)

Each is its preset (`pixelsplat_tpu_torch.config`) and the JAX loader's
composition of its yaml file, cut to the size of `test_torch_re10k.py`
(slim backbones, the small epipolar transformer). The images are held with
`test_torch_re10k.py`'s excuses: tiles whose lists differ by tied depth
keys, and (Gaussian, pixel) pairs at the 1/255 alpha threshold.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from pixelsplat_tpu.config import load_config
from pixelsplat_tpu.interop import torch_import
from pixelsplat_tpu.model.decoder import get_decoder
from pixelsplat_tpu.ops.rasterizer import projection as jx_projection
from pixelsplat_tpu.training import model_wrapper as jx_wrapper
from pixelsplat_tpu.training.optimizer import OptimizerCfg as JxOptimizerCfg
from pixelsplat_tpu_torch import config as pt_config
from pixelsplat_tpu_torch.interop import from_jax
from pixelsplat_tpu_torch.model.encoder.encoder_epipolar import EncoderEpipolar as PtEncoder
from pixelsplat_tpu_torch.ops.rasterizer import projection as pt_projection
from pixelsplat_tpu_torch.training.model_wrapper import ModelWrapper as PtWrapper

import test_torch_encoder as enc_helpers
import test_torch_re10k as re10k_helpers
import test_torch_slice as slice_helpers
from test_torch_re10k import small_backbones  # noqa: F401  (an autouse fixture)

H = W = slice_helpers.H
THREE_VIEW, SINGLE = "re10k_3_view", "re10k_ablation_no_probabilistic_sampling"
NO_DEPTH_ENCODING = "re10k_ablation_no_depth_encoding"
PRESETS = {
    THREE_VIEW: pt_config.re10k_3_view,
    SINGLE: pt_config.re10k_ablation_no_probabilistic_sampling,
    NO_DEPTH_ENCODING: pt_config.re10k_ablation_no_depth_encoding,
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: next to the other test processes, more threads
    only contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def experiment_cfgs(experiment):
    """(JAX encoder cfg, port encoder cfg, JAX decoder cfg, port decoder cfg)
    of the experiment, cut to the test's size (a depth encoding of at most
    the small transformer's octaves: none stays none)."""
    jmodel = load_config([f"+experiment={experiment}"]).model
    pcfg, pdec = PRESETS[experiment]()
    views = jmodel.encoder.num_context_views
    assert pcfg.num_context_views == views

    def cut(cfg):
        et = cfg.epipolar_transformer
        octaves = min(et.num_octaves, re10k_helpers.SMALL_TRANSFORMER["num_octaves"])
        small = re10k_helpers.small(cfg, views)
        return dataclasses.replace(small, epipolar_transformer=dataclasses.replace(
            small.epipolar_transformer, num_octaves=octaves))

    return cut(jmodel.encoder), cut(pcfg), jmodel.decoder, pdec


def with_context_views(batch, views, seed):
    """`batch` with `views` context views along x (0, 0.4, 0.8 for three:
    the evaluation sampler puts the midpoint second)."""
    if views == 2:
        return batch
    rng = np.random.default_rng(seed)
    c = batch["context"]
    b = c["image"].shape[0]
    extr = np.tile(np.eye(4, dtype=np.float32), (b, views, 1, 1))
    extr[:, :, 0, 3] = np.linspace(0.0, 0.8, views)
    batch = dict(batch)
    batch["context"] = {
        "image": rng.uniform(0, 1, (b, views, 3, H, W)).astype(np.float32),
        "extrinsics": extr,
        "intrinsics": np.tile(c["intrinsics"][:, :1], (1, views, 1, 1)),
        "near": np.ones((b, views), np.float32),
        "far": np.full((b, views), 100.0, np.float32),
    }
    return batch


def record_view_orders(monkeypatch):
    """Record every view-embedding order the JAX encoder draws (a host
    callback on `jax.random.permutation`)."""
    orders = []
    original = jax.random.permutation

    def recording(key, x, *args, **kwargs):
        out = original(key, x, *args, **kwargs)
        jax.debug.callback(lambda o: orders.append(np.array(o)), out)
        return out

    monkeypatch.setattr(jax.random, "permutation", recording)
    return orders


@pytest.fixture(scope="module", params=[THREE_VIEW, SINGLE, NO_DEPTH_ENCODING])
def models(request):
    with pytest.MonkeyPatch.context() as mp:
        re10k_helpers.shrink_backbones(mp)
        jcfg, pcfg, jdec, pdec = experiment_cfgs(request.param)
        source = enc_helpers.randomize(PtEncoder(pcfg), seed=90)
        flax_params = torch_import.convert_encoder(source.state_dict(), jcfg)
        jw = jx_wrapper.ModelWrapper(
            JxOptimizerCfg(), jx_wrapper.TrainCfg(), jx_wrapper.TestCfg(), jcfg, get_decoder(jdec), []
        )
        pw = PtWrapper(pcfg, pdec, device="cpu")
        from_jax.load_from_jax(pw.encoder, flax_params)
        yield request.param, jw, {"params": flax_params}, pw


def test_experiment_eval_scene_probabilistic_soa(models, monkeypatch):
    """The experiment's Gaussians (count v x h x w x gpp), settings and
    images against the JAX package's, with its uniforms and view order."""
    experiment, jw, params, pw = models
    cfg = pw.encoder_cfg
    views, gpp = cfg.num_context_views, cfg.gaussians_per_pixel
    batch = with_context_views(slice_helpers.make_batch(0), views, seed=91)
    orders = record_view_orders(monkeypatch)
    g_j, u = slice_helpers.jax_encode(jw, params, batch, False, True, monkeypatch)
    assert u.shape == (1, views, H * W, 1, gpp)
    if views > 2:
        assert len(orders) == 1 and sorted(orders[0]) == list(range(views - 1))
        view_order = torch.as_tensor(orders[0])
        assert "epipolar_transformer.view_embeddings.weight" in pw.encoder.state_dict()
    else:
        assert not orders
        view_order = None
    g_p = pw.make_eval_encode(pack_soa=True)(batch, False, 0, u=torch.as_tensor(np.array(u)), view_order=view_order)
    assert g_p.mean_x.shape == (1, views * H * W * gpp)
    for name in ("mean_x", "mean_y", "mean_z", "cov", "opacity", "harmonics"):
        enc_helpers.close(getattr(g_p, name), getattr(g_j, name), re10k_helpers.GAUSSIAN_RTOL, name)

    s_j, img_j, ovf_j = slice_helpers.jax_render(jw, g_j, batch)
    s_p, img_p, ovf_p = slice_helpers.port_render(pw, g_p, batch)
    assert dataclasses.asdict(s_p) == dataclasses.asdict(s_j)
    assert ovf_p == ovf_j == 0 and img_p.shape == (1, 3, 3, H, W)
    soa_j = jx_projection.GaussiansSoA(*(None if x is None else x[0] for x in g_j))
    soa_p = pt_projection.GaussiansSoA(*(None if x is None else x[0] for x in g_p))
    excused = slice_helpers.tie_reordered_tiles(soa_j, soa_p, *slice_helpers.shimmed(jw, pw, batch), s_p)
    re10k_helpers.assert_images_close(img_p, img_j, excused)

    if experiment == NO_DEPTH_ENCODING:
        assert cfg.epipolar_transformer.num_octaves == 0
        assert not any(k.startswith("epipolar_transformer.depth_encoding") for k in pw.encoder.state_dict())
    elif views > 2:
        # The other order gives other Gaussians: the embeddings are read.
        with torch.no_grad():
            other = pw.make_eval_encode(pack_soa=True)(
                batch, False, 0, u=torch.as_tensor(np.array(u)), view_order=view_order.flip(0)
            )
        assert float((other.mean_z - g_p.mean_z).abs().max()) > 1e-4
    else:
        # Transmittance opacities: not the densities of the sampled buckets.
        plain = PtWrapper(dataclasses.replace(cfg, use_transmittance=False), pw.decoder.cfg, device="cpu")
        plain.encoder.load_state_dict(pw.encoder.state_dict())
        densities = plain.make_eval_encode(pack_soa=True)(batch, False, 0, u=torch.as_tensor(np.array(u)))
        assert bool((g_p.opacity >= densities.opacity - 1e-7).all())
        assert float((g_p.opacity - densities.opacity).abs().max()) > 1e-3
