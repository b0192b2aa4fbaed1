"""The slice end to end against the JAX package, on the CPU: data shim ->
`make_eval_encode` (probabilistic, gpp=3, SoA) -> `choose_eval_settings`
-> `make_eval_decode`, on 2 context and 3 target views at 64x64.

The model is `re10k_ablation_no_epipolar_transformer` with the ViT cut to
a tiny spec. Weights are made by numpy from a seed, converted to the Flax
tree by the JAX package's `convert_encoder`, and loaded into the port
through `interop/from_jax.py`. The JAX encoder's sampler is wrapped so
that the uniforms it draws are recorded (by a host callback) and handed
to the port.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelsplat_tpu.interop import torch_import
from pixelsplat_tpu.model.decoder import get_decoder
from pixelsplat_tpu.model.encoder.backbone import dino as jx_dino
from pixelsplat_tpu.ops.rasterizer import binning as jx_binning
from pixelsplat_tpu.ops.rasterizer import projection as jx_projection
from pixelsplat_tpu.training import model_wrapper as jx_wrapper
from pixelsplat_tpu.training.optimizer import OptimizerCfg
from pixelsplat_tpu_torch.interop import from_jax
from pixelsplat_tpu_torch.model.encoder.backbone import dino as pt_dino
from pixelsplat_tpu_torch.model.encoder.encoder_epipolar import EncoderEpipolar as PtEncoder
from pixelsplat_tpu_torch.ops.rasterizer import binning as pt_binning
from pixelsplat_tpu_torch.ops.rasterizer import projection as pt_projection
from pixelsplat_tpu_torch.training.model_wrapper import ModelWrapper as PtWrapper
from pixelsplat_tpu_torch.training.model_wrapper import batch_to

import test_torch_encoder as enc_helpers

jx_depth_module = importlib.import_module(
    "pixelsplat_tpu.model.encoder.epipolar.depth_predictor_monocular"
)

H = W = 64


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: next to the other test processes, more threads
    only contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def make_batch(seed=0):
    rng = np.random.default_rng(seed)
    k = np.array([[0.9, 0, 0.5], [0, 0.9, 0.5], [0, 0, 1]], np.float32)
    c_extr = np.tile(np.eye(4, dtype=np.float32), (1, 2, 1, 1))
    c_extr[0, 1, 0, 3] = 0.8
    t_extr = np.tile(np.eye(4, dtype=np.float32), (1, 3, 1, 1))
    t_extr[0, :, 0, 3] = [-0.3, 0.2, 0.6]
    t_extr[0, :, 2, 3] = [0.0, -0.1, 0.1]

    def views(v, extr):
        return {
            "image": rng.uniform(0, 1, (1, v, 3, H, W)).astype(np.float32),
            "extrinsics": extr,
            "intrinsics": np.tile(k, (1, v, 1, 1)),
            "near": np.ones((1, v), np.float32),
            "far": np.full((1, v), 100.0, np.float32),
        }

    return {"context": views(2, c_extr), "target": views(3, t_extr)}


@pytest.fixture(scope="module")
def models():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jx_dino.VIT_SPECS, "tiny", enc_helpers.TINY)
        mp.setitem(pt_dino.VIT_SPECS, "tiny", enc_helpers.TINY)
        jcfg, pcfg = enc_helpers.tiny_encoder_cfgs()
        from pixelsplat_tpu.config import load_config
        from pixelsplat_tpu_torch import config as pt_config

        jdec_cfg = load_config(["+experiment=re10k_ablation_no_epipolar_transformer"]).model.decoder
        _, pdec_cfg = pt_config.re10k_ablation_no_epipolar_transformer()
        # Weights: numpy-seeded on a port encoder, as the Flax tree.
        source = enc_helpers.randomize(PtEncoder(pcfg), seed=21)
        flax_params = torch_import.convert_encoder(source.state_dict(), jcfg)
        jw = jx_wrapper.ModelWrapper(
            OptimizerCfg(), jx_wrapper.TrainCfg(), jx_wrapper.TestCfg(), jcfg, get_decoder(jdec_cfg), []
        )
        pw = PtWrapper(pcfg, pdec_cfg, device="cpu")
        from_jax.load_from_jax(pw.encoder, flax_params)
        yield jw, {"params": flax_params}, pw


def jax_encode(jw, params, batch, deterministic, pack_soa, monkeypatch):
    """The JAX package's `make_eval_encode`, with its sampler wrapped so a
    host callback records the uniforms it draws."""
    recorded = []
    original = jx_depth_module.sample_discrete_distribution

    def recording(key, pdf, num_samples):
        u = jax.random.uniform(key, (*pdf.shape[:-1], num_samples), dtype=pdf.dtype)
        jax.debug.callback(lambda x: recorded.append(np.array(x)), u)
        return original(key, pdf, num_samples)

    monkeypatch.setattr(jx_depth_module, "sample_discrete_distribution", recording)
    g = jw.make_eval_encode(pack_soa=pack_soa)(params, batch, deterministic, 0, jax.random.PRNGKey(5))
    jax.block_until_ready(g)
    assert len(recorded) == (0 if deterministic else 1)
    return g, (recorded[0] if recorded else None)


def jax_render(jw, g, batch):
    shimmed = jw.data_shim(batch)
    tgt = shimmed["target"]
    settings = jw.choose_eval_settings(g, tgt["extrinsics"], tgt["intrinsics"], tgt["near"], (H, W))
    color, overflow = jw.make_eval_decode()(
        g, tgt["extrinsics"], tgt["intrinsics"], tgt["near"], tgt["far"], (H, W), settings
    )
    return settings, np.asarray(color), int(overflow)


def view_lists(proj_module, bin_module, xp, soa, extr, intr, near, settings):
    """One target view's tile lists (flat, block_start, counts) and depths,
    as render_view_soa builds them (1/near world rescale, project, bin)."""
    scale = 1.0 / near
    extr = xp.concatenate([extr[:3, :3], extr[:3, 3:] * scale], axis=1)
    extr = xp.concatenate([extr, xp.asarray([[0.0, 0.0, 0.0, 1.0]])], axis=0)
    soa = soa._replace(
        mean_x=soa.mean_x * scale, mean_y=soa.mean_y * scale, mean_z=soa.mean_z * scale,
        cov=soa.cov * scale**2,
    )
    proj = proj_module.project_gaussians_soa(extr, intr, (H, W), soa)
    tiles = bin_module.bin_gaussians(
        proj, (H, W), tile_size=settings.tile_size, capacity=settings.capacity,
        span=settings.span, big_capacity=settings.big_capacity, chunk=settings.chunk,
        pair_budget=settings.pair_budget,
    )
    return tiles.flat, tiles.block_start, tiles.counts, proj.depth


jx_view_lists = jax.jit(
    lambda soa, extr, intr, near, settings: view_lists(
        jx_projection, jx_binning, jnp, soa, extr, intr, near, settings
    ),
    static_argnums=4,
)


class _TorchNp:
    """The two numpy-namespace calls view_lists makes, for torch tensors."""

    @staticmethod
    def concatenate(xs, axis):
        return torch.cat(xs, dim=axis)

    @staticmethod
    def asarray(x):
        return torch.tensor(x)


def split_lists(flat, block_start, counts, depth, chunk):
    flat = np.asarray(flat)
    lists = [flat[s * chunk : s * chunk + n] for s, n in zip(np.asarray(block_start), np.asarray(counts))]
    return lists, np.maximum(np.asarray(depth), 0).view(np.int32)


def tie_reordered_tiles(jx_soa, pt_soa, batch_j, batch_p, settings):
    """Per target view, the tiles whose lists differ between the two sides
    only by the order of Gaussians whose depth keys tie (binning.py's
    2^-n relative depth quantization; either side's sort may break such
    ties in any order). Any other list difference fails the test."""
    depth_bits = 31 - (H // 16 * (W // 16) + 1).bit_length()
    out = []
    for v in range(3):
        cams_j = [jnp.asarray(batch_j["target"][k][0, v]) for k in ("extrinsics", "intrinsics", "near")]
        cams_p = [batch_p["target"][k][0, v] for k in ("extrinsics", "intrinsics", "near")]
        lists_j, depth_j = split_lists(*jx_view_lists(jx_soa, *cams_j, settings), settings.chunk)
        lists_p, depth_p = split_lists(
            *view_lists(pt_projection, pt_binning, _TorchNp, pt_soa, *cams_p, settings), settings.chunk
        )
        reordered = set()
        for tile, (a, b) in enumerate(zip(lists_j, lists_p)):
            if np.array_equal(a, b):
                continue
            assert sorted(a) == sorted(b), f"view {v} tile {tile}: different Gaussians"
            differ = a != b
            key_j = depth_j[a] >> (31 - depth_bits)
            key_p = depth_p[b] >> (31 - depth_bits)
            tied = np.zeros_like(differ)
            for key in (key_j, key_p):
                run = np.diff(key) == 0
                tied[1:] |= run
                tied[:-1] |= run
            assert tied[differ].all(), f"view {v} tile {tile}: reordered beyond key ties"
            reordered.add(tile)
        out.append(reordered)
    return out


def shimmed(jw, pw, batch):
    return jw.data_shim(batch), pw.data_shim(batch_to(batch, pw.device))


def port_render(pw, g, batch):
    tgt = pw.data_shim(batch_to(batch, pw.device))["target"]
    settings = pw.choose_eval_settings(g, tgt["extrinsics"], tgt["intrinsics"], tgt["near"], (H, W))
    color, overflow = pw.make_eval_decode()(
        g, tgt["extrinsics"], tgt["intrinsics"], tgt["near"], tgt["far"], (H, W), settings
    )
    return settings, color.numpy(), int(overflow)


def assert_images_close(got, want, excused):
    """Images equal to 5e-4 x the largest colour: the Gaussians agree to
    ~1e-6 relative (f32 sums in another order through the backbone), and
    JAX on the CPU composites every chunk while the port stops a tile at
    T < 1e-4, worth up to 1e-4 x the largest colour.

    Tiles whose lists differ only in the order of depth-key ties
    (`excused`, per view) composite those Gaussians in another order. Most
    such ties are harmless (gpp=3 samples that land in one depth bucket
    are identical Gaussians), so there too at most 0.1 % of all pixels may
    exceed 5e-4, and none 0.1."""
    scale = max(1.0, float(np.abs(want).max()))
    n_loose = 0
    for v, tiles in enumerate(excused):
        mask = np.zeros((H // 16, W // 16), bool)
        for tile in tiles:
            mask[tile // (W // 16), tile % (W // 16)] = True
        mask = np.kron(mask, np.ones((16, 16), bool))
        diff = np.abs(got[0, v] - want[0, v])  # (3, H, W)
        assert diff[:, ~mask].max(initial=0) <= 5e-4 * scale, f"view {v}"
        assert diff[:, mask].max(initial=0) <= 0.1 * scale, f"view {v}, reordered tiles"
        n_loose += int((diff[:, mask] > 5e-4 * scale).sum())
    assert n_loose <= 1e-3 * want.size, f"{n_loose} of {want.size} values differ by more than 5e-4"


def test_data_shim_crops_and_bounds(models):
    """Patch shim (centre crop to a multiple of 16, intrinsics rescaled)
    and bounds shim (near/far from the widest baseline)."""
    jw, _, pw = models
    batch = make_batch(2)
    for views in batch.values():
        views["image"] = np.pad(views["image"], ((0, 0), (0, 0), (0, 0), (4, 4), (6, 20)))  # 72 x 90
    want = jw.data_shim(batch)
    got = pw.data_shim(batch_to(batch, pw.device))
    for side in ("context", "target"):
        assert got[side]["image"].shape[-2:] == (64, 80)
        for key in ("image", "intrinsics", "near", "far"):
            np.testing.assert_allclose(
                got[side][key].numpy(), np.asarray(want[side][key]), rtol=1e-6, err_msg=f"{side} {key}"
            )


def test_eval_scene_probabilistic_soa(models, monkeypatch):
    jw, params, pw = models
    batch = make_batch(0)
    g_j, u = jax_encode(jw, params, batch, False, True, monkeypatch)
    assert u.shape == (1, 2, H * W, 1, 3)
    g_p = pw.make_eval_encode(pack_soa=True)(batch, False, 0, u=torch.as_tensor(np.array(u)))

    assert g_p.mean_x.shape == (1, 2 * H * W * 3)
    for name in ("mean_x", "mean_y", "mean_z", "cov", "opacity", "harmonics"):
        enc_helpers.close(getattr(g_p, name), getattr(g_j, name), 2e-5, name)

    s_j, img_j, ovf_j = jax_render(jw, g_j, batch)
    s_p, img_p, ovf_p = port_render(pw, g_p, batch)
    assert dataclasses.asdict(s_p) == dataclasses.asdict(s_j)
    assert ovf_p == ovf_j == 0
    assert img_p.shape == (1, 3, 3, H, W)
    soa_j = jx_projection.GaussiansSoA(*(None if x is None else x[0] for x in g_j))
    soa_p = pt_projection.GaussiansSoA(*(None if x is None else x[0] for x in g_p))
    excused = tie_reordered_tiles(soa_j, soa_p, *shimmed(jw, pw, batch), s_p)
    assert_images_close(img_p, img_j, excused)


def test_eval_scene_deterministic_aos(models, monkeypatch):
    jw, params, pw = models
    batch = make_batch(1)
    g_j, _ = jax_encode(jw, params, batch, True, False, monkeypatch)
    g_p = pw.make_eval_encode(pack_soa=False)(batch, True, 0)
    assert g_p.means.shape == (1, 2 * H * W, 3)
    for name in g_j._fields:
        enc_helpers.close(getattr(g_p, name), getattr(g_j, name), 2e-5, name)

    s_j, img_j, ovf_j = jax_render(jw, g_j, batch)
    s_p, img_p, ovf_p = port_render(pw, g_p, batch)
    assert dataclasses.asdict(s_p) == dataclasses.asdict(s_j)
    assert ovf_p == ovf_j == 0
    soa_j = jx_projection.pack_gaussians_soa(
        g_j.means[0], g_j.covariances[0], g_j.opacities[0], harmonics=g_j.harmonics[0]
    )
    soa_p = pt_projection.pack_gaussians_soa(
        g_p.means[0], g_p.covariances[0], g_p.opacities[0], harmonics=g_p.harmonics[0]
    )
    excused = tie_reordered_tiles(soa_j, soa_p, *shimmed(jw, pw, batch), s_p)
    assert_images_close(img_p, img_j, excused)
