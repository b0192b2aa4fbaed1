"""The depth and orthographic renderers, `render_adaptive`,
`sample_training_rays`, the decoder's `depth_mode` and one
`re10k_depth_loss` training step, against the JAX package on the CPU.

The scenes are those of `tests/test_rasterizer.py` and
`tests/test_adaptive_render.py`, made with numpy from a seed and handed to
both sides. On the CPU the JAX package composites with its XLA scan, which
runs every chunk, and the port with the plain versions of its CUDA kernels,
which stop a tile once every pixel's transmittance is below 1e-4: a
rendered value may differ by 1e-4 times the largest value composited, plus
f32 rounding, so each render is held to `RENDER_ATOL` times the larger of 1
and that value (`test_torch_rasterizer.py`).
"""

import importlib
from functools import partial
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelsplat_tpu.config import load_config
from pixelsplat_tpu.geometry import projection as jx_geometry
from pixelsplat_tpu.interop import torch_import
from pixelsplat_tpu.loss import LossDepth as JxLossDepth
from pixelsplat_tpu.loss import LossDepthCfg as JxLossDepthCfg
from pixelsplat_tpu.loss import LossMse as JxLossMse
from pixelsplat_tpu.loss import LossMseCfg as JxLossMseCfg
from pixelsplat_tpu.model.decoder import get_decoder
from pixelsplat_tpu.model.decoder.decoder_splatting import DecoderSplatting as JxDecoder
from pixelsplat_tpu.model.decoder.decoder_splatting import DecoderSplattingCfg as JxDecoderCfg
from pixelsplat_tpu.model.types import Gaussians as JxGaussians
from pixelsplat_tpu.ops.rasterizer import adaptive as jx_adaptive
from pixelsplat_tpu.training import model_wrapper as jx_wrapper
from pixelsplat_tpu.training.optimizer import OptimizerCfg as JxOptimizerCfg
from pixelsplat_tpu_torch import config as pt_config
from pixelsplat_tpu_torch.geometry import projection as pt_geometry
from pixelsplat_tpu_torch.interop import from_jax
from pixelsplat_tpu_torch.loss import LossDepthCfg, LossMseCfg
from pixelsplat_tpu_torch.model.decoder.decoder_splatting import DecoderSplatting as PtDecoder
from pixelsplat_tpu_torch.model.decoder.decoder_splatting import DecoderSplattingCfg as PtDecoderCfg
from pixelsplat_tpu_torch.model.encoder.encoder_epipolar import EncoderEpipolar as PtEncoder
from pixelsplat_tpu_torch.model.types import Gaussians as PtGaussians
from pixelsplat_tpu_torch.ops.rasterizer import adaptive as pt_adaptive
from pixelsplat_tpu_torch.ops.rasterizer import composite_kernel
from pixelsplat_tpu_torch.ops.rasterizer.projection import pack_gaussians_soa
from pixelsplat_tpu_torch.training.model_wrapper import ModelWrapper as PtWrapper
from pixelsplat_tpu_torch.training.model_wrapper import TrainCfg
from pixelsplat_tpu_torch.training.optimizer import OptimizerCfg

import test_torch_encoder as enc_helpers
import test_torch_train_step as train_helpers
from test_torch_rasterizer import IMAGE, K, RENDER_ATOL, make_scene
from test_torch_re10k import shrink_backbones, small_cfgs

jx_render = importlib.import_module("pixelsplat_tpu.ops.rasterizer.render")
pt_render = importlib.import_module("pixelsplat_tpu_torch.ops.rasterizer.render")

MODES = ["depth", "disparity", "relative_disparity", "log"]


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


def jitted(fn, *args, **static):
    """`fn` on the arrays `args` under `jax.jit`, the keywords static: one
    compile in place of the many small ones of an eager call."""
    return np.asarray(jax.jit(partial(fn, **static))(*(jnp.asarray(a) for a in args)))


def assert_render_close(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=RENDER_ATOL * max(1.0, float(np.abs(want).max())))


def depth_scene(seed=8, g=100, extr=None, near=1.0):
    means, covs, _, opac = make_scene(seed, g=g)
    extr = np.eye(4, dtype=np.float32) if extr is None else extr
    return (
        extr[None], K[None], np.full(1, near, np.float32), np.full(1, 100.0, np.float32), IMAGE,
        means[None], covs[None], opac[None],
    )


@pytest.mark.parametrize("mode", MODES)
def test_render_depth_matches_jax(mode):
    """The four modes on `test_rasterizer.py::test_render_depth_modes`'s
    scene, and on a moved camera with near 0.5."""
    moved = np.eye(4, dtype=np.float32)
    moved[:3, 3] = [0.2, -0.1, -0.5]
    for args in (depth_scene(), depth_scene(seed=9, g=300, extr=moved, near=0.5)):
        arrays = args[:4] + args[5:]
        want = jitted(
            lambda e, k, n, f, m, c, o, **kw: jx_render.render_depth(e, k, n, f, IMAGE, m, c, o, **kw),
            *arrays, mode=mode, settings=jx_render.RenderSettings(capacity=256),
        )
        got = pt_render.render_depth(
            *(t(a) for a in args[:4]), IMAGE, *(t(a) for a in args[5:]), mode=mode,
            settings=pt_render.RenderSettings(capacity=256),
        ).numpy()
        assert got.shape == want.shape == (1, *IMAGE)
        assert np.isfinite(got).all()
        covered = want != 0
        assert covered.mean() > 0.3  # the scene covers the view, so every mode has values to compare
        assert_render_close(got, want)
    if mode == "depth":
        assert float(got.max()) <= 8.5  # within the scene's z range, as the JAX test asserts


def test_depth_to_relative_disparity_matches_jax():
    rng = np.random.default_rng(3)
    depth = rng.uniform(0.5, 50.0, (2, 40)).astype(np.float32)
    near = rng.uniform(0.1, 1.0, (2, 1)).astype(np.float32)
    far = rng.uniform(60.0, 200.0, (2, 1)).astype(np.float32)
    want = jitted(jx_render.depth_to_relative_disparity, depth, near, far)
    got = pt_render.depth_to_relative_disparity(t(depth), t(near), t(far)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(pt_render.depth_to_relative_disparity(t(near), t(near), t(far)).numpy(), 0, atol=1e-5)
    np.testing.assert_allclose(pt_render.depth_to_relative_disparity(t(far), t(near), t(far)).numpy(), 1, atol=1e-5)


def ortho_args(seed=4):
    rng = np.random.default_rng(seed)
    b = 2
    extr = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    extr[1, :3, 3] = [0.3, -0.2, -0.4]
    width = rng.uniform(2.0, 3.0, b).astype(np.float32)
    height = rng.uniform(1.5, 2.5, b).astype(np.float32)
    near = np.full(b, 0.5, np.float32)
    far = np.full(b, 100.0, np.float32)
    return extr, width, height, near, far


def test_orthographic_frustum_matches_jax():
    args = ortho_args()
    want = jax.jit(partial(jx_render.orthographic_frustum, fov_degrees=0.1))(*(jnp.asarray(a) for a in args))
    got = [x.numpy() for x in pt_render.orthographic_frustum(*(t(a) for a in args), fov_degrees=0.1)]
    for name, g, w in zip(("extrinsics", "intrinsics", "near", "far"), got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6, atol=1e-6, err_msg=name)
    # A camera pushed back along its own axis by the same amount as near.
    assert np.allclose(got[0][:, :3, :3], np.tile(np.eye(3), (2, 1, 1)))
    np.testing.assert_allclose(got[2] - 0.5, -got[0][:, 2, 3] + np.array([0.0, -0.4]), rtol=1e-5)


@pytest.mark.parametrize("use_sh", [False, True])
def test_render_orthographic_matches_jax(use_sh):
    """Two views of one scene each, colours precomputed or degree-4 SH."""
    extr, width, height, near, far = ortho_args()
    means, covs, colors, opac = make_scene(5, g=250, z_range=(3.0, 6.0))
    feats = np.random.default_rng(6).normal(size=(len(means), 3, 25)).astype(np.float32) * 0.3 if use_sh else colors
    stack = lambda x: np.stack([x, x])  # noqa: E731
    args = (extr, width, height, near, far, np.tile(np.float32([0.1, 0.2, 0.3]), (2, 1)),
            stack(means), stack(covs), stack(feats), stack(opac))
    settings = dict(capacity=512, big_capacity=64, chunk=64)
    want = jitted(
        lambda e, wd, ht, n, f, bg, m, c, sh, o, **kw: jx_render.render_orthographic(
            e, wd, ht, n, f, IMAGE, bg, m, c, sh, o, **kw
        ),
        *args, use_sh=use_sh, settings=jx_render.RenderSettings(**settings),
    )
    got = pt_render.render_orthographic(
        *(t(a) for a in args[:5]), IMAGE, *(t(a) for a in args[5:]), use_sh=use_sh,
        settings=pt_render.RenderSettings(**settings),
    ).numpy()
    assert got.shape == want.shape == (2, 3, *IMAGE)
    assert np.abs(want - np.float32([0.1, 0.2, 0.3])[:, None, None]).max() > 0.1  # the scene is in view
    assert_render_close(got, want)


def adaptive_scene(g=512, seed=0):
    """`test_adaptive_render.py::_scene`, drawn with numpy."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-0.8, 0.8, (1, g, 3)).astype(np.float32)
    means[..., 2] += 4.0
    covs = np.broadcast_to(np.eye(3, dtype=np.float32) * 2e-4, (1, g, 3, 3)).copy()
    sh = np.zeros((1, g, 3, 25), np.float32)
    sh[..., 0] = rng.uniform(0, 1, (1, g, 3)) / 0.2821
    opac = rng.uniform(0.3, 0.9, (1, g)).astype(np.float32)
    extr = np.eye(4, dtype=np.float32)[None]
    intr = np.float32([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1.0]])[None]
    return extr, intr, np.ones(1, np.float32), np.full(1, 100.0, np.float32), means, covs, sh, opac


@pytest.mark.parametrize("seed", [0, 3])
def test_render_adaptive_matches_jax_and_fixed_capacity(seed):
    """The port's `render_adaptive` chooses the settings the JAX package's
    `choose_settings` chooses, and renders the image that JAX's `render`
    gives at them, which is what JAX's `render_adaptive` returns
    (`adaptive.py:165-190`; its render jitted here)."""
    extr, intr, near, far, means, covs, sh, opac = adaptive_scene(seed=seed)
    bg = np.zeros((1, 3), np.float32)
    kw = dict(capacity=1024, big_capacity=32, chunk=64)
    chosen_j = jx_adaptive.choose_settings(
        *(jnp.asarray(a) for a in (extr, intr, near, means, covs, opac)), (64, 64),
        settings=jx_render.RenderSettings(**kw), capacities=(64, 128, 256),
    )
    chosen_p = pt_adaptive.choose_settings(
        *(t(a) for a in (extr, intr, near, means, covs, opac)), (64, 64),
        settings=pt_render.RenderSettings(**kw), capacities=(64, 128, 256),
    )
    assert (chosen_p.capacity, chosen_p.pair_budget) == (chosen_j.capacity, chosen_j.pair_budget)
    assert chosen_p.capacity < kw["capacity"]
    args = (extr, intr, near, far, bg, means, covs, sh, opac)
    want = jitted(
        lambda e, k, n, f, b, m, c, s, o, **st: jx_render.render(e, k, n, f, (64, 64), b, m, c, s, o, **st),
        *args, settings=chosen_j,
    )
    tensors = [t(a) for a in args]
    got = pt_adaptive.render_adaptive(
        *tensors[:4], (64, 64), *tensors[4:], settings=pt_render.RenderSettings(**kw), capacities=(64, 128, 256)
    ).numpy()
    fixed = pt_render.render(*tensors[:4], (64, 64), *tensors[4:], settings=pt_render.RenderSettings(**kw)).numpy()
    assert got.shape == want.shape == (1, 3, 64, 64)
    assert_render_close(got, want)
    # The chosen capacity cuts no list, so the image is the fixed capacity's.
    np.testing.assert_allclose(got, fixed, rtol=0, atol=1e-6)


def test_sample_training_rays_matches_jax():
    rng = np.random.default_rng(2)
    b, v, h, w = 2, 3, 5, 7
    image = rng.uniform(0, 1, (b, v, 3, h, w)).astype(np.float32)
    intr = np.tile(K, (b, v, 1, 1))
    extr = np.tile(np.eye(4, dtype=np.float32), (b, v, 1, 1))
    extr[..., :3, 3] = rng.normal(size=(b, v, 3))
    key = jax.random.PRNGKey(7)
    want = jx_geometry.sample_training_rays(key, jnp.asarray(image), jnp.asarray(intr), jnp.asarray(extr), 50)
    indices = np.asarray(jax.random.randint(key, (b, 50), 0, v * h * w))
    got = pt_geometry.sample_training_rays(t(image), t(intr), t(extr), 50, ray_indices=t(indices))
    for name, g, x in zip(("origins", "directions", "colours"), got, want):
        assert g.shape == (b, 50, 3)
        np.testing.assert_allclose(g.numpy(), np.asarray(x), rtol=1e-5, atol=1e-6, err_msg=name)
    # Drawn from a generator: indices in range, and each ray's colour is its pixel's.
    origins, directions, colours = pt_geometry.sample_training_rays(
        t(image), t(intr), t(extr), 400, generator=torch.Generator().manual_seed(0)
    )
    flat = t(image).permute(0, 1, 3, 4, 2).reshape(b, v * h * w, 3)
    assert all(any(torch.equal(c, p) for p in flat[i]) for i in range(b) for c in colours[i][:20])
    np.testing.assert_allclose(directions.norm(dim=-1).numpy(), 1.0, rtol=1e-5)


def decoder_gaussians(seed=11, b=2, g=150):
    means, covs, _, opac = zip(*(make_scene(seed + i, g=g) for i in range(b)))
    sh = np.random.default_rng(seed).normal(size=(b, g, 3, 25)).astype(np.float32) * 0.3
    return np.stack(means), np.stack(covs), sh, np.stack(opac)


@pytest.mark.parametrize("mode", ["depth", "log"])
def test_decoder_depth_mode_matches_jax(mode):
    """Two batch elements of two target views each: colour (b, v, 3, h, w)
    and depth (b, v, h, w), against the JAX decoder (the four modes'
    arithmetic: `test_render_depth_matches_jax`)."""
    means, covs, sh, opac = decoder_gaussians()
    b, v = 2, 2
    extr = np.tile(np.eye(4, dtype=np.float32), (b, v, 1, 1))
    extr[:, 1, :3, 3] = [0.15, -0.1, -0.3]
    intr = np.tile(K, (b, v, 1, 1))
    near = np.full((b, v), 0.8, np.float32)
    far = np.full((b, v), 100.0, np.float32)
    settings = dict(capacity=512, big_capacity=64, chunk=64)
    decoder = JxDecoder(JxDecoderCfg(render=jx_render.RenderSettings(**settings)))
    want = jax.jit(lambda g, e, k, n, f: decoder(JxGaussians(*g), e, k, n, f, IMAGE, depth_mode=mode))(
        *(tuple(jnp.asarray(x) for x in a) if isinstance(a, tuple) else jnp.asarray(a)
          for a in ((means, covs, sh, opac), extr, intr, near, far))
    )
    got = PtDecoder(PtDecoderCfg(render=pt_render.RenderSettings(**settings)))(
        PtGaussians(*(t(x) for x in (means, covs, sh, opac))), t(extr), t(intr), t(near), t(far), IMAGE,
        depth_mode=mode,
    )
    assert got.color.shape == (b, v, 3, *IMAGE) and got.depth.shape == (b, v, *IMAGE)
    assert_render_close(got.color.numpy(), np.asarray(want.color))
    assert_render_close(got.depth.numpy(), np.asarray(want.depth))
    assert int(got.overflow) == int(want.overflow)
    assert PtDecoder(PtDecoderCfg())(
        PtGaussians(*(t(x) for x in (means, covs, sh, opac))), t(extr), t(intr), t(near), t(far), IMAGE,
    ).depth is None


def test_decoder_depth_mode_refuses_soa():
    """Depth renders take the public AoS Gaussians, as in the JAX package."""
    means, covs, sh, opac = decoder_gaussians(b=1)
    soa = pack_gaussians_soa(t(means[0]), t(covs[0]), t(opac[0]), harmonics=t(sh[0]))
    soa = type(soa)(*(None if x is None else x[None] for x in soa))
    cams = (t(np.eye(4, dtype=np.float32)[None, None]), t(K[None, None]), torch.ones(1, 1), torch.full((1, 1), 100.0))
    decoder = PtDecoder(PtDecoderCfg())
    with pytest.raises(NotImplementedError, match="AoS"):
        decoder(soa, *cams, IMAGE, depth_mode="depth")
    assert decoder(soa, *cams, IMAGE).color.shape == (1, 1, 3, *IMAGE)


def test_depth_render_runs_the_compositor_with_one_channel(monkeypatch):
    """On the CPU the depth render goes through the compositor's plain
    versions, forward and backward, with the depth in colour channel 0 of
    the table and nothing in the others."""
    seen = []
    for name in ("composite_core_plain", "composite_bwd_plain"):
        original = getattr(composite_kernel, name)

        def spy(table, *args, _name=name, _original=original, **kwargs):
            seen.append((_name, table.detach().clone()))
            return _original(table, *args, **kwargs)

        monkeypatch.setattr(composite_kernel, name, spy)
    args = depth_scene()
    means = t(args[5]).requires_grad_()
    depth = pt_render.render_depth(
        *(t(a) for a in args[:4]), IMAGE, means, t(args[6]), t(args[7]), settings=pt_render.RenderSettings(capacity=256)
    )
    depth.sum().backward()
    assert [name for name, _ in seen] == ["composite_core_plain", "composite_bwd_plain"]
    table = seen[0][1]
    assert table.shape[1] == 12 and float(table[:-1, 6].abs().min()) > 1.0  # z of every Gaussian in channel 0
    assert float(table[:, 7:].abs().max()) == 0.0
    assert float(means.grad.abs().max()) > 0


# ---------------------------------------------------------------------------
# One training step of `re10k_depth_loss` (the `re10k` model at the size of
# `test_torch_re10k_train.py`) against the JAX step.


@pytest.fixture(scope="module")
def depth_setup():
    with pytest.MonkeyPatch.context() as mp:
        shrink_backbones(mp)
        jcfg, pcfg = small_cfgs()
        loaded = load_config(["+experiment=re10k_depth_loss"])
        _, training = pt_config.EXPERIMENTS["re10k_depth_loss"]
        depth_cfg = next(c for c in training().loss if isinstance(c, LossDepthCfg))
        assert loaded.train.depth_mode == training().train.depth_mode == "depth"
        source = enc_helpers.randomize(PtEncoder(pcfg), seed=53)
        flax_params = torch_import.convert_encoder(source.state_dict(), jcfg)
        # MSE + depth: the preset's LPIPS is gated off until step 150,000,
        # and its parity belongs to `test_torch_train_step.py`.
        jw = jx_wrapper.ModelWrapper(
            JxOptimizerCfg(lr=train_helpers.LR, warm_up_steps=train_helpers.WARM_UP),
            jx_wrapper.TrainCfg(depth_mode="depth"), jx_wrapper.TestCfg(), jcfg, get_decoder(loaded.model.decoder),
            [JxLossMse(JxLossMseCfg()), JxLossDepth(JxLossDepthCfg(weight=depth_cfg.weight))],
            gradient_clip_val=train_helpers.CLIP,
        )
        pw = PtWrapper(
            pcfg, pt_config.re10k()[1], device="cpu",
            optimizer_cfg=OptimizerCfg(lr=train_helpers.LR, warm_up_steps=train_helpers.WARM_UP),
            train_cfg=TrainCfg(depth_mode="depth"), loss_cfgs=(LossMseCfg(), depth_cfg),
            gradient_clip_val=train_helpers.CLIP,
        )
        from_jax.load_from_jax(pw.encoder, flax_params)
        yield train_helpers.JaxSide(jw, mp), {"params": jax.tree.map(jnp.asarray, flax_params)}, pcfg, pw


def test_re10k_depth_loss_train_step_matches_jax(depth_setup):
    """The loss's parts (the depth loss on the rendered depth map among
    them), every gradient by name and Adam's first moment after the update,
    under the tolerances of `test_torch_train_step.py`."""
    jx, params_j, pcfg, pw = depth_setup
    batch = train_helpers.make_batch(8)
    parts_j, grads_j, u = jx.grads(params_j, batch, 0, seed=21)
    parts_p, grads_p = train_helpers.port_grads(pw, batch, 0, u)
    assert parts_p.keys() == parts_j.keys() == {
        "loss/mse", "loss/depth", "loss/total", "train/psnr_probabilistic", "train/overflow_pairs"
    }
    assert parts_j["loss/depth"] > 0
    for key in ("loss/mse", "loss/depth", "loss/total", "train/psnr_probabilistic"):
        # Depths agree to 1e-4 of the largest one; the loss squares
        # differences of 1 / depth, a few 1e-5 relative.
        np.testing.assert_allclose(parts_p[key], parts_j[key], rtol=5e-5, err_msg=key)
    assert parts_p["train/overflow_pairs"] == parts_j["train/overflow_pairs"] == 0.0
    train_helpers.assert_trees_close(grads_p, grads_j, pcfg, train_helpers.GRAD_RTOL, "gradient")

    _, opt_state_j = jx.update_fn(grads_j, jx.optimizer.init(params_j), params_j)
    state_p, step_parts = pw.make_train_step()(pw.init_state(), batch, u=torch.as_tensor(u))
    assert state_p.step == 1
    np.testing.assert_allclose(float(step_parts["loss/depth"]), parts_j["loss/depth"], rtol=5e-5)
    adam_p = state_p.optimizer.adam.state
    mu_p = {k: adam_p[p]["exp_avg"] for k, p in state_p.params.items()}
    train_helpers.assert_trees_close(mu_p, opt_state_j[-1][0].mu, pcfg, train_helpers.GRAD_RTOL, "first moment")


def test_backward_inputs_of_a_depth_render(monkeypatch):
    """`scripts/train_scene.py::backward_inputs` with a depth mode, which
    `chip_smoke.py` hands to the backward kernel: per target view the
    depth render's table (camera z in colour channel 0, nothing in the
    others), its image equal to the decoder's depth map, and the depth
    loss's cotangent in channel 0 only, finite though the small random
    model leaves pixels that no Gaussian reaches
    (`test_depth_loss_leaves_unrendered_pixels_out`)."""
    from pixelsplat_tpu_torch.ops.rasterizer.composite import assemble_image
    from pixelsplat_tpu_torch.scripts.train_scene import backward_inputs, make_train_scene
    from pixelsplat_tpu_torch.training.model_wrapper import batch_to

    shrink_backbones(monkeypatch)
    _, pcfg = small_cfgs()
    scene = make_train_scene(device="cpu", image_shape=(64, 64), encoder_cfg=pcfg, model="re10k_depth_loss")
    assert scene.wrapper.train_cfg.depth_mode == "depth"
    batch = scene.batch(1)
    inputs = backward_inputs(scene, batch, seed=3, depth_mode="depth")
    assert len(inputs) == 4

    wrapper = scene.wrapper
    shimmed = wrapper.data_shim(batch_to(batch, wrapper.device))
    gaussians = wrapper.encoder(shimmed["context"], 0, False, generator=torch.Generator().manual_seed(3))
    t = shimmed["target"]
    depth = wrapper.decoder(
        gaussians, t["extrinsics"], t["intrinsics"], t["near"], t["far"], (64, 64), depth_mode="depth"
    ).depth
    for v, inp in enumerate(inputs):
        table = inp["table"]
        assert float(table[:-1, 6].min()) > 0 and float(table[:, 7:].abs().max()) == 0.0
        acc, trans, _ = composite_kernel.composite_core(
            table, inp["tiles"].flat, inp["tiles"].block_start, inp["tiles"].counts, inp["tiles_x"], inp["chunk"]
        )
        image = assemble_image(acc, trans, torch.zeros(1), (64, 64))
        torch.testing.assert_close(image[0], depth[0, v].detach(), rtol=0, atol=0)
        assert bool(inp["g_acc"].isfinite().all()) and bool(inp["g_trans"].isfinite().all())
        assert float(inp["g_acc"][:, 0].abs().max()) > 0 and float(inp["g_acc"][:, 1:].abs().max()) == 0.0
    assert sum(int((d == 0).sum()) for d in depth[0]) > 0  # the case the depth loss must survive


@pytest.mark.parametrize("second", [False, True])
def test_depth_loss_leaves_unrendered_pixels_out(second):
    """A pixel that no Gaussian reaches renders depth 0. The JAX package's
    loss takes 1 / 0 there and is infinite; the port averages over the
    differences between rendered pixels only, a deliberate difference (on
    maps without such pixels the two agree: `test_torch_losses_optim.py`)."""
    from pixelsplat_tpu_torch.loss.loss_depth import LossDepth

    rng = np.random.default_rng(4)
    depth = rng.uniform(1.0, 5.0, (1, 2, 12, 16)).astype(np.float32)
    depth[0, 1, 0, :3] = 0.0  # a corner no Gaussian reaches
    want = JxLossDepth(JxLossDepthCfg(use_second_derivative=second))(
        SimpleNamespace(depth=jnp.asarray(depth)), {}, None, 0
    )
    assert not np.isfinite(float(want))
    d = t(depth).requires_grad_()
    got = LossDepth(LossDepthCfg(use_second_derivative=second))(SimpleNamespace(depth=d), {}, None, 0)
    got.backward()
    got = float(got.detach())

    disp = np.where(depth > 0, 1.0 / np.where(depth > 0, depth, 1.0), np.nan)
    total = 0.0
    for axis in (-1, -2):
        diff = np.diff(disp, n=2 if second else 1, axis=axis)
        total += np.nanmean(diff**2)  # NaN exactly where a difference touches an unrendered pixel
    assert np.isfinite(got) and bool(d.grad.isfinite().all())
    np.testing.assert_allclose(got, 0.25 * total, rtol=1e-5)
    assert float(d.grad[0, 1, 0, :3].abs().max()) == 0.0
