"""The port's losses, LPIPS network, optimizer and checkpointing against
the JAX package's, on the CPU. Inputs are made with numpy from a seed and
handed to both sides; each tolerance is stated where it is used."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pixelsplat_tpu.evaluation import lpips as jx_lpips
from pixelsplat_tpu.interop import torch_import
from pixelsplat_tpu.loss import loss_depth as jx_loss_depth
from pixelsplat_tpu.loss import loss_lpips as jx_loss_lpips
from pixelsplat_tpu.loss import loss_mse as jx_loss_mse
from pixelsplat_tpu.model.decoder.decoder_splatting import DecoderOutput as JxOutput
from pixelsplat_tpu.training import optimizer as jx_optimizer
from pixelsplat_tpu_torch.evaluation import lpips as pt_lpips
from pixelsplat_tpu_torch.interop import from_jax
from pixelsplat_tpu_torch.loss import get_losses
from pixelsplat_tpu_torch.loss import loss_depth as pt_loss_depth
from pixelsplat_tpu_torch.loss import loss_lpips as pt_loss_lpips
from pixelsplat_tpu_torch.loss import loss_mse as pt_loss_mse
from pixelsplat_tpu_torch.model.decoder.decoder_splatting import DecoderOutput as PtOutput
from pixelsplat_tpu_torch.training import checkpoint as pt_checkpoint
from pixelsplat_tpu_torch.training import optimizer as pt_optimizer


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


def prediction_and_batch(seed, h=32, w=48):
    rng = np.random.default_rng(seed)
    color = rng.uniform(0, 1, (2, 3, 3, h, w)).astype(np.float32)
    depth = rng.uniform(1.0, 9.0, (2, 3, h, w)).astype(np.float32)
    image = rng.uniform(0, 1, (2, 3, 3, h, w)).astype(np.float32)
    jx = (JxOutput(color=jnp.asarray(color), depth=jnp.asarray(depth)), {"target": {"image": jnp.asarray(image)}})
    pt = (PtOutput(color=t(color), depth=t(depth)), {"target": {"image": t(image)}})
    return jx, pt


def test_loss_mse():
    (out_j, batch_j), (out_p, batch_p) = prediction_and_batch(0)
    want = jx_loss_mse.LossMse(jx_loss_mse.LossMseCfg(weight=0.7))(out_j, batch_j, None, 0)
    got = pt_loss_mse.LossMse(pt_loss_mse.LossMseCfg(weight=0.7))(out_p, batch_p, None, 0)
    # A mean of 27,648 f32 terms in another order.
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize(
    "sigma_image,second", [(None, False), (0.1, False), (0.1, True), (None, True)],
    ids=["plain", "bilateral", "bilateral_second", "second"],
)
def test_loss_depth(sigma_image, second):
    """On a synthetic depth map: the decoder's depth rendering is not ported yet."""
    (out_j, batch_j), (out_p, batch_p) = prediction_and_batch(1)
    kw = dict(weight=0.25, sigma_image=sigma_image, use_second_derivative=second)
    want = jx_loss_depth.LossDepth(jx_loss_depth.LossDepthCfg(**kw))(out_j, batch_j, None, 0)
    depth = out_p.depth.clone().requires_grad_(True)
    got = pt_loss_depth.LossDepth(pt_loss_depth.LossDepthCfg(**kw))(out_p._replace(depth=depth), batch_p, None, 0)
    # Means of ~9,000 squared f32 differences (and an exp) in another order.
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    grad_j = jax.grad(
        lambda d: jx_loss_depth.LossDepth(jx_loss_depth.LossDepthCfg(**kw))(out_j._replace(depth=d), batch_j, None, 0)
    )(out_j.depth)
    got.backward()
    np.testing.assert_allclose(depth.grad.numpy(), np.asarray(grad_j), rtol=1e-4, atol=1e-9)


def test_loss_depth_needs_depth():
    (_, _), (out_p, batch_p) = prediction_and_batch(1)
    with pytest.raises(ValueError, match="depth_mode"):
        pt_loss_depth.LossDepth(pt_loss_depth.LossDepthCfg())(out_p._replace(depth=None), batch_p, None, 0)


@pytest.fixture(scope="module")
def lpips_pair():
    """The JAX package's random LPIPS parameters, carried into the port."""
    params = jax.device_get(jx_lpips.random_lpips_params())
    model = pt_lpips.LPIPS()
    model.load_state_dict(from_jax.lpips_state_dict_from_jax(params), strict=True)
    return params, model.eval()


def test_lpips_matches_jax(lpips_pair):
    params, model = lpips_pair
    rng = np.random.default_rng(2)
    a = rng.uniform(0, 1, (2, 3, 64, 64)).astype(np.float32)
    b = rng.uniform(0, 1, (2, 3, 64, 64)).astype(np.float32)
    want = jx_lpips.LPIPS().apply(params, jnp.asarray(a), jnp.asarray(b))
    a_t = t(a).requires_grad_(True)
    got = model(a_t, t(b))
    # 13 f32 convolutions deep, sums in another order.
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-7)
    grad_j = jax.grad(lambda x: jx_lpips.LPIPS().apply(params, x, jnp.asarray(b)).mean())(jnp.asarray(a))
    got.mean().backward()
    np.testing.assert_allclose(
        a_t.grad.numpy(), np.asarray(grad_j), atol=1e-4 * float(np.abs(grad_j).max()), rtol=0
    )
    assert all(not p.requires_grad for p in model.parameters())  # frozen


def test_lpips_state_dict_round_trip(lpips_pair):
    """`lpips_state_dict_from_jax` inverts the JAX package's `convert_lpips`."""
    params, model = lpips_pair
    back = torch_import.convert_lpips(model.state_dict())
    flat_a = jax.tree_util.tree_leaves_with_path(back)
    flat_b = jax.tree_util.tree_leaves_with_path(params)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, x), (_, y) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_loss_lpips_gate_and_value(lpips_pair, monkeypatch):
    params, model = lpips_pair
    (out_j, batch_j), (out_p, batch_p) = prediction_and_batch(3, h=32, w=32)
    cfg_kw = dict(weight=0.05, apply_after_step=10, allow_random_weights=True)
    loss_j = jx_loss_lpips.LossLpips(jx_loss_lpips.LossLpipsCfg(**cfg_kw))
    loss_j.params = params
    loss_p = pt_loss_lpips.LossLpips(pt_loss_lpips.LossLpipsCfg(**cfg_kw), device="cpu")
    assert not loss_p.pretrained
    loss_p.lpips = model

    calls = []
    monkeypatch.setattr(model, "forward", lambda *a, _f=model.forward: calls.append(1) or _f(*a))
    before = loss_p(out_p, batch_p, None, 9)
    assert float(before) == 0.0 and not calls  # the VGG does not run before the gate
    assert float(loss_j(out_j, batch_j, None, jnp.asarray(9))) == 0.0
    for step in (10, 11):
        want = loss_j(out_j, batch_j, None, jnp.asarray(step))
        got = loss_p(out_p, batch_p, None, step)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-4, atol=1e-8)
    assert len(calls) == 2


def test_loss_lpips_fails_without_weights():
    assert not pt_lpips.DEFAULT_WEIGHTS_PATH.exists()
    with pytest.raises(FileNotFoundError, match="LPIPS weights"):
        pt_loss_lpips.LossLpips(pt_loss_lpips.LossLpipsCfg(), device="cpu")
    with pytest.raises(FileNotFoundError, match="LPIPS weights"):
        get_losses([pt_loss_mse.LossMseCfg(), pt_loss_lpips.LossLpipsCfg()], device="cpu")


def test_lpips_loads_exported_npz(tmp_path, lpips_pair):
    """The .npz layout of the JAX package's exporter (HWIO kernels)."""
    params, model = lpips_pair
    arrays = {}
    for i in range(13):
        arrays[f"vgg_conv{i}_kernel"] = np.asarray(params["params"]["vgg"][f"conv{i}"]["kernel"])
        arrays[f"vgg_conv{i}_bias"] = np.asarray(params["params"]["vgg"][f"conv{i}"]["bias"])
    for i in range(5):
        arrays[f"lin{i}_kernel"] = np.asarray(params["params"][f"lin{i}"]["kernel"])
    np.savez(tmp_path / "lpips.npz", **arrays)
    loaded = pt_lpips.load_lpips(str(tmp_path / "lpips.npz"))
    for (k, a), (_, b) in zip(loaded.state_dict().items(), model.state_dict().items()):
        assert torch.equal(a, b), k
    assert pt_lpips.load_lpips(str(tmp_path / "absent.npz")) is None


def test_get_losses_by_name():
    losses = get_losses(
        [pt_loss_mse.LossMseCfg(), pt_loss_depth.LossDepthCfg(),
         pt_loss_lpips.LossLpipsCfg(allow_random_weights=True)], device="cpu",
    )
    assert [loss.name for loss in losses] == ["mse", "depth", "lpips"]


# ---------------------------------------------------------------------------
# Optimizer


def test_warm_up_schedule_matches_optax():
    cfg_j = jx_optimizer.OptimizerCfg(lr=1.5e-4, warm_up_steps=5)
    cfg_p = pt_optimizer.OptimizerCfg(lr=1.5e-4, warm_up_steps=5)
    assert [pt_optimizer.learning_rate(cfg_p, s) for s in range(8)] == pytest.approx(
        [1.5e-4 * min(1.0, (s + 1) / 5) for s in range(8)]
    )
    # Through optax: with a constant unit gradient Adam's update is
    # -lr * m_hat / (sqrt(v_hat) + eps) = -lr (to eps and f32 bias
    # corrections, ~1e-5 relative), so the update reads the schedule back.
    opt = jx_optimizer.build_optimizer(cfg_j, gradient_clip_val=0.0)
    p = {"w": jnp.zeros(())}
    state = opt.init(p)
    for s in range(8):
        updates, state = opt.update({"w": jnp.ones(())}, state, p)
        np.testing.assert_allclose(-float(updates["w"]), pt_optimizer.learning_rate(cfg_p, s), rtol=2e-5)


@pytest.mark.parametrize("scale", [0.01, 30.0], ids=["below_clip", "above_clip"])
def test_clip_and_adam_steps_match_optax(scale):
    """A toy tree over 6 steps: gradients below and above the 0.5 clip,
    with warm-up. Weights and both Adam moments must follow optax."""
    rng = np.random.default_rng(7)
    shapes = {"a": (4, 3), "b": (5,), "c": (2, 2, 2)}
    init = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [
        {k: (scale * rng.normal(size=s)).astype(np.float32) for k, s in shapes.items()} for _ in range(6)
    ]
    opt_j = jx_optimizer.build_optimizer(jx_optimizer.OptimizerCfg(lr=1e-2, warm_up_steps=4), 0.5)
    params_j = {k: jnp.asarray(v) for k, v in init.items()}
    state_j = opt_j.init(params_j)

    params_p = {k: torch.nn.Parameter(t(v)) for k, v in init.items()}
    opt_p = pt_optimizer.Optimizer(
        params_p.values(), pt_optimizer.OptimizerCfg(lr=1e-2, warm_up_steps=4), 0.5
    )
    for step, g in enumerate(grads):
        updates, state_j = opt_j.update({k: jnp.asarray(v) for k, v in g.items()}, state_j, params_j)
        params_j = optax.apply_updates(params_j, updates)
        for k, p in params_p.items():
            p.grad = t(g[k])
        opt_p.step(step)
        norm = np.sqrt(sum(float((v.astype(np.float64) ** 2).sum()) for v in g.values()))
        assert (norm > 0.5) == (scale > 1)
        adam_j = state_j[-1][0]
        for k, p in params_p.items():
            # f32 arithmetic in another association (optax divides the
            # moments by their bias corrections, torch folds them into
            # the step size): a few ulps per step.
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(params_j[k]), rtol=2e-6, atol=1e-7)
            st = opt_p.adam.state[p]
            np.testing.assert_allclose(st["exp_avg"].numpy(), np.asarray(adam_j.mu[k]), rtol=1e-5, atol=1e-9)
            np.testing.assert_allclose(st["exp_avg_sq"].numpy(), np.asarray(adam_j.nu[k]), rtol=1e-5, atol=1e-12)
        assert int(adam_j.count) == step + 1


def test_clip_by_global_norm_rule():
    """optax's rule: scale by clip / max(norm, clip), not clip / (norm + 1e-6)."""
    g = [torch.full((4,), 3.0), torch.full((9,), -2.0)]
    norm = pt_optimizer.clip_by_global_norm(g, 0.5)
    assert float(norm) == pytest.approx(np.sqrt(4 * 9 + 9 * 4))
    total = torch.sqrt(sum((x**2).sum() for x in g))
    assert float(total) == pytest.approx(0.5, rel=1e-6)
    small = [torch.full((4,), 1e-3)]
    pt_optimizer.clip_by_global_norm(small, 0.5)
    assert torch.equal(small[0], torch.full((4,), 1e-3))  # untouched below the clip


# ---------------------------------------------------------------------------
# Checkpoint


def test_checkpoint_round_trip(tmp_path):
    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.Linear(3, 2))
    opt = pt_optimizer.Optimizer(net.parameters(), pt_optimizer.OptimizerCfg(warm_up_steps=3))
    for step in range(3):
        net(torch.randn(5, 4)).square().sum().backward()
        opt.step(step)
        net.zero_grad()
    payload = {"params": net.state_dict(), "optimizer": opt.state_dict(), "step": 3}
    assert pt_checkpoint.latest_checkpoint(tmp_path / "none") is None
    pt_checkpoint.save_checkpoint(tmp_path, 2, {**payload, "step": 2})
    path = pt_checkpoint.save_checkpoint(tmp_path, 10, payload)
    assert path.name == "step_10"
    assert pt_checkpoint.latest_checkpoint(tmp_path) == path  # numeric, not lexical, order

    loaded = pt_checkpoint.load_checkpoint(path)
    assert loaded["step"] == 3
    net2 = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.Linear(3, 2))
    opt2 = pt_optimizer.Optimizer(net2.parameters(), pt_optimizer.OptimizerCfg(warm_up_steps=3))
    net2.load_state_dict(loaded["params"])
    opt2.load_state_dict(loaded["optimizer"])
    for a, b in zip(net.parameters(), net2.parameters()):
        assert torch.equal(a, b)
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(opt.adam.state[a][key], opt2.adam.state[b][key])
        assert float(opt.adam.state[a]["step"]) == float(opt2.adam.state[b]["step"]) == 3
    # The restored pair continues exactly as the original does.
    x = torch.randn(5, 4)
    for n, o in ((net, opt), (net2, opt2)):
        n(x).square().sum().backward()
        o.step(3)
    for a, b in zip(net.parameters(), net2.parameters()):
        assert torch.equal(a, b)
