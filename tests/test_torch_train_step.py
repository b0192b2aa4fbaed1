"""The training step as a whole against the JAX package, on the CPU.

The model is `re10k_ablation_no_epipolar_transformer` with the ViT cut to a
tiny spec (as in `test_torch_slice.py`), on 2 context and 2 target views at
64x64, trained with MSE + LPIPS (LPIPS from step 1 on, with the JAX
package's random VGG weights carried across), clip 0.5 and Adam with a
4-step warm-up to 1e-4 (a rate at which two steps move the weights by
thousands of f32 ulps, yet too little for the two sides to drift apart). Weights are made by numpy from a seed and loaded
on both sides; the JAX sampler's uniforms are recorded and handed to the
port. On the CPU the JAX package differentiates its XLA compositor and the
port runs the plain versions of its two CUDA kernels.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pixelsplat_tpu.interop import torch_import
from pixelsplat_tpu.loss import LossLpips as JxLossLpips
from pixelsplat_tpu.loss import LossLpipsCfg as JxLossLpipsCfg
from pixelsplat_tpu.loss import LossMse as JxLossMse
from pixelsplat_tpu.loss import LossMseCfg as JxLossMseCfg
from pixelsplat_tpu.model.decoder import get_decoder
from pixelsplat_tpu.model.encoder.backbone import dino as jx_dino
from pixelsplat_tpu.training import model_wrapper as jx_wrapper
from pixelsplat_tpu.training.optimizer import OptimizerCfg as JxOptimizerCfg
from pixelsplat_tpu.utils import distributions as jx_distributions
from pixelsplat_tpu_torch import config as pt_config
from pixelsplat_tpu_torch.interop import from_jax
from pixelsplat_tpu_torch.loss import LossLpipsCfg, LossMseCfg
from pixelsplat_tpu_torch.model.encoder.backbone import dino as pt_dino
from pixelsplat_tpu_torch.model.encoder.encoder_epipolar import EncoderEpipolar as PtEncoder
from pixelsplat_tpu_torch.training.model_wrapper import ModelWrapper as PtWrapper
from pixelsplat_tpu_torch.training.model_wrapper import TrainCfg
from pixelsplat_tpu_torch.training.optimizer import OptimizerCfg, learning_rate

import test_torch_encoder as enc_helpers
import test_torch_slice as slice_helpers

H = W = 64
LR, WARM_UP, CLIP = 1e-4, 4, 0.5
LPIPS_FROM = 1

# Gradients, per parameter tensor relative to its largest entry. Most
# tensors agree to 1e-6..1e-4 (f32 through the backbone, heads, projection,
# compositing and, from step 1, the VGG, forward and backward, every sum in
# another order; JAX on the CPU composites every chunk where the port stops
# a tile at T < 1e-4). A few deep ResNet tensors differ by up to ~1e-3: at
# 64x64 their feature maps are 4x4, and one ReLU input that rounds to the
# other side of zero flips that unit's whole contribution. So each tensor
# is held to GRAD_RTOL and the median tensor to a tenth of it.
GRAD_RTOL = 2e-3


@pytest.fixture(autouse=True)
def one_thread(request):
    """One intra-op thread: next to the other test processes, more threads
    only contend for the cores. `test_two_train_steps_match_jax` keeps the
    default count, at which its tolerance was set: with one thread the
    step-1 gradient of `layer1.1.conv1.weight` lands 1.24e-5 from the JAX
    package's, over its limit of 9.1e-6. It is the JAX side that drifts
    there: `test_two_train_steps_float64_reference` puts the port's
    one-thread gradient 1.9e-4 of the tensor's largest entry from the
    float64 one and the JAX package's 2.8e-3."""
    threads = torch.get_num_threads()
    if request.node.name != "test_two_train_steps_match_jax":
        torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def make_batch(seed, b=1):
    rng = np.random.default_rng(seed)
    k = np.array([[0.9, 0, 0.5], [0, 0.9, 0.5], [0, 0, 1]], np.float32)
    c_extr = np.tile(np.eye(4, dtype=np.float32), (b, 2, 1, 1))
    c_extr[:, 1, 0, 3] = 0.8
    t_extr = np.tile(np.eye(4, dtype=np.float32), (b, 2, 1, 1))
    t_extr[:, :, 0, 3] = [0.2, 0.6]
    t_extr[:, :, 2, 3] = [-0.1, 0.1]

    def views(extr):
        v = extr.shape[1]
        return {
            "image": rng.uniform(0, 1, (b, v, 3, H, W)).astype(np.float32),
            "extrinsics": extr,
            "intrinsics": np.tile(k, (b, v, 1, 1)),
            "near": np.ones((b, v), np.float32),
            "far": np.full((b, v), 100.0, np.float32),
        }

    return {"context": views(c_extr), "target": views(t_extr)}


def port_wrapper(pcfg, pdec_cfg, flax_params, lpips_params, remat=False):
    pw = PtWrapper(
        pcfg, pdec_cfg, device="cpu",
        optimizer_cfg=OptimizerCfg(lr=LR, warm_up_steps=WARM_UP),
        train_cfg=TrainCfg(remat_encoder=remat),
        loss_cfgs=(LossMseCfg(), LossLpipsCfg(apply_after_step=LPIPS_FROM, allow_random_weights=True)),
        gradient_clip_val=CLIP,
    )
    from_jax.load_from_jax(pw.encoder, flax_params)
    pw.losses[1].lpips.load_state_dict(from_jax.lpips_state_dict_from_jax(lpips_params), strict=True)
    return pw


@pytest.fixture(scope="module")
def setup():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jx_dino.VIT_SPECS, "tiny", enc_helpers.TINY)
        mp.setitem(pt_dino.VIT_SPECS, "tiny", enc_helpers.TINY)
        jcfg, pcfg = enc_helpers.tiny_encoder_cfgs()
        from pixelsplat_tpu.config import load_config

        jdec_cfg = load_config(["+experiment=re10k_ablation_no_epipolar_transformer"]).model.decoder
        _, pdec_cfg = pt_config.re10k_ablation_no_epipolar_transformer()
        source = enc_helpers.randomize(PtEncoder(pcfg), seed=31)
        flax_params = torch_import.convert_encoder(source.state_dict(), jcfg)
        losses = [
            JxLossMse(JxLossMseCfg()),
            JxLossLpips(JxLossLpipsCfg(apply_after_step=LPIPS_FROM, allow_random_weights=True)),
        ]
        jw = jx_wrapper.ModelWrapper(
            JxOptimizerCfg(lr=LR, warm_up_steps=WARM_UP), jx_wrapper.TrainCfg(), jx_wrapper.TestCfg(),
            jcfg, get_decoder(jdec_cfg), losses, gradient_clip_val=CLIP,
        )
        lpips_params = jax.device_get(losses[1].params)
        make_port = lambda remat=False: port_wrapper(pcfg, pdec_cfg, flax_params, lpips_params, remat)
        yield JaxSide(jw, mp), {"params": jax.tree.map(jnp.asarray, flax_params)}, pcfg, make_port


class JaxSide:
    """The JAX package's loss gradients and optimizer update, jitted once
    for the module, with the sampler's uniforms recorded at every call."""

    def __init__(self, jw, monkeypatch):
        self.recorded = []
        original = slice_helpers.jx_depth_module.sample_discrete_distribution

        def recording(key, pdf, num_samples):
            u = jax.random.uniform(key, (*pdf.shape[:-1], num_samples), dtype=pdf.dtype)
            jax.debug.callback(lambda x: self.recorded.append(np.array(x)), u)
            return original(key, pdf, num_samples)

        monkeypatch.setattr(slice_helpers.jx_depth_module, "sample_discrete_distribution", recording)
        self.grad_fn = jax.jit(jax.value_and_grad(jw.loss_fn, has_aux=True))
        self.update_fn = jax.jit(jw.optimizer.update)
        self.optimizer = jw.optimizer

    def grads(self, params, batch, step, seed):
        n = len(self.recorded)
        (_, parts), grads = self.grad_fn(
            params, jax.tree.map(jnp.asarray, batch), jnp.asarray(step), jax.random.PRNGKey(seed)
        )
        jax.block_until_ready(grads)
        assert len(self.recorded) == n + 1
        return {k: float(v) for k, v in parts.items()}, grads, self.recorded[-1]


def port_grads(pw, batch, step, u):
    for p in pw.encoder.parameters():
        p.grad = None
    total, parts = pw.loss_fn(batch, step, u=torch.as_tensor(u))
    total.backward()
    grads = {k: p.grad.clone() for k, p in pw.encoder.named_parameters()}
    return {k: float(v) for k, v in parts.items()}, grads


def assert_trees_close(got: dict, want_tree, pcfg, rtol, what):
    """`got` (by port parameter name) against a JAX tree shaped like the
    parameters: each tensor to `rtol` of the JAX tensor's largest entry, and
    the median tensor to a tenth of that."""
    want = from_jax.state_dict_from_jax(jax.device_get(want_tree["params"]), pcfg)
    assert got.keys() == want.keys()
    rels = []
    for name, w in want.items():
        scale = float(w.abs().max())
        err = float((got[name].detach() - w).abs().max())
        assert err <= rtol * scale + 1e-12, f"{what} {name}: {err:.3g} > {rtol} x {scale:.3g}"
        rels.append(err / max(scale, 1e-30))
    assert float(np.median(rels)) <= 0.1 * rtol, f"{what}: median tensor off by {np.median(rels):.3g}"


def assert_parts_close(got, want, lpips_on):
    assert got.keys() == want.keys() == {
        "loss/mse", "loss/lpips", "loss/total", "train/psnr_probabilistic", "train/overflow_pairs"
    }
    # Images agree to ~1e-4 of the largest colour (test_torch_slice.py), so
    # their mean squares and LPIPS distances do to a few 1e-5 relative.
    for key in ("loss/mse", "loss/total", "train/psnr_probabilistic"):
        np.testing.assert_allclose(got[key], want[key], rtol=5e-5, err_msg=key)
    assert got["train/overflow_pairs"] == want["train/overflow_pairs"] == 0.0
    if lpips_on:
        assert want["loss/lpips"] != 0.0
        np.testing.assert_allclose(got["loss/lpips"], want["loss/lpips"], rtol=2e-3, atol=1e-7)
    else:
        assert got["loss/lpips"] == want["loss/lpips"] == 0.0


def test_batchnorm_statistics_are_trained(setup):
    """The JAX package declares the frozen BatchNorm's mean and var as
    parameters and masks nothing in its optimizer, so its training step
    moves them; the port must do the same under the same names, and must
    never switch those layers to batch statistics."""
    jx, params, pcfg, make_port = setup
    batch = make_batch(0)
    _, grads, u = jx.grads(params, batch, 0, seed=3)
    bn = grads["params"]["backbone"]["resnet_backbone"]["bn1"]
    assert float(jnp.abs(bn["mean"]).max()) > 0 and float(jnp.abs(bn["var"]).max()) > 0
    updates, _ = jx.update_fn(grads, jx.optimizer.init(params), params)
    moved = optax.apply_updates(params, updates)["params"]["backbone"]["resnet_backbone"]["bn1"]
    assert float(jnp.abs(moved["mean"] - params["params"]["backbone"]["resnet_backbone"]["bn1"]["mean"]).max()) > 0

    pw = make_port()
    names = [k for k, _ in pw.encoder.named_parameters() if k.endswith(("running_mean", "running_var"))]
    assert len(names) == 2 * 43  # every BatchNorm of the 4-stage ResNet-50 trunk
    before = {k: v.detach().clone() for k, v in pw.encoder.named_parameters()}
    image = torch.as_tensor(batch["context"]["image"])
    pw.encoder.train()  # training mode must not bring in batch statistics
    with torch.no_grad():
        out_train = pw.encoder.backbone(image)
        pw.encoder.eval()
        assert torch.equal(out_train, pw.encoder.backbone(image))
    state, _ = pw.make_train_step()(pw.init_state(), batch, u=torch.as_tensor(u))
    for k in names:
        assert bool((state.params[k].detach() != before[k]).any()), k


def test_two_train_steps_match_jax(setup):
    jx, params_j, pcfg, make_port = setup
    pw = make_port()
    checker = make_port()  # takes the JAX side's weights before each gradient check
    state_p = pw.init_state()
    step_fn = pw.make_train_step()
    opt_state_j = jx.optimizer.init(params_j)
    batch = make_batch(1)
    clipped_j = []
    for step in (0, 1):
        parts_j, grads_j, u = jx.grads(params_j, batch, step, seed=10 + step)
        assert u.shape == (1, 2, H * W, 1, 3)
        # Every parameter's gradient by name, BatchNorm statistics included,
        # at equal weights. (After step 0 the two sides' own weights differ
        # a little, where Adam's first update took the sign of a gradient
        # too small to agree on.)
        from_jax.load_from_jax(checker.encoder, jax.device_get(params_j["params"]))
        parts_p, grads_p = port_grads(checker, batch, step, u)
        assert_parts_close(parts_p, parts_j, lpips_on=step >= LPIPS_FROM)
        assert_trees_close(grads_p, grads_j, pcfg, GRAD_RTOL, f"step {step} gradient")
        assert float(grads_p["backbone.resnet_backbone.model.bn1.running_var"].abs().max()) > 0

        updates, opt_state_j = jx.update_fn(grads_j, opt_state_j, params_j)
        params_j = optax.apply_updates(params_j, updates)
        norm = float(optax.global_norm(grads_j))
        clipped_j.append(jax.tree.map(lambda g: g * (CLIP / max(norm, CLIP)), grads_j))
        state_p, step_parts = step_fn(state_p, batch, u=torch.as_tensor(u))
        assert_parts_close({k: float(v) for k, v in step_parts.items()}, parts_j, lpips_on=step >= LPIPS_FROM)
    assert state_p.step == 2

    # Adam's moments after two steps (linear in the clipped gradients).
    adam_j = opt_state_j[-1][0]
    assert int(adam_j.count) == 2
    adam_p = state_p.optimizer.adam.state
    mu_p = {k: adam_p[p]["exp_avg"] for k, p in state_p.params.items()}
    nu_p = {k: adam_p[p]["exp_avg_sq"] for k, p in state_p.params.items()}
    # Twice the gradients' tolerance: the second step's gradients were taken
    # at each side's own, slightly different, weights.
    assert_trees_close(mu_p, adam_j.mu, pcfg, 2 * GRAD_RTOL, "first moment")
    nu_j = from_jax.state_dict_from_jax(jax.device_get(jax.tree.map(jnp.sqrt, adam_j.nu)["params"]), pcfg)
    for k, v in nu_p.items():  # compared as sqrt(nu): linear in |gradient|
        err = float((v.sqrt() - nu_j[k]).abs().max())
        assert err <= 2 * GRAD_RTOL * float(nu_j[k].max()) + 1e-12, f"second moment {k}: {err:.3g}"

    # Updated weights. Adam's first updates are ~lr * sign(gradient): where
    # both steps' gradients stand well clear of rounding (1 % of the
    # tensor's largest), the two sides move alike to 5 % of the distance
    # moved; elsewhere they may differ by the whole of it.
    want = from_jax.state_dict_from_jax(jax.device_get(params_j["params"]), pcfg)
    g0, g1 = (from_jax.state_dict_from_jax(jax.device_get(c["params"]), pcfg) for c in clipped_j)
    cfg = OptimizerCfg(lr=LR, warm_up_steps=WARM_UP)
    moved = learning_rate(cfg, 0) + learning_rate(cfg, 1)
    n_clear = 0
    for k, p in state_p.params.items():
        diff = (p.detach() - want[k]).abs()
        clear = (g0[k].abs() > 1e-2 * g0[k].abs().max()) & (g1[k].abs() > 1e-2 * g1[k].abs().max())
        n_clear += int(clear.sum())
        worst = float(diff[clear].max()) if bool(clear.any()) else 0.0
        assert worst <= 0.05 * moved, f"{k}: {worst:.3g} where both gradients are clear"
        assert float(diff.max()) <= 2.2 * moved, k
    assert n_clear > 10_000


@contextlib.contextmanager
def port_in_float64():
    """Let the port run in float64: its `.float()` casts (the bf16 policy's
    promotions to f32) keep float64, and `einsum` promotes mixed operands
    (the ViT's position-embedding resize matrix is float32)."""
    to_float, einsum = torch.Tensor.float, torch.einsum

    def keep_float64(self, *args, **kwargs):
        return self if self.dtype == torch.float64 else to_float(self, *args, **kwargs)

    def promoting_einsum(equation, *operands):
        if any(o.dtype == torch.float64 for o in operands):
            operands = [o.double() if o.is_floating_point() else o for o in operands]
        return einsum(equation, *operands)

    torch.Tensor.float, torch.einsum = keep_float64, promoting_einsum
    try:
        yield
    finally:
        torch.Tensor.float, torch.einsum = to_float, einsum


def as_float64(tree):
    return {k: as_float64(v) if isinstance(v, dict) else np.asarray(v, np.float64) for k, v in tree.items()}


def test_two_train_steps_float64_reference(setup, monkeypatch):
    """Which side drifts where `test_two_train_steps_match_jax` needs the
    default thread count. Both steps' gradients (at the JAX side's weights,
    as that test takes them) in float64 on both sides, the port in
    torch.float64 and the JAX package with x64 on, agree to 1e-5 of each
    tensor's largest entry (5.7e-7 measured), so they are the reference.
    Against it, at one thread, each of the port's f32 gradients holds the
    other test's GRAD_RTOL; on the tensor that fails there the JAX package's
    f32 gradient lies farther off than the port's (2.8e-3 and 1.9e-4)."""
    jx, params_j, pcfg, make_port = setup
    assert torch.get_num_threads() == 1
    batch = make_batch(1)

    def sampler_x64(key, pdf, num_samples):
        # The uniforms the f32 run drew from the same key (32 random bits
        # either way), recorded as JaxSide records them, then widened.
        u = jax.random.uniform(key, (*pdf.shape[:-1], num_samples), dtype=jnp.float32)
        jax.debug.callback(lambda x: jx.recorded.append(np.array(x)), u)
        normalized = pdf / (jx_distributions._EPS + pdf.sum(axis=-1, keepdims=True))
        cdf = jnp.cumsum(normalized, axis=-1)
        index = jnp.sum((cdf[..., :, None] <= u.astype(pdf.dtype)[..., None, :]).astype(jnp.int32), axis=-2)
        index = jnp.clip(index, 0, pdf.shape[-1] - 1)
        return index, jx_distributions.onehot_gather(normalized, index)

    # The depth sort keys stay f32 bit patterns, as the port's binner makes them.
    bitcast = jax.lax.bitcast_convert_type
    monkeypatch.setattr(slice_helpers.jx_depth_module, "sample_discrete_distribution", sampler_x64)
    monkeypatch.setattr(
        jax.lax, "bitcast_convert_type",
        lambda x, t: bitcast(x.astype(jnp.float32) if x.dtype == jnp.float64 and t == jnp.int32 else x, t),
    )

    opt_state_j = jx.optimizer.init(params_j)
    worst = {}
    for step in (0, 1):
        seed = 10 + step
        _, tree_j, u = jx.grads(params_j, batch, step, seed)
        weights = jax.device_get(params_j["params"])
        with jax.enable_x64(True):
            params64 = jax.tree.map(lambda x: jnp.asarray(np.asarray(x, np.float64)), params_j)
            _, grads64_j = jx.grad_fn(
                params64, jax.tree.map(jnp.asarray, as_float64(batch)), jnp.asarray(step), jax.random.PRNGKey(seed)
            )
            grads64_j = jax.device_get(grads64_j["params"])
        np.testing.assert_array_equal(jx.recorded[-1], u)
        assert {x.dtype for x in jax.tree.leaves(grads64_j)} == {np.dtype(np.float64)}
        reference = from_jax.state_dict_from_jax(grads64_j, pcfg)

        checker = make_port()
        from_jax.load_from_jax(checker.encoder, weights)
        _, grads_p = port_grads(checker, batch, step, u)
        checker.encoder.double()
        checker.losses[1].lpips.double()
        with port_in_float64():
            _, grads64_p = port_grads(checker, as_float64(batch), step, u.astype(np.float64))
        grads_j = from_jax.state_dict_from_jax(jax.device_get(tree_j["params"]), pcfg)

        def rel(got, name):
            return float((got[name].double() - reference[name]).abs().max()) / max(float(reference[name].abs().max()), 1e-30)

        for name in reference:
            assert grads64_p[name].dtype == torch.float64
            assert rel(grads64_p, name) <= 1e-5, f"step {step} float64 {name}: {rel(grads64_p, name):.3g}"
            assert rel(grads_p, name) <= GRAD_RTOL, f"step {step} port f32 {name}: {rel(grads_p, name):.3g}"
        rels = [rel(grads_p, name) for name in reference]
        assert float(np.median(rels)) <= 0.1 * GRAD_RTOL
        name = "backbone.resnet_backbone.model.layer1.1.conv1.weight"
        worst[step] = (rel(grads_p, name), rel(grads_j, name))

        updates, opt_state_j = jx.update_fn(tree_j, opt_state_j, params_j)
        params_j = optax.apply_updates(params_j, updates)
    port_off, jax_off = worst[1]
    assert port_off < GRAD_RTOL < jax_off, worst


def test_accumulate_two_equals_manual_average(setup):
    """`make_train_step(accumulate=2)` on a batch of 2: one clip and one Adam
    update on the mean of the two micro-batches' gradients."""
    _, _, _, make_port = setup
    batch = make_batch(2, b=2)
    u = torch.as_tensor(np.random.default_rng(5).uniform(0, 1, (2, 2, H * W, 1, 3)).astype(np.float32))

    manual = make_port()
    halves = []
    for i in range(2):
        mb = jax.tree.map(lambda x: x[i : i + 1], batch)
        parts, grads = port_grads(manual, mb, 0, u[i : i + 1])
        halves.append((parts, grads))
    state_m = manual.init_state()
    for k, p in state_m.params.items():
        p.grad = (halves[0][1][k] + halves[1][1][k]) * 0.5
    state_m.optimizer.step(0)

    accumulated = make_port()
    state_a, parts = accumulated.make_train_step(accumulate=2)(accumulated.init_state(), batch, u=u)
    assert state_a.step == 1
    for k in halves[0][0]:
        np.testing.assert_allclose(float(parts[k]), 0.5 * (halves[0][0][k] + halves[1][0][k]), rtol=1e-6, err_msg=k)
    for k, p in state_a.params.items():
        # The same arithmetic; .grad accumulates a + b where the manual path adds clones.
        assert torch.allclose(p.detach(), state_m.params[k].detach(), rtol=0, atol=1e-9), k
        assert torch.allclose(
            state_a.optimizer.adam.state[p]["exp_avg"],
            state_m.optimizer.adam.state[state_m.params[k]]["exp_avg"], rtol=1e-6, atol=1e-12,
        ), k
    with pytest.raises(ValueError, match="does not divide"):
        accumulated.make_train_step(accumulate=3)(state_a, batch, u=u)


def test_remat_encoder_equals_plain(setup):
    """Recomputing the encoder in the backward pass (the uniforms drawn
    before it, from the generator) changes no gradient."""
    _, _, _, make_port = setup
    batch = make_batch(3)
    results = []
    for remat in (False, True):
        pw = make_port(remat=remat)
        assert pw.train_cfg.remat_encoder is remat
        for p in pw.encoder.parameters():
            p.grad = None
        total, parts = pw.loss_fn(batch, LPIPS_FROM, generator=torch.Generator().manual_seed(9))
        total.backward()
        results.append((float(total.detach()), {k: p.grad.clone() for k, p in pw.encoder.named_parameters()}))
    (loss_a, grads_a), (loss_b, grads_b) = results
    assert loss_a == loss_b
    for k in grads_a:
        assert torch.equal(grads_a[k], grads_b[k]), k


def test_train_state_checkpoint_round_trip(setup, tmp_path):
    """ModelWrapper.state_dict / load_state_dict through training/checkpoint.py."""
    from pixelsplat_tpu_torch.training import checkpoint

    _, _, _, make_port = setup
    batch = make_batch(4)
    u = torch.as_tensor(np.random.default_rng(6).uniform(0, 1, (1, 2, H * W, 1, 3)).astype(np.float32))
    pw = make_port()
    state, _ = pw.make_train_step()(pw.init_state(), batch, u=u)
    path = checkpoint.save_checkpoint(tmp_path, state.step, pw.state_dict(state))
    assert path == checkpoint.latest_checkpoint(tmp_path) and path.name == "step_1"

    other = make_port()
    restored = other.load_state_dict(other.init_state(), checkpoint.load_checkpoint(path))
    assert restored.step == 1
    for k, p in state.params.items():
        assert torch.equal(p, restored.params[k]), k
    # Both continue alike.
    state, _ = pw.make_train_step()(state, batch, u=u)
    restored, _ = other.make_train_step()(restored, batch, u=u)
    for k, p in state.params.items():
        assert torch.equal(p, restored.params[k]), k
