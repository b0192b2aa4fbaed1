"""One training step of the production `re10k` model (with the epipolar
transformer) against the JAX package, on the CPU, at the small size of
`test_torch_re10k.py` (slim backbones included): loss parts, every gradient
by name, Adam's moments,
remat on against off, a strict `load_state_dict`, and the view order for
three context views drawn before the checkpoint.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelsplat_tpu.config import load_config
from pixelsplat_tpu.interop import torch_import
from pixelsplat_tpu.loss import LossMse as JxLossMse
from pixelsplat_tpu.loss import LossMseCfg as JxLossMseCfg
from pixelsplat_tpu.model.decoder import get_decoder
from pixelsplat_tpu.training import model_wrapper as jx_wrapper
from pixelsplat_tpu.training.optimizer import OptimizerCfg as JxOptimizerCfg
from pixelsplat_tpu_torch import config as pt_config
from pixelsplat_tpu_torch.interop import from_jax
from pixelsplat_tpu_torch.model.encoder.encoder_epipolar import EncoderEpipolar as PtEncoder
from pixelsplat_tpu_torch.training.model_wrapper import ModelWrapper as PtWrapper

import test_torch_encoder as enc_helpers
import test_torch_train_step as train_helpers
from test_torch_re10k import H, W, shrink_backbones, small_backbones, small_cfgs  # noqa: F401  (an autouse fixture)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: next to the other test processes, more threads
    only contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def train_setup():
    with pytest.MonkeyPatch.context() as mp:
        shrink_backbones(mp)
        jcfg, pcfg = small_cfgs()
        jdec_cfg = load_config(["+experiment=re10k"]).model.decoder
        _, pdec_cfg = pt_config.re10k()
        source = enc_helpers.randomize(PtEncoder(pcfg), seed=52)
        flax_params = torch_import.convert_encoder(source.state_dict(), jcfg)
        # MSE only: LPIPS's parity, and its VGG's compile time, belong to
        # `test_torch_train_step.py`.
        jw = jx_wrapper.ModelWrapper(
            JxOptimizerCfg(lr=train_helpers.LR, warm_up_steps=train_helpers.WARM_UP),
            jx_wrapper.TrainCfg(), jx_wrapper.TestCfg(),
            jcfg, get_decoder(jdec_cfg), [JxLossMse(JxLossMseCfg())], gradient_clip_val=train_helpers.CLIP,
        )

        def make_port(remat=False):
            pw = PtWrapper(
                pcfg, pdec_cfg, device="cpu",
                optimizer_cfg=train_helpers.OptimizerCfg(lr=train_helpers.LR, warm_up_steps=train_helpers.WARM_UP),
                train_cfg=train_helpers.TrainCfg(remat_encoder=remat),
                loss_cfgs=(train_helpers.LossMseCfg(),), gradient_clip_val=train_helpers.CLIP,
            )
            from_jax.load_from_jax(pw.encoder, flax_params)
            return pw

        yield train_helpers.JaxSide(jw, mp), {"params": jax.tree.map(jnp.asarray, flax_params)}, pcfg, make_port


PART_KEYS = {"loss/mse", "loss/total", "train/psnr_probabilistic", "train/overflow_pairs"}


def assert_parts_close(got, want):
    """As `test_torch_train_step.assert_parts_close`, without LPIPS: images
    agree to ~1e-4 of the largest colour, so their mean squares do to a few
    1e-5 relative."""
    assert got.keys() == want.keys() == PART_KEYS
    for key in ("loss/mse", "loss/total", "train/psnr_probabilistic"):
        np.testing.assert_allclose(got[key], want[key], rtol=5e-5, err_msg=key)
    assert got["train/overflow_pairs"] == want["train/overflow_pairs"] == 0.0


def test_re10k_train_step_matches_jax(train_setup):
    """One training step from step 0: the loss's parts, every parameter's
    gradient by name (the epipolar transformer's included) and Adam's
    moments after the update, under the tolerances of
    `test_torch_train_step.py`."""
    jx, params_j, pcfg, make_port = train_setup
    pw = make_port()
    batch = train_helpers.make_batch(5)
    parts_j, grads_j, u = jx.grads(params_j, batch, 0, seed=20)
    parts_p, grads_p = train_helpers.port_grads(pw, batch, 0, u)
    assert_parts_close(parts_p, parts_j)
    train_helpers.assert_trees_close(grads_p, grads_j, pcfg, train_helpers.GRAD_RTOL, "gradient")
    transformer = [k for k in grads_p if k.startswith("epipolar_transformer.")]
    assert len(transformer) == 35  # 1 + 1 layers in place of the 82 tensors of 2 + 2
    for k in transformer:
        assert float(grads_p[k].abs().max()) > 0, k

    # The update from these gradients, on both sides.
    _, opt_state_j = jx.update_fn(grads_j, jx.optimizer.init(params_j), params_j)
    state_p, step_parts = pw.make_train_step()(pw.init_state(), batch, u=torch.as_tensor(u))
    assert state_p.step == 1
    assert_parts_close({k: float(v) for k, v in step_parts.items()}, parts_j)
    adam_j = opt_state_j[-1][0]
    assert int(adam_j.count) == 1
    adam_p = state_p.optimizer.adam.state
    mu_p = {k: adam_p[p]["exp_avg"] for k, p in state_p.params.items()}
    train_helpers.assert_trees_close(mu_p, adam_j.mu, pcfg, train_helpers.GRAD_RTOL, "first moment")
    nu_j = from_jax.state_dict_from_jax(jax.device_get(jax.tree.map(jnp.sqrt, adam_j.nu)["params"]), pcfg)
    for k, p in state_p.params.items():  # compared as sqrt(nu): linear in |gradient|
        err = float((adam_p[p]["exp_avg_sq"].sqrt() - nu_j[k]).abs().max())
        assert err <= train_helpers.GRAD_RTOL * float(nu_j[k].max()) + 1e-12, f"second moment {k}: {err:.3g}"


def test_re10k_remat_equals_plain_and_strict_load(train_setup):
    """`remat_encoder` (the recipe's setting) changes no gradient, and a
    state_dict of one wrapper loads strictly into another."""
    _, _, _, make_port = train_setup
    batch = train_helpers.make_batch(7)
    results = []
    for remat in (False, True):
        pw = make_port(remat=remat)
        assert pw.train_cfg.remat_encoder is remat
        for p in pw.encoder.parameters():
            p.grad = None
        total, _ = pw.loss_fn(batch, 0, generator=torch.Generator().manual_seed(9))
        total.backward()
        results.append((float(total.detach()), {k: p.grad.clone() for k, p in pw.encoder.named_parameters()}))
    (loss_a, grads_a), (loss_b, grads_b) = results
    assert loss_a == loss_b
    for k in grads_a:
        assert torch.equal(grads_a[k], grads_b[k]), k

    other = make_port()
    with torch.no_grad():
        for p in other.encoder.parameters():
            p.zero_()
    state = other.load_state_dict(other.init_state(), pw.state_dict(pw.init_state()))
    assert state.step == 0
    for k, v in pw.encoder.state_dict().items():
        assert torch.equal(other.encoder.state_dict()[k], v), k
    broken = {k: v for k, v in pw.encoder.state_dict().items() if "to_kv" not in k}
    with pytest.raises(RuntimeError, match="to_kv"):
        other.encoder.load_state_dict(broken, strict=True)


def test_view_order_is_drawn_before_the_checkpoint():
    """With three context views the view embeddings' order is random; the
    wrapper draws it once, before the (rematerialized) encoder, so remat on
    and off see the same order, which is one of the two possible ones."""
    _, pcfg = small_cfgs(num_context_views=3)
    _, pdec_cfg = pt_config.re10k()
    rng = np.random.default_rng(53)
    batch = train_helpers.make_batch(8)
    c = batch["context"]
    extr = np.tile(np.eye(4, dtype=np.float32), (1, 3, 1, 1))
    extr[0, :, 0, 3] = [0.0, 0.5, 1.0]
    batch["context"] = {
        "image": rng.uniform(0, 1, (1, 3, 3, H, W)).astype(np.float32),
        "extrinsics": extr,
        "intrinsics": np.tile(c["intrinsics"][:, :1], (1, 3, 1, 1)),
        "near": np.ones((1, 3), np.float32),
        "far": np.full((1, 3), 100.0, np.float32),
    }
    u = torch.as_tensor(rng.uniform(0, 1, (1, 3, H * W, 1, 3)).astype(np.float32))
    weights = enc_helpers.randomize(PtEncoder(pcfg), seed=54).state_dict()
    assert "epipolar_transformer.view_embeddings.weight" in weights
    losses = {}
    for remat in (False, True):
        pw = PtWrapper(
            pcfg, pdec_cfg, device="cpu", train_cfg=train_helpers.TrainCfg(remat_encoder=remat),
            loss_cfgs=(train_helpers.LossMseCfg(),),
        )
        pw.encoder.load_state_dict(weights)
        total, _ = pw.loss_fn(batch, 0, generator=torch.Generator().manual_seed(0), u=u)
        total.backward()
        assert pw.encoder.epipolar_transformer.view_embeddings.weight.grad.abs().max() > 0
        losses[remat] = float(total.detach())
    assert losses[False] == losses[True]
    given = PtWrapper(pcfg, pdec_cfg, device="cpu", loss_cfgs=(train_helpers.LossMseCfg(),))
    given.encoder.load_state_dict(weights)
    with torch.no_grad():
        by_order = {
            order: float(given.loss_fn(batch, 0, u=u, view_order=torch.tensor(order))[0])
            for order in ((0, 1), (1, 0))
        }
    assert by_order[(0, 1)] != by_order[(1, 0)]  # the order matters
    assert losses[False] in by_order.values()  # and the drawn one is one of the two
