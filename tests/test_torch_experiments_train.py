"""One training step of `re10k_3_view` and of
`re10k_ablation_no_probabilistic_sampling` against the JAX package, on the
CPU, at the size of `test_torch_experiments.py`: the loss's parts and every
parameter's gradient by name, with the JAX step's uniforms and (three
context views) view-embedding order handed to the port. MSE only, as in
`test_torch_re10k_train.py` (LPIPS's parity is `test_torch_train_step.py`'s).
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from pixelsplat_tpu.interop import torch_import
from pixelsplat_tpu.loss import LossMse as JxLossMse
from pixelsplat_tpu.loss import LossMseCfg as JxLossMseCfg
from pixelsplat_tpu.model.decoder import get_decoder
from pixelsplat_tpu.training import model_wrapper as jx_wrapper
from pixelsplat_tpu.training.optimizer import OptimizerCfg as JxOptimizerCfg
from pixelsplat_tpu_torch.interop import from_jax
from pixelsplat_tpu_torch.model.encoder.encoder_epipolar import EncoderEpipolar as PtEncoder
from pixelsplat_tpu_torch.training.model_wrapper import ModelWrapper as PtWrapper

import test_torch_encoder as enc_helpers
import test_torch_experiments as exp_helpers
import test_torch_re10k as re10k_helpers
import test_torch_re10k_train as re10k_train
import test_torch_train_step as train_helpers
from test_torch_re10k import small_backbones  # noqa: F401  (an autouse fixture)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: next to the other test processes, more threads
    only contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("experiment", [exp_helpers.THREE_VIEW, exp_helpers.SINGLE])
def test_experiment_train_step_matches_jax(experiment):
    with pytest.MonkeyPatch.context() as mp:
        re10k_helpers.shrink_backbones(mp)
        jcfg, pcfg, jdec, pdec = exp_helpers.experiment_cfgs(experiment)
        source = enc_helpers.randomize(PtEncoder(pcfg), seed=92)
        flax_params = torch_import.convert_encoder(source.state_dict(), jcfg)
        jw = jx_wrapper.ModelWrapper(
            JxOptimizerCfg(lr=train_helpers.LR, warm_up_steps=train_helpers.WARM_UP),
            jx_wrapper.TrainCfg(), jx_wrapper.TestCfg(), jcfg, get_decoder(jdec),
            [JxLossMse(JxLossMseCfg())], gradient_clip_val=train_helpers.CLIP,
        )
        orders = exp_helpers.record_view_orders(mp)
        jx = train_helpers.JaxSide(jw, mp)
        views = pcfg.num_context_views
        batch = exp_helpers.with_context_views(train_helpers.make_batch(93), views, seed=94)
        parts_j, grads_j, u = jx.grads({"params": jax.tree.map(jnp.asarray, flax_params)}, batch, 0, seed=95)
        assert u.shape == (1, views, exp_helpers.H * exp_helpers.W, 1, pcfg.gaussians_per_pixel)

        pw = PtWrapper(
            pcfg, pdec, device="cpu",
            optimizer_cfg=train_helpers.OptimizerCfg(lr=train_helpers.LR, warm_up_steps=train_helpers.WARM_UP),
            train_cfg=train_helpers.TrainCfg(), loss_cfgs=(train_helpers.LossMseCfg(),),
            gradient_clip_val=train_helpers.CLIP,
        )
        from_jax.load_from_jax(pw.encoder, flax_params)
        view_order = None
        if views > 2:
            assert len(orders) == 1
            view_order = torch.as_tensor(orders[0])
        for p in pw.encoder.parameters():
            p.grad = None
        total, parts = pw.loss_fn(batch, 0, u=torch.as_tensor(u), view_order=view_order)
        total.backward()
        grads_p = {k: p.grad.clone() for k, p in pw.encoder.named_parameters()}

    re10k_train.assert_parts_close({k: float(v) for k, v in parts.items()}, parts_j)
    train_helpers.assert_trees_close(grads_p, grads_j, pcfg, train_helpers.GRAD_RTOL, "gradient")
    if views > 2:
        assert float(grads_p["epipolar_transformer.view_embeddings.weight"].abs().max()) > 0
    for k, g in grads_p.items():
        assert bool(torch.isfinite(g).all()), k
