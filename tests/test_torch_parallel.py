"""The port across processes (`pixelsplat_tpu_torch/parallel`, the
data-parallel train step, `fit` and `main` on two ranks) against the JAX
package and against one process, on the CPU.

Ranks are JAX-free subprocesses (torch only, one intra-op thread) that
join a gloo group through a `FileStore` in the test's `tmp_path`
(`PIXELSPLAT_COORDINATOR=file://...`), so parallel test workers never
share a port. The model is `test_torch_train_step.py`'s tiny
`re10k_ablation_no_epipolar_transformer` at 64x64, 2 context and 2 target
views, trained with MSE (LPIPS's parity belongs to that file), clip 0.5 and
Adam with a 4-step warm-up to 1e-4.

The JAX reference is the manual data-parallel step of
`tests/test_multidevice_train_step.py`, which holds it against the JAX
`shard_map` step on 8 devices: each example's gradient with the key
`fold_in(rng, i)`, averaged, one update. The uniforms those keys draw are
recorded and handed to the ranks, rank i taking example i.

Tolerances: against JAX, the loss to 1e-5 relative and the weights by name
to rtol 2e-3 / atol 5e-4 (`test_multidevice_train_step.py`'s), the
averaged and clipped gradients per tensor as `test_torch_train_step.py`
holds gradients. Against one process taking the same global batch as 2
accumulated micro-batches: the two compute the same sums (g0 + g1 on
either side, then x 0.5) on the same inputs at one thread each, so the
weights, gradients and loss parts to ONE_PROCESS_ATOL; measured equal bit
for bit.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

from pixelsplat_tpu.interop import torch_import
from pixelsplat_tpu.loss import LossMse as JxLossMse
from pixelsplat_tpu.loss import LossMseCfg as JxLossMseCfg
from pixelsplat_tpu.model.decoder import get_decoder
from pixelsplat_tpu.model.encoder.backbone import dino as jx_dino
from pixelsplat_tpu.parallel.mesh import make_mesh
from pixelsplat_tpu.training import model_wrapper as jx_wrapper
from pixelsplat_tpu.training.optimizer import OptimizerCfg as JxOptimizerCfg
from pixelsplat_tpu_torch import config as pt_config
from pixelsplat_tpu_torch.interop import from_jax
from pixelsplat_tpu_torch.loss import LossMseCfg
from pixelsplat_tpu_torch.model.decoder.decoder_splatting import DecoderSplatting, DecoderSplattingCfg
from pixelsplat_tpu_torch.model.encoder.backbone import dino as pt_dino
from pixelsplat_tpu_torch.model.encoder.encoder_epipolar import EncoderEpipolar as PtEncoder
from pixelsplat_tpu_torch.model.types import Gaussians
from pixelsplat_tpu_torch.ops.rasterizer.render import RenderSettings
from pixelsplat_tpu_torch.parallel import distributed, mesh
from pixelsplat_tpu_torch.scripts.profile_protocol import write_scene_set
from pixelsplat_tpu_torch.scripts.train_fixture import write_train_root
from pixelsplat_tpu_torch.training.checkpoint import save_checkpoint
from pixelsplat_tpu_torch.training.model_wrapper import ModelWrapper as PtWrapper
from pixelsplat_tpu_torch.training.model_wrapper import effective_accumulate
from pixelsplat_tpu_torch.training.optimizer import OptimizerCfg

import test_torch_encoder as enc_helpers
import test_torch_eval_protocol as protocol_helpers
import test_torch_fit as fit_helpers
import test_torch_re10k as re10k_helpers
import test_torch_slice as slice_helpers
import test_torch_train_step as train_helpers

ROOT = Path(__file__).resolve().parent.parent
H = W = train_helpers.H
LR, WARM_UP, CLIP = train_helpers.LR, train_helpers.WARM_UP, train_helpers.CLIP
WORLD = 2
STEP_KEY = 11
LOSS_RTOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 2e-3, 5e-4
ONE_PROCESS_ATOL = 1e-7
RENDER_SETTINGS = RenderSettings(capacity=64, big_capacity=8, chunk=64)

# Run in each rank: join the group the environment names, then the mode's
# work on the inputs the parent wrote; the results go to rank<r>.pt.
RANK = r"""
import dataclasses, json, sys
from pathlib import Path
import torch
torch.set_num_threads(1)
from pixelsplat_tpu_torch import config as pt_config
from pixelsplat_tpu_torch.model.encoder.backbone import dino, resnet
from pixelsplat_tpu_torch.parallel import distributed, mesh

tmp, mode = Path(sys.argv[1]), sys.argv[2]
inputs = torch.load(tmp / "inputs.pt", weights_only=False)
dino.VIT_SPECS["tiny"] = inputs["tiny"]
if "slim_trunk" in inputs:
    resnet.RESNET_SPECS["dino_resnet50"] = inputs["slim_trunk"]
out = {}

if mode == "step":
    from pixelsplat_tpu_torch.loss import LossMseCfg
    from pixelsplat_tpu_torch.training.model_wrapper import ModelWrapper
    from pixelsplat_tpu_torch.training.optimizer import OptimizerCfg

    rank, world = distributed.maybe_initialize("cpu")
    encoder_cfg, decoder_cfg = pt_config.re10k_ablation_no_epipolar_transformer()
    encoder_cfg = dataclasses.replace(
        encoder_cfg, d_feature=32, backbone=dataclasses.replace(encoder_cfg.backbone, model="tiny", d_out=64))
    wrapper = ModelWrapper(encoder_cfg, decoder_cfg, device="cpu", optimizer_cfg=OptimizerCfg(*inputs["optimizer"]),
                           loss_cfgs=(LossMseCfg(),), gradient_clip_val=inputs["clip"])
    wrapper.encoder.load_state_dict(inputs["weights"])
    state = wrapper.init_state()
    step_fn = wrapper.make_train_step()
    u = inputs["u"][mesh.rank_slice(len(inputs["u"]), rank, world)]
    state, parts = step_fn(state, mesh.shard_batch(inputs["batch"], rank, world), u=u)
    out = dict(params={k: p.detach() for k, p in state.params.items()},
               grads={k: p.grad for k, p in state.params.items()},
               parts={k: float(v) for k, v in parts.items()}, reduced_bytes=step_fn.reduced_bytes,
               rank_world=distributed.maybe_initialize("cpu"))
    distributed.destroy()
elif mode == "render":
    from pixelsplat_tpu_torch.model.decoder.decoder_splatting import DecoderSplatting, DecoderSplattingCfg
    from pixelsplat_tpu_torch.parallel.render import render_views_sharded

    rank, world = distributed.maybe_initialize("cpu")
    decoder = DecoderSplatting(DecoderSplattingCfg(render=inputs["settings"]))
    for name, depth_mode in (("color", None), ("depth", "depth")):
        o = render_views_sharded(decoder, inputs["gaussians"], *inputs["cameras"], (inputs["h"], inputs["w"]),
                                 depth_mode=depth_mode)
        out[name] = dict(color=o.color, depth=o.depth, overflow=int(o.overflow))
    distributed.destroy()
elif mode == "main":
    from pixelsplat_tpu_torch import main as cli
    from pixelsplat_tpu_torch.dataset.data_module import DataModule
    from pixelsplat_tpu_torch.training import trainer
    from pixelsplat_tpu_torch.utils.benchmarker import Benchmarker
    from pixelsplat_tpu_torch.utils.local_logger import LocalLogger

    calls = {"save_checkpoint": 0, "log_metrics": 0, "log_image": 0, "dump": 0, "dump_memory": 0}

    def counted(owner, name):
        original = getattr(owner, name)
        def wrapped(*a, **k):
            calls[name] += 1
            return original(*a, **k)
        setattr(owner, name, wrapped)

    counted(trainer, "save_checkpoint")
    for name in ("log_metrics", "log_image"):
        counted(LocalLogger, name)
    for name in ("dump", "dump_memory"):
        counted(Benchmarker, name)
    read = []
    make_loader = DataModule.train_dataloader

    def train_dataloader(self):
        for batch in make_loader(self):
            read.append((batch["scene"][0], batch["context"]["index"][0].tolist()))
            yield batch

    DataModule.train_dataloader = train_dataloader
    result = cli.main(inputs["argv"], device="cpu")
    out = dict(calls=calls, read=read, initialized_after=torch.distributed.is_initialized())
    if isinstance(result, dict):  # mode=test: this rank's summary
        out["summary"] = result
    else:
        out.update(params={k: p.detach() for k, p in result.params.items()}, step=result.step)
import os
torch.save(out, tmp / f"rank{os.environ['PIXELSPLAT_PROCESS_ID']}.pt")
"""


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def run_ranks(tmp: Path, mode: str, world: int = WORLD, timeout: int = 240) -> list[dict]:
    """Start `world` JAX-free ranks on `tmp/inputs.pt`, wait for all, and
    return each rank's results."""
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "PIXELSPLAT_DISTRIBUTED")}
    env.update(PYTHONPATH=str(ROOT), PIXELSPLAT_COORDINATOR=f"file://{tmp / 'store'}",
               PIXELSPLAT_NUM_PROCESSES=str(world), OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", RANK, str(tmp), mode], env={**env, "PIXELSPLAT_PROCESS_ID": str(r)}, cwd=tmp,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for r in range(world)
    ]
    outputs = [p.communicate(timeout=timeout) for p in procs]
    for r, (p, (stdout, stderr)) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"rank {r}:\n{stdout[-2000:]}\n{stderr[-4000:]}"
    return [dict(torch.load(tmp / f"rank{r}.pt", weights_only=False), stdout=stdout) for r, (stdout, _) in enumerate(outputs)]


# ---------------------------------------------------------------------------
# The data-parallel step


@pytest.fixture(scope="module")
def step_runs(tmp_path_factory):
    """The JAX manual data-parallel step, the one-process `accumulate=2`
    step and the two-rank step, on one global batch of 2."""
    tmp = tmp_path_factory.mktemp("step")
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jx_dino.VIT_SPECS, "tiny", enc_helpers.TINY)
        mp.setitem(pt_dino.VIT_SPECS, "tiny", enc_helpers.TINY)
        jcfg, pcfg = enc_helpers.tiny_encoder_cfgs()
        from pixelsplat_tpu.config import load_config

        jdec_cfg = load_config(["+experiment=re10k_ablation_no_epipolar_transformer"]).model.decoder
        _, pdec_cfg = pt_config.re10k_ablation_no_epipolar_transformer()
        source = enc_helpers.randomize(PtEncoder(pcfg), seed=41)
        params = {"params": jax.tree.map(jnp.asarray, torch_import.convert_encoder(source.state_dict(), jcfg))}
        jw = jx_wrapper.ModelWrapper(
            JxOptimizerCfg(lr=LR, warm_up_steps=WARM_UP), jx_wrapper.TrainCfg(), jx_wrapper.TestCfg(),
            jcfg, get_decoder(jdec_cfg), [JxLossMse(JxLossMseCfg())], gradient_clip_val=CLIP,
        )
        recorded = []
        original = slice_helpers.jx_depth_module.sample_discrete_distribution

        def recording(key, pdf, num_samples):
            u = jax.random.uniform(key, (*pdf.shape[:-1], num_samples), dtype=pdf.dtype)
            jax.debug.callback(lambda x: recorded.append(np.array(x)), u)
            return original(key, pdf, num_samples)

        mp.setattr(slice_helpers.jx_depth_module, "sample_discrete_distribution", recording)
        grad_fn = jax.jit(jax.value_and_grad(jw.loss_fn, has_aux=True))
        batch = train_helpers.make_batch(7, b=WORLD)
        rng = jax.random.PRNGKey(STEP_KEY)
        grads_sum, losses = None, []
        for i in range(WORLD):
            example = jax.tree.map(lambda x: jnp.asarray(x[i : i + 1]), batch)
            (_, parts), grads = grad_fn(params, example, jnp.asarray(0), jax.random.fold_in(rng, i))
            jax.block_until_ready(grads)
            losses.append(float(parts["loss/total"]))
            grads_sum = grads if grads_sum is None else jax.tree.map(jnp.add, grads_sum, grads)
        assert len(recorded) == WORLD

        @jax.jit
        def update(params, grads_sum):
            grads_avg = jax.tree.map(lambda g: g / WORLD, grads_sum)
            updates, _ = jw.optimizer.update(grads_avg, jw.optimizer.init(params), params)
            norm = optax.global_norm(grads_avg)
            clipped = jax.tree.map(lambda g: g * (CLIP / jnp.maximum(norm, CLIP)), grads_avg)
            return optax.apply_updates(params, updates), clipped

        jax_params, jax_clipped = update(params, grads_sum)
        u = torch.as_tensor(np.concatenate(recorded))
        assert u.shape == (WORLD, 2, H * W, 1, 3)

        # One process: the global batch as two accumulated micro-batches.
        one = PtWrapper(pcfg, pdec_cfg, device="cpu", optimizer_cfg=OptimizerCfg(lr=LR, warm_up_steps=WARM_UP),
                        loss_cfgs=(LossMseCfg(),), gradient_clip_val=CLIP)
        one.encoder.load_state_dict(source.state_dict())
        state, one_parts = one.make_train_step(accumulate=WORLD)(one.init_state(), batch, u=u)
        one_process = dict(params={k: p.detach() for k, p in state.params.items()},
                           grads={k: p.grad for k, p in state.params.items()},
                           parts={k: float(v) for k, v in one_parts.items()})

        torch.save(dict(tiny=enc_helpers.TINY, optimizer=(LR, WARM_UP), clip=CLIP, weights=source.state_dict(),
                        batch=batch, u=u), tmp / "inputs.pt")
        ranks = run_ranks(tmp, "step")
        yield dict(pcfg=pcfg, jax_params=jax_params, jax_clipped=jax_clipped, jax_loss=float(np.mean(losses)),
                   one=one_process, ranks=ranks)


def test_two_ranks_match_jax_data_parallel_step(step_runs):
    pcfg, ranks = step_runs["pcfg"], step_runs["ranks"]
    for r, out in enumerate(ranks):
        assert out["rank_world"] == (r, WORLD)
        np.testing.assert_allclose(out["parts"]["loss/total"], step_runs["jax_loss"], rtol=LOSS_RTOL)
        assert out["parts"]["train/overflow_pairs"] == 0.0
    want = from_jax.state_dict_from_jax(jax.device_get(step_runs["jax_params"]["params"]), pcfg)
    got = ranks[0]["params"]
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=PARAM_RTOL, atol=PARAM_ATOL, err_msg=k)
    # The averaged, clipped gradient each rank handed to Adam, by name.
    train_helpers.assert_trees_close(ranks[0]["grads"], step_runs["jax_clipped"], pcfg, train_helpers.GRAD_RTOL,
                                     "mean gradient")


def test_two_ranks_match_one_process_accumulating(step_runs):
    one, ranks = step_runs["one"], step_runs["ranks"]
    for out in ranks:
        assert out["parts"].keys() == one["parts"].keys()
        for k, v in one["parts"].items():
            assert abs(out["parts"][k] - v) <= ONE_PROCESS_ATOL * max(1.0, abs(v)), k
    worst = 0.0
    for k, p in one["params"].items():
        worst = max(worst, float((ranks[0]["params"][k] - p).abs().max()), float((ranks[0]["grads"][k] - one["grads"][k]).abs().max()))
    assert worst <= ONE_PROCESS_ATOL, worst
    # The all-reduce moved every gradient and the loss parts, in f32.
    n = sum(p.numel() for p in one["params"].values()) + len(one["parts"])
    assert ranks[0]["reduced_bytes"] == 4 * n


def test_replicas_equal_after_the_step(step_runs):
    a, b = (r["params"] for r in step_runs["ranks"])
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_accumulate_clamp_follows_jax(capsys):
    """`effective_accumulate` against the clamp inside the JAX
    `make_jit_train_step` (message and value), per-rank batch x accumulate."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jx_dino.VIT_SPECS, "tiny", enc_helpers.TINY)
        jcfg, _ = enc_helpers.tiny_encoder_cfgs()
        jw = jx_wrapper.ModelWrapper(
            JxOptimizerCfg(), jx_wrapper.TrainCfg(), jx_wrapper.TestCfg(), jcfg,
            get_decoder(jx_config_decoder()), [],
        )
        one_device = make_mesh(1)
        for batch in range(1, 9):
            for accumulate in range(1, 9):
                capsys.readouterr()
                jw.make_jit_train_step(one_device, batch_size=batch, accumulate=accumulate)
                jax_message = capsys.readouterr().out
                got = effective_accumulate(batch, accumulate)
                assert capsys.readouterr().out == jax_message, (batch, accumulate)
                want = int(jax_message.split("using ")[1]) if jax_message else accumulate
                assert got == want and batch % got == 0 and got <= accumulate, (batch, accumulate)
    assert effective_accumulate(7, 7) == 7 and effective_accumulate(1, 7) == 1 and effective_accumulate(6, 4) == 3


def jx_config_decoder():
    from pixelsplat_tpu.config import load_config

    return load_config(["+experiment=re10k_ablation_no_epipolar_transformer"]).model.decoder


# ---------------------------------------------------------------------------
# Process wiring


def test_maybe_initialize_without_environment(monkeypatch):
    for name in ("RANK", "WORLD_SIZE", "PIXELSPLAT_COORDINATOR", "PIXELSPLAT_DISTRIBUTED", "SLURM_PROCID"):
        monkeypatch.delenv(name, raising=False)
    assert distributed.read_wiring() is None
    assert distributed.maybe_initialize("cpu") == (0, 1)
    assert not dist.is_initialized()
    assert distributed.rank_and_world() == (0, 1) and distributed.is_rank_zero()
    assert distributed.local_device("cuda") == torch.device("cuda", 0)
    assert distributed.rank_seed(7, 0) == 7 and distributed.rank_seed(7, 1) != 7


@pytest.mark.parametrize(
    "env, want",
    [
        (dict(RANK="3", WORLD_SIZE="8", LOCAL_RANK="1", MASTER_ADDR="n0", MASTER_PORT="1234"), (3, 8, 1, "env://")),
        (dict(PIXELSPLAT_COORDINATOR="10.0.0.1:4321", PIXELSPLAT_NUM_PROCESSES="4", PIXELSPLAT_PROCESS_ID="2"),
         (2, 4, 2, "tcp://10.0.0.1:4321")),
        (dict(PIXELSPLAT_COORDINATOR="file:///shared/store", PIXELSPLAT_NUM_PROCESSES="2",
              PIXELSPLAT_PROCESS_ID="1", LOCAL_RANK="0"), (1, 2, 0, "file:///shared/store")),
        (dict(PIXELSPLAT_DISTRIBUTED="1", SLURM_PROCID="5", SLURM_NTASKS="16", SLURM_LOCALID="1",
              SLURM_JOB_NODELIST="gpu[03-05,07]"), (5, 16, 1, "tcp://gpu03:29500")),
        (dict(PIXELSPLAT_DISTRIBUTED="1", SLURM_PROCID="0", SLURM_NTASKS="2", SLURM_LOCALID="0",
              SLURM_JOB_NODELIST="a1,a2", MASTER_ADDR="head", MASTER_PORT="777"), (0, 2, 0, "tcp://head:777")),
    ],
    ids=["torchrun", "pixelsplat_tcp", "pixelsplat_file", "slurm_nodelist", "slurm_master"],
)
def test_environment_maps_to_rank_and_world(env, want):
    wiring = distributed.read_wiring(env)
    assert (wiring.rank, wiring.world_size, wiring.local_rank, wiring.init_method) == want


def test_maybe_initialize_joins_once(tmp_path, monkeypatch):
    """One gloo process through a FileStore: the group comes up once, a
    second call reports it, and `main`'s `destroy` leaves it."""
    monkeypatch.setenv("PIXELSPLAT_COORDINATOR", f"file://{tmp_path / 'store'}")
    monkeypatch.setenv("PIXELSPLAT_NUM_PROCESSES", "1")
    monkeypatch.setenv("PIXELSPLAT_PROCESS_ID", "0")
    monkeypatch.delenv("RANK", raising=False)
    assert not dist.is_initialized()
    try:
        assert distributed.maybe_initialize("cpu") == (0, 1)
        assert dist.is_initialized() and dist.get_backend() == "gloo"
        group = dist.group.WORLD
        assert distributed.maybe_initialize("cpu") == (0, 1)
        assert dist.group.WORLD is group
        # Over one rank the all-reduce mean is the identity.
        x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
        y = torch.ones(4, dtype=torch.float64)
        assert mesh.all_reduce_mean_([x, y]) == 6 * 4 + 4 * 8
        assert torch.equal(x, torch.arange(6, dtype=torch.float32).reshape(2, 3)) and torch.equal(y, torch.ones(4, dtype=torch.float64))
    finally:
        distributed.destroy()
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="outside SLURM"):
        distributed.read_wiring({"PIXELSPLAT_DISTRIBUTED": "1"})


def test_shard_batch_and_rank_slice():
    batch = {"a": np.arange(6), "b": {"c": torch.arange(12).reshape(6, 2)}, "scene": list("abcdef")}
    parts = [mesh.shard_batch(batch, r, 3) for r in range(3)]
    assert [p["scene"] for p in parts] == [["a", "b"], ["c", "d"], ["e", "f"]]
    assert np.array_equal(np.concatenate([p["a"] for p in parts]), batch["a"])
    assert torch.equal(torch.cat([p["b"]["c"] for p in parts]), batch["b"]["c"])
    with pytest.raises(ValueError, match="does not split"):
        mesh.rank_slice(5, 0, 2)


# ---------------------------------------------------------------------------
# View-sharded rendering


def test_render_views_sharded_equals_one_process(tmp_path):
    """5 target views over 2 ranks (padded to 6, the last camera repeated,
    the pad dropped), colour and depth, against the one-process decoder at
    `tests/test_parallel_render.py`'s tolerance."""
    rng = np.random.default_rng(3)
    b, g, v = 1, 64, 5
    means = rng.uniform(-0.5, 0.5, (b, g, 3)).astype(np.float32)
    means[..., 2] += 3.0
    harmonics = np.zeros((b, g, 3, 25), np.float32)
    harmonics[..., 0] = rng.uniform(0, 1, (b, g, 3)) / 0.2821
    gaussians = Gaussians(
        torch.as_tensor(means), torch.eye(3).expand(b, g, 3, 3) * 1e-3, torch.as_tensor(harmonics),
        torch.as_tensor(rng.uniform(0.4, 0.9, (b, g)).astype(np.float32)),
    )
    extrinsics = torch.eye(4).repeat(b, v, 1, 1)
    extrinsics[:, :, 0, 3] = torch.linspace(-0.2, 0.2, v)
    intrinsics = torch.tensor([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1.0]]).repeat(b, v, 1, 1)
    cameras = (extrinsics, intrinsics, torch.ones(b, v), torch.full((b, v), 100.0))
    torch.save(dict(tiny=enc_helpers.TINY, settings=RENDER_SETTINGS, gaussians=gaussians, cameras=cameras, h=32, w=32),
               tmp_path / "inputs.pt")
    ranks = run_ranks(tmp_path, "render")

    decoder = DecoderSplatting(DecoderSplattingCfg(render=RENDER_SETTINGS))
    for name, depth_mode in (("color", None), ("depth", "depth")):
        want = decoder(gaussians, *cameras, (32, 32), depth_mode=depth_mode)
        for out in ranks:
            got = out[name]
            assert got["color"].shape == want.color.shape == (b, v, 3, 32, 32)
            np.testing.assert_allclose(got["color"].numpy(), want.color.numpy(), rtol=1e-5, atol=1e-5)
            assert got["overflow"] == int(want.overflow) == 0
            if depth_mode is None:
                assert got["depth"] is None
            else:
                assert got["depth"].shape == (b, v, 32, 32) and bool(got["depth"].isfinite().all())
                np.testing.assert_allclose(got["depth"].numpy(), want.depth.numpy(), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# `main` on two ranks


def test_main_trains_on_two_ranks(tmp_path_factory):
    """`main` `mode=train` in each of two gloo ranks (the tiny `re10k` of
    `test_torch_fit.py`, the fixture's train split, 2 steps, validation and
    a checkpoint every 2): only rank 0 saves, logs, validates and writes the
    benchmark files; the ranks read different examples; both end on the
    same weights; each leaves its group."""
    tmp = tmp_path_factory.mktemp("main")
    root = write_train_root(tmp / "re10k", copies=2)
    out = tmp / "out"
    argv = fit_helpers.train_argv(root, out, "loss=[mse]", "trainer.max_steps=2")
    torch.save(dict(tiny=enc_helpers.TINY, slim_trunk=re10k_helpers.SLIM_TRUNK, argv=argv), tmp / "inputs.pt")
    ranks = run_ranks(tmp, "main")
    for r, result in enumerate(ranks):
        assert f"mode=train rank={r}/{WORLD} device=cpu" in result["stdout"]
        assert result["step"] == 2 and not result["initialized_after"]
    zero, one = (r["calls"] for r in ranks)
    assert zero == {"save_checkpoint": 1, "log_metrics": 3, "log_image": 1, "dump": 1, "dump_memory": 1}, zero
    assert one == {k: 0 for k in one}, one
    assert sorted(p.name for p in (out / "checkpoints").iterdir()) == ["step_2"]
    logged = [json.loads(x) for x in (out / "local" / "metrics.jsonl").read_text().splitlines()]
    assert [x["step"] for x in logged] == [1, 2, 2]  # two steps' losses, one validation
    assert [p.name for p in (out / "local" / "comparison").iterdir()] == ["000002.png"]
    assert (out / "benchmark.json").exists() and (out / "peak_memory.json").exists()
    # Each rank drew its own examples: the first batch and one after each step.
    reads = [r["read"] for r in ranks]
    assert len(reads[0]) == len(reads[1]) == 3 and reads[0] != reads[1], reads
    a, b = (r["params"] for r in ranks)
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def test_main_tests_on_two_ranks(tmp_path, monkeypatch):
    """`main` `mode=test` on two gloo ranks over a root of two chunks (one
    fixture scene each): the data module gives each rank one chunk, each
    rank writes its own scene's PNGs and returns its own scene's summary,
    and only rank 0 writes the benchmark files."""
    re10k_helpers.shrink_backbones(monkeypatch)
    root, index = write_scene_set(tmp_path / "re10k", copies=1, chunks=2)
    out = tmp_path / "test"
    argv = [a for a in protocol_helpers.PROTOCOL if not a.startswith(("dataset.roots", "dataset.view_sampler.index"))]
    argv += [f"dataset.roots=[{root}]", f"dataset.view_sampler.index_path={index}", f"test.output_path={out}",
             f"output_dir={tmp_path / 'outputs'}"]
    cfg = pt_config.load_config(argv)
    wrapper = PtWrapper(cfg.model.encoder, cfg.model.decoder, device="cpu")
    checkpoint = save_checkpoint(tmp_path / "checkpoints", 0, wrapper.state_dict(wrapper.init_state()))
    torch.save(dict(tiny=enc_helpers.TINY, slim_trunk=re10k_helpers.SLIM_TRUNK,
                    argv=argv + [f"checkpointing.load={checkpoint}"]), tmp_path / "inputs.pt")
    ranks = run_ranks(tmp_path, "main")
    scenes = sorted(p.name for p in (out / "pixelsplat_tpu").iterdir() if p.is_dir())
    assert scenes == ["fixture_scene_a_0000", "fixture_scene_b_0000"]
    for r, result in enumerate(ranks):
        assert f"mode=test rank={r}/{WORLD} device=cpu" in result["stdout"]
        summary = result["summary"]
        assert summary["num_scenes"] == 1 and summary["overflow_pairs"] == 0 and np.isfinite(summary["psnr"])
        assert result["calls"]["dump"] == result["calls"]["dump_memory"] == (1 if r == 0 else 0)
        assert not result["initialized_after"]
    # Each rank scored its own scene: the two summaries differ.
    assert ranks[0]["summary"]["psnr"] != ranks[1]["summary"]["psnr"]
    assert sorted(p.name for p in (out / "pixelsplat_tpu").iterdir() if p.is_file()) == [
        "benchmark.json", "peak_memory.json"
    ]
    pngs = sorted(str(p.relative_to(out / "pixelsplat_tpu")) for p in (out / "pixelsplat_tpu").rglob("*.png"))
    assert len(pngs) == 6
