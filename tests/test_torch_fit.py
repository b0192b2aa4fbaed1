"""Training through the CLI (`main.py mode=train` -> `Trainer.fit`) against
the JAX package's, on the CPU.

The model is `config/experiment/re10k.yaml` at the small size of
`test_torch_eval_protocol.py` (config overrides and slim backbones), on the
repo's fixture made into a train split (`scripts/train_fixture.py`: two
copies of each of its two scenes, the context gap cut to 2-6 frames),
cropped to 64x64, with 2 target views in place of the recipe's 4 (half
the JAX step's compile). Both packages' `Trainer.fit` run 3 steps of batch 1
within the train stream's first pass (past it the JAX inline stream
re-seeds and the port's does not: `training/trainer.py`), with MSE, Adam
at 1e-4 after a 4-step warm-up and validation every 2 steps. The same
weights reach both (numpy-seeded on a port encoder, converted by the JAX
package's `convert_encoder`), and the uniforms the JAX step draws are
recorded and handed to the port's step. The JAX step runs without remat,
whose recomputation would record its draws twice (`remat_encoder` is held
to the plain step in `test_torch_re10k_train.py`), and without LPIPS,
whose parity and compile time belong to `test_torch_train_step.py`.

Tolerances: the logged losses by step to 5e-5 relative, and the weights
after the last step per tensor, as `test_torch_train_step.py` holds them;
validation's PSNR within 1e-3 dB and SSIM within 1e-4, and its comparison
grid within 1 LSB on all but 0.01 % of its values, as
`test_torch_eval_protocol.py` holds the protocol's metrics and PNGs.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixelsplat_tpu import config as jx_config
from pixelsplat_tpu import main as jx_main
from pixelsplat_tpu.evaluation import lpips as jx_lpips
from pixelsplat_tpu.interop import torch_import
from pixelsplat_tpu.parallel.mesh import make_mesh, replicated
from pixelsplat_tpu.training.model_wrapper import TrainState as JxTrainState
from pixelsplat_tpu_torch import config as pt_config
from pixelsplat_tpu_torch import main as pt_main
from pixelsplat_tpu_torch.evaluation.lpips import load_lpips
from pixelsplat_tpu_torch.interop import from_jax
from pixelsplat_tpu_torch.model.encoder.encoder_epipolar import EncoderEpipolar as PtEncoder
from pixelsplat_tpu_torch.scripts.train_fixture import FIXTURE_OVERRIDES, write_train_root
from pixelsplat_tpu_torch.training.model_wrapper import ModelWrapper as PtWrapper
from pixelsplat_tpu_torch.training.optimizer import OptimizerCfg, learning_rate

import test_torch_encoder as enc_helpers
import test_torch_re10k as re10k_helpers
import test_torch_slice as slice_helpers
import test_torch_train_step as train_helpers
from test_torch_eval_protocol import PNG_FRAC_BEYOND_1_LSB, PSNR_ATOL_DB, SMALL, SSIM_ATOL

ROOT = Path(__file__).resolve().parent.parent
H = W = 64
STEPS, EVERY = 3, 2
VIEWS = 2  # target views per example (4 in the recipe): half the JAX step's compile
LOSS_RTOL = 5e-5


def train_argv(root: Path, out: Path, *extra: str) -> list[str]:
    return [
        "+experiment=re10k", "mode=train", f"dataset.roots=[{root}]", f"output_dir={out}", *FIXTURE_OVERRIDES,
        f"dataset.image_shape=[{H},{W}]", f"dataset.view_sampler.num_target_views={VIEWS}", *SMALL,
        "data_loader.train.num_workers=0", "data_loader.val.num_workers=0",  # workers: test_worker_sees_the_trainers_step
        "data_loader.train.batch_size=1", "trainer.accumulate_grad_batches=1", "train.remat_encoder=false",
        f"optimizer.lr={train_helpers.LR}", f"optimizer.warm_up_steps={train_helpers.WARM_UP}",
        f"trainer.max_steps={STEPS}", f"trainer.val_check_interval={EVERY}",
        f"checkpointing.every_n_train_steps={EVERY}", "trainer.log_every_n_steps=1", *extra,
    ]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: next to the other test processes, more threads
    only contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def small_backbones(monkeypatch):
    re10k_helpers.shrink_backbones(monkeypatch)


@pytest.fixture(scope="module")
def train_root(tmp_path_factory):
    return write_train_root(tmp_path_factory.mktemp("fixture") / "re10k", copies=2)


def metrics_by_step(out: Path) -> dict:
    """The logged training losses by step (the lines with loss parts)."""
    lines = [json.loads(x) for x in (out / "local" / "metrics.jsonl").read_text().splitlines()]
    return {x["step"]: {k: v for k, v in x.items() if k != "step"} for x in lines if "loss/total" in x}


@pytest.fixture(scope="module")
def fit_runs(tmp_path_factory, train_root):
    """Both packages' `fit` from `main.build_everything` on the same
    weights, batches and uniforms; validation passes recorded, not run."""
    tmp = tmp_path_factory.mktemp("fit")
    with pytest.MonkeyPatch.context() as mp:
        re10k_helpers.shrink_backbones(mp)
        jcfg = jx_config.load_config(train_argv(train_root, tmp / "jax", "loss=[mse]"))
        pcfg = pt_config.load_config(train_argv(train_root, tmp / "port", "loss=[mse]"))
        assert dataclasses.asdict(pcfg.model) == dataclasses.asdict(jcfg.model)
        assert pcfg.trainer.max_steps == jcfg.trainer.max_steps == STEPS
        source = enc_helpers.randomize(PtEncoder(pcfg.model.encoder), seed=64)
        flax_params = torch_import.convert_encoder(source.state_dict(), jcfg.model.encoder)

        # JAX: its trainer from its own main, starting from these weights.
        jt = jx_main.build_everything(jcfg)
        jw = jt.wrapper
        # Placed as the step returns it (replicated on the one-device mesh
        # that batch 1 gets), so the step compiles once.
        mp.setattr(jw, "init_state", lambda batch, seed=0: jax.device_put(JxTrainState(
            params={"params": flax_params}, opt_state=jw.optimizer.init({"params": flax_params}),
            step=jnp.asarray(0),
        ), replicated(make_mesh(1))))
        uniforms, validated = [], {"jax": [], "port": []}
        original = slice_helpers.jx_depth_module.sample_discrete_distribution

        def sampler(key, pdf, num_samples):
            u = jax.random.uniform(key, (*pdf.shape[:-1], num_samples), dtype=pdf.dtype)
            jax.debug.callback(lambda x: uniforms.append(np.array(x)), u)
            return original(key, pdf, num_samples)

        mp.setattr(slice_helpers.jx_depth_module, "sample_discrete_distribution", sampler)
        mp.setattr(jt, "validation_step", lambda state, batch, step: validated["jax"].append(step))
        jax_state = jt.fit()

        # The port, through its own `main.build_everything`, on the JAX draws.
        pt = pt_main.build_everything(pcfg, "cpu")
        pw = pt.wrapper
        from_jax.load_from_jax(pw.encoder, flax_params)
        draws = iter(uniforms)
        generators = []
        make_step = pw.make_train_step

        def make_train_step(accumulate=1, benchmarker=None):
            step_fn = make_step(accumulate=accumulate, benchmarker=benchmarker)

            def fed(state, batch, generator=None, u=None):
                generators.append(generator)
                return step_fn(state, batch, u=torch.as_tensor(next(draws)))

            return fed

        mp.setattr(pw, "make_train_step", make_train_step)
        mp.setattr(pt, "validation_step", lambda state, batch, step: validated["port"].append(step))
        port_state = pt.fit()
        yield dict(
            tmp=tmp, jcfg=jcfg, pcfg=pcfg, uniforms=uniforms, generators=generators, validated=validated,
            jax=(jt, jax_state), port=(pt, port_state),
        )


def test_fit_losses_and_checkpoints_equal_jax(fit_runs):
    tmp, (jt, jax_state), (pt, port_state) = fit_runs["tmp"], fit_runs["jax"], fit_runs["port"]
    assert int(jax_state.step) == port_state.step == STEPS
    assert jt.step_tracker.get_step() == pt.step_tracker.get_step() == STEPS
    assert len(fit_runs["uniforms"]) == STEPS and fit_runs["uniforms"][0].shape == (1, 2, H * W, 1, 3)
    # One generator on the wrapper's device, seeded seed + 7, for the whole fit.
    gens = fit_runs["generators"]
    assert len(gens) == STEPS and all(g is gens[0] for g in gens)
    assert gens[0].initial_seed() == fit_runs["pcfg"].seed + 7 and gens[0].device == torch.device("cpu")

    got, want = metrics_by_step(tmp / "port"), metrics_by_step(tmp / "jax")
    assert sorted(got) == sorted(want) == list(range(1, STEPS + 1))
    for step in want:
        assert got[step].keys() == want[step].keys() == {
            "loss/mse", "loss/total", "train/psnr_probabilistic", "train/overflow_pairs"
        }
        for key in ("loss/mse", "loss/total", "train/psnr_probabilistic"):
            np.testing.assert_allclose(got[step][key], want[step][key], rtol=LOSS_RTOL, err_msg=f"{key} {step}")
        assert got[step]["train/overflow_pairs"] == want[step]["train/overflow_pairs"] == 0.0
    # The losses moved: the steps trained on different batches.
    assert len({round(x["loss/mse"], 6) for x in want.values()}) == STEPS

    # Checkpoints at the same steps: the periodic one, then the final one.
    names = {side: sorted(p.name for p in (tmp / side / "checkpoints").iterdir()) for side in ("jax", "port")}
    assert names["port"] == names["jax"] == ["step_2", "step_3"]
    assert fit_runs["validated"] == {"jax": [EVERY], "port": [EVERY]}


def test_fit_weights_equal_jax(fit_runs):
    """Every weight by name after the last step. Adam's early updates are
    about lr x sign(gradient) per step, so where a gradient is too small
    for the two sides to agree on its sign they may differ by all they
    moved (`test_torch_train_step.py`); each tensor is held to that bound
    and the model's median weight to 5 % of it."""
    (_, jax_state), (_, port_state) = fit_runs["jax"], fit_runs["port"]
    pcfg = fit_runs["pcfg"]
    want = from_jax.state_dict_from_jax(jax.device_get(jax_state.params["params"]), pcfg.model.encoder)
    cfg = OptimizerCfg(lr=train_helpers.LR, warm_up_steps=train_helpers.WARM_UP)
    moved = sum(learning_rate(cfg, s) for s in range(STEPS))
    assert want.keys() == port_state.params.keys()
    diffs = []
    for k, p in port_state.params.items():
        diff = (p.detach() - want[k]).abs()
        assert float(diff.max()) <= 2.2 * moved, k
        diffs.append(diff.flatten())
    diffs = torch.cat(diffs)
    assert float(diffs.median()) <= 0.05 * moved, f"median weight off by {float(diffs.median()):.3g}"


def test_resume_restores_the_state_and_ends_at_max_steps(fit_runs, monkeypatch):
    """`main` again on the port's output directory with one more step: it
    resumes from the latest checkpoint, `step_3`, with the weights, Adam's
    moments and the step exactly as the first run left them, and ends at
    `max_steps` (as `tests/test_trainer.py` resumes the JAX trainer)."""
    tmp, (pt, port_state) = fit_runs["tmp"], fit_runs["port"]
    loaded = []
    load = PtWrapper.load_state_dict

    def snapshot(self, state, payload):
        state = load(self, state, payload)
        loaded.append(dict(
            step=state.step, params={k: p.detach().clone() for k, p in state.params.items()},
            adam={k: {n: v.clone() for n, v in state.optimizer.adam.state[p].items()} for k, p in state.params.items()},
        ))
        return state

    monkeypatch.setattr(PtWrapper, "load_state_dict", snapshot)
    train_root = Path(fit_runs["pcfg"].dataset.roots[0])
    argv = train_argv(train_root, tmp / "port", "loss=[mse]", f"trainer.max_steps={STEPS + 1}")
    state = pt_main.main(argv, device="cpu")
    assert state.step == STEPS + 1
    assert len(loaded) == 1 and loaded[0]["step"] == STEPS
    adam = port_state.optimizer.adam.state
    for k, p in port_state.params.items():
        assert torch.equal(loaded[0]["params"][k], p.detach()), k
        assert loaded[0]["adam"][k].keys() == adam[p].keys() == {"step", "exp_avg", "exp_avg_sq"}
        for n, v in adam[p].items():
            assert torch.equal(loaded[0]["adam"][k][n], v), (k, n)
    assert sorted(p.name for p in (tmp / "port" / "checkpoints").iterdir()) == ["step_2", "step_3", "step_4"]
    assert max(metrics_by_step(tmp / "port")) == STEPS + 1


@pytest.fixture(scope="module")
def validation_runs(tmp_path_factory, train_root):
    """Both packages' `validation_step` on one validation batch at equal
    weights, with capturing loggers and the JAX draw handed to the port."""
    tmp = tmp_path_factory.mktemp("validation")

    class Captured:
        def __init__(self):
            self.metrics, self.images = [], []

        def log_metrics(self, metrics, step=None):
            self.metrics.append((step, dict(metrics)))

        def log_image(self, key, image, step=None):
            self.images.append((key, step, np.asarray(image)))

    with pytest.MonkeyPatch.context() as mp:
        re10k_helpers.shrink_backbones(mp)
        jcfg = jx_config.load_config(train_argv(train_root, tmp / "jax", "loss=[mse]"))
        pcfg = pt_config.load_config(train_argv(train_root, tmp / "port", "loss=[mse]"))
        source = enc_helpers.randomize(PtEncoder(pcfg.model.encoder), seed=65)
        flax_params = torch_import.convert_encoder(source.state_dict(), jcfg.model.encoder)
        jt, pt = jx_main.build_everything(jcfg), pt_main.build_everything(pcfg, "cpu")
        jt.logger, pt.logger = Captured(), Captured()
        # The JAX decoder as one compiled program (its validation calls it
        # eagerly): the same computation, one compile in place of many.
        decode = jax.jit(jt.wrapper.decoder, static_argnums=(5,))
        mp.setattr(jt.wrapper, "decoder", lambda g, e, k, n, f, shape: decode(g, e, k, n, f, shape))
        from_jax.load_from_jax(pt.wrapper.encoder, flax_params)
        batch = next(iter(pt.data_module.val_dataloader()))

        uniforms, encodes = [], []
        original = slice_helpers.jx_depth_module.sample_discrete_distribution

        def sampler(key, pdf, num_samples):
            u = jax.random.uniform(key, (*pdf.shape[:-1], num_samples), dtype=pdf.dtype)
            jax.debug.callback(lambda x: uniforms.append(np.array(x)), u)
            return original(key, pdf, num_samples)

        mp.setattr(slice_helpers.jx_depth_module, "sample_discrete_distribution", sampler)
        # No pretrained LPIPS weights here, so neither side scores LPIPS; the
        # JAX validation would still build random VGG weights it never uses.
        assert load_lpips() is None
        mp.setattr(jx_lpips, "get_lpips_params", lambda: (None, False))
        step = 6
        jax_metrics = jt.validation_step(JxTrainState({"params": flax_params}, None, jnp.asarray(0)), batch, step)

        make_encode = pt.wrapper.make_eval_encode

        def make_eval_encode(pack_soa=False):
            encode = make_encode(pack_soa=pack_soa)

            def encode_fn(batch, deterministic, step, generator=None, u=None, view_order=None):
                encodes.append((pack_soa, deterministic, generator.initial_seed()))
                if not deterministic:  # the JAX draw in place of the generator's
                    u = torch.as_tensor(uniforms[0])
                return encode(batch, deterministic, step, generator=generator, u=u)

            return encode_fn

        mp.setattr(pt.wrapper, "make_eval_encode", make_eval_encode)
        port_metrics = pt.validation_step(pt.wrapper.init_state(), batch, step)
        yield dict(step=step, uniforms=uniforms, encodes=encodes, jax=(jt.logger, jax_metrics),
                   port=(pt.logger, port_metrics))


def test_validation_step_equals_jax(validation_runs):
    step = validation_runs["step"]
    (j_log, j_metrics), (p_log, p_metrics) = validation_runs["jax"], validation_runs["port"]
    # The JAX probabilistic encode draws once; the deterministic one draws nothing.
    assert len(validation_runs["uniforms"]) == 1
    # Each variant encodes AoS Gaussians from a generator seeded with the step.
    assert validation_runs["encodes"] == [(False, False, step), (False, True, step)]
    names = {f"val/{m}_{v}" for m in ("psnr", "ssim") for v in ("probabilistic", "deterministic")}
    assert p_metrics.keys() == j_metrics.keys() == names  # no LPIPS without pretrained weights
    assert p_log.metrics == [(step, p_metrics)] and j_log.metrics == [(step, j_metrics)]
    for key in names:
        atol = PSNR_ATOL_DB if "psnr" in key else SSIM_ATOL
        assert abs(p_metrics[key] - j_metrics[key]) <= atol, (key, p_metrics[key], j_metrics[key])
    assert p_metrics["val/psnr_probabilistic"] != p_metrics["val/psnr_deterministic"]


def test_validation_grid_equals_jax(validation_runs):
    (j_log, _), (p_log, _) = validation_runs["jax"], validation_runs["port"]
    [(key_p, step_p, got)], [(key_j, step_j, want)] = p_log.images, j_log.images
    assert key_p == key_j == "comparison" and step_p == step_j == validation_runs["step"]
    # Four labelled rows (2 context views, then the target views), bordered.
    assert got.shape == want.shape and got.shape[0] == 3 and got.shape[1] > 4 * H + 2 * 8
    to_u8 = lambda x: (np.clip(x, 0, 1) * 255).astype(np.int64)  # as LocalLogger writes it  # noqa: E731
    diff = np.abs(to_u8(got) - to_u8(want))
    assert int((diff > 1).sum()) <= PNG_FRAC_BEYOND_1_LSB * diff.size, f"{int((diff > 1).sum())} values beyond 1 LSB"


def test_main_trains_the_recipe_with_lpips(train_root, tmp_path, monkeypatch):
    """`main` `mode=train` with the experiment's own losses (MSE + LPIPS,
    random VGG weights allowed), its remat and 2 accumulated micro-batches:
    the trainer's step function takes the configured accumulation, the
    losses are built, validation writes its grid, and the final state
    comes back. The trainer's Benchmarker times each data wait, step,
    micro-batch forward and backward, optimizer update, validation pass
    and checkpoint save into `benchmark.json`."""
    accumulated = []
    make_step = PtWrapper.make_train_step
    monkeypatch.setattr(
        PtWrapper, "make_train_step",
        lambda self, accumulate=1, benchmarker=None: accumulated.append(accumulate)
        or make_step(self, accumulate, benchmarker),
    )
    out = tmp_path / "out"
    argv = train_argv(train_root, out, "train.remat_encoder=true", "data_loader.train.batch_size=2",
                      "trainer.accumulate_grad_batches=2", "trainer.max_steps=2", "loss.lpips.allow_random_weights=true")
    state = pt_main.main(argv, device="cpu")
    assert state.step == 2 and accumulated == [2]
    logged = metrics_by_step(out)
    assert sorted(logged) == [1, 2] and all(x["loss/lpips"] == 0.0 for x in logged.values())  # gated until 150,000
    assert all(np.isfinite(x["loss/total"]) for x in logged.values())
    grids = sorted((out / "local" / "comparison").iterdir())
    assert [p.name for p in grids] == ["000002.png"]
    lines = [json.loads(x) for x in (out / "local" / "metrics.jsonl").read_text().splitlines()]
    assert [x["step"] for x in lines if "val/psnr_probabilistic" in x] == [2]
    assert sorted(p.name for p in (out / "checkpoints").iterdir()) == ["step_2"]  # no duplicate final save
    times = json.loads((out / "benchmark.json").read_text())
    # The first batch and one after each step; 2 micro-batches a step.
    assert {k: len(v) for k, v in times.items()} == {
        "data": 3, "step": 2, "forward": 4, "backward": 4, "optimizer": 2, "validation": 1, "checkpoint": 1,
    }
    assert all(t > 0 for v in times.values() for t in v)
    assert json.loads((out / "peak_memory.json").read_text()) == {}  # no device memory on the CPU


def test_main_train_refusals(train_root, tmp_path):
    """The LPIPS loss demands its exported weights unless random ones are
    allowed; the extended visualization runs, and writes the projections,
    the camera diagram and both videos at the validation."""
    with pytest.raises(FileNotFoundError, match="LPIPS weights"):
        pt_main.main(train_argv(train_root, tmp_path / "a"), device="cpu")
    assert not (tmp_path / "a" / "checkpoints").exists()
    state = pt_main.main(train_argv(train_root, tmp_path / "b", "loss=[mse]", "train.extended_visualization=true",
                                    "trainer.max_steps=1", "trainer.val_check_interval=1", "dataset.image_shape=[32,32]"),
                         device="cpu")
    assert state.step == 1 and (tmp_path / "b" / "checkpoints" / "step_1").is_file()
    local = tmp_path / "b" / "local"
    for key in ("comparison", "projections", "cameras", "encoder/gaussians"):
        assert (local / key / "000001.png").is_file(), key
    for name in ("wobble", "interpolation"):
        assert [p.name for p in (local / "video" / name).iterdir()] in (["000001.gif"], ["000001.mp4"]), name


WORKER_STEP = r"""
import sys
from pixelsplat_tpu_torch.config import load_config
from pixelsplat_tpu_torch.dataset.data_module import DataModule
from pixelsplat_tpu_torch.utils.step_tracker import StepTracker

cfg = load_config(sys.argv[1:])
tracker = StepTracker()
loader = iter(DataModule(cfg.dataset, cfg.data_loader, step_tracker=tracker).train_dataloader())
gaps = [int(b["context"]["index"][0, 1] - b["context"]["index"][0, 0]) for b in (next(loader) for _ in range(2))]
tracker.set_step(1)  # what Trainer.fit does after a step
for _ in range(12):
    batch = next(loader)
    gaps.append(int(batch["context"]["index"][0, 1] - batch["context"]["index"][0, 0]))
print(" ".join(map(str, gaps)))
"""


def test_worker_sees_the_trainers_step(train_root):
    """The bounded sampler's curriculum in forked loader workers reads the
    step the trainer sets: with a one-step warm-up from a gap of 2 to 6,
    the workers' batches go from gap 2 to gap 6 once the step is set (after
    the batches they had already prefetched). Workers fork, so this runs in
    a process without JAX."""
    overrides = [
        "+experiment=re10k", f"dataset.roots=[{train_root}]", *FIXTURE_OVERRIDES, "dataset.image_shape=[32,32]",
        "dataset.view_sampler.warm_up_steps=1", "data_loader.train.num_workers=2",
        "data_loader.train.batch_size=1",
    ]
    proc = subprocess.run(
        [sys.executable, "-c", WORKER_STEP, *overrides], env={**os.environ, "PYTHONPATH": str(ROOT)}, cwd=ROOT,
        capture_output=True, text=True, timeout=180,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    gaps = [int(x) for x in proc.stdout.split()]
    assert gaps[:2] == [2, 2] and gaps[-1] == 6 and set(gaps) == {2, 6}, gaps
