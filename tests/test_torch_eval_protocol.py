"""The evaluation protocol (`main.py mode=test` -> `Trainer.test`) against
the JAX package's, on the CPU.

The model is `config/experiment/re10k.yaml` cut to the size of
`test_torch_re10k.py` (the tiny ViT, a one-block-per-stage dino_resnet50,
d_feature 32, a 1-layer epipolar transformer with a 1-layer image
self-attention, 4 octaves), set through config overrides; the data is the
repo's fixture (two scenes, 2 context and 3 target views each) under its
evaluation index, cropped to 64x64. The same weights reach both packages
(numpy-seeded on a port encoder, converted to the Flax tree by the JAX
package's `convert_encoder` and loaded back through `interop/from_jax.py`),
and the uniforms the JAX protocol draws per scene are recorded and handed
to the port's encoder. On the CPU the JAX package composites with its XLA
scan and the port with the plain versions of its CUDA kernels.

Tolerances: per scene, PSNR within 1e-3 dB and SSIM within 1e-4 (the
images agree to ~1e-5; a pair within rounding of the 1/255 alpha cut-off
moves one value by up to 1/255, which moves PSNR by ~1e-4 dB); the PNGs
(8-bit) within 1 LSB on all but 0.01 % of the values.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from pixelsplat_tpu import config as jx_config
from pixelsplat_tpu.dataset.data_module import DataModule as JxDataModule
from pixelsplat_tpu.interop import torch_import
from pixelsplat_tpu.model.decoder import get_decoder
from pixelsplat_tpu.training import model_wrapper as jx_wrapper
from pixelsplat_tpu.training import trainer as jx_trainer
from pixelsplat_tpu.training.optimizer import OptimizerCfg as JxOptimizerCfg
from pixelsplat_tpu_torch import config as pt_config
from pixelsplat_tpu_torch import main as pt_main
from pixelsplat_tpu_torch.dataset.data_module import DataModule as PtDataModule
from pixelsplat_tpu_torch.interop import from_jax
from pixelsplat_tpu_torch.model.encoder.encoder_epipolar import EncoderEpipolar as PtEncoder
from pixelsplat_tpu_torch.scripts import profile_protocol
from pixelsplat_tpu_torch.scripts.train_fixture import FIXTURE_OVERRIDES, write_train_root
from pixelsplat_tpu_torch.training import trainer as pt_trainer
from pixelsplat_tpu_torch.training.checkpoint import save_checkpoint
from pixelsplat_tpu_torch.training.model_wrapper import ModelWrapper as PtWrapper

import test_torch_encoder as enc_helpers
import test_torch_re10k as re10k_helpers
import test_torch_slice as slice_helpers

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "tests" / "fixtures"
H = W = 64
PSNR_ATOL_DB = 1e-3
SSIM_ATOL = 1e-4
PNG_FRAC_BEYOND_1_LSB = 1e-4
TARGETS = {"fixture_scene_a": [1, 3, 4], "fixture_scene_b": [2, 4, 5]}

ET = "model.encoder.epipolar_transformer"
SMALL = [
    "model.encoder.backbone.model=tiny",
    "model.encoder.backbone.d_out=64",
    "model.encoder.d_feature=32",
    *[f"{ET}.{k}={v}" for k, v in re10k_helpers.SMALL_TRANSFORMER.items()],
    *[f"{ET}.self_attention.{k}={v}" for k, v in re10k_helpers.SMALL_SELF_ATTENTION.items()],
]
PROTOCOL = [
    "+experiment=re10k",
    "mode=test",
    f"dataset.roots=[{FIXTURE / 're10k'}]",
    "dataset/view_sampler=evaluation",
    f"dataset.view_sampler.index_path={FIXTURE / 'evaluation_index_fixture.json'}",
    f"dataset.image_shape=[{H},{W}]",
    "data_loader.test.num_workers=0",  # worker processes: test_torch_dataset.py and chip_smoke.py
    *SMALL,
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


def small_cfgs(tmp_path):
    overrides = PROTOCOL + [f"output_dir={tmp_path / 'outputs'}"]
    jcfg = jx_config.load_config(overrides + [f"test.output_path={tmp_path / 'jax'}"])
    pcfg = pt_config.load_config(overrides + [f"test.output_path={tmp_path / 'port'}"])
    assert dataclasses.asdict(pcfg.model) == dataclasses.asdict(jcfg.model)
    assert pcfg.model.encoder.epipolar_transformer == re10k_helpers.small_cfgs()[1].epipolar_transformer
    return jcfg, pcfg


def recording(module, name, store, monkeypatch):
    """Wrap `module.name` so every result lands in `store` as a float."""
    original = getattr(module, name)

    def wrapped(*args, **kwargs):
        out = original(*args, **kwargs)
        store.append(float(np.asarray(out.detach() if hasattr(out, "detach") else out).mean()))
        return out

    monkeypatch.setattr(module, name, wrapped)


def read_pngs(directory: Path) -> dict:
    return {
        str(p.relative_to(directory)): np.asarray(Image.open(p)) for p in sorted(directory.rglob("*.png"))
    }


@pytest.fixture(scope="module")
def protocol_runs(tmp_path_factory):
    """Both packages' `Trainer.test` on the fixture with the same weights and
    uniforms; per-scene metrics recorded on both sides."""
    tmp_path = tmp_path_factory.mktemp("protocol")
    with pytest.MonkeyPatch.context() as mp:
        re10k_helpers.shrink_backbones(mp)
        jcfg, pcfg = small_cfgs(tmp_path)
        source = enc_helpers.randomize(PtEncoder(pcfg.model.encoder), seed=61)
        flax_params = torch_import.convert_encoder(source.state_dict(), jcfg.model.encoder)

        # JAX: its trainer as `main.build_everything` wires it, without the
        # training losses (its LPIPS loss needs the pretrained weights).
        jw = jx_wrapper.ModelWrapper(
            JxOptimizerCfg(), jx_wrapper.TrainCfg(), jcfg.test, jcfg.model.encoder,
            get_decoder(jcfg.model.decoder), [],
        )
        jdm = JxDataModule(jcfg.dataset, jcfg.data_loader)
        jt = jx_trainer.Trainer(jcfg.trainer, jw, jdm, jcfg.checkpointing, tmp_path / "jax_out", seed=jcfg.seed)
        uniforms, jax_metrics = [], {"psnr": [], "ssim": []}
        original = slice_helpers.jx_depth_module.sample_discrete_distribution

        def sampler(key, pdf, num_samples):
            import jax

            u = jax.random.uniform(key, (*pdf.shape[:-1], num_samples), dtype=pdf.dtype)
            jax.debug.callback(lambda x: uniforms.append(np.array(x)), u)
            return original(key, pdf, num_samples)

        mp.setattr(slice_helpers.jx_depth_module, "sample_discrete_distribution", sampler)
        for name in ("compute_psnr", "compute_ssim"):
            recording(jx_trainer, name, jax_metrics[name.split("_")[1]], mp)
        jax_summary = jt.test({"params": flax_params})

        # The port, through its own config, data module and trainer.
        pw = PtWrapper(pcfg.model.encoder, pcfg.model.decoder, device="cpu", test_cfg=pcfg.test)
        from_jax.load_from_jax(pw.encoder, flax_params)
        pt = pt_trainer.Trainer(
            pcfg.trainer, pw, PtDataModule(pcfg.dataset, pcfg.data_loader), pcfg.checkpointing,
            tmp_path / "port_out", seed=pcfg.seed,
        )
        draws = iter(uniforms)
        make_encode = pw.make_eval_encode
        encodes = []

        def make_eval_encode(pack_soa=False):
            encode = make_encode(pack_soa=pack_soa)

            def encode_fn(batch, deterministic, step, generator=None, u=None, view_order=None):
                encodes.append((pack_soa, deterministic, generator is not None))
                return encode(batch, deterministic, step, u=torch.as_tensor(next(draws)))

            return encode_fn

        mp.setattr(pw, "make_eval_encode", make_eval_encode)
        port_metrics = {"psnr": [], "ssim": []}
        for name in ("compute_psnr", "compute_ssim"):
            recording(pt_trainer, name, port_metrics[name.split("_")[1]], mp)
        port_summary = pt.test()
        yield dict(
            tmp=tmp_path, uniforms=uniforms, encodes=encodes, jax=(jax_summary, jax_metrics),
            port=(port_summary, port_metrics),
        )


def test_trainer_test_summary_equals_jax(protocol_runs):
    (j_summary, j_metrics), (p_summary, p_metrics) = protocol_runs["jax"], protocol_runs["port"]
    assert len(protocol_runs["uniforms"]) == 2
    assert protocol_runs["uniforms"][0].shape == (1, 2, H * W, 1, 3)
    # Each scene: the probabilistic encoder, straight to the SoA layout,
    # with the trainer's generator (replaced here by the JAX draws).
    assert protocol_runs["encodes"] == [(True, False, True)] * 2
    assert p_summary["num_scenes"] == j_summary["num_scenes"] == 2
    assert p_summary["overflow_pairs"] == j_summary["overflow_pairs"] == 0
    assert p_summary["lpips"] is None and j_summary["lpips"] is None  # no pretrained LPIPS weights here
    assert set(p_summary) == set(j_summary)
    for key in ("psnr", "ssim"):
        assert len(p_metrics[key]) == len(j_metrics[key]) == 2  # one call per scene
    np.testing.assert_allclose(p_metrics["psnr"], j_metrics["psnr"], rtol=0, atol=PSNR_ATOL_DB)
    np.testing.assert_allclose(p_metrics["ssim"], j_metrics["ssim"], rtol=0, atol=SSIM_ATOL)
    assert p_summary["psnr"] == pytest.approx(np.mean(p_metrics["psnr"]), abs=1e-6)
    assert abs(p_summary["psnr"] - j_summary["psnr"]) <= PSNR_ATOL_DB
    assert abs(p_summary["ssim"] - j_summary["ssim"]) <= SSIM_ATOL


def test_trainer_test_pngs_equal_jax(protocol_runs):
    tmp = protocol_runs["tmp"]
    got = read_pngs(tmp / "port" / "pixelsplat_tpu")
    want = read_pngs(tmp / "jax" / "pixelsplat_tpu")
    names = sorted(f"{scene}/color/{i:06d}.png" for scene, idx in TARGETS.items() for i in idx)
    assert sorted(got) == sorted(want) == names
    values, beyond = 0, 0
    for name in names:
        assert got[name].shape == want[name].shape == (H, W, 3) and got[name].dtype == np.uint8
        diff = np.abs(got[name].astype(int) - want[name].astype(int))
        values += diff.size
        beyond += int((diff > 1).sum())
    assert beyond <= PNG_FRAC_BEYOND_1_LSB * values, f"{beyond} of {values} values differ by more than 1 LSB"


def test_trainer_test_writes_the_benchmark_files(protocol_runs):
    tmp = protocol_runs["tmp"]
    for side, memory in (("port", {}), ("jax", None)):
        out = tmp / side / "pixelsplat_tpu"
        bench = json.loads((out / "benchmark.json").read_text())
        assert {k: len(v) for k, v in bench.items()} == {"encoder": 2, "decoder": 6}
        if memory is not None:  # the port on the CPU has no device memory stats
            assert json.loads((out / "peak_memory.json").read_text()) == memory


@pytest.fixture()
def port_checkpoint(tmp_path):
    """A port checkpoint of the small model's seeded weights."""
    cfg = pt_config.load_config(PROTOCOL)
    wrapper = PtWrapper(cfg.model.encoder, cfg.model.decoder, device="cpu")
    enc_helpers.randomize(wrapper.encoder, seed=62)
    return save_checkpoint(tmp_path / "checkpoints", 0, wrapper.state_dict(wrapper.init_state())), wrapper


def test_main_runs_the_protocol_end_to_end(port_checkpoint, tmp_path, monkeypatch):
    """`main(argv, device="cpu")`: config, fixture, checkpoint, protocol,
    files; the weights are the checkpoint's."""
    path, wrapper = port_checkpoint
    out = tmp_path / "test_out"
    argv = PROTOCOL + [f"checkpointing.load={path}", f"test.output_path={out}", f"output_dir={tmp_path / 'o'}"]
    built = []
    build = pt_main.build_everything
    monkeypatch.setattr(pt_main, "build_everything", lambda *a, **k: built.append(build(*a, **k)) or built[-1])
    summary = pt_main.main(argv, device="cpu")

    assert summary["num_scenes"] == 2 and summary["overflow_pairs"] == 0 and summary["lpips"] is None
    assert np.isfinite(summary["psnr"]) and np.isfinite(summary["ssim"])
    trainer = built[0]
    assert trainer.wrapper.device == torch.device("cpu") and trainer.wrapper.losses == []
    for k, v in wrapper.encoder.state_dict().items():
        assert torch.equal(trainer.wrapper.encoder.state_dict()[k], v), k
    results = out / "pixelsplat_tpu"
    pngs = read_pngs(results)
    assert sorted(pngs) == sorted(f"{s}/color/{i:06d}.png" for s, idx in TARGETS.items() for i in idx)
    assert all(img.shape == (H, W, 3) for img in pngs.values())
    bench = json.loads((results / "benchmark.json").read_text())
    assert {k: len(v) for k, v in bench.items()} == {"encoder": 2, "decoder": 6}
    assert json.loads((results / "peak_memory.json").read_text()) == {}


def test_make_eval_render_equals_encode_then_decode():
    """`make_eval_render` is the probabilistic encoder followed by a render
    of the shimmed target views at the decoder's static settings."""
    cfg = pt_config.load_config(PROTOCOL)
    wrapper = PtWrapper(cfg.model.encoder, cfg.model.decoder, device="cpu")
    enc_helpers.randomize(wrapper.encoder, seed=63)
    batch = slice_helpers.make_batch(3)
    u = torch.rand((1, 2, H * W, 1, 3), generator=torch.Generator().manual_seed(4))
    color, overflow = wrapper.make_eval_render()(batch, 0, u=u)
    gaussians = wrapper.make_eval_encode()(batch, False, 0, u=u)
    target = wrapper.data_shim(slice_helpers.batch_to(batch, wrapper.device))["target"]
    want, want_overflow = wrapper.make_eval_decode()(
        gaussians, target["extrinsics"], target["intrinsics"], target["near"], target["far"], (H, W)
    )
    assert color.shape == (1, 3, 3, H, W) and int(overflow) == int(want_overflow) == 0
    assert torch.equal(color, want)


def test_main_refuses_what_it_cannot_run(port_checkpoint, tmp_path, monkeypatch):
    path, _ = port_checkpoint
    monkeypatch.chdir(tmp_path)  # anything written to the default output_dir lands here
    # `mode=train` runs (`test_torch_fit.py` holds it against the JAX trainer):
    # one step on the fixture made into a train split, from fresh weights.
    root = write_train_root(tmp_path / "re10k")
    train_argv = [
        "+experiment=re10k", "mode=train", f"dataset.roots=[{root}]", *FIXTURE_OVERRIDES, f"dataset.image_shape=[{H},{W}]",
        *SMALL, "data_loader.train.num_workers=0", "data_loader.train.batch_size=1", "trainer.accumulate_grad_batches=1",
        "trainer.max_steps=1", "loss=[mse]",
    ]
    state = pt_main.main(train_argv, device="cpu")
    assert state.step == 1 and (tmp_path / "outputs" / "checkpoints" / "step_1").is_file()
    with pytest.raises(ValueError, match="checkpointing.load"):
        pt_main.main(PROTOCOL, device="cpu")
    # An orbax checkpoint of the JAX package is a directory.
    (tmp_path / "orbax").mkdir()
    with pytest.raises(ValueError, match="interop/from_jax.py"):
        pt_main.main(PROTOCOL + [f"checkpointing.load={tmp_path / 'orbax'}"], device="cpu")
    with pytest.raises(ValueError, match="wandb"):
        pt_main.main(PROTOCOL + ["checkpointing.load=wandb://run:v1"], device="cpu")
    # The one option the port does not run yet (ROADMAP queue 1 item 7)
    # loads into the config and fails the run. `use_transmittance` runs: a
    # checkpoint of another model fails only its strict load.
    with pytest.raises(NotImplementedError, match="extended_visualization"):
        pt_main.main(train_argv + ["train.extended_visualization=true", f"output_dir={tmp_path / 'viz'}"], device="cpu")
    with pytest.raises(RuntimeError, match="size mismatch"):
        pt_main.main(
            ["+experiment=re10k_ablation_no_probabilistic_sampling", "mode=test", f"checkpointing.load={path}"],
            device="cpu",
        )
    # The CLI's device is the card: without one it raises, before building anything.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(pt_main, "build_everything", lambda *a, **k: pytest.fail("built without a card"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt_main.main(PROTOCOL + [f"checkpointing.load={path}"])


def test_profile_protocol_scene_set_repeats_the_fixture(tmp_path):
    """`scripts/profile_protocol.py`'s scene set: every copy of a fixture
    scene gives that scene's batch bit for bit, under its own key."""

    def scenes(root, index_path):
        cfg = pt_config.load_config([
            "+experiment=re10k", "mode=test", f"dataset.roots=[{root}]", "dataset/view_sampler=evaluation",
            f"dataset.view_sampler.index_path={index_path}", "data_loader.test.num_workers=0",
        ])
        return {b["scene"][0]: b for b in PtDataModule(cfg.dataset, cfg.data_loader).test_dataloader()}

    def assert_equal(got, want, where):
        assert set(got) == set(want), where
        for k, v in want.items():
            if isinstance(v, dict):
                assert_equal(got[k], v, f"{where}/{k}")
            elif isinstance(v, np.ndarray):
                assert got[k].dtype == v.dtype and np.array_equal(got[k], v), f"{where}/{k}"

    root, index_path = profile_protocol.write_scene_set(tmp_path / "re10k", copies=2, chunks=3)
    assert len(list((root / "test").glob("*.torch"))) == 3
    fixture = scenes(FIXTURE / "re10k", FIXTURE / "evaluation_index_fixture.json")
    copies = scenes(root, index_path)
    assert sorted(copies) == sorted(f"{scene}_{c:04d}" for scene in TARGETS for c in range(2))
    for key, batch in copies.items():
        want = fixture[key.rsplit("_", 1)[0]]
        assert_equal({k: v for k, v in batch.items() if k != "scene"}, {k: v for k, v in want.items() if k != "scene"}, key)
