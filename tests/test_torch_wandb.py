"""`wandb://run[:version]` checkpoints in the port, against a stub `wandb`
module (no network), resolved as the JAX package's
`utils/wandb_tools.py::update_checkpoint_path` resolves them and loaded
through the CLI's `checkpointing.load`.

The model is `re10k` cut to `test_torch_eval_protocol.py`'s size, on the
repo's fixture made into a train split."""

import shutil
import sys
import types
from pathlib import Path

import pytest
import torch

from pixelsplat_tpu_torch import config as pt_config
from pixelsplat_tpu_torch import main as pt_main
from pixelsplat_tpu_torch.scripts.train_fixture import FIXTURE_OVERRIDES, write_train_root
from pixelsplat_tpu_torch.training.checkpoint import load_checkpoint, save_checkpoint
from pixelsplat_tpu_torch.training.model_wrapper import ModelWrapper
from pixelsplat_tpu_torch.utils import wandb_tools

import test_torch_encoder as enc_helpers
import test_torch_eval_protocol as protocol_helpers
import test_torch_re10k as re10k_helpers


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


def install_stub_wandb(monkeypatch, artifacts):
    """A `wandb` module whose `Api().run(path).logged_artifacts()` serves
    `artifacts`: (type, version, [files]) each, downloaded by copying."""
    stub = types.ModuleType("wandb")
    stub.runs = []

    class Artifact:
        def __init__(self, type, version, files):
            self.type, self.version, self.files = type, version, files

        def download(self, root):
            for f in self.files:
                shutil.copy(f, Path(root) / Path(f).name)
            return root

    class Run:
        def logged_artifacts(self):
            return [Artifact(*a) for a in artifacts]

    class Api:
        def run(self, path):
            stub.runs.append(path)
            return Run()

    stub.Api = Api
    monkeypatch.setitem(sys.modules, "wandb", stub)
    monkeypatch.setattr(wandb_tools, "wandb", stub)
    monkeypatch.setattr(wandb_tools, "WANDB_AVAILABLE", True)
    return stub


def train_argv(tmp_path):
    root = write_train_root(tmp_path / "re10k")
    return [
        "+experiment=re10k", "mode=train", f"dataset.roots=[{root}]", *FIXTURE_OVERRIDES,
        f"dataset.image_shape=[{protocol_helpers.H},{protocol_helpers.W}]", *protocol_helpers.SMALL,
        "data_loader.train.num_workers=0", "data_loader.train.batch_size=1", "trainer.accumulate_grad_batches=1",
        "loss=[mse]", f"output_dir={tmp_path / 'outputs'}", "wandb.project=proj", "wandb.entity=ent",
    ]


@pytest.fixture
def uploads(tmp_path):
    """Three checkpoints at step 1 with different seeded weights, as the
    port's `WandbLogger.log_model` uploads them (one `step_1` file each)."""
    cfg = pt_config.load_config(train_argv(tmp_path))
    files = []
    for seed in range(3):
        wrapper = ModelWrapper(cfg.model.encoder, cfg.model.decoder, device="cpu")
        enc_helpers.randomize(wrapper.encoder, seed=seed)
        state = wrapper.init_state()
        state.step = 1
        files.append(save_checkpoint(tmp_path / "uploads" / f"v{seed}", 1, wrapper.state_dict(state)))
    return files


def test_update_checkpoint_path_resolves_wandb_uris(tmp_path, monkeypatch, uploads):
    monkeypatch.chdir(tmp_path)
    # Out of order, with an artifact of another type holding a later version.
    stub = install_stub_wandb(monkeypatch, [
        ("model", "v1", [uploads[1]]), ("model", "v2", [uploads[2]]), ("dataset", "v9", [uploads[0]]),
        ("model", "v0", [uploads[0]]),
    ])
    cfg = pt_config.WandbCfg(project="proj", entity="ent")
    newest = wandb_tools.update_checkpoint_path("wandb://abc123", cfg)
    assert stub.runs == ["ent/proj/abc123"]
    assert newest == Path("checkpoints") / "ent_proj_abc123" / "v2" / "step_1"
    assert newest.read_bytes() == uploads[2].read_bytes()
    v1 = wandb_tools.update_checkpoint_path("wandb://abc123:v1", cfg)
    assert v1.name == "step_1" and v1.read_bytes() == uploads[1].read_bytes()
    with pytest.raises(ValueError, match="No matching checkpoint artifact"):
        wandb_tools.update_checkpoint_path("wandb://abc123:v7", cfg)
    # Without an entity, the project alone, as in the JAX package.
    wandb_tools.update_checkpoint_path("wandb://abc123:v0", pt_config.WandbCfg(project="proj"))
    assert stub.runs[-1] == "proj/abc123"
    assert wandb_tools.update_checkpoint_path(str(uploads[0]), cfg) == uploads[0]
    assert wandb_tools.update_checkpoint_path(None, cfg) is None


def test_artifact_must_hold_one_checkpoint_file(tmp_path, monkeypatch, uploads):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "model.ckpt").write_bytes(b"orbax")
    install_stub_wandb(monkeypatch, [("model", "v0", []), ("model", "v1", [uploads[1], tmp_path / "model.ckpt"])])
    cfg = pt_config.WandbCfg(project="proj")
    with pytest.raises(ValueError, match="holds 0 files"):
        wandb_tools.update_checkpoint_path("wandb://abc123:v0", cfg)
    with pytest.raises(ValueError, match="holds 2 files"):
        wandb_tools.update_checkpoint_path("wandb://abc123:v1", cfg)


def test_wandb_checkpoint_loads_through_the_cli(tmp_path, monkeypatch, uploads):
    """`checkpointing.load=wandb://abc123:v1` into `main mode=train` at the
    checkpoint's own step: `fit` resumes from v1's file and takes no step,
    so the returned weights are v1's bit for bit."""
    monkeypatch.chdir(tmp_path)
    install_stub_wandb(monkeypatch, [("model", f"v{i}", [f]) for i, f in enumerate(uploads)])
    state = pt_main.main(train_argv(tmp_path) + ["checkpointing.load=wandb://abc123:v1", "trainer.max_steps=1"],
                         device="cpu")
    assert state.step == 1
    want = load_checkpoint(uploads[1])["params"]
    other = load_checkpoint(uploads[2])["params"]
    assert state.params.keys() <= want.keys()
    assert any(not torch.equal(want[k], other[k]) for k in state.params)
    for k, p in state.params.items():
        assert torch.equal(p.detach(), want[k]), k
