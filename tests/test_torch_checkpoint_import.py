"""The port's reference-checkpoint loader, its import script and the parity
runbook against the JAX package's, on the CPU.

A `.ckpt` in the published checkpoint's key layout (`encoder.*` entries of
`state_dict`, BatchNorm's `num_batches_tracked` counters, Lightning's other
top-level entries, as `tests/test_parity_runbook.py::_lightning_checkpoint`
lays them out) is written from the port's own encoder with numpy-seeded
weights, for a ResNet and a DINO backbone. The JAX route reads it with
`pixelsplat_tpu/interop/torch_import.py::load_lightning_checkpoint` and the
port loads that Flax tree through `interop/from_jax.py::load_from_jax`; the
port's direct load must give the same tensors bit for bit.
"""

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pixelsplat_tpu.config import load_config as jx_load_config
from pixelsplat_tpu.interop import torch_import as jx_import
from pixelsplat_tpu_torch import main as pt_main
from pixelsplat_tpu_torch.config import load_config as pt_load_config
from pixelsplat_tpu_torch.interop import from_jax
from pixelsplat_tpu_torch.interop import torch_import as pt_import
from pixelsplat_tpu_torch.model.encoder.encoder_epipolar import EncoderEpipolar as PtEncoder
from pixelsplat_tpu_torch.scripts import import_checkpoint, run_parity_eval
from pixelsplat_tpu_torch.training.checkpoint import load_checkpoint
from pixelsplat_tpu_torch.training.model_wrapper import ModelWrapper

import test_torch_encoder as enc_helpers
import test_torch_re10k as re10k_helpers
from test_parity_runbook import EVAL_INDEX, FIXTURE_ROOT, REPO, SMALL_OVERRIDES

GLOBAL_STEP = 123456


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


def encoder_cfgs(backbone: str):
    """(JAX, port) encoder configs: `re10k` cut to `SMALL_OVERRIDES` (a
    ResNet-18 trunk) or to `test_torch_re10k.py`'s size (the tiny ViT and a
    slim dino_resnet50, whose frozen BatchNorm has counters to drop)."""
    if backbone == "resnet":
        overrides = ["+experiment=re10k", *SMALL_OVERRIDES]
        jcfg, pcfg = jx_load_config(overrides).model.encoder, pt_load_config(overrides).model.encoder
    else:
        jcfg, pcfg = re10k_helpers.small_cfgs()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(pcfg)
    return jcfg, pcfg


def lightning_checkpoint(path: Path, encoder: torch.nn.Module, extra: dict = ()) -> dict:
    """Write `encoder`'s weights as the published `.ckpt` lays them out,
    with a `num_batches_tracked` counter beside every BatchNorm's
    statistics; returns the checkpoint's `state_dict`."""
    state_dict = {}
    for k, v in encoder.state_dict().items():
        state_dict[f"encoder.{k}"] = v.detach().clone()
        if k.endswith(".running_var"):
            state_dict[f"encoder.{k[: -len('running_var')]}num_batches_tracked"] = torch.tensor(7, dtype=torch.int64)
    state_dict.update(extra)
    flat = list(encoder.parameters())
    ckpt = {
        "epoch": 3,
        "global_step": GLOBAL_STEP,
        "pytorch-lightning_version": "2.1.0",
        "state_dict": state_dict,
        "loops": {"fit_loop": {"epoch_progress": {}}},
        "callbacks": {"ModelCheckpoint": {"best_model_score": None}},
        "optimizer_states": [
            {
                "state": {
                    i: {"step": torch.tensor(float(GLOBAL_STEP)), "exp_avg": torch.zeros_like(p),
                        "exp_avg_sq": torch.zeros_like(p)}
                    for i, p in enumerate(flat)
                },
                "param_groups": [{"lr": 1.5e-4, "betas": (0.9, 0.999), "params": list(range(len(flat)))}],
            }
        ],
        "lr_schedulers": [{"_step_count": GLOBAL_STEP + 1, "lr_lambdas": [None]}],
        "hparams_name": "kwargs",
        # Lightning pickles the run's config objects here; the restricted
        # unpickler refuses such objects.
        "hyper_parameters": {"cfg": argparse.Namespace(lr=1.5e-4)},
    }
    torch.save(ckpt, path)
    return state_dict


@pytest.mark.parametrize("backbone", ["resnet", "dino"])
def test_direct_load_equals_the_jax_route_bit_for_bit(backbone, tmp_path):
    jcfg, pcfg = encoder_cfgs(backbone)
    source = enc_helpers.randomize(PtEncoder(pcfg), seed=41)
    path = tmp_path / "re10k.ckpt"
    state_dict = lightning_checkpoint(path, source)
    counters = [k for k in state_dict if k.endswith("num_batches_tracked")]
    assert bool(counters) == (backbone == "dino")

    direct = PtEncoder(pcfg)
    assert pt_import.load_lightning_checkpoint(path, direct) == GLOBAL_STEP
    via_jax = from_jax.load_from_jax(PtEncoder(pcfg), jx_import.load_lightning_checkpoint(path, jcfg)["params"])
    got, want = direct.state_dict(), via_jax.state_dict()
    assert got.keys() == want.keys() == source.state_dict().keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
        assert torch.equal(got[k], source.state_dict()[k]), k


def test_only_batchnorm_counters_are_dropped(tmp_path):
    _, pcfg = encoder_cfgs("dino")
    source = enc_helpers.randomize(PtEncoder(pcfg), seed=42)
    path = tmp_path / "counters.ckpt"
    state_dict = lightning_checkpoint(path, source)
    kept = pt_import.encoder_state_dict(pt_import.read_lightning_checkpoint(path))
    assert set(kept) == {k[len("encoder."):] for k in state_dict if not k.endswith(".num_batches_tracked")}

    stray = tmp_path / "stray.ckpt"
    lightning_checkpoint(stray, source, extra={"encoder.backbone.extra.weight": torch.zeros(3)})
    with pytest.raises(RuntimeError, match="Unexpected key.*backbone.extra.weight"):
        pt_import.load_lightning_checkpoint(stray, PtEncoder(pcfg))

    missing = tmp_path / "missing.ckpt"
    torch.save({"state_dict": {k: v for k, v in state_dict.items() if not k.endswith("to_gaussians.1.bias")}}, missing)
    with pytest.raises(RuntimeError, match="Missing key.*to_gaussians.1.bias"):
        pt_import.load_lightning_checkpoint(missing, PtEncoder(pcfg))


def fixture_overrides(tmp_path: Path) -> list[str]:
    return [
        "+experiment=re10k",
        *SMALL_OVERRIDES,
        f"dataset.roots=[{FIXTURE_ROOT}]",
        "dataset/view_sampler=evaluation",
        f"dataset.view_sampler.index_path={EVAL_INDEX}",
        "data_loader.test.num_workers=0",
        f"output_dir={tmp_path / 'outputs'}",
    ]


def test_import_script_keeps_the_step_and_main_reads_it(tmp_path):
    _, pcfg = encoder_cfgs("resnet")
    source = enc_helpers.randomize(PtEncoder(pcfg), seed=43)
    ckpt = tmp_path / "re10k.ckpt"
    lightning_checkpoint(ckpt, source)
    overrides = fixture_overrides(tmp_path)
    path = import_checkpoint.main([str(ckpt), str(tmp_path / "imported"), "--device", "cpu", *overrides])
    assert path == (tmp_path / "imported" / f"step_{GLOBAL_STEP}").resolve()
    payload = load_checkpoint(path)
    assert payload["step"] == GLOBAL_STEP
    for k, v in source.state_dict().items():
        assert torch.equal(payload["params"][k], v), k

    # Resuming: `fit` restores this payload into a fresh state.
    cfg = pt_load_config(overrides)
    wrapper = ModelWrapper(cfg.model.encoder, cfg.model.decoder, device="cpu", optimizer_cfg=cfg.optimizer)
    state = wrapper.load_state_dict(wrapper.init_state(), payload)
    assert state.step == GLOBAL_STEP and not state.optimizer.adam.state

    # Testing: the CLI's `checkpointing.load` reads it back.
    summary = pt_main.main(
        [*overrides, "mode=test", f"test.output_path={tmp_path / 'test'}", f"checkpointing.load={path}"], device="cpu"
    )
    assert summary["num_scenes"] == 2 and summary["overflow_pairs"] == 0 and np.isfinite(summary["psnr"])


def jax_runbook():
    sys.path.insert(0, str(REPO / "tools"))
    try:
        import run_parity_eval as jx_runbook
    finally:
        sys.path.remove(str(REPO / "tools"))
    return jx_runbook


def test_parity_runbook_on_a_ckpt_and_on_the_imported_checkpoint(tmp_path, capsys):
    jx_runbook = jax_runbook()
    assert run_parity_eval.PUBLISHED == jx_runbook.PUBLISHED
    assert run_parity_eval.PSNR_GATE_DB == jx_runbook.PSNR_GATE_DB

    _, pcfg = encoder_cfgs("resnet")
    source = enc_helpers.randomize(PtEncoder(pcfg), seed=44)
    ckpt = tmp_path / "re10k.ckpt"
    lightning_checkpoint(ckpt, source)
    imported = import_checkpoint.main(
        [str(ckpt), str(tmp_path / "imported"), "--device", "cpu", "+experiment=re10k", *SMALL_OVERRIDES]
    )
    summaries = {}
    for label, weights in (("ckpt", ckpt), ("imported", imported.parent)):
        out = tmp_path / label
        argv = ["--ckpt", str(weights), "--data", str(FIXTURE_ROOT), "--index", str(EVAL_INDEX), "--output", str(out),
                "--chunk-size", "3", "--device", "cpu", *SMALL_OVERRIDES, "data_loader.test.num_workers=0"]
        summary = run_parity_eval.run(argv)
        printed = capsys.readouterr().out
        assert json.loads((out / "parity_summary.json").read_text()) == summary
        assert sorted((out / "pixelsplat_tpu").rglob("*.png"))
        assert "| metric | ours | published (re10k) | delta |" in printed
        assert f"| psnr | {summary['psnr']:.4f} | 26.0900 | {summary['psnr'] - 26.09:.4f} |" in printed
        assert "| overflow pairs | 0 | 0 | - |" in printed
        # Random weights: far from the published PSNR, so the gate reads FAIL.
        assert summary["gate"] is False and "): FAIL" in printed
        assert summary["psnr_delta"] == pytest.approx(summary["psnr"] - 26.09)
        summaries[label] = summary
    # The same weights and the same protocol seed: the same numbers.
    assert summaries["ckpt"] == summaries["imported"]
