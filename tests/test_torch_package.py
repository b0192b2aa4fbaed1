"""Guards of the PyTorch port as a package: it stands apart from JAX and
from the JAX package, imports without a GPU or nvcc, carries the same
model configuration, and never drifts to the CPU on its own."""

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "pixelsplat_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "chex", "pixelsplat_tpu"}


def port_sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def imported_top_levels(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_imports(path):
    assert path.exists(), path
    bad = imported_top_levels(path) & FORBIDDEN
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_import_without_cuda_or_nvcc(tmp_path):
    """Every module imports with no GPU and no nvcc on PATH, and importing
    builds nothing."""
    code = (
        "import importlib, pkgutil, pixelsplat_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, 'pixelsplat_tpu_torch.')]\n"
        "[importlib.import_module(n) for n in names]\n"
        "import sys; assert 'jax' not in sys.modules and 'pixelsplat_tpu' not in sys.modules\n"
        "assert 'optax' not in sys.modules and 'flax' not in sys.modules\n"
        "from pixelsplat_tpu_torch.training.model_wrapper import ModelWrapper, TrainCfg, TrainState\n"
        "for n in ('training.optimizer', 'training.checkpoint', 'loss.loss_lpips', 'evaluation.lpips',\n"
        "          'scripts.train_scene', 'ops.rasterizer.composite_kernel', 'ops.rasterizer.composite_ablation',\n"
        "          'ops.kernel_tools', 'ops.grid_sample', 'geometry.epipolar_lines', 'utils.pairings',\n"
        "          'model.encodings', 'model.transformer.transformer',\n"
        "          'model.encoder.epipolar.epipolar_sampler', 'model.encoder.epipolar.image_self_attention',\n"
        "          'model.encoder.epipolar.epipolar_transformer', 'scripts.kernel_smoke',\n"
        "          'scripts.bench_segment_sum', 'scripts.bench_kernel_ablation', 'scripts.check_composite_bwd',\n"
        "          'main', 'config', 'utils.step_tracker', 'utils.collation', 'utils.benchmarker',\n"
        "          'utils.local_logger', 'utils.image_io', 'utils.wandb_tools', 'dataset.types', 'dataset.dataset',\n"
        "          'dataset.dataset_re10k', 'dataset.data_module', 'dataset.validation_wrapper',\n"
        "          'dataset.view_sampler', 'dataset.view_sampler.view_sampler_evaluation',\n"
        "          'dataset.view_sampler.view_sampler_all', 'dataset.view_sampler.view_sampler_arbitrary',\n"
        "          'dataset.view_sampler.view_sampler_bounded', 'dataset.shims.crop_shim',\n"
        "          'dataset.shims.augmentation_shim', 'evaluation.metrics', 'training.trainer',\n"
        "          'scripts.write_checkpoint', 'scripts.profile_protocol'):\n"
        "    assert 'pixelsplat_tpu_torch.' + n in names, n\n"
        "from pixelsplat_tpu_torch import kernel_build\n"
        "assert not kernel_build._loaded and not kernel_build.BUILD_DIR.exists()\n"
        "print(len(names))\n"
    )
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "PATH": str(tmp_path), "PYTHONPATH": str(ROOT)}
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 70
    assert not list(tmp_path.iterdir())


def test_config_matches_jax_experiment():
    from pixelsplat_tpu.config import load_config
    from pixelsplat_tpu_torch.config import re10k_ablation_no_epipolar_transformer

    want = load_config(["+experiment=re10k_ablation_no_epipolar_transformer"]).model
    encoder, decoder = re10k_ablation_no_epipolar_transformer()
    assert dataclasses.asdict(encoder) == dataclasses.asdict(want.encoder)
    assert dataclasses.asdict(decoder) == dataclasses.asdict(want.decoder)
    assert encoder.backbone.resolved_pos_grid == want.encoder.backbone.resolved_pos_grid == 28


def test_default_device_entry_point_raises_without_gpu(monkeypatch):
    from pixelsplat_tpu_torch.config import re10k_ablation_no_epipolar_transformer
    from pixelsplat_tpu_torch.training.model_wrapper import ModelWrapper, resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    encoder, decoder = re10k_ablation_no_epipolar_transformer()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ModelWrapper(encoder, decoder)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")


def test_unported_options_raise():
    from pixelsplat_tpu_torch.config import re10k_ablation_no_epipolar_transformer
    from pixelsplat_tpu_torch.model.decoder import DecoderSplatting
    from pixelsplat_tpu_torch.model.encoder.encoder_epipolar import EncoderEpipolar

    encoder, decoder = re10k_ablation_no_epipolar_transformer()
    # The epipolar transformer is ported: the production config builds.
    assert hasattr(EncoderEpipolar(dataclasses.replace(encoder, use_epipolar_transformer=True)), "epipolar_transformer")
    # So are the encoder's other options: the bf16 policy, a predicted
    # opacity, transmittance opacities and the ResNet trunks.
    assert EncoderEpipolar(dataclasses.replace(encoder, compute_dtype="bfloat16")).dtype == torch.bfloat16
    assert hasattr(EncoderEpipolar(dataclasses.replace(encoder, predict_opacity=True)), "to_opacity")
    assert EncoderEpipolar(dataclasses.replace(encoder, use_transmittance=True)).depth_predictor.use_transmittance
    with pytest.raises(ValueError, match="compute_dtype"):
        EncoderEpipolar(dataclasses.replace(encoder, compute_dtype="int8"))
    # Depth renders take the public AoS Gaussians only, as in the JAX package.
    from pixelsplat_tpu_torch.ops.rasterizer.projection import GaussiansSoA

    soa = GaussiansSoA(*(torch.zeros(1, 0) for _ in GaussiansSoA._fields))
    with pytest.raises(NotImplementedError, match="depth_mode rendering takes the public AoS Gaussians"):
        DecoderSplatting(decoder)(soa, torch.eye(4)[None, None], None, None, None, (16, 16), depth_mode="depth")


TRAINING_SLICE_SOURCES = [
    "csrc/composite_bwd.cu",
    "evaluation/lpips.py",
    "loss/loss.py",
    "loss/loss_depth.py",
    "loss/loss_lpips.py",
    "loss/loss_mse.py",
    "scripts/train_scene.py",
    "training/checkpoint.py",
    "training/optimizer.py",
]


@pytest.mark.parametrize("relative", TRAINING_SLICE_SOURCES)
def test_training_slice_sources_exist_and_are_checked(relative):
    path = PORT / relative
    assert path.exists()
    if path.suffix == ".py":
        assert path in port_sources()  # so the import-isolation test reads it


def test_training_config_matches_jax_experiment():
    from pixelsplat_tpu.config import load_config
    from pixelsplat_tpu_torch.config import NUM_TARGET_VIEWS, re10k_ablation_no_epipolar_transformer_training

    want = load_config(["+experiment=re10k_ablation_no_epipolar_transformer"])
    got = re10k_ablation_no_epipolar_transformer_training()
    assert dataclasses.asdict(got.optimizer) == dataclasses.asdict(want.optimizer)
    assert dataclasses.asdict(got.train) == dataclasses.asdict(want.train)
    assert [dataclasses.asdict(c) for c in got.loss] == [dataclasses.asdict(c) for c in want.loss]
    assert got.gradient_clip_val == want.trainer.gradient_clip_val == 0.5
    assert got.accumulate_grad_batches == want.trainer.accumulate_grad_batches
    assert NUM_TARGET_VIEWS == want.dataset.view_sampler.num_target_views == 4


@pytest.mark.parametrize("which", ["composite_core", "composite_bwd"])
def test_compositor_wrappers_take_cpu_or_cuda_only(which):
    """No quiet plain-version path for a tensor that is not on the CPU."""
    from pixelsplat_tpu_torch.ops.rasterizer import composite_kernel as ck

    table = torch.zeros((3, 12), device="meta")
    ints = torch.zeros((1,), dtype=torch.int32, device="meta")
    args = (table, ints, ints, ints)
    if which == "composite_bwd":
        floats = torch.zeros((1, 256), device="meta")
        args += (ints, floats, torch.zeros((1, 8, 256), device="meta"), floats)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        getattr(ck, which)(*args, 1, 128)


PRODUCTION_SLICE_SOURCES = [
    "csrc/composite_fwd_ablation.cu",
    "csrc/composite_fwd_body.cuh",
    "csrc/copy_rows.cu",
    "csrc/smoke_scale.cu",
    "geometry/epipolar_lines.py",
    "model/encodings.py",
    "model/encoder/epipolar/epipolar_sampler.py",
    "model/encoder/epipolar/epipolar_transformer.py",
    "model/encoder/epipolar/image_self_attention.py",
    "model/transformer/transformer.py",
    "ops/grid_sample.py",
    "ops/kernel_tools.py",
    "ops/rasterizer/composite_ablation.py",
    "scripts/bench_kernel_ablation.py",
    "scripts/bench_segment_sum.py",
    "scripts/check_composite_bwd.py",
    "scripts/kernel_smoke.py",
    "utils/pairings.py",
]


@pytest.mark.parametrize("relative", PRODUCTION_SLICE_SOURCES)
def test_production_slice_sources_exist_and_are_checked(relative):
    path = PORT / relative
    assert path.exists()
    if path.suffix == ".py":
        assert path in port_sources()  # so the import-isolation test reads it
    else:
        text = path.read_text()
        assert "torch/extension.h" not in text and "#include <torch" not in text  # plain C interface, seconds to build
        if path.suffix == ".cu":
            assert 'extern "C" int ' + path.stem in text
            assert "cudaGetLastError()" in text


def test_kernel_names_are_the_cu_files_only():
    from pixelsplat_tpu_torch import kernel_build

    assert kernel_build.kernel_names() == [
        "composite_bwd", "composite_fwd", "composite_fwd_ablation", "copy_rows", "smoke_scale",
    ]


def test_library_path_follows_the_shared_header(tmp_path, monkeypatch):
    """An edited header rebuilds every kernel that includes it, and only those."""
    import shutil

    from pixelsplat_tpu_torch import kernel_build

    csrc = tmp_path / "csrc"
    shutil.copytree(kernel_build.CSRC, csrc)
    monkeypatch.setattr(kernel_build, "CSRC", csrc)
    before = {name: kernel_build.library_path(name).name for name in kernel_build.kernel_names()}
    header = csrc / "composite_fwd_body.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: kernel_build.library_path(name).name for name in kernel_build.kernel_names()}
    changed = {name for name in before if before[name] != after[name]}
    assert changed == {"composite_fwd", "composite_fwd_ablation"}
    source = csrc / "smoke_scale.cu"
    source.write_text(source.read_text() + "\n// edited\n")
    assert kernel_build.library_path("smoke_scale").name != after["smoke_scale"]

