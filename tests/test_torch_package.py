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
        "print(len(names))\n"
    )
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "PATH": str(tmp_path), "PYTHONPATH": str(ROOT)}
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 20
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
    with pytest.raises(NotImplementedError, match="epipolar transformer"):
        EncoderEpipolar(dataclasses.replace(encoder, use_epipolar_transformer=True))
    with pytest.raises(NotImplementedError, match="depth_mode"):
        DecoderSplatting(decoder)(None, torch.eye(4)[None, None], None, None, None, (16, 16), depth_mode="depth")
