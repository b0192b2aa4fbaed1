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
        "assert 'matplotlib' not in sys.modules  # the GPU machine has none: imported only where drawn\n"
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
        "          'scripts.write_checkpoint', 'scripts.profile_protocol', 'parallel', 'parallel.distributed',\n"
        "          'parallel.mesh', 'parallel.render', 'utils.shape_checks', 'interop.pretrained',\n"
        "          'evaluation.evaluation_cfg', 'evaluation.metric_computer', 'evaluation.evaluation_index_generator',\n"
        "          'scripts.compute_metrics', 'scripts.generate_evaluation_index',\n"
        "          'scripts.generate_video_evaluation_index', 'visualization.validation_in_3d',\n"
        "          'model.encoder.visualization.encoder_visualizer_epipolar', 'scripts.test_splatter',\n"
        "          'interop.torch_import', 'scripts.import_checkpoint', 'scripts.run_parity_eval',\n"
        "          'scripts.dump_launch_configs', 'paper', 'paper.common', 'paper.table',\n"
        "          'paper.generate_point_cloud_figure', 'paper.generate_sampling_figure',\n"
        "          'paper.generate_attention_figure', 'paper.generate_epipolar_sampling_figure',\n"
        "          'scripts.export_weights', 'scripts.make_fixture_chunk', 'ops.sh'):\n"
        "    assert 'pixelsplat_tpu_torch.' + n in names, n\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized()  # importing parallel/ creates no process group\n"
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
    "csrc/conv7.cu",
    "csrc/copy_rows.cu",
    "csrc/linear_split.cu",
    "csrc/smoke_scale.cu",
    "geometry/epipolar_lines.py",
    "model/encodings.py",
    "model/encoder/epipolar/epipolar_sampler.py",
    "model/encoder/epipolar/epipolar_transformer.py",
    "model/encoder/epipolar/image_self_attention.py",
    "model/encoder/graphs.py",
    "model/transformer/transformer.py",
    "ops/conv7_kernel.py",
    "ops/grid_sample.py",
    "ops/kernel_tools.py",
    "ops/linear_kernel.py",
    "ops/rasterizer/composite_ablation.py",
    "scripts/bench_conv7.py",
    "scripts/bench_kernel_ablation.py",
    "scripts/bench_linear.py",
    "scripts/bench_segment_sum.py",
    "scripts/check_alpha_threshold.py",
    "scripts/check_composite_bwd.py",
    "scripts/kernel_smoke.py",
    "utils/device_constants.py",
    "utils/pairings.py",
]


# The slice across processes, and the evaluation tools.
PARALLEL_AND_EVALUATION_SOURCES = [
    "parallel/__init__.py",
    "parallel/distributed.py",
    "parallel/mesh.py",
    "parallel/render.py",
    "utils/shape_checks.py",
    "interop/pretrained.py",
    "evaluation/evaluation_cfg.py",
    "evaluation/metric_computer.py",
    "evaluation/evaluation_index_generator.py",
    "scripts/compute_metrics.py",
    "scripts/generate_evaluation_index.py",
    "scripts/generate_video_evaluation_index.py",
    "scripts/distributed_step.py",
]


@pytest.mark.parametrize("relative", PARALLEL_AND_EVALUATION_SOURCES)
def test_parallel_and_evaluation_sources_exist_and_are_checked(relative):
    path = PORT / relative
    assert path.exists()
    assert path in port_sources()  # so the import-isolation test reads it
    assert not imported_top_levels(path) & FORBIDDEN


def test_importing_parallel_creates_no_group():
    import torch.distributed as dist

    import pixelsplat_tpu_torch.parallel.distributed  # noqa: F401
    import pixelsplat_tpu_torch.parallel.mesh  # noqa: F401
    import pixelsplat_tpu_torch.parallel.render  # noqa: F401

    assert not dist.is_initialized()


def test_main_raises_without_a_card_unless_asked_for_the_cpu(monkeypatch):
    """`main` runs on `cuda:LOCAL_RANK` by default and joins no group when
    the environment names none."""
    from pixelsplat_tpu_torch import main as cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("RANK", "WORLD_SIZE", "PIXELSPLAT_COORDINATOR", "PIXELSPLAT_DISTRIBUTED"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["+experiment=re10k", "mode=test"])
    import torch.distributed as dist

    assert not dist.is_initialized()


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
        "composite_bwd", "composite_fwd", "composite_fwd_ablation", "conv3x3", "conv7", "copy_rows", "linear_split",
        "project_bin", "smoke_scale",
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



# The extended visualization, the PLY writer and the smoke scripts.
VISUALIZATION_SLICE_SOURCES = [
    "visualization/colors.py",
    "visualization/color_map.py",
    "visualization/layout.py",
    "visualization/validation_in_3d.py",
    "visualization/drawing/__init__.py",
    "visualization/drawing/types.py",
    "visualization/drawing/coordinate_conversion.py",
    "visualization/drawing/rendering.py",
    "visualization/drawing/lines.py",
    "visualization/drawing/points.py",
    "visualization/drawing/cameras.py",
    "visualization/camera_trajectory/__init__.py",
    "visualization/camera_trajectory/wobble.py",
    "visualization/camera_trajectory/interpolation.py",
    "visualization/camera_trajectory/spin.py",
    "model/encoder/visualization/__init__.py",
    "model/encoder/visualization/encoder_visualizer_epipolar.py",
    "model/ply_export.py",
    "utils/video.py",
    "scripts/test_splatter.py",
    "scripts/visualize_epipolar_lines.py",
]


def module_level_imports(path: Path) -> set[str]:
    """Top-level packages a module imports when it is imported (its body,
    and the bodies of top-level if / try blocks), not inside functions."""
    names = set()
    pending = list(ast.parse(path.read_text(), filename=str(path)).body)
    while pending:
        node = pending.pop()
        if isinstance(node, ast.Import):
            names |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, (ast.If, ast.Try)):
            pending += node.body + node.orelse + getattr(node, "finalbody", [])
            pending += [n for handler in getattr(node, "handlers", []) for n in handler.body]
    return names


@pytest.mark.parametrize("relative", VISUALIZATION_SLICE_SOURCES)
def test_visualization_slice_sources_exist_and_are_checked(relative):
    path = PORT / relative
    assert path.exists()
    assert path in port_sources()  # so the import-isolation test reads it
    assert not imported_top_levels(path) & FORBIDDEN
    assert "matplotlib" not in module_level_imports(path)


# The reference-checkpoint loader, the parity runbook, the paper figures and
# tables, and the launch-command listing.
TOOLING_SLICE_SOURCES = [
    "interop/torch_import.py",
    "scripts/import_checkpoint.py",
    "scripts/run_parity_eval.py",
    "scripts/dump_launch_configs.py",
    "paper/__init__.py",
    "paper/common.py",
    "paper/table.py",
    "paper/generate_benchmark_table.py",
    "paper/generate_comparison_table.py",
    "paper/generate_image_comparison.py",
    "paper/generate_3_view_image_comparison.py",
    "paper/generate_ablation_image_comparison.py",
    "paper/generate_epipolar_sampling_figure.py",
    "paper/generate_attention_figure.py",
    "paper/generate_point_cloud_figure.py",
    "paper/generate_sampling_figure.py",
]


@pytest.mark.parametrize("relative", TOOLING_SLICE_SOURCES)
def test_tooling_slice_sources_exist_and_are_checked(relative):
    path = PORT / relative
    assert path.exists()
    assert path in port_sources()  # so the import-isolation test reads it
    assert not imported_top_levels(path) & FORBIDDEN
    assert not module_level_imports(path) & {"matplotlib", "scipy"}


# Slice 10: the weight import, the fixture generator, wandb:// checkpoints
# and the public spherical-harmonics functions.
ASSETS_SLICE_SOURCES = [
    "evaluation/lpips.py",
    "interop/pretrained.py",
    "scripts/export_weights.py",
    "scripts/make_fixture_chunk.py",
    "utils/wandb_tools.py",
    "ops/sh.py",
]


@pytest.mark.parametrize("relative", ASSETS_SLICE_SOURCES)
def test_assets_slice_sources_exist_and_are_checked(relative):
    path = PORT / relative
    assert path.exists()
    assert path in port_sources()  # so the import-isolation test reads it
    assert not imported_top_levels(path) & FORBIDDEN
    # scipy, PIL and lpips are imported where they are used (wandb, optional,
    # is tried at import).
    assert not module_level_imports(path) & {"scipy", "PIL", "lpips", "matplotlib"}


def test_every_jax_module_has_a_counterpart():
    """Every file of the JAX package has one at the same path in the port,
    but for the three ported under other names."""
    jax_package = ROOT / "pixelsplat_tpu"
    renamed = {
        "ops/rasterizer/pallas_composite.py": "csrc/composite_fwd.cu",
        "ops/rasterizer/pallas_backward.py": "csrc/composite_bwd.cu",
        "ops/rasterizer/tile_gather.py": "ops/rasterizer/composite.py",
    }
    missing = [
        str(p.relative_to(jax_package)) for p in sorted(jax_package.rglob("*.py"))
        if "__pycache__" not in p.parts and not (PORT / p.relative_to(jax_package)).exists()
    ]
    assert sorted(missing) == sorted(renamed)
    assert all((PORT / port).exists() for port in renamed.values())
