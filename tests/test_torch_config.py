"""The port's config composer against the JAX package's, and the port's
presets against the experiments they name.

Both packages compose the same YAML files under `config/`; every override
list of `tests/test_config.py` (and each shipped experiment) must give the
same composed dict and a `RootCfg` whose fields equal the JAX one's, field
for field.
"""

import dataclasses

import pytest

from pixelsplat_tpu import config as jx_config
from pixelsplat_tpu_torch import config as pt_config

OVERRIDE_LISTS = {
    "default": [],
    "re10k": ["+experiment=re10k"],
    "cli_overrides": [
        "+experiment=re10k",
        "mode=test",
        "dataset/view_sampler=evaluation",
        "data_loader.train.batch_size=3",
        "checkpointing.load=ckpts/foo",
        "model.encoder.gaussians_per_pixel=1",
    ],
    "evaluation_protocol": [
        "+experiment=re10k",
        "mode=test",
        "dataset.roots=[tests/fixtures/re10k]",
        "dataset/view_sampler=evaluation",
        "dataset.view_sampler.index_path=tests/fixtures/evaluation_index_fixture.json",
        "checkpointing.load=ckpt",
        "test.output_path=out",
    ],
    "re10k_ablation_no_epipolar_transformer": ["+experiment=re10k_ablation_no_epipolar_transformer"],
    "re10k_3_view": ["+experiment=re10k_3_view"],
    "re10k_depth_loss": ["+experiment=re10k_depth_loss"],
    "re10k_ablation_no_probabilistic_sampling": ["+experiment=re10k_ablation_no_probabilistic_sampling"],
    "re10k_ablation_no_depth_encoding": ["+experiment=re10k_ablation_no_depth_encoding"],
    "acid": ["+experiment=acid"],
    "top_level_group_selection": ["loss=[mse]", "dataset/view_sampler=arbitrary"],
    "all_sampler": ["dataset/view_sampler=all"],
}


@pytest.mark.parametrize("name", sorted(OVERRIDE_LISTS))
def test_composition_equals_jax(name):
    overrides = OVERRIDE_LISTS[name]
    assert pt_config.compose_config(overrides) == jx_config.compose_config(overrides)
    got = pt_config.load_config(overrides)
    want = jx_config.load_config(overrides)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    # The unions resolved to the same kinds of config.
    assert type(got.dataset.view_sampler).__name__ == type(want.dataset.view_sampler).__name__
    assert type(got.model.encoder.backbone).__name__ == type(want.model.encoder.backbone).__name__
    assert [type(c).__name__ for c in got.loss] == [type(c).__name__ for c in want.loss]


def test_compute_metrics_config_equals_jax():
    got = pt_config.compose_config([], main_name="compute_metrics")
    assert got == jx_config.compose_config([], main_name="compute_metrics")
    assert got["dataset"]["view_sampler"]["name"] == "evaluation"


def test_the_port_builds_its_own_dataclasses():
    cfg = pt_config.load_config(OVERRIDE_LISTS["evaluation_protocol"])
    assert type(cfg).__module__ == "pixelsplat_tpu_torch.config"
    assert type(cfg.dataset).__module__ == "pixelsplat_tpu_torch.dataset.dataset_re10k"
    assert type(cfg.dataset.view_sampler).__module__.startswith("pixelsplat_tpu_torch.dataset.view_sampler")
    assert type(cfg.test).__module__ == "pixelsplat_tpu_torch.training.model_wrapper"
    assert type(cfg.trainer).__module__ == "pixelsplat_tpu_torch.training.trainer"
    assert cfg.mode == "test" and cfg.checkpointing.load == "ckpt"
    assert cfg.data_loader.test.num_workers == 4 and cfg.data_loader.test.batch_size == 1
    assert cfg.dataset.image_shape == (256, 256) and cfg.model.encoder.gaussians_per_pixel == 3
    assert str(cfg.dataset.view_sampler.index_path).endswith("evaluation_index_fixture.json")


@pytest.mark.parametrize("experiment", sorted(pt_config.EXPERIMENTS))
def test_presets_equal_the_loaded_experiment(experiment):
    loaded = pt_config.load_config([f"+experiment={experiment}"])
    model, training = pt_config.EXPERIMENTS[experiment]
    encoder, decoder = model()
    assert encoder == loaded.model.encoder
    assert decoder == loaded.model.decoder
    got = training()
    assert got.optimizer == loaded.optimizer
    assert got.train == loaded.train
    assert tuple(got.loss) == loaded.loss
    assert got.gradient_clip_val == loaded.trainer.gradient_clip_val
    assert got.accumulate_grad_batches == loaded.trainer.accumulate_grad_batches
    assert got.batch_size == loaded.data_loader.train.batch_size


# The presets the JAX package composes too: those of pixelSplat's epipolar
# encoder, the only encoder it has (`mvsplat`, MVSplat's cost-volume
# encoder, and `gslrm`, GS-LRM's transformer, are the port's alone).
JAX_EXPERIMENTS = sorted(name for name, (model, _) in pt_config.EXPERIMENTS.items() if model()[0].name == "epipolar")


@pytest.mark.parametrize("experiment", JAX_EXPERIMENTS)
def test_presets_equal_the_jax_loaded_experiment(experiment):
    """Each preset that the JAX package composes (every one but `mvsplat`
    and `gslrm`) against what its own loader composes for the experiment,
    field for field."""
    want = jx_config.load_config([f"+experiment={experiment}"])
    model, training = pt_config.EXPERIMENTS[experiment]
    encoder, decoder = model()
    assert dataclasses.asdict(encoder) == dataclasses.asdict(want.model.encoder)
    assert dataclasses.asdict(decoder) == dataclasses.asdict(want.model.decoder)
    got = training()
    assert dataclasses.asdict(got.optimizer) == dataclasses.asdict(want.optimizer)
    assert dataclasses.asdict(got.train) == dataclasses.asdict(want.train)
    assert [dataclasses.asdict(c) for c in got.loss] == [dataclasses.asdict(c) for c in want.loss]
    assert (got.gradient_clip_val, got.accumulate_grad_batches, got.batch_size) == (
        want.trainer.gradient_clip_val, want.trainer.accumulate_grad_batches, want.data_loader.train.batch_size
    )


def test_the_other_presets_set_what_their_experiments_change():
    """The four presets of the shipped experiments beyond `re10k`, the
    ablation and the depth loss, and the encoder's default config."""
    re10k, _ = pt_config.re10k()
    assert pt_config.EXPERIMENTS["acid"][0]() == pt_config.re10k()
    three, _ = pt_config.re10k_3_view()
    assert three.num_context_views == 3 and pt_config.re10k_3_view_training().batch_size == 3
    assert pt_config.re10k_ablation_no_depth_encoding()[0].epipolar_transformer.num_octaves == 0
    single, _ = pt_config.re10k_ablation_no_probabilistic_sampling()
    assert (single.gaussians_per_pixel, single.use_transmittance) == (1, True)
    for name in ("acid", "re10k_3_view", "re10k_ablation_no_depth_encoding",
                 "re10k_ablation_no_probabilistic_sampling"):
        training = pt_config.EXPERIMENTS[name][1]()
        assert (training.train.remat_encoder, training.accumulate_grad_batches) == (False, 1), name
    encoder, decoder = pt_config.default_model()
    want = jx_config.load_config([]).model
    assert dataclasses.asdict(encoder) == dataclasses.asdict(want.encoder)
    assert dataclasses.asdict(decoder) == dataclasses.asdict(want.decoder)
    assert (encoder.backbone.name, encoder.backbone.model, encoder.backbone.num_layers) == ("resnet", "resnet50", 5)


@pytest.mark.parametrize("name", ["mvsplat", "gslrm"])
def test_benchmark_configuration_overlays_its_composed_experiment(name):
    """`config/experiment/<name>.yaml` composes to the preset that the
    benchmark's configuration file overlays, and the file, which lists
    every encoder field, changes none of them."""
    import json
    from pathlib import Path

    from benchmark import port

    config = json.loads((Path(__file__).resolve().parents[1] / "benchmark" / "configs" / f"{name}.json").read_text())
    loaded = pt_config.load_config([f"+experiment={config['experiment']}"])
    encoder, decoder = port.model_cfgs(config)
    assert encoder == loaded.model.encoder == pt_config.EXPERIMENTS[name][0]()[0]
    assert decoder == loaded.model.decoder


def test_num_target_views_preset_equals_the_loaded_sampler():
    loaded = pt_config.load_config(["+experiment=re10k"])
    assert pt_config.NUM_TARGET_VIEWS == loaded.dataset.view_sampler.num_target_views


@pytest.mark.parametrize("bad", ["no_equals_sign", "+experiment=not_an_experiment"])
def test_malformed_overrides_raise(bad):
    with pytest.raises((ValueError, FileNotFoundError)):
        pt_config.load_config([bad])
