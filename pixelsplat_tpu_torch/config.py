"""Configuration of the port: the YAML composer, the root config and the
presets of the shipped experiments.

The config dataclasses live beside the modules they configure, as in the
JAX package. `compose_config` / `load_config` are the port's own copy of
`pixelsplat_tpu/config.py`'s Hydra subset: `config/main.yaml` (at the root
of the checkout, shared with the JAX package) with its `defaults` list of
composable groups, `optional` defaults with `${group}`-interpolated names,
`# @package _global_` experiment files applied at the root, and dotted CLI
overrides (`a.b.c=value`, `+experiment=re10k`, group selections such as
`dataset/view_sampler=evaluation`); the composed dict becomes a `RootCfg`
of the port's dataclasses (unions of configs told apart by their `name`).

The presets build the model and training configuration of the seven
shipped experiments without the YAML files, and equal what `load_config`
composes for them. `re10k`
(`config/experiment/re10k.yaml`) is the production model: the DINO
ViT-B/8 + dino_resnet50 backbone, d_feature 128, the epipolar transformer
(downscale 4, 32 samples per line, 2 cross-attention layers whose
feed-forward is a 2-layer image self-attention, 4 heads x 128, 10
octaves), 32 depth buckets, 3 Gaussians per pixel and degree-4 SH, trained
with MSE + LPIPS (from step 150,000) by Adam at 1.5e-4 with a 2,000-step
warm-up and a 0.5 global-norm clip (`config/main.yaml`), the encoder
rematerialized and 7 batches accumulated per update.
`re10k_depth_loss` trains the same model on MSE + LPIPS + a depth
smoothness loss on a rendered depth map, without remat or accumulation.
`re10k_ablation_no_epipolar_transformer` is the published ablation without
the transformer, remat or accumulation. `acid` trains `re10k`'s model on
ACID (only the dataset roots differ); `re10k_3_view` encodes 3 context
views (with view embeddings for the epipolar transformer) at batch 3;
`re10k_ablation_no_depth_encoding` drops the transformer's depth encoding
(`num_octaves: 0`); `re10k_ablation_no_probabilistic_sampling` places one
Gaussian per pixel at the most likely depth with the transmittance
opacity. These four keep `config/main.yaml`'s trainer settings: no remat,
no accumulation.
"""

from __future__ import annotations

import dataclasses
import types
import typing
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Union

import yaml

from .dataset.data_module import DataLoaderCfg, DataLoaderStageCfg
from .dataset.dataset_re10k import DatasetRE10kCfg
from .dataset.view_sampler import (
    ViewSamplerAllCfg,
    ViewSamplerArbitraryCfg,
    ViewSamplerBoundedCfg,
    ViewSamplerEvaluationCfg,
)
from .loss import LossDepthCfg, LossLpipsCfg, LossMseCfg
from .model.decoder.decoder_splatting import DecoderSplattingCfg
from .model.encoder.backbone.dino import BackboneDinoCfg
from .model.encoder.backbone.resnet import BackboneResnetCfg
from .model.encoder.common.gaussian_adapter import GaussianAdapterCfg
from .model.encoder.encoder_epipolar import EncoderEpipolarCfg, OpacityMappingCfg
from .model.encoder.epipolar.epipolar_transformer import EpipolarTransformerCfg
from .model.encoder.epipolar.image_self_attention import ImageSelfAttentionCfg
from .ops.rasterizer.render import RenderSettings
from .training.model_wrapper import CheckpointingCfg, TestCfg, TrainCfg
from .training.optimizer import OptimizerCfg
from .training.trainer import TrainerCfg

CONFIG_ROOT = Path(__file__).resolve().parent.parent / "config"

# ---------------------------------------------------------------------------
# Composition


def _deep_merge(base: dict, override: dict) -> dict:
    out = dict(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _load_yaml(path: Path) -> tuple[dict, bool]:
    """Returns (data, is_global_package)."""
    text = path.read_text()
    is_global = "@package _global_" in text.split("\n", 2)[0] + "\n".join(
        text.split("\n")[:3]
    )
    data = yaml.safe_load(text) or {}
    return data, is_global


def _compose_group(
    group: str,
    name: str,
    choices: dict,
    selections: dict,
    config_root: Path,
) -> dict:
    """Load config/<group>/<name>.yaml, recursively applying its defaults.

    `selections` (group path -> name) overrides nested default choices, the
    way Hydra CLI group overrides do.
    """
    path = config_root / group / f"{name}.yaml"
    data, _ = _load_yaml(path)
    defaults = data.pop("defaults", [])
    result: dict = {}
    for entry in defaults:
        if entry == "_self_":
            continue
        assert isinstance(entry, dict), f"unsupported default {entry!r}"
        ((sub_group, sub_name),) = entry.items()
        full = f"{group}/{sub_group}"
        sub_name = selections.get(full, sub_name)
        choices[full] = sub_name
        result[sub_group] = _deep_merge(
            result.get(sub_group, {}),
            _compose_group(full, sub_name, choices, selections, config_root),
        )
    choices[group] = name
    return _deep_merge(result, data)


def compose_config(
    overrides: list[str],
    config_root: Path = CONFIG_ROOT,
    main_name: str = "main",
) -> dict:
    """Compose config/main.yaml with CLI overrides (Hydra-style).

    Merge order matches Hydra with an implicit trailing _self_:
    group defaults (with experiment `override /group` and CLI group
    selections applied in place) -> interpolated optional defaults -> main
    body -> experiment bodies -> CLI dotted value overrides.
    """
    main, _ = _load_yaml(config_root / f"{main_name}.yaml")
    defaults = main.pop("defaults", [])

    # Parse CLI overrides.
    selections: dict[str, Any] = {}
    value_overrides: list[tuple[str, Any]] = []
    experiments: list[str] = []
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"Malformed override: {ov!r}")
        key, _, value = ov.partition("=")
        if key.startswith("+experiment"):
            experiments.append(value)
        elif "/" in key and not key.startswith("+"):
            selections[key] = yaml.safe_load(value)
        else:
            value_overrides.append((key.lstrip("+"), yaml.safe_load(value)))

    # Experiment defaults modify the main defaults list in place.
    experiment_bodies: list[dict] = []
    exp_selections: dict[str, Any] = {}
    for exp in experiments:
        data, _ = _load_yaml(config_root / "experiment" / f"{exp}.yaml")
        for entry in data.pop("defaults", []):
            if entry == "_self_":
                continue
            ((group, name),) = entry.items()
            if group.startswith("override"):
                group = group[len("override") :].strip()
            group = group.lstrip("/")
            exp_selections[group] = name
        experiment_bodies.append(data)
    # CLI selections beat experiment selections.
    selections = {**exp_selections, **selections}

    # `override group: name` entries in the main defaults list modify the
    # selection of an earlier entry (used by compute_metrics.yaml etc.).
    pruned_defaults = []
    own_overrides: dict[str, Any] = {}
    for entry in defaults:
        if isinstance(entry, dict):
            ((group, name),) = entry.items()
            if isinstance(group, str) and group.startswith("override"):
                own_overrides[group[len("override") :].strip().lstrip("/")] = name
                continue
        pruned_defaults.append(entry)
    defaults = pruned_defaults

    # Hydra also accepts group selections for TOP-LEVEL groups without a
    # slash in the key (e.g. `loss=[mse]`, `dataset=acid`): reclassify
    # undotted value overrides whose key names a defaults-list group.
    top_groups = set()
    for entry in defaults:
        if isinstance(entry, dict):
            ((group, _),) = entry.items()
            if isinstance(group, str):
                if group.startswith("optional "):
                    group = group[len("optional ") :].strip()
                top_groups.add(group)
    remaining: list[tuple[str, Any]] = []
    for key, value in value_overrides:
        if key in top_groups and "." not in key:
            selections[key] = value
        else:
            remaining.append((key, value))
    value_overrides = remaining

    selections = {**own_overrides, **selections}

    choices: dict[str, Any] = {}
    cfg: dict = {}
    deferred: list[tuple[str, str]] = []
    for entry in defaults:
        if entry == "_self_":
            continue
        assert isinstance(entry, dict), f"unsupported default {entry!r}"
        ((group, name),) = entry.items()
        if isinstance(group, str) and group.startswith("optional "):
            deferred.append((group[len("optional ") :].strip(), name))
            continue
        name = selections.get(group, name)
        if isinstance(name, list):
            target: dict = {}
            for n in name:
                target = _deep_merge(
                    target,
                    {n: _compose_group(group, n, choices, selections, config_root)},
                )
            choices[group] = name
        else:
            target = _compose_group(group, name, choices, selections, config_root)
        # Nest under the group path (e.g. model/encoder -> cfg[model][encoder]).
        node = cfg
        parts = group.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = _deep_merge(node.get(parts[-1], {}), target)

    # Interpolated optional defaults (view-sampler-specific overrides);
    # these files are @package _global_.
    for group, name in deferred:
        resolved = name
        while "${" in resolved:
            start = resolved.index("${")
            end = resolved.index("}", start)
            var = resolved[start + 2 : end]
            resolved = (
                resolved[:start] + str(choices.get(var, "")) + resolved[end + 1 :]
            )
        path = config_root / group / f"{resolved}.yaml"
        if not path.exists():
            continue
        data, _ = _load_yaml(path)
        data.pop("defaults", None)
        cfg = _deep_merge(cfg, data)

    cfg = _deep_merge(cfg, main)
    for body in experiment_bodies:
        cfg = _deep_merge(cfg, body)

    # Finally, dotted value overrides.
    for key, value in value_overrides:
        node = cfg
        parts = key.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value

    cfg["__choices__"] = choices
    return cfg


# ---------------------------------------------------------------------------
# dict -> dataclass conversion


def _convert(value: Any, ty: Any) -> Any:
    origin = typing.get_origin(ty)
    if ty is Any:
        return value
    if origin in (Union, types.UnionType):
        args = [a for a in typing.get_args(ty) if a is not type(None)]
        if value is None:
            return None
        # Discriminate dataclass unions by their `name` literal default.
        if isinstance(value, dict) and "name" in value:
            for arg in args:
                if dataclasses.is_dataclass(arg):
                    f = {f.name: f for f in dataclasses.fields(arg)}.get("name")
                    if f is not None and f.default == value["name"]:
                        return _convert(value, arg)
        for arg in args:
            try:
                return _convert(value, arg)
            except (TypeError, ValueError, KeyError):
                continue
        raise TypeError(f"Cannot convert {value!r} to {ty}")
    if dataclasses.is_dataclass(ty):
        if not isinstance(value, dict):
            raise TypeError(f"expected dict for {ty}, got {value!r}")
        hints = typing.get_type_hints(ty)
        return ty(**{f.name: _convert(value[f.name], hints[f.name]) for f in dataclasses.fields(ty) if f.name in value})
    if origin in (list, tuple) or ty in (list, tuple):
        args = typing.get_args(ty)
        if origin is tuple or ty is tuple:
            if args and args[-1] is Ellipsis:
                return tuple(_convert(v, args[0]) for v in value)
            if args:
                return tuple(_convert(v, a) for v, a in zip(value, args))
            return tuple(value)
        elt = args[0] if args else Any
        return [_convert(v, elt) for v in value]
    if ty is Path:
        return Path(value)
    if ty in (int, float, str, bool):
        return ty(value)
    if origin is typing.Literal or typing.get_origin(ty) is typing.Literal:
        return value
    return value


def from_dict(ty, value: dict):
    return _convert(value, ty)


# ---------------------------------------------------------------------------
# Root config


@dataclass(frozen=True)
class WandbCfg:
    project: str = "pixelsplat_tpu"
    entity: str = ""
    name: str = "placeholder"
    mode: str = "disabled"
    tags: tuple[str, ...] = ()


@dataclass(frozen=True)
class ModelCfg:
    encoder: EncoderEpipolarCfg = field(default_factory=EncoderEpipolarCfg)
    decoder: DecoderSplattingCfg = field(default_factory=DecoderSplattingCfg)


LossCfgUnion = Union[LossMseCfg, LossLpipsCfg, LossDepthCfg]


@dataclass(frozen=True)
class RootCfg:
    wandb: WandbCfg = field(default_factory=WandbCfg)
    mode: str = "train"
    dataset: DatasetRE10kCfg = field(default_factory=DatasetRE10kCfg)
    data_loader: DataLoaderCfg = field(default_factory=DataLoaderCfg)
    model: ModelCfg = field(default_factory=ModelCfg)
    optimizer: OptimizerCfg = field(default_factory=OptimizerCfg)
    checkpointing: CheckpointingCfg = field(default_factory=CheckpointingCfg)
    trainer: TrainerCfg = field(default_factory=TrainerCfg)
    train: TrainCfg = field(default_factory=TrainCfg)
    test: TestCfg = field(default_factory=TestCfg)
    loss: tuple[LossCfgUnion, ...] = ()
    seed: int = 111123
    output_dir: Path = Path("outputs")


def _losses_from_dict(loss_cfg: dict) -> tuple:
    """{name: {weight: ..}} -> tuple of typed loss cfgs (the config keys
    losses by their group name)."""
    classes = {"mse": LossMseCfg, "lpips": LossLpipsCfg, "depth": LossDepthCfg}
    out = []
    for name, body in (loss_cfg or {}).items():
        body = dict(body or {})
        body.pop("name", None)
        out.append(_convert({"name": name, **body}, classes[name]))
    return tuple(out)


def load_typed_root_config(cfg: dict) -> RootCfg:
    cfg = dict(cfg)
    cfg.pop("__choices__", None)
    loss = cfg.pop("loss", {})
    root = _convert(cfg, RootCfg)
    return dataclasses.replace(root, loss=_losses_from_dict(loss))


def load_config(overrides: list[str]) -> RootCfg:
    return load_typed_root_config(compose_config(overrides))


# ---------------------------------------------------------------------------
# Presets

# Target views per training example
# (config/dataset/view_sampler_dataset_specific_config/bounded_re10k.yaml).
NUM_TARGET_VIEWS = 4


@dataclass(frozen=True)
class TrainingCfg:
    """What `config/main.yaml` and the experiment give the trainer."""

    optimizer: OptimizerCfg = field(default_factory=OptimizerCfg)
    train: TrainCfg = field(default_factory=TrainCfg)
    loss: tuple = (LossMseCfg(), LossLpipsCfg())
    gradient_clip_val: float = 0.5
    accumulate_grad_batches: int = 1
    # `data_loader.train.batch_size`: examples per optimizer update.
    batch_size: int = 4


def re10k() -> tuple[EncoderEpipolarCfg, DecoderSplattingCfg]:
    """(encoder cfg, decoder cfg) of the `re10k` experiment:
    `config/model/encoder/epipolar.yaml` with the `dino` backbone, and
    `config/model/decoder/splatting.yaml`."""
    encoder = EncoderEpipolarCfg(
        d_feature=128,
        num_monocular_samples=32,
        num_surfaces=1,
        predict_opacity=False,
        backbone=BackboneDinoCfg(model="dino_vitb8", d_out=512),
        near_disparity=3.0,
        gaussian_adapter=GaussianAdapterCfg(
            gaussian_scale_min=0.5, gaussian_scale_max=15.0, sh_degree=4
        ),
        apply_bounds_shim=True,
        epipolar_transformer=EpipolarTransformerCfg(
            self_attention=ImageSelfAttentionCfg(
                patch_size=4, num_octaves=10, num_layers=2, num_heads=4,
                d_token=128, d_dot=128, d_mlp=256,
            ),
            num_octaves=10, num_layers=2, num_heads=4, num_samples=32,
            d_dot=128, d_mlp=256, downscale=4,
        ),
        opacity_mapping=OpacityMappingCfg(initial=0.0, final=0.0, warm_up=1),
        gaussians_per_pixel=3,
        use_epipolar_transformer=True,
        use_transmittance=False,
        compute_dtype=None,
    )
    return encoder, DecoderSplattingCfg()


def re10k_training() -> TrainingCfg:
    """Optimizer, train settings, the loss list `[mse, lpips]` and the
    trainer's accumulation of the `re10k` experiment."""
    return TrainingCfg(
        optimizer=OptimizerCfg(lr=1.5e-4, warm_up_steps=2000),
        train=TrainCfg(depth_mode=None, extended_visualization=False, remat_encoder=True),
        loss=(LossMseCfg(weight=1.0), LossLpipsCfg(weight=0.05, apply_after_step=150_000)),
        gradient_clip_val=0.5,
        accumulate_grad_batches=7,
        batch_size=7,
    )


def re10k_ablation_no_epipolar_transformer() -> tuple[EncoderEpipolarCfg, DecoderSplattingCfg]:
    """The `re10k_ablation_no_epipolar_transformer` experiment: `re10k`
    with `use_epipolar_transformer: false`."""
    encoder, decoder = re10k()
    return dataclasses.replace(encoder, use_epipolar_transformer=False), decoder


def re10k_ablation_no_epipolar_transformer_training() -> TrainingCfg:
    """The ablation's training settings: `re10k`'s without remat or
    accumulation (`config/main.yaml`'s defaults)."""
    training = re10k_training()
    return dataclasses.replace(
        training, train=dataclasses.replace(training.train, remat_encoder=False), accumulate_grad_batches=1
    )


def re10k_3_view() -> tuple[EncoderEpipolarCfg, DecoderSplattingCfg]:
    """The `re10k_3_view` experiment: `re10k` with 3 context views."""
    encoder, decoder = re10k()
    return dataclasses.replace(encoder, num_context_views=3), decoder


def re10k_3_view_training() -> TrainingCfg:
    """`re10k_3_view`'s training settings: the ablation's, at batch 3."""
    return dataclasses.replace(re10k_ablation_no_epipolar_transformer_training(), batch_size=3)


def re10k_ablation_no_depth_encoding() -> tuple[EncoderEpipolarCfg, DecoderSplattingCfg]:
    """The `re10k_ablation_no_depth_encoding` experiment: `re10k` without
    the epipolar transformer's depth encoding (`num_octaves: 0`)."""
    encoder, decoder = re10k()
    et = dataclasses.replace(encoder.epipolar_transformer, num_octaves=0)
    return dataclasses.replace(encoder, epipolar_transformer=et), decoder


def re10k_ablation_no_probabilistic_sampling() -> tuple[EncoderEpipolarCfg, DecoderSplattingCfg]:
    """The `re10k_ablation_no_probabilistic_sampling` experiment: `re10k`
    with one Gaussian per pixel and transmittance opacities."""
    encoder, decoder = re10k()
    return dataclasses.replace(encoder, gaussians_per_pixel=1, use_transmittance=True), decoder


def re10k_depth_loss_training() -> TrainingCfg:
    """The `re10k_depth_loss` experiment's training settings (its model is
    `re10k`'s): a rendered depth map per target view (`depth_mode: depth`)
    and the losses `[mse, lpips, depth]`, without remat or accumulation
    (`config/main.yaml`'s defaults)."""
    return TrainingCfg(
        optimizer=OptimizerCfg(lr=1.5e-4, warm_up_steps=2000),
        train=TrainCfg(depth_mode="depth", extended_visualization=False, remat_encoder=False),
        loss=(
            LossMseCfg(weight=1.0),
            LossLpipsCfg(weight=0.05, apply_after_step=150_000),
            LossDepthCfg(weight=0.25, sigma_image=None, use_second_derivative=False),
        ),
        gradient_clip_val=0.5,
        accumulate_grad_batches=1,
        batch_size=7,
    )


# (model config, training config) by experiment name, for the scripts.
# Every experiment that keeps config/main.yaml's trainer settings trains as
# the ablation does (batch 7 unless it says otherwise).
EXPERIMENTS = {
    "re10k": (re10k, re10k_training),
    "re10k_depth_loss": (re10k, re10k_depth_loss_training),
    "re10k_ablation_no_epipolar_transformer": (
        re10k_ablation_no_epipolar_transformer,
        re10k_ablation_no_epipolar_transformer_training,
    ),
    "acid": (re10k, re10k_ablation_no_epipolar_transformer_training),
    "re10k_3_view": (re10k_3_view, re10k_3_view_training),
    "re10k_ablation_no_depth_encoding": (
        re10k_ablation_no_depth_encoding,
        re10k_ablation_no_epipolar_transformer_training,
    ),
    "re10k_ablation_no_probabilistic_sampling": (
        re10k_ablation_no_probabilistic_sampling,
        re10k_ablation_no_epipolar_transformer_training,
    ),
}


def default_model() -> tuple[EncoderEpipolarCfg, DecoderSplattingCfg]:
    """The model that `config/main.yaml` composes with no experiment:
    `config/model/encoder/epipolar.yaml` with its default `resnet` backbone
    (resnet50, 5 layers, InstanceNorm), read through `load_config`."""
    model = load_config([]).model
    return model.encoder, model.decoder


__all__ = [
    "CONFIG_ROOT",
    "CheckpointingCfg",
    "DataLoaderCfg",
    "DataLoaderStageCfg",
    "DatasetRE10kCfg",
    "ModelCfg",
    "RootCfg",
    "TestCfg",
    "TrainerCfg",
    "ViewSamplerAllCfg",
    "ViewSamplerArbitraryCfg",
    "ViewSamplerBoundedCfg",
    "ViewSamplerEvaluationCfg",
    "WandbCfg",
    "compose_config",
    "from_dict",
    "load_config",
    "load_typed_root_config",
    "BackboneDinoCfg",
    "BackboneResnetCfg",
    "DecoderSplattingCfg",
    "EncoderEpipolarCfg",
    "EpipolarTransformerCfg",
    "GaussianAdapterCfg",
    "ImageSelfAttentionCfg",
    "LossDepthCfg",
    "LossLpipsCfg",
    "LossMseCfg",
    "OpacityMappingCfg",
    "OptimizerCfg",
    "RenderSettings",
    "TrainCfg",
    "TrainingCfg",
    "EXPERIMENTS",
    "re10k",
    "re10k_training",
    "re10k_depth_loss_training",
    "re10k_ablation_no_epipolar_transformer",
    "re10k_ablation_no_epipolar_transformer_training",
    "re10k_3_view",
    "re10k_3_view_training",
    "re10k_ablation_no_depth_encoding",
    "re10k_ablation_no_probabilistic_sampling",
    "default_model",
]
