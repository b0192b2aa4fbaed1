"""Configuration of the port: the config dataclasses and the slice's model.

The dataclasses live beside the modules they configure, as in the JAX
package (`pixelsplat_tpu/config.py` composes them from the YAML files
under `config/`). This module gathers them and builds the configurations of
two experiments. `re10k` (`config/experiment/re10k.yaml`) is the production
model: the DINO ViT-B/8 + dino_resnet50 backbone, d_feature 128, the
epipolar transformer (downscale 4, 32 samples per line, 2 cross-attention
layers whose feed-forward is a 2-layer image self-attention, 4 heads x 128,
10 octaves), 32 depth buckets, 3 Gaussians per pixel and degree-4 SH,
trained with MSE + LPIPS (from step 150,000) by Adam at 1.5e-4 with a
2,000-step warm-up and a 0.5 global-norm clip (`config/main.yaml`), the
encoder rematerialized and 7 batches accumulated per update.
`re10k_ablation_no_epipolar_transformer` is the published ablation without
the transformer, remat or accumulation.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

from .model.decoder.decoder_splatting import DecoderSplattingCfg
from .model.encoder.backbone.dino import BackboneDinoCfg
from .model.encoder.backbone.resnet import BackboneResnetCfg
from .model.encoder.common.gaussian_adapter import GaussianAdapterCfg
from .model.encoder.encoder_epipolar import EncoderEpipolarCfg, OpacityMappingCfg
from .model.encoder.epipolar.epipolar_transformer import EpipolarTransformerCfg
from .model.encoder.epipolar.image_self_attention import ImageSelfAttentionCfg
from .loss import LossDepthCfg, LossLpipsCfg, LossMseCfg
from .ops.rasterizer.render import RenderSettings
from .training.model_wrapper import TrainCfg
from .training.optimizer import OptimizerCfg

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


# (model config, training config) by experiment name, for the scripts.
EXPERIMENTS = {
    "re10k": (re10k, re10k_training),
    "re10k_ablation_no_epipolar_transformer": (
        re10k_ablation_no_epipolar_transformer,
        re10k_ablation_no_epipolar_transformer_training,
    ),
}


__all__ = [
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
    "re10k_ablation_no_epipolar_transformer",
    "re10k_ablation_no_epipolar_transformer_training",
]
