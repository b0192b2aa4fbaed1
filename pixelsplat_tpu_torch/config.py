"""Configuration of the port: the config dataclasses and the slice's model.

The dataclasses live beside the modules they configure, as in the JAX
package (`pixelsplat_tpu/config.py` composes them from the YAML files
under `config/`). This module gathers them and builds the configuration of
the published ablation `config/experiment/re10k_ablation_no_epipolar_
transformer.yaml`: pixelSplat's re10k model without the epipolar
transformer, i.e. the DINO ViT-B/8 + dino_resnet50 backbone, d_feature
128, 32 depth buckets, 3 Gaussians per pixel and degree-4 SH, trained with
MSE + LPIPS (from step 150,000) by Adam at 1.5e-4 with a 2,000-step warm-up
and a 0.5 global-norm clip (`config/main.yaml`).
"""

from __future__ import annotations

from .model.decoder.decoder_splatting import DecoderSplattingCfg
from .model.encoder.backbone.dino import BackboneDinoCfg
from .model.encoder.backbone.resnet import BackboneResnetCfg
from .model.encoder.common.gaussian_adapter import GaussianAdapterCfg
from .model.encoder.encoder_epipolar import (
    EncoderEpipolarCfg,
    EpipolarTransformerCfg,
    ImageSelfAttentionCfg,
    OpacityMappingCfg,
)
from dataclasses import dataclass, field

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


def re10k_ablation_no_epipolar_transformer() -> tuple[EncoderEpipolarCfg, DecoderSplattingCfg]:
    """(encoder cfg, decoder cfg) of the `re10k_ablation_no_epipolar_
    transformer` experiment: `config/model/encoder/epipolar.yaml` with the
    `dino` backbone and `use_epipolar_transformer: false`, and
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
        use_epipolar_transformer=False,
        use_transmittance=False,
        compute_dtype=None,
    )
    return encoder, DecoderSplattingCfg()


def re10k_ablation_no_epipolar_transformer_training() -> TrainingCfg:
    """Optimizer, train settings and the loss list `[mse, lpips]` of the
    `re10k_ablation_no_epipolar_transformer` experiment."""
    return TrainingCfg(
        optimizer=OptimizerCfg(lr=1.5e-4, warm_up_steps=2000),
        train=TrainCfg(depth_mode=None, extended_visualization=False, remat_encoder=False),
        loss=(LossMseCfg(weight=1.0), LossLpipsCfg(weight=0.05, apply_after_step=150_000)),
        gradient_clip_val=0.5,
        accumulate_grad_batches=1,
    )


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
    "re10k_ablation_no_epipolar_transformer",
    "re10k_ablation_no_epipolar_transformer_training",
]
