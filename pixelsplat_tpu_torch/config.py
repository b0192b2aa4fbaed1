"""Configuration of the port: the config dataclasses and the slice's model.

The dataclasses live beside the modules they configure, as in the JAX
package (`pixelsplat_tpu/config.py` composes them from the YAML files
under `config/`). This module gathers them and builds the configuration of
the published ablation `config/experiment/re10k_ablation_no_epipolar_
transformer.yaml`: pixelSplat's re10k model without the epipolar
transformer, i.e. the DINO ViT-B/8 + dino_resnet50 backbone, d_feature
128, 32 depth buckets, 3 Gaussians per pixel and degree-4 SH.
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
from .ops.rasterizer.render import RenderSettings


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


__all__ = [
    "BackboneDinoCfg",
    "BackboneResnetCfg",
    "DecoderSplattingCfg",
    "EncoderEpipolarCfg",
    "EpipolarTransformerCfg",
    "GaussianAdapterCfg",
    "ImageSelfAttentionCfg",
    "OpacityMappingCfg",
    "RenderSettings",
    "re10k_ablation_no_epipolar_transformer",
]
