"""The pixelSplat encoder: context images -> per-pixel 3D Gaussians.

Port of `pixelsplat_tpu/model/encoder/encoder_epipolar.py`: backbone -> 1x1
projection to d_feature -> epipolar transformer (unless
`use_epipolar_transformer=False`, the published ablation) -> high-resolution
conv skip -> monocular depth predictor -> per-pixel Gaussian head ->
Gaussian adapter, with the pdf -> opacity warm-up mapping and per-pixel xy
offsets. `predict_opacity` scales every opacity by a learned per-pixel
sigmoid; `use_transmittance` takes the opacities from the depth pdf over
the mass left in front of each bucket. `compute_dtype="bfloat16"` is the
JAX package's bf16 compute policy (`model/precision.py`): the backbone, its
projection, the epipolar transformer and the high-resolution skip run in
bf16; the features go back to f32 before the depth predictor, and the
heads, the Gaussians and the rasterizer stay f32.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Literal, Optional, Union

import torch
from torch import nn

from ...geometry.projection import sample_image_grid
from ...ops.rasterizer.projection import GaussiansSoA
from .. import precision
from ..types import Gaussians
from .backbone.dino import BackboneDino, BackboneDinoCfg
from .backbone.resnet import BackboneResnet, BackboneResnetCfg
from .common.gaussian_adapter import GaussianAdapter, GaussianAdapterCfg
from .epipolar.depth_predictor_monocular import DepthPredictorMonocular
from .epipolar.epipolar_transformer import EpipolarTransformer, EpipolarTransformerCfg


@dataclass(frozen=True)
class OpacityMappingCfg:
    initial: float = 0.0
    final: float = 0.0
    warm_up: int = 1


@dataclass(frozen=True)
class EncoderEpipolarCfg:
    name: Literal["epipolar"] = "epipolar"
    d_feature: int = 128
    num_monocular_samples: int = 32
    num_surfaces: int = 1
    predict_opacity: bool = False
    backbone: Union[BackboneResnetCfg, BackboneDinoCfg] = field(
        default_factory=BackboneResnetCfg
    )
    near_disparity: float = 3.0
    gaussian_adapter: GaussianAdapterCfg = field(default_factory=GaussianAdapterCfg)
    apply_bounds_shim: bool = True
    epipolar_transformer: EpipolarTransformerCfg = field(
        default_factory=EpipolarTransformerCfg
    )
    opacity_mapping: OpacityMappingCfg = field(default_factory=OpacityMappingCfg)
    gaussians_per_pixel: int = 3
    use_epipolar_transformer: bool = True
    use_transmittance: bool = False
    num_context_views: int = 2
    # The bf16 compute policy ("bfloat16"); None computes in float32.
    compute_dtype: Optional[str] = None


class EncoderEpipolar(nn.Module):
    def __init__(self, cfg: EncoderEpipolarCfg):
        super().__init__()
        self.cfg = cfg
        dtype = self.dtype = precision.resolve_dtype(cfg.compute_dtype)
        if isinstance(cfg.backbone, BackboneDinoCfg):
            self.backbone = BackboneDino(cfg.backbone, dtype=dtype)
        else:
            self.backbone = BackboneResnet(cfg.backbone, dtype=dtype)
        d_out = cfg.backbone.d_out
        self.backbone_projection = nn.Sequential(
            nn.ReLU(), precision.Linear(d_out, cfg.d_feature, compute_dtype=dtype)
        )
        if cfg.use_epipolar_transformer:
            self.epipolar_transformer = EpipolarTransformer(
                cfg.epipolar_transformer, cfg.d_feature, num_context_views=cfg.num_context_views, dtype=dtype
            )
        self.high_resolution_skip = nn.Sequential(
            precision.Conv2d(3, cfg.d_feature, 7, padding=3, compute_dtype=dtype), nn.ReLU()
        )
        self.depth_predictor = DepthPredictorMonocular(
            cfg.d_feature, cfg.num_monocular_samples, cfg.num_surfaces, cfg.use_transmittance
        )
        self.gaussian_adapter = GaussianAdapter(cfg.gaussian_adapter)
        self.to_gaussians = nn.Sequential(
            nn.ReLU(),
            nn.Linear(cfg.d_feature, cfg.num_surfaces * (2 + self.gaussian_adapter.d_in)),
        )
        if cfg.predict_opacity:
            self.to_opacity = nn.Sequential(nn.ReLU(), nn.Linear(cfg.d_feature, 1))

    def map_pdf_to_opacity(self, pdf: torch.Tensor, global_step: int) -> torch.Tensor:
        """Warm-up-scheduled exponent mapping."""
        cfg = self.cfg.opacity_mapping
        frac = min(global_step / cfg.warm_up, 1.0)
        x = cfg.initial + frac * (cfg.final - cfg.initial)
        exponent = 2.0**x
        return 0.5 * (1.0 - (1.0 - pdf) ** exponent + pdf ** (1.0 / exponent))

    def forward(
        self,
        context: dict,
        global_step: int,
        deterministic: bool = False,
        pack_soa: bool = False,
        u: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        view_order: Optional[torch.Tensor] = None,
        visualization_dump: Optional[dict] = None,
    ) -> Union[Gaussians, GaussiansSoA]:
        """Encode `context` (images (b, v, 3, h, w) and cameras).

        The depth samples are drawn from `u` ((b, v, h*w, surfaces, gpp)
        uniforms) when given, else from `generator`. With more than two
        views the epipolar transformer's view embeddings are dealt in
        `view_order` (a permutation of v-1) when given; else in a random
        order from `generator`, or in plain order when deterministic. With
        `pack_soa` the scene comes out as `GaussiansSoA` planes with a
        leading batch axis in (v, srf, gpp, r) Gaussian order, its harmonics
        sample-shared (b, 3, d_sh, v*srf, 1, h*w); otherwise as AoS
        `Gaussians`. `visualization_dump`, when given, receives the depths,
        scales, rotations and the epipolar sampling.
        """
        cfg = self.cfg
        image = context["image"]
        b, v, _, h, w = image.shape

        features = self.backbone(image)  # (b, v, h, w, c)
        features = self.backbone_projection(features)

        sampling = None
        if cfg.use_epipolar_transformer:
            if view_order is None and v > 2 and not deterministic:
                view_order = torch.randperm(v - 1, generator=generator, device=features.device)
            features, sampling = self.epipolar_transformer(
                features, context["extrinsics"], context["intrinsics"], context["near"], context["far"],
                view_order=view_order,
            )

        skip = self.high_resolution_skip(image.reshape(b * v, 3, h, w))
        features = features + skip.permute(0, 2, 3, 1).reshape(b, v, h, w, cfg.d_feature)

        features = features.reshape(b, v, h * w, cfg.d_feature).float()
        gpp = 1 if deterministic else cfg.gaussians_per_pixel
        depths, densities = self.depth_predictor(
            features, context["near"], context["far"], deterministic, gpp, u=u, generator=generator
        )

        adapter = self.gaussian_adapter
        raw = self.to_gaussians(features)
        raw = raw.reshape(b, v, h * w, cfg.num_surfaces, 2 + adapter.d_in)

        xy_ray, _ = sample_image_grid((h, w), device=features.device, dtype=features.dtype)
        xy_ray = xy_ray.reshape(h * w, 1, 2)
        offset_xy = torch.sigmoid(raw[..., :2])
        pixel_size = torch.tensor([1.0 / w, 1.0 / h], dtype=features.dtype, device=features.device)
        xy_ray = xy_ray[None, None] + (offset_xy - 0.5) * pixel_size

        gaussians = adapter(
            context["extrinsics"][:, :, None, None, None],
            context["intrinsics"][:, :, None, None, None],
            xy_ray[:, :, :, :, None],  # (b, v, r, srf, 1, 2)
            depths,
            self.map_pdf_to_opacity(densities, global_step) / cfg.gaussians_per_pixel,
            raw[..., None, 2:],  # (b, v, r, srf, 1, d_in)
            (h, w),
        )

        spp = gaussians.means.shape[-2]
        srf = cfg.num_surfaces
        if visualization_dump is not None:
            visualization_dump["depth"] = depths.reshape(b, v, h, w, srf, -1)
            visualization_dump["scales"] = gaussians.scales.reshape(b, -1, 3)
            visualization_dump["rotations"] = gaussians.rotations.reshape(b, -1, 4)
            if sampling is not None:
                visualization_dump["sampling"] = sampling
        g = v * (h * w) * srf * spp
        opacities = gaussians.opacities
        if cfg.predict_opacity:
            opacities = torch.sigmoid(self.to_opacity(features))[..., None] * opacities  # (b, v, r, 1, 1)
        if pack_soa:
            # SoA g-order (v, srf, gpp, r): the sample axis is second
            # outermost, so the per-ray harmonics factor as (V, 1, R).

            def plane(x):  # (b, v, r, srf, spp) -> (b, g)
                x = x.expand(b, v, h * w, srf, spp)
                return x.permute(0, 1, 3, 4, 2).reshape(b, g)

            means = gaussians.means
            cov = gaussians.covariances
            cov6 = torch.stack(
                [plane(cov[..., i, j]) for i, j in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))],
                dim=1,
            )  # (b, 6, g)
            harm = gaussians.harmonics.permute(0, 5, 6, 1, 3, 4, 2)
            harm = harm.reshape(b, 3, adapter.d_sh, v * srf, 1, h * w)
            return GaussiansSoA(
                mean_x=plane(means[..., 0]),
                mean_y=plane(means[..., 1]),
                mean_z=plane(means[..., 2]),
                cov=cov6,
                opacity=plane(opacities),
                harmonics=harm,
            )
        harmonics = gaussians.harmonics.expand(b, v, h * w, srf, spp, 3, adapter.d_sh)
        return Gaussians(
            means=gaussians.means.reshape(b, g, 3),
            covariances=gaussians.covariances.reshape(b, g, 3, 3),
            harmonics=harmonics.reshape(b, g, 3, adapter.d_sh),
            opacities=opacities.reshape(b, g),
        )
