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

from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Iterator, Literal, Optional, Union

import torch
from torch import nn

from ...geometry.projection import sample_image_grid
from ...ops.rasterizer.projection import GaussiansSoA
from ...utils import tracing
from ...utils.distributions import uniforms
from ...utils.shape_checks import check_context
from .. import precision
from ..types import Gaussians
from .backbone.dino import BackboneDino, BackboneDinoCfg
from .backbone.resnet import BackboneResnet, BackboneResnetCfg
from .common.gaussian_adapter import GaussianAdapter, GaussianAdapterCfg, pixel_size
from .common.opacity import OpacityMappingCfg, map_pdf_to_opacity, opacity_exponent
from .common.packing import pack
from .epipolar.depth_predictor_monocular import DepthPredictorMonocular
from .epipolar.epipolar_transformer import EpipolarTransformer, EpipolarTransformerCfg
from .graphs import EncoderGraphs, Stage, run_eagerly


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
        self._graphs = EncoderGraphs()

    def opacity_exponent(self, global_step: int) -> float:
        """The warm-up-scheduled exponent of `map_pdf_to_opacity`."""
        return opacity_exponent(self.cfg.opacity_mapping, global_step)

    def map_pdf_to_opacity(self, pdf: torch.Tensor, global_step: int) -> torch.Tensor:
        """Warm-up-scheduled exponent mapping."""
        return map_pdf_to_opacity(pdf, self.opacity_exponent(global_step))

    @contextmanager
    def capture_intermediates(self) -> Iterator[dict]:
        """Within the block, each forward records what the JAX encoder sows
        into `intermediates`: under "attention", one list per layer of the
        epipolar transformer's cross-attention maps (b*v*r, heads, 1,
        samples*(v-1)) (not the image self-attention's); under "pdf" and
        "offset", the depth predictor's. Outside the block the encoder
        records nothing."""
        layers = []
        if self.cfg.use_epipolar_transformer:
            layers = [attention.fn for attention, _ in self.epipolar_transformer.transformer.layers]
        captured: dict = {"attention": [[] for _ in layers]}
        for layer, maps in zip(layers, captured["attention"]):
            layer.capture = maps
        self.depth_predictor.capture = captured
        try:
            yield captured
        finally:
            for layer in layers:
                layer.capture = None
            self.depth_predictor.capture = None

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

        On a CUDA device without autograd, the visualization dump or
        `capture_intermediates`, the stages run as CUDA graphs
        (`graphs.py`), captured on the first call of each signature and
        replayed after; the depth uniforms and the view order are then
        drawn before the replay, by the same calls in the same order.
        """
        check_context(context)
        cfg = self.cfg
        image = context["image"]
        b, v, _, h, w = image.shape
        gpp = 1 if deterministic else cfg.gaussians_per_pixel
        if cfg.use_epipolar_transformer and view_order is None and v > 2 and not deterministic:
            view_order = torch.randperm(v - 1, generator=generator, device=image.device)

        inputs = {name: context[name] for name in ("image", "extrinsics", "intrinsics", "near", "far")}
        inputs["u"] = None if deterministic else u
        reads_order = cfg.use_epipolar_transformer and v > 2 and view_order is not None
        inputs["view_order"] = view_order if reads_order else None
        stages = self._stages(global_step, deterministic, pack_soa, generator, visualization_dump)
        if self._graphs.replays(image, u, visualization_dump, self.depth_predictor.capture is not None):
            if u is None and not deterministic:
                inputs["u"] = uniforms((b, v, h * w, cfg.num_surfaces, gpp), torch.float32, image.device, generator)
            if reads_order:
                inputs["view_order"] = view_order.to(image.device)
            values = (pack_soa, deterministic, self.opacity_exponent(global_step), self.dtype)
            gaussians = self._graphs.run(self, stages, inputs, values)
        else:
            gaussians = run_eagerly(stages, inputs)
        tracing.count("gaussians", b * v * h * w * cfg.num_surfaces * gpp)
        return gaussians

    def _stages(self, global_step, deterministic, pack_soa, generator, visualization_dump) -> list[Stage]:
        """The encode as its four stages, on the inputs `forward` names:
        image, extrinsics, intrinsics, near, far, u and view_order."""
        cameras = ("extrinsics", "intrinsics", "near", "far")

        def backbone(image):
            return self.backbone_projection(self.backbone(image))  # (b, v, h, w, d_feature)

        def heads(features, image, extrinsics, intrinsics, near, far, u):
            return self._gaussians(features, image, extrinsics, intrinsics, near, far, u, global_step, deterministic,
                                   pack_soa, generator, visualization_dump)

        stages = [Stage("encoder.backbone", backbone, ("image",), "features")]
        if self.cfg.use_epipolar_transformer:
            transformer = self.epipolar_transformer

            def attend(*args):
                low, sampling = transformer.attend(*args)
                if visualization_dump is not None:
                    visualization_dump["sampling"] = sampling
                return low

            attended = "low" if transformer.cfg.downscale else "features"
            stages.append(Stage("encoder.epipolar", attend, ("features", *cameras, "view_order"), attended))
            if transformer.cfg.downscale:
                stages.append(Stage("encoder.refine", transformer.refine, ("low",), "features"))
        stages.append(Stage("encoder.heads", heads, ("features", "image", *cameras, "u"), "gaussians"))
        return stages

    def _gaussians(self, features, image, extrinsics, intrinsics, near, far, u, global_step, deterministic, pack_soa,
                   generator, visualization_dump):
        """The stage `encoder.heads` on the transformer's features: the
        high-resolution skip, the depth predictor, the Gaussian head and
        adapter, and the packing `forward` describes."""
        cfg = self.cfg
        b, v, _, h, w = image.shape
        skip = self.high_resolution_skip(image.reshape(b * v, 3, h, w))
        features = features + skip.permute(0, 2, 3, 1).reshape(b, v, h, w, cfg.d_feature)

        features = features.reshape(b, v, h * w, cfg.d_feature).float()
        gpp = 1 if deterministic else cfg.gaussians_per_pixel
        depths, densities = self.depth_predictor(features, near, far, deterministic, gpp, u=u, generator=generator)

        adapter = self.gaussian_adapter
        raw = self.to_gaussians(features)
        raw = raw.reshape(b, v, h * w, cfg.num_surfaces, 2 + adapter.d_in)

        xy_ray, _ = sample_image_grid((h, w), device=features.device, dtype=features.dtype)
        xy_ray = xy_ray.reshape(h * w, 1, 2)
        offset_xy = torch.sigmoid(raw[..., :2])
        xy_ray = xy_ray[None, None] + (offset_xy - 0.5) * pixel_size((h, w), features.device, features.dtype)

        gaussians = adapter(
            extrinsics[:, :, None, None, None],
            intrinsics[:, :, None, None, None],
            xy_ray[:, :, :, :, None],  # (b, v, r, srf, 1, 2)
            depths,
            self.map_pdf_to_opacity(densities, global_step) / cfg.gaussians_per_pixel,
            raw[..., None, 2:],  # (b, v, r, srf, 1, d_in)
            (h, w),
        )

        if visualization_dump is not None:
            visualization_dump["depth"] = depths.reshape(b, v, h, w, cfg.num_surfaces, -1)
            visualization_dump["scales"] = gaussians.scales.reshape(b, -1, 3)
            visualization_dump["rotations"] = gaussians.rotations.reshape(b, -1, 4)
        opacities = gaussians.opacities
        if cfg.predict_opacity:
            opacities = torch.sigmoid(self.to_opacity(features))[..., None] * opacities  # (b, v, r, 1, 1)
        return pack(gaussians, opacities, pack_soa)
