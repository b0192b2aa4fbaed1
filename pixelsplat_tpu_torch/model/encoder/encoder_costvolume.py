"""The MVSplat encoder: context images -> one 3D Gaussian a pixel, its depth
from a plane-sweep cost volume across the context views.

MVSplat (Chen et al., ECCV 2024, arXiv:2403.14627; github.com/donydchen/
mvsplat `src/model/encoder/encoder_costvolume.py`) keeps pixelSplat's
decoder and Gaussian adapter and replaces the encoder with a multi-view one,
run here as six stages at features of 1/`downscale_factor` resolution:

1. `encoder.backbone`: UniMatch's CNN (`costvolume/backbone_multiview.py`).
2. `encoder.mv_transformer`: 6 blocks of windowed self-attention and
   cross-view attention over the CNN's features.
3. `encoder.costvolume`: each view's pixels lifted at `num_depth_candidates`
   disparities evenly spaced from 1 / far to 1 / near, projected into every
   other view, whose features are gathered there by bilinear `grid_sample`
   and correlated; the mean over the other views beside the features.
4. `encoder.cv_refine`: a convolution and a U-Net with attention across the
   views, a residual, a depth head and a softmax over the candidates: the
   coarse disparity is its expectation, `pdf_max` its maximum.
5. `encoder.depth_refine`: the features upsampled to full resolution, a
   U-Net on them with the image, the disparity and `pdf_max`, and a head
   that gives a disparity delta and a density.
6. `encoder.heads`: a convolutional Gaussian head on the refined features,
   the image and the upsampled features, pixelSplat's `GaussianAdapter`
   and the packing.

It samples nothing: `forward` takes `EncoderEpipolar.forward`'s arguments
and ignores `u`, `generator` and `view_order`. Only float32 runs
(`compute_dtype` None). On a CUDA device without autograd or a
visualization dump the stages run as CUDA graphs (`graphs.py`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Literal, Optional, Union

import torch
from torch import nn

from ...geometry.projection import sample_image_grid
from ...ops.rasterizer.projection import GaussiansSoA
from ...utils import tracing
from ...utils.shape_checks import check_context
from ..types import Gaussians
from .common.gaussian_adapter import GaussianAdapter, GaussianAdapterCfg, pixel_size
from .common.opacity import OpacityMappingCfg, map_pdf_to_opacity, opacity_exponent
from .common.packing import pack
from .costvolume.backbone_multiview import BackboneMultiview
from .costvolume.depth_predictor_multiview import DepthPredictorMultiView
from .graphs import EncoderGraphs, Stage, run_eagerly


@dataclass(frozen=True)
class EncoderCostVolumeCfg:
    """The fields of MVSplat's `config/model/encoder/costvolume.yaml` that
    change the forward pass, at that file's values."""

    name: Literal["costvolume"] = "costvolume"
    d_feature: int = 128
    num_depth_candidates: int = 32
    num_surfaces: int = 1
    gaussians_per_pixel: int = 1
    gaussian_adapter: GaussianAdapterCfg = field(default_factory=GaussianAdapterCfg)
    opacity_mapping: OpacityMappingCfg = field(default_factory=OpacityMappingCfg)
    multiview_trans_attn_split: int = 2
    costvolume_unet_feat_dim: int = 128
    costvolume_unet_channel_mult: tuple[int, ...] = (1, 1, 1)
    costvolume_unet_attn_res: tuple[int, ...] = ()
    depth_unet_feat_dim: int = 64
    depth_unet_attn_res: tuple[int, ...] = ()
    depth_unet_channel_mult: tuple[int, ...] = (1, 1, 1)
    downscale_factor: int = 4
    shim_patch_size: int = 4
    num_context_views: int = 2
    # Only float32 (None) runs.
    compute_dtype: Optional[str] = None


class EncoderCostVolume(nn.Module):
    def __init__(self, cfg: EncoderCostVolumeCfg):
        super().__init__()
        if cfg.compute_dtype is not None:
            raise ValueError(f"the cost-volume encoder computes in float32 only, not {cfg.compute_dtype!r}")
        if cfg.num_surfaces != 1:
            raise ValueError(f"the cost-volume encoder places one surface a pixel, not {cfg.num_surfaces}")
        if cfg.downscale_factor != 4:
            raise ValueError(f"UniMatch's CNN gives features at 1/4 resolution, not 1/{cfg.downscale_factor}")
        self.cfg = cfg
        self.backbone = BackboneMultiview(cfg.d_feature)
        self.gaussian_adapter = GaussianAdapter(cfg.gaussian_adapter)
        self.depth_predictor = DepthPredictorMultiView(cfg, cfg.num_surfaces * (self.gaussian_adapter.d_in + 2))
        self._graphs = EncoderGraphs()

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
        """Encode `context` (images (b, v, 3, h, w) and cameras) into
        `gaussians_per_pixel` Gaussians a pixel; `pack_soa` as in
        `common/packing.py`. `deterministic`, `u`, `generator` and
        `view_order` change nothing: MVSplat draws no samples.
        `visualization_dump`, when given, receives the depths, scales and
        rotations."""
        check_context(context)
        image = context["image"]
        b, v, _, h, w = image.shape
        splits = self.cfg.multiview_trans_attn_split
        if (h // self.cfg.downscale_factor) % splits or (w // self.cfg.downscale_factor) % splits:
            raise ValueError(f"features of {h}x{w} images do not split into {splits}x{splits} windows")
        if v != self.cfg.num_context_views:
            raise ValueError(f"the encoder is configured for {self.cfg.num_context_views} context views, got {v}")
        inputs = {name: context[name] for name in ("image", "extrinsics", "intrinsics", "near", "far")}
        stages = self._stages(global_step, pack_soa, visualization_dump)
        if self._graphs.replays(image, None, visualization_dump, False):
            values = (pack_soa, opacity_exponent(self.cfg.opacity_mapping, global_step))
            gaussians = self._graphs.run(self, stages, inputs, values)
        else:
            gaussians = run_eagerly(stages, inputs)
        # Bilinear samples of the cost volume, each gathered for every channel.
        hf, wf = h // self.cfg.downscale_factor, w // self.cfg.downscale_factor
        tracing.count("costvolume_taps", b * v * (v - 1) * self.cfg.num_depth_candidates * hf * wf)
        tracing.count("gaussians", b * v * h * w * self.cfg.num_surfaces * self.cfg.gaussians_per_pixel)
        return gaussians

    def _stages(self, global_step: int, pack_soa: bool, visualization_dump: Optional[dict]) -> list[Stage]:
        """The encode as its six stages, on the inputs `forward` names:
        image, extrinsics, intrinsics, near and far."""
        backbone, predictor = self.backbone, self.depth_predictor
        splits = self.cfg.multiview_trans_attn_split
        gpp = self.cfg.gaussians_per_pixel

        def heads(refined, image, extrinsics, intrinsics):
            return self._gaussians(refined, image, extrinsics, intrinsics, global_step, pack_soa, visualization_dump)

        cameras = ("intrinsics", "extrinsics", "near", "far")
        return [
            Stage("encoder.backbone", backbone.cnn, ("image",), "cnn"),
            Stage("encoder.mv_transformer", lambda cnn: backbone.transformer(cnn, splits), ("cnn",), "features"),
            Stage("encoder.costvolume", predictor.cost_volume, ("features", *cameras), "volume"),
            Stage("encoder.cv_refine", lambda volume: predictor.refine_cost_volume(*volume), ("volume",), "coarse"),
            Stage(
                "encoder.depth_refine",
                lambda features, cnn, image, coarse, near, far: predictor.refine_depth(
                    features, cnn, image, *coarse, near, far, gpp
                ),
                ("features", "cnn", "image", "coarse", "near", "far"),
                "refined",
            ),
            Stage("encoder.heads", heads, ("refined", "image", "extrinsics", "intrinsics"), "gaussians"),
        ]

    def _gaussians(self, refined, image, extrinsics, intrinsics, global_step, pack_soa, visualization_dump):
        """The stage `encoder.heads`: the Gaussian head on the refined
        features, the image and the upsampled features, the adapter, and the
        packing."""
        cfg = self.cfg
        refined, upsampled, depths, densities = refined
        b, v, _, h, w = image.shape
        gpp, srf = cfg.gaussians_per_pixel, cfg.num_surfaces
        images = image.transpose(0, 1).reshape(v * b, 3, h, w)
        raw = self.depth_predictor.to_gaussians(torch.cat([refined, images, upsampled], dim=1))

        def bv(x):  # (v b, c, h, w) -> (b, v, h*w, c)
            return x.reshape(v, b, x.shape[1], h * w).permute(1, 0, 3, 2)

        adapter = self.gaussian_adapter
        raw = bv(raw).reshape(b, v, h * w, srf, 2 + adapter.d_in)
        depths = bv(depths)[:, :, :, None, :]  # (b, v, r, srf, gpp)
        densities = bv(densities)[:, :, :, None, :]

        xy_ray, _ = sample_image_grid((h, w), device=raw.device, dtype=raw.dtype)
        xy_ray = xy_ray.reshape(h * w, 1, 2)
        xy_ray = xy_ray[None, None] + (torch.sigmoid(raw[..., :2]) - 0.5) * pixel_size((h, w), raw.device, raw.dtype)
        exponent = opacity_exponent(cfg.opacity_mapping, global_step)
        gaussians = adapter(
            extrinsics[:, :, None, None, None],
            intrinsics[:, :, None, None, None],
            xy_ray[:, :, :, :, None],  # (b, v, r, srf, 1, 2)
            depths,
            map_pdf_to_opacity(densities, exponent) / gpp,
            raw[..., None, 2:],  # (b, v, r, srf, 1, d_in)
            (h, w),
        )
        if visualization_dump is not None:
            visualization_dump["depth"] = depths.reshape(b, v, h, w, srf, -1)
            visualization_dump["scales"] = gaussians.scales.reshape(b, -1, 3)
            visualization_dump["rotations"] = gaussians.rotations.reshape(b, -1, 4)
        return pack(gaussians, gaussians.opacities, pack_soa)
