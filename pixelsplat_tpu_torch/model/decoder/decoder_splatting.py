"""Decoder: render Gaussians into the target views with the tiled rasterizer.

Port of `pixelsplat_tpu/model/decoder/decoder_splatting.py`. The scene is
packed to structure-of-arrays once per batch element, or arrives packed
from the encoder (`GaussiansSoA`), and each target view is rendered from it
in turn. With a `depth_mode` each view is also rendered as depth
(`render_depth`, one colour channel), from the public AoS Gaussians only.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Literal, NamedTuple, Optional, Union

import torch

from ...ops.rasterizer.projection import GaussiansSoA, pack_gaussians_soa
from ...ops.rasterizer.render import DepthRenderingMode, RenderSettings, render_depth, render_view_soa
from ...utils import tracing
from ..types import Gaussians


class DecoderOutput(NamedTuple):
    color: torch.Tensor  # (b, v, 3, h, w)
    depth: Optional[torch.Tensor] = None  # (b, v, h, w)
    # (gaussian, tile) pairs the binner dropped, summed over all views.
    overflow: Optional[torch.Tensor] = None  # () int32


@dataclass(frozen=True)
class DecoderSplattingCfg:
    name: Literal["splatting"] = "splatting"
    background_color: tuple[float, float, float] = (0.0, 0.0, 0.0)
    render: RenderSettings = field(default_factory=RenderSettings)


class DecoderSplatting:
    """Stateless decoder (no learnable parameters)."""

    def __init__(self, cfg: DecoderSplattingCfg):
        self.cfg = cfg

    def __call__(
        self,
        gaussians: Union[Gaussians, GaussiansSoA],
        extrinsics: torch.Tensor,  # (b, v, 4, 4)
        intrinsics: torch.Tensor,  # (b, v, 3, 3)
        near: torch.Tensor,  # (b, v)
        far: torch.Tensor,  # (b, v)
        image_shape: tuple[int, int],
        depth_mode: Optional[DepthRenderingMode] = None,
        render_settings: Optional[RenderSettings] = None,
    ) -> DecoderOutput:
        if depth_mode is not None and isinstance(gaussians, GaussiansSoA):
            raise NotImplementedError("depth_mode rendering takes the public AoS Gaussians")
        settings = render_settings if render_settings is not None else self.cfg.render
        with tracing.sync_point("upload.background"):
            background = torch.tensor(
                self.cfg.background_color, dtype=extrinsics.dtype, device=extrinsics.device
            )
        colors, overflows = [], []
        for i in range(extrinsics.shape[0]):
            if isinstance(gaussians, GaussiansSoA):
                soa = GaussiansSoA(*(None if x is None else x[i] for x in gaussians))
            else:
                soa = pack_gaussians_soa(
                    gaussians.means[i],
                    gaussians.covariances[i],
                    gaussians.opacities[i],
                    harmonics=gaussians.harmonics[i],
                )
            views = [
                render_view_soa(
                    extrinsics[i, j], intrinsics[i, j], near[i, j], far[i, j], background, soa,
                    image_shape=image_shape, settings=settings,
                )
                for j in range(extrinsics.shape[1])
            ]
            colors.append(torch.stack([image for image, _ in views]))
            overflows.extend(overflow for _, overflow in views)
        depth = None
        if depth_mode is not None:
            depth = torch.stack([
                torch.cat([
                    render_depth(
                        extrinsics[i, j, None], intrinsics[i, j, None], near[i, j, None], far[i, j, None],
                        image_shape, gaussians.means[i, None], gaussians.covariances[i, None],
                        gaussians.opacities[i, None], mode=depth_mode, settings=settings,
                    )
                    for j in range(extrinsics.shape[1])
                ])
                for i in range(extrinsics.shape[0])
            ])  # (b, v, h, w)
        return DecoderOutput(
            color=torch.stack(colors), depth=depth, overflow=torch.stack(overflows).sum(dtype=torch.int32)
        )
