"""Evaluation entry points around the encoder and decoder.

Port of the evaluation methods of `pixelsplat_tpu/training/model_wrapper.py`
(`make_eval_encode`, `choose_eval_settings`, `make_eval_decode`): encode
the context views, choose render settings for the scene from its tile
occupancy, render the target views. Training waits for a later slice.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from ..model.decoder.decoder_splatting import DecoderSplatting, DecoderSplattingCfg
from ..model.encoder.data_shim import get_data_shim
from ..model.encoder.encoder_epipolar import EncoderEpipolar, EncoderEpipolarCfg
from ..model.types import Gaussians
from ..ops.rasterizer.adaptive import choose_settings
from ..ops.rasterizer.projection import GaussiansSoA
from ..ops.rasterizer.render import RenderSettings


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The device to run on; a CUDA device must exist (no CPU fallback)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pixelsplat_tpu_torch runs on the GPU unless the caller "
            "passes device='cpu'"
        )
    return device


def batch_to(batch: dict, device: torch.device) -> dict:
    """Nested dict of arrays/tensors -> tensors on `device`, floats as float32."""
    out = {}
    for key, value in batch.items():
        if isinstance(value, dict):
            out[key] = batch_to(value, device)
            continue
        value = torch.as_tensor(value)
        if value.is_floating_point():
            value = value.float()
        out[key] = value.to(device)
    return out


class ModelWrapper:
    """Holds the encoder (in eval mode on `device`), the decoder and the
    encoder's data shim."""

    def __init__(
        self,
        encoder_cfg: EncoderEpipolarCfg,
        decoder_cfg: DecoderSplattingCfg,
        device: Union[str, torch.device] = "cuda",
    ):
        self.device = resolve_device(device)
        self.encoder_cfg = encoder_cfg
        self.encoder = EncoderEpipolar(encoder_cfg).to(self.device).eval()
        self.data_shim = get_data_shim(encoder_cfg)
        self.decoder = DecoderSplatting(decoder_cfg)

    def make_eval_encode(self, pack_soa: bool = False) -> Callable:
        """`encode_fn(batch, deterministic, step, generator=None, u=None)`.

        Runs the data shim and the encoder without autograd. `pack_soa=True`
        emits the scene in the rasterizer's SoA layout, for callers that
        only render. The depth samples come from `u` when given, else from
        `generator`.
        """

        @torch.no_grad()
        def encode_fn(
            batch: dict,
            deterministic: bool,
            step: int,
            generator: Optional[torch.Generator] = None,
            u: Optional[torch.Tensor] = None,
        ) -> Union[Gaussians, GaussiansSoA]:
            batch = self.data_shim(batch_to(batch, self.device))
            return self.encoder(
                batch["context"], step, deterministic, pack_soa=pack_soa, u=u, generator=generator
            )

        return encode_fn

    def choose_eval_settings(
        self,
        gaussians: Union[Gaussians, GaussiansSoA],
        extrinsics: torch.Tensor,  # (b, v, 4, 4)
        intrinsics: torch.Tensor,  # (b, v, 3, 3)
        near: torch.Tensor,  # (b, v)
        image_shape: tuple[int, int],
    ) -> RenderSettings:
        """Occupancy-adaptive render settings for batch element 0's views
        (one host sync per scene)."""
        if isinstance(gaussians, GaussiansSoA):
            means = torch.stack(
                [gaussians.mean_x[0], gaussians.mean_y[0], gaussians.mean_z[0]], dim=-1
            )
            c = gaussians.cov[0]
            covs = torch.stack(
                [
                    torch.stack([c[0], c[1], c[2]], -1),
                    torch.stack([c[1], c[3], c[4]], -1),
                    torch.stack([c[2], c[4], c[5]], -1),
                ],
                dim=-2,
            )
            opacities = gaussians.opacity[0]
        else:
            means = gaussians.means[0]
            covs = gaussians.covariances[0]
            opacities = gaussians.opacities[0]
        v = extrinsics.shape[1]
        g = means.shape[0]
        with torch.no_grad():
            return choose_settings(
                extrinsics[0].to(self.device),
                intrinsics[0].to(self.device),
                near[0].to(self.device),
                means[None].expand(v, g, 3),
                covs[None].expand(v, g, 3, 3),
                opacities[None].expand(v, g),
                image_shape,
                settings=self.decoder.cfg.render,
            )

    def make_eval_decode(self) -> Callable:
        """`decode_fn(gaussians, extrinsics, intrinsics, near, far,
        image_shape, render_settings=None)` -> (color (b, v, 3, h, w),
        overflow)."""

        @torch.no_grad()
        def decode_fn(
            gaussians,
            extrinsics,
            intrinsics,
            near,
            far,
            image_shape,
            render_settings: Optional[RenderSettings] = None,
        ):
            output = self.decoder(
                gaussians,
                extrinsics.to(self.device),
                intrinsics.to(self.device),
                near.to(self.device),
                far.to(self.device),
                image_shape,
                render_settings=render_settings,
            )
            return output.color, output.overflow

        return decode_fn
