"""Epipolar transformer: per-pixel cross-attention over epipolar samples.

Port of `pixelsplat_tpu/model/encoder/epipolar/epipolar_transformer.py`:
strided-conv downscale, epipolar sampling, positional depth encoding added
to the kv features, a cross-attention transformer whose feed-forward is an
image self-attention block, and a transposed-conv upscale with a conv
refinement. Feature maps are channels-last at this module's boundary and
between its steps, as in the JAX package, so each reshape reads as there;
only the downscaler and upscaler see channels-first views (the
refinement's two 7x7 convolutions run channels-last, `ops/conv7_kernel.py`).
With a compute `dtype` (`model/precision.py`) the convolutions, the depth
encoding's projection and the transformer run in it, as in the JAX module;
the epipolar samples come out f32.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch
from torch import nn

from ....geometry.epipolar_lines import get_depth
from ....ops import conv7_kernel
from ....utils import tracing
from ... import precision
from ...encodings import PositionalEncoding
from ...transformer.transformer import Transformer
from .conversions import depth_to_relative_disparity
from .epipolar_sampler import EpipolarSampling, collect_other_views, sample_along_epipolar_lines
from .image_self_attention import ImageSelfAttention, ImageSelfAttentionCfg


@dataclass(frozen=True)
class EpipolarTransformerCfg:
    self_attention: ImageSelfAttentionCfg = field(default_factory=ImageSelfAttentionCfg)
    num_octaves: int = 10
    num_layers: int = 2
    num_heads: int = 4
    num_samples: int = 32
    d_dot: int = 128
    d_mlp: int = 256
    downscale: int = 4


def conv_nhwc(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Apply a channels-first convolution to a channels-last stack: the
    downscaler and the upscaler.

    The convolution is handed a contiguous channels-first copy: for a
    channels-last float32 view cuDNN falls back to a generic engine, which
    ran the 7x7 refinement convolutions 2.3x slower than its channels-first
    implicit GEMM on an H100 (PERF.md). The refinement no longer comes here:
    `ops/conv7_kernel.py::refine` runs it channels-last (K9 on the card).
    """
    return conv(x.permute(0, 3, 1, 2).contiguous()).permute(0, 2, 3, 1)


class ImageSelfAttentionFF(nn.Module):
    """Feed-forward layer that is an image self-attention block (with its
    own residual), on the (b*v*h*w, 1, c) token layout."""

    def __init__(self, cfg: ImageSelfAttentionCfg, dim: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.self_attention = ImageSelfAttention(cfg, dim, dim, dtype=dtype)

    def forward(self, x: torch.Tensor, b: int, v: int, h: int, w: int) -> torch.Tensor:
        c = x.shape[-1]
        img = x.reshape(b * v, h, w, c)
        img = self.self_attention(img) + img
        return img.reshape(b * v * h * w, 1, c)


class EpipolarTransformer(nn.Module):
    def __init__(self, cfg: EpipolarTransformerCfg, d_in: int, num_context_views: int = 2,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg = cfg
        self.d_in = d_in
        if cfg.downscale:
            self.downscaler = precision.Conv2d(d_in, d_in, cfg.downscale, cfg.downscale, compute_dtype=dtype)
            self.upscaler = precision.ConvTranspose2d(d_in, d_in, cfg.downscale, cfg.downscale, compute_dtype=dtype)
            self.upscale_refinement = nn.Sequential(
                precision.Conv2d(d_in, d_in * 2, 7, 1, 3, compute_dtype=dtype), nn.GELU(),
                precision.Conv2d(d_in * 2, d_in, 7, 1, 3, compute_dtype=dtype),
            )
        if cfg.num_octaves > 0:
            encoding = PositionalEncoding(cfg.num_octaves)
            self.depth_encoding = nn.Sequential(encoding, precision.Linear(encoding.d_out(1), d_in, compute_dtype=dtype))
        # Per-view embeddings tell the other views apart when there are
        # more than two context views.
        if num_context_views > 2:
            self.view_embeddings = nn.Embedding(num_context_views, d_in)
        self.transformer = Transformer(
            d_in, cfg.num_layers, cfg.num_heads, cfg.d_dot, cfg.d_mlp,
            selfatt=False, kv_dim=d_in,
            feed_forward_factory=lambda dim, _mlp_dim: ImageSelfAttentionFF(cfg.self_attention, dim, dtype=dtype),
            dtype=dtype,
        )

    def forward(
        self,
        features: torch.Tensor,  # (b, v, h, w, c) channels-last
        extrinsics: torch.Tensor,  # (b, v, 4, 4)
        intrinsics: torch.Tensor,  # (b, v, 3, 3)
        near: torch.Tensor,  # (b, v)
        far: torch.Tensor,  # (b, v)
        view_order: Optional[torch.Tensor] = None,  # (v-1,) int64 permutation, read when v > 2
    ) -> tuple[torch.Tensor, EpipolarSampling]:
        with tracing.span("encoder.epipolar"):
            low, sampling = self.attend(features, extrinsics, intrinsics, near, far, view_order)
        if not self.cfg.downscale:
            return low, sampling
        with tracing.span("encoder.refine"):
            return self.refine(low), sampling

    def attend(self, features, extrinsics, intrinsics, near, far, view_order=None):
        """The stage `encoder.epipolar`: downscale, sample along the epipolar
        lines, attend. Returns the attended features at the downscaled size
        and the sampling."""
        cfg = self.cfg
        b, v, h_full, w_full, c = features.shape
        if cfg.downscale:
            x = conv_nhwc(self.downscaler, features.reshape(b * v, h_full, w_full, c))
            features = x.reshape(b, v, x.shape[1], x.shape[2], self.d_in)
        h, w = features.shape[2], features.shape[3]

        sampling = sample_along_epipolar_lines(features, extrinsics, intrinsics, near, far, cfg.num_samples)

        if cfg.num_octaves > 0:
            # Positionally encode each sample's depth (as relative disparity).
            near_b, far_b = near[:, :, None, None, None], far[:, :, None, None, None]
            depths = get_depth(
                sampling.origins[:, :, None, :, None],  # (b, v, 1, r, 1, 3)
                sampling.directions[:, :, None, :, None],
                sampling.xy_sample,  # (b, v, ov, r, s, 2)
                collect_other_views(extrinsics, v)[:, :, :, None, None],
                collect_other_views(intrinsics, v)[:, :, :, None, None],
            )
            depths = torch.minimum(torch.maximum(depths, near_b), far_b)
            depths = depth_to_relative_disparity(depths, near_b, far_b)
            kv = sampling.features + self.depth_encoding(depths[..., None])
        else:
            kv = sampling.features

        if v > 2:
            if view_order is None:
                view_order = torch.arange(v - 1, device=features.device)
            kv = kv + self.view_embeddings(view_order.to(features.device))[None, None, :, None, None, :]

        q = features.reshape(b * v * h * w, 1, self.d_in)
        # kv: (b, v, ov, r, s, c) -> (b*v*r, s*ov, c), the reference's
        # "(b v r) (s ov) c" token layout.
        kv = kv.permute(0, 1, 3, 4, 2, 5).reshape(b * v * h * w, cfg.num_samples * (v - 1), self.d_in)
        out = self.transformer(q, z=kv, b=b, v=v, h=h, w=w)
        return out.reshape(b, v, h, w, self.d_in), sampling

    def refine(self, features: torch.Tensor) -> torch.Tensor:
        """The stage `encoder.refine`: upscale the attended features (b, v,
        h, w, c) by `downscale` and refine them (K9 on the card)."""
        b, v, h, w, _ = features.shape
        x = conv_nhwc(self.upscaler, features.reshape(b * v, h, w, self.d_in))
        x = conv7_kernel.refine(x, self.upscale_refinement[0], self.upscale_refinement[2])
        return x.reshape(b, v, x.shape[1], x.shape[2], self.d_in)
