"""Patchified image self-attention (the epipolar transformer's feed-forward).

Port of `pixelsplat_tpu/model/encoder/epipolar/image_self_attention.py`:
patchify with a strided conv, add positionally encoded patch centres, run
a small self-attention transformer, un-patchify with a transposed conv.
Images are channels-last at this module's boundary, as in the JAX package.
With a compute `dtype` (`model/precision.py`) the convolutions, the
projection of the positional encoding and the transformer run in it; the
encoding itself stays f32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ....geometry.projection import sample_image_grid
from ...encodings import PositionalEncoding
from ... import precision
from ...transformer.transformer import Transformer


@dataclass(frozen=True)
class ImageSelfAttentionCfg:
    patch_size: int = 4
    num_octaves: int = 10
    num_layers: int = 2
    num_heads: int = 4
    d_token: int = 128
    d_dot: int = 128
    d_mlp: int = 256


class ImageSelfAttention(nn.Module):
    def __init__(self, cfg: ImageSelfAttentionCfg, d_in: int, d_out: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg = cfg
        self.patch_embedder = nn.Sequential(
            precision.Conv2d(d_in, cfg.d_token, cfg.patch_size, cfg.patch_size, compute_dtype=dtype), nn.ReLU()
        )
        encoding = PositionalEncoding(cfg.num_octaves)
        self.positional_encoding = nn.Sequential(
            encoding, precision.Linear(encoding.d_out(2), cfg.d_token, compute_dtype=dtype)
        )
        self.transformer = Transformer(
            cfg.d_token, cfg.num_layers, cfg.num_heads, cfg.d_dot, cfg.d_mlp, dtype=dtype
        )
        self.resampler = precision.ConvTranspose2d(
            cfg.d_token, d_out, cfg.patch_size, cfg.patch_size, compute_dtype=dtype
        )

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        """image: (b, h, w, d_in) -> (b, h, w, d_out)."""
        tokens = self.patch_embedder(image.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)  # (b, nh, nw, d)
        b, nh, nw, d = tokens.shape
        xy, _ = sample_image_grid((nh, nw), device=image.device, dtype=torch.float32)
        tokens = tokens + self.positional_encoding(xy)[None].to(tokens.dtype)
        tokens = self.transformer(tokens.reshape(b, nh * nw, d)).reshape(b, nh, nw, d)
        return self.resampler(tokens.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
