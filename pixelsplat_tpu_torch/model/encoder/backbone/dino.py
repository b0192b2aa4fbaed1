"""DINO ViT backbone fused with a DINO ResNet-50 branch.

Port of `pixelsplat_tpu/model/encoder/backbone/dino.py`: a DINO ViT
(default ViT-B/8) gives a global CLS token and per-patch tokens; each goes
through a small MLP to `d_out`, is broadcast to the pixel grid (patch
tokens by nearest repeat) and summed with the ResNet branch. Module names
are the reference's (`dino.blocks.0.attn.qkv`, `global_token_mlp.0`, ...).
With a compute `dtype` (`model/precision.py`) the patch embedding, the
attention and MLP projections, the token MLPs and the ResNet branch's
convolutions run in it, as in the JAX module; the LayerNorms and the
residual stream are f32.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Literal, Optional

import numpy as np
import torch
from torch import nn

from ... import precision
from .resnet import BackboneResnet, BackboneResnetCfg

VIT_SPECS: dict[str, dict] = {
    "dino_vits16": dict(patch=16, dim=384, depth=12, heads=6),
    "dino_vits8": dict(patch=8, dim=384, depth=12, heads=6),
    "dino_vitb16": dict(patch=16, dim=768, depth=12, heads=12),
    "dino_vitb8": dict(patch=8, dim=768, depth=12, heads=12),
}


@dataclass(frozen=True)
class BackboneDinoCfg:
    name: Literal["dino"] = "dino"
    model: str = "dino_vitb8"
    d_out: int = 512
    # Positional-embedding grid of the checkpoint (None: 224 // patch).
    pos_grid: int | None = None

    @property
    def resolved_pos_grid(self) -> int:
        if self.pos_grid is not None:
            return self.pos_grid
        return 224 // VIT_SPECS[self.model]["patch"]


@lru_cache(maxsize=None)
def _keys_cubic_resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) weights of `jax.image.resize(..., "bicubic")` on one axis.

    That resize is `jax.image.scale_and_translate` with the Keys cubic
    kernel (a = -0.5), half-pixel centres, and a kernel widened by the
    shrink factor (antialiasing) when it downsamples; it is not
    `torch.nn.functional.interpolate(mode="bicubic")`, whose a is -0.75.
    The arithmetic follows JAX's `compute_weight_mat`, in float32.
    """
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    weights = ((f32(1.5) * x - f32(2.5)) * x) * x + f32(1.0)
    weights = np.where(x >= 1.0, ((f32(-0.5) * x + f32(2.5)) * x - f32(4.0)) * x + f32(2.0), weights)
    weights = np.where(x >= 2.0, f32(0.0), weights).astype(f32)
    total = weights.sum(axis=0, keepdims=True)
    weights = np.where(
        np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
        weights / np.where(total != 0, total, 1),
        0,
    )
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], weights, 0).astype(f32)


def resize_pos_embed(grid: torch.Tensor, shape: tuple[int, int]) -> torch.Tensor:
    """(1, gh0, gw0, dim) -> (1, gh, gw, dim), as jax.image.resize bicubic."""
    _, h0, w0, _ = grid.shape
    h, w = shape
    if h != h0:
        m = torch.as_tensor(_keys_cubic_resize_matrix(h0, h), device=grid.device)
        grid = torch.einsum("bhwc,hH->bHwc", grid, m)
    if w != w0:
        m = torch.as_tensor(_keys_cubic_resize_matrix(w0, w), device=grid.device)
        grid = torch.einsum("bhwc,wW->bhWc", grid, m)
    return grid


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.heads = heads
        self.qkv = precision.Linear(dim, 3 * dim, compute_dtype=dtype)
        self.proj = precision.Linear(dim, dim, compute_dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, t, dim = x.shape
        qkv = self.qkv(x).reshape(n, t, 3, self.heads, dim // self.heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)  # (n, heads, t, head_dim) each
        q = q / np.sqrt(dim // self.heads)
        attn = torch.softmax(q @ k.transpose(-1, -2), dim=-1)
        return self.proj((attn @ v).transpose(1, 2).reshape(n, t, dim))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.fc1 = precision.Linear(dim, hidden, compute_dtype=dtype)
        self.fc2 = precision.Linear(hidden, dim, compute_dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # Exact (erf) GELU.
        return self.fc2(nn.functional.gelu(self.fc1(x)))


class ViTBlock(nn.Module):
    """Pre-norm block; LayerNorm eps 1e-5 as in the JAX package."""

    def __init__(self, dim: int, heads: int, mlp_ratio: int = 4, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.norm1 = precision.LayerNorm(dim, eps=1e-5)
        self.attn = Attention(dim, heads, dtype)
        self.norm2 = precision.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, dim * mlp_ratio, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.proj = precision.Conv2d(3, dim, patch, stride=patch, compute_dtype=dtype)


class DinoViT(nn.Module):
    """DINO vision transformer trunk; returns normalized (cls, patch) tokens."""

    def __init__(self, patch: int, dim: int, depth: int, heads: int, pos_grid: int = 28,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dim = dim
        self.pos_grid = pos_grid
        self.patch_embed = PatchEmbed(patch, dim, dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + pos_grid * pos_grid, dim))
        self.blocks = nn.ModuleList(ViTBlock(dim, heads, dtype=dtype) for _ in range(depth))
        self.norm = precision.LayerNorm(dim, eps=1e-5)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images: (n, 3, h, w) -> (n, 1 + h/p * w/p, dim) tokens."""
        n = images.shape[0]
        x = self.patch_embed.proj(images)  # (n, dim, gh, gw)
        gh, gw = x.shape[-2:]
        x = x.flatten(2).transpose(1, 2)  # (n, gh * gw, dim)

        cls_pos, patch_pos = self.pos_embed[:, :1], self.pos_embed[:, 1:]
        if (gh, gw) != (self.pos_grid, self.pos_grid):
            grid = patch_pos.reshape(1, self.pos_grid, self.pos_grid, self.dim)
            patch_pos = resize_pos_embed(grid, (gh, gw)).reshape(1, gh * gw, self.dim)
        x = x + patch_pos
        cls = (self.cls_token + cls_pos).expand(n, 1, self.dim)
        x = torch.cat([cls, x], dim=1)
        for block in self.blocks:
            x = block(x)
        return self.norm(x)


class BackboneDino(nn.Module):
    def __init__(self, cfg: BackboneDinoCfg, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg = cfg
        spec = VIT_SPECS[cfg.model]
        self.patch = spec["patch"]
        self.resnet_backbone = BackboneResnet(
            BackboneResnetCfg("resnet", "dino_resnet50", 4, False, cfg.d_out), dtype=dtype
        )
        self.dino = DinoViT(
            spec["patch"], spec["dim"], spec["depth"], spec["heads"], cfg.resolved_pos_grid, dtype=dtype
        )
        dim = spec["dim"]

        def token_mlp():
            return nn.Sequential(
                precision.Linear(dim, dim, compute_dtype=dtype), nn.ReLU(),
                precision.Linear(dim, cfg.d_out, compute_dtype=dtype),
            )

        self.global_token_mlp = token_mlp()
        self.local_token_mlp = token_mlp()

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images: (b, v, 3, h, w) -> (b, v, h, w, d_out), channels-last."""
        b, v, _, h, w = images.shape
        p = self.patch
        if h % p or w % p:
            raise ValueError(f"image size {h}x{w} is not a multiple of the patch size {p}")
        resnet_features = self.resnet_backbone(images)
        tokens = self.dino(images.reshape(b * v, 3, h, w))
        d_out = self.cfg.d_out
        global_token = self.global_token_mlp(tokens[:, 0]).reshape(b, v, 1, 1, d_out)
        local_tokens = self.local_token_mlp(tokens[:, 1:]).reshape(b, v, h // p, w // p, d_out)
        local_tokens = local_tokens.repeat_interleave(p, dim=2).repeat_interleave(p, dim=3)
        return resnet_features + local_tokens + global_token

    @property
    def d_out(self) -> int:
        return self.cfg.d_out
