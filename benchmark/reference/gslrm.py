"""The GS-LRM scene encoder as plain PyTorch: context views -> one 3D
Gaussian a pixel, from one transformer over every view's patches at once.

Written from GS-LRM's description (Zhang, Bi, Tan, Xiangli, Zhao,
Sunkavalli and Xu, "GS-LRM: Large Reconstruction Model for 3D Gaussian
Splatting", ECCV 2024, arXiv:2404.19702, sections 3-4: the scene model
trained and evaluated on RealEstate10K at 256x256 from 2 views), scene by
scene, in float64 (below):

1. Each pixel's input is its RGB beside its Plücker ray (o x d, d): o the
   camera centre, d the unit direction through the pixel centre, both in
   world coordinates (OpenCV camera-to-world extrinsics, normalized
   intrinsics). 8x8 patches, each flattened in (row, column, channel)
   order, 576 values, go through one linear layer to the model width.
2. The tokens of all context views are concatenated into one sequence (2 x
   32 x 32 = 2,048 at 256x256) and go through `depth` pre-norm transformer
   blocks: LayerNorm, multi-head self-attention over the whole sequence
   (one linear layer to q, k, v, each head's q, k, v contiguous in it as
   (3, heads, head width); softmax(q k^T / sqrt(head width)) v; an output
   linear layer) added to the stream; LayerNorm, a linear layer to
   `mlp_ratio` times the width, the exact (erf) GELU and a linear layer
   back, added to the stream. Then a LayerNorm.
3. A linear layer to 8 x 8 x 12 values a token, unpatchified in the same
   order to 12 channels a pixel: RGB 3, scale 3, rotation 4, opacity 1,
   ray distance 1. The Gaussian's mean is o + t d, t = near + (far - near)
   sigmoid(x); its scales min(exp(x - 2.3), 0.3); its rotation the
   normalized quaternion (xyzw) in the world frame, its covariance R S S
   R^T; its opacity sigmoid(x - 2); its colour sigmoid(x), as the degree-0
   SH coefficient (sigmoid(x) - 0.5) / C0 that the rasterizer's +0.5
   renders back to it.

Precision. The reference computes in float64 and returns its Gaussians in
the input's dtype. Two correct float32 programs round each Gaussian's depth
by about 1e-6 of it. Where two large Gaussians overlap at depths closer
than that, the two programs sort them in different orders, and the pixels
they share change by several hundredths. A float32 reference made such
flips against a float32 program of its own accord. In float64 only the
program's rounding remains. Where TF32 products are allowed, it computes in
float32 with them: that is the precision below the configuration's, which
the control (`benchmark/control.py`) runs.

Departures, and details the description does not fix (the configuration's
`assumed`): biases in every linear layer; LayerNorm eps 1e-5; no learned
position embedding, the Plücker rays the only position signal; the head's
activations and constants above; the order of a patch's values; images in
[0, 1] as the loader gives them; weights random from the seed (no
checkpoint is in the repository). Parameters carry the program's module
names, so one state dict loads here and into the program under test. It
imports nothing of the program under test, and runs on meta tensors for
the FLOP count.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from . import geometry as geo
from .costvolume import gelu, layer_norm
from .encoder import quaternion_matrix

IN_CHANNELS = 3 + 6
OUT_SPLIT = (3, 3, 4, 1, 1)  # RGB, scale, rotation, opacity, ray distance
SH_C0 = 0.28209479177387814


def working_dtype(dtype: torch.dtype) -> torch.dtype:
    """float64; float32 for float32 inputs where TF32 products are allowed."""
    if dtype == torch.float32 and torch.backends.cuda.matmul.allow_tf32:
        return torch.float32
    return torch.float64


def linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """`layer` applied in `x`'s dtype."""
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):  # (n, t, dim) -> (n, t, dim), every token attending to every other
        n, t, d = x.shape
        q, k, v = linear(self.qkv, x).reshape(n, t, 3, self.heads, d // self.heads).permute(2, 0, 3, 1, 4)
        scores = q @ k.transpose(-1, -2) / math.sqrt(d // self.heads)
        return linear(self.proj, (torch.softmax(scores, dim=-1) @ v).transpose(1, 2).reshape(n, t, d))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return linear(self.fc2, gelu(linear(self.fc1, x)))


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, mlp_ratio * dim)

    def forward(self, x):
        x = x + self.attn(layer_norm(x, self.norm1))
        return x + self.mlp(layer_norm(x, self.norm2))


class Transformer(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.blocks = nn.ModuleList(Block(cfg["d_model"], cfg["heads"], cfg["mlp_ratio"]) for _ in range(cfg["depth"]))
        self.norm = nn.LayerNorm(cfg["d_model"], eps=1e-5)

    def forward(self, x):
        for block in self.blocks:
            x = block(x)
        return layer_norm(x, self.norm)


def plucker(extrinsics: torch.Tensor, intrinsics: torch.Tensor, h: int, w: int):
    """One view's (h, w, 6) Plücker rays (o x d, d), origins and unit
    directions, each (h, w, 3)."""
    xy = geo.image_grid(h, w, extrinsics.device, extrinsics.dtype)
    o, d = geo.world_rays(xy, extrinsics, intrinsics)
    return torch.cat([torch.linalg.cross(o, d), d], dim=-1), o, d


class Encoder(nn.Module):
    """GS-LRM's scene encoder for a configuration's `encoder` section."""

    def __init__(self, cfg: dict):
        super().__init__()
        # The configuration's products: TF32 off (the control turns it on).
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if cfg["sh_degree"] != 0:
            raise ValueError("GS-LRM's Gaussians carry SH degree 0")
        self.cfg = cfg
        p = cfg["patch_size"]
        self.tokenizer = nn.Linear(IN_CHANNELS * p * p, cfg["d_model"])
        self.transformer = Transformer(cfg)
        self.head = nn.Linear(cfg["d_model"], sum(OUT_SPLIT) * p * p)

    def forward(self, context: dict, step: int, u: torch.Tensor, view_order: torch.Tensor | None = None):
        """context: image (b, v, 3, h, w), extrinsics, intrinsics, near, far;
        `step`, `u` and `view_order` are not read (GS-LRM samples nothing).
        Returns (means (b, g, 3), covariances (b, g, 3, 3), harmonics
        (b, g, 3, 1), opacities (b, g)) in (view, pixel) order, in the
        image's dtype, computed in `working_dtype`'s."""
        out_dtype = context["image"].dtype
        dtype = working_dtype(out_dtype)
        context = {k: v.to(dtype) if v.is_floating_point() else v for k, v in context.items()}
        image = context["image"]
        b, v, _, h, w = image.shape
        p = self.cfg["patch_size"]
        gh, gw = h // p, w // p
        outs = []
        for s in range(b):
            rays = [plucker(context["extrinsics"][s, i], context["intrinsics"][s, i], h, w) for i in range(v)]
            pixels = torch.cat([image[s].permute(0, 2, 3, 1), torch.stack([r[0] for r in rays])], dim=-1)
            patches = pixels.reshape(v, gh, p, gw, p, IN_CHANNELS).permute(0, 1, 3, 2, 4, 5)
            tokens = linear(self.tokenizer, patches.reshape(1, v * gh * gw, p * p * IN_CHANNELS))
            raw = linear(self.head, self.transformer(tokens))  # (1, v gh gw, p p 12)
            raw = raw.reshape(v, gh, gw, p, p, -1).permute(0, 1, 3, 2, 4, 5).reshape(v * h * w, -1)
            rgb, scale, rot, opacity, t = raw.split(OUT_SPLIT, dim=-1)
            origins = torch.stack([r[1] for r in rays]).reshape(v * h * w, 3)
            dirs = torch.stack([r[2] for r in rays]).reshape(v * h * w, 3)
            near = context["near"][s].repeat_interleave(h * w)[:, None]
            far = context["far"][s].repeat_interleave(h * w)[:, None]
            means = origins + dirs * (near + (far - near) * torch.sigmoid(t))
            scale = torch.clamp(torch.exp(scale - 2.3), max=0.3)
            rot = rot / (torch.linalg.vector_norm(rot, dim=-1, keepdim=True) + 1e-8)
            m = quaternion_matrix(rot)
            cov = (m * (scale * scale)[:, None, :]) @ m.transpose(-1, -2)
            harmonics = ((torch.sigmoid(rgb) - 0.5) / SH_C0)[..., None]
            outs.append((means, cov, harmonics, torch.sigmoid(opacity[:, 0] - 2.0)))
        return tuple(torch.stack(parts).to(out_dtype) for parts in zip(*outs))


def apply_shims(batch: dict, cfg: dict) -> dict:
    """Centre-crop every view to a multiple of the patch size, the focal
    lengths rescaled; the dataset's near and far stay."""
    patch = cfg["patch_size"]
    out = {}
    for key, views in batch.items():
        *_, h, w = views["image"].shape
        hn, wn = h // patch * patch, w // patch * patch
        r0, c0 = (h - hn) // 2, (w - wn) // 2
        k = views["intrinsics"].clone()
        k[..., 0, 0] *= w / wn
        k[..., 1, 1] *= h / hn
        out[key] = {**views, "image": views["image"][..., r0:r0 + hn, c0:c0 + wn], "intrinsics": k}
    return out
