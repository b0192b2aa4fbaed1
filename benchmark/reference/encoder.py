"""The pixelSplat encoder as plain PyTorch: context views -> 3D Gaussians.

A frozen copy of the published model's forward pass (pixelSplat,
`src/model/encoder/encoder_epipolar.py` and the modules it calls): the DINO
ViT fused with the DINO ResNet-50, the epipolar transformer with its depth
encoding and image self-attention, the high-resolution skip, the monocular
depth head with inverse-CDF sampling, and the Gaussian adapter with SH
rotated into the world frame; `settle_draws` keeps a check's depth
uniforms off the sampling's bucket edges. Parameters carry the published
module names, so one state dict loads here and into the program under test.
Everything runs in the tensors' dtype; attention forms its keys and values
outright. It imports nothing of the program under test.
"""

from __future__ import annotations

import math
from dataclasses import replace
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import geometry as geo

VIT_SPECS = {
    "dino_vits16": dict(patch=16, dim=384, depth=12, heads=6),
    "dino_vits8": dict(patch=8, dim=384, depth=12, heads=6),
    "dino_vitb16": dict(patch=16, dim=768, depth=12, heads=12),
    "dino_vitb8": dict(patch=8, dim=768, depth=12, heads=12),
}


# --------------------------------------------------------------------------
# Backbone: DINO ResNet-50 (frozen-statistics BatchNorm) + DINO ViT


class FrozenBN(nn.Module):
    """Inference BatchNorm whose statistics are parameters (they train)."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.running_mean = nn.Parameter(torch.zeros(c))
        self.running_var = nn.Parameter(torch.ones(c))

    def forward(self, x):
        shape = (1, -1, 1, 1)
        return (x - self.running_mean.view(shape)) * torch.rsqrt(self.running_var.view(shape) + 1e-5) * (
            self.weight.view(shape)
        ) + self.bias.view(shape)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, c: int, stride: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, c, 1, bias=False)
        self.bn1 = FrozenBN(c)
        self.conv2 = nn.Conv2d(c, c, 3, stride, 1, bias=False)
        self.bn2 = FrozenBN(c)
        self.conv3 = nn.Conv2d(c, 4 * c, 1, bias=False)
        self.bn3 = FrozenBN(4 * c)
        self.downsample = None
        if stride != 1 or cin != 4 * c:
            self.downsample = nn.Sequential(nn.Conv2d(cin, 4 * c, 1, stride, bias=False), FrozenBN(4 * c))

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return torch.relu(y + (x if self.downsample is None else self.downsample(x)))


class ResNetTrunk(nn.Module):
    def __init__(self, stages: int):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = FrozenBN(64)
        self.widths = [64]
        cin = 64
        for s in range(1, stages + 1):
            width = (64, 128, 256, 512)[s - 1]
            blocks = []
            for i in range((3, 4, 6, 3)[s - 1]):
                blocks.append(Bottleneck(cin, width, 2 if (s > 1 and i == 0) else 1))
                cin = 4 * width
            self.add_module(f"layer{s}", nn.Sequential(*blocks))
            self.widths.append(cin)


class ResNetBranch(nn.Module):
    """Every stage projected to d_out, resized to full resolution (bilinear,
    corners aligned) and summed."""

    def __init__(self, d_out: int, num_layers: int = 4):
        super().__init__()
        self.num_layers = num_layers
        self.model = ResNetTrunk(num_layers - 1)
        self.projections = nn.ModuleDict(
            {f"layer{i}": nn.Conv2d(c, d_out, 1) for i, c in enumerate(self.model.widths)}
        )

    def forward(self, x):  # (n, 3, h, w) -> (n, d_out, h, w)
        h, w = x.shape[-2:]
        x = torch.relu(self.model.bn1(self.model.conv1(x)))
        feats = [self.projections["layer0"](x)]
        for s in range(1, self.num_layers):
            x = getattr(self.model, f"layer{s}")(x)
            feats.append(self.projections[f"layer{s}"](x))
        return sum(F.interpolate(f, size=(h, w), mode="bilinear", align_corners=True) for f in feats)


@lru_cache(maxsize=None)
def keys_cubic_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) weights of an antialiased Keys-cubic (a = -0.5) resize
    with half-pixel centres, the resize the published ViT position grid
    takes (not torch's bicubic, whose a is -0.75)."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    wts = ((f32(1.5) * x - f32(2.5)) * x) * x + f32(1.0)
    wts = np.where(x >= 1.0, ((f32(-0.5) * x + f32(2.5)) * x - f32(4.0)) * x + f32(2.0), wts)
    wts = np.where(x >= 2.0, f32(0.0), wts).astype(f32)
    total = wts.sum(axis=0, keepdims=True)
    wts = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps), wts / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], wts, 0).astype(f32)


class ViTAttention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        n, t, d = x.shape
        q, k, v = self.qkv(x).reshape(n, t, 3, self.heads, d // self.heads).permute(2, 0, 3, 1, 4)
        attn = torch.softmax((q / math.sqrt(d // self.heads)) @ k.transpose(-1, -2), dim=-1)
        return self.proj((attn @ v).transpose(1, 2).reshape(n, t, d))


class ViTMlp(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, 4 * dim)
        self.fc2 = nn.Linear(4 * dim, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class ViTBlock(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = ViTAttention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = ViTMlp(dim)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, patch)


class ViT(nn.Module):
    def __init__(self, patch: int, dim: int, depth: int, heads: int, pos_grid: int):
        super().__init__()
        self.dim, self.pos_grid = dim, pos_grid
        self.patch_embed = PatchEmbed(patch, dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + pos_grid * pos_grid, dim))
        self.blocks = nn.ModuleList(ViTBlock(dim, heads) for _ in range(depth))
        self.norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, images):  # (n, 3, h, w) -> (n, 1 + tokens, dim)
        x = self.patch_embed.proj(images)
        gh, gw = x.shape[-2:]
        x = x.flatten(2).transpose(1, 2)
        pos = self.pos_embed[:, 1:].reshape(1, self.pos_grid, self.pos_grid, self.dim)
        if (gh, gw) != (self.pos_grid, self.pos_grid):
            mh = torch.as_tensor(keys_cubic_matrix(self.pos_grid, gh), device=x.device, dtype=x.dtype)
            mw = torch.as_tensor(keys_cubic_matrix(self.pos_grid, gw), device=x.device, dtype=x.dtype)
            pos = torch.einsum("bhwc,hH,wW->bHWc", pos, mh, mw)
        x = x + pos.reshape(1, gh * gw, self.dim)
        cls = (self.cls_token + self.pos_embed[:, :1]).expand(x.shape[0], 1, self.dim)
        x = torch.cat([cls, x], dim=1)
        for block in self.blocks:
            x = block(x)
        return self.norm(x)


class Backbone(nn.Module):
    """DINO: the ResNet-50 branch plus the ViT's CLS token (everywhere) and
    patch tokens (nearest-repeated to pixels), each through a token MLP."""

    def __init__(self, model: str, d_out: int, pos_grid: int | None):
        super().__init__()
        spec = VIT_SPECS[model]
        self.patch = spec["patch"]
        self.d_out = d_out
        self.resnet_backbone = ResNetBranch(d_out)
        self.dino = ViT(spec["patch"], spec["dim"], spec["depth"], spec["heads"], pos_grid or 224 // spec["patch"])

        def token_mlp():
            return nn.Sequential(nn.Linear(spec["dim"], spec["dim"]), nn.ReLU(), nn.Linear(spec["dim"], d_out))

        self.global_token_mlp = token_mlp()
        self.local_token_mlp = token_mlp()

    def forward(self, images):  # (b, v, 3, h, w) -> (b, v, h, w, d_out)
        b, v, _, h, w = images.shape
        p = self.patch
        flat = images.reshape(b * v, 3, h, w)
        res = self.resnet_backbone(flat).permute(0, 2, 3, 1).reshape(b, v, h, w, self.d_out)
        tokens = self.dino(flat)
        glob = self.global_token_mlp(tokens[:, 0]).reshape(b, v, 1, 1, self.d_out)
        local = self.local_token_mlp(tokens[:, 1:]).reshape(b, v, h // p, w // p, self.d_out)
        local = local.repeat_interleave(p, dim=2).repeat_interleave(p, dim=3)
        return res + local + glob


# --------------------------------------------------------------------------
# Transformers


class Attention(nn.Module):
    """Multi-head attention: self (to_qkv) or cross (to_q, to_kv)."""

    def __init__(self, dim: int, heads: int, dim_head: int, selfatt: bool, kv_dim: int | None = None):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        if selfatt:
            self.to_qkv = nn.Linear(dim, 3 * inner, bias=False)
        else:
            self.to_q = nn.Linear(dim, inner, bias=False)
            self.to_kv = nn.Linear(kv_dim or dim, 2 * inner, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, dim))

    def split(self, t):
        n, s, _ = t.shape
        return t.reshape(n, s, self.heads, self.dim_head).transpose(1, 2)

    def forward(self, x, z=None):
        if z is None:
            q, k, v = (self.split(t) for t in self.to_qkv(x).chunk(3, dim=-1))
        else:
            q = self.split(self.to_q(x))
            k, v = (self.split(t) for t in self.to_kv(z).chunk(2, dim=-1))
        attn = torch.softmax((q @ k.transpose(-1, -2)) * self.dim_head**-0.5, dim=-1)
        out = (attn @ v).transpose(1, 2)
        return self.to_out(out.reshape(*out.shape[:2], -1))


class FeedForward(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.net = nn.Sequential(nn.Linear(dim, hidden), nn.GELU(), nn.Identity(), nn.Linear(hidden, dim))

    def forward(self, x, **_):
        return self.net(x)


class PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.fn = fn

    def forward(self, x, **kw):
        return self.fn(self.norm(x), **kw)


class Transformer(nn.Module):
    def __init__(self, dim, depth, heads, dim_head, mlp_dim, selfatt=True, kv_dim=None, ff=None):
        super().__init__()
        ff = ff or (lambda: FeedForward(dim, mlp_dim))
        self.layers = nn.ModuleList(
            nn.ModuleList([PreNorm(dim, Attention(dim, heads, dim_head, selfatt, kv_dim)), PreNorm(dim, ff())])
            for _ in range(depth)
        )

    def forward(self, x, z=None, **kw):
        for attn, ff in self.layers:
            x = x + attn(x, z=z)
            x = x + ff(x, **kw)
        return x


class ImageSelfAttention(nn.Module):
    """Patchify, add encoded patch centres, self-attend, un-patchify."""

    def __init__(self, cfg: dict, d_in: int, d_out: int):
        super().__init__()
        p, d = cfg["patch_size"], cfg["d_token"]
        self.octaves = cfg["num_octaves"]
        self.patch_embedder = nn.Sequential(nn.Conv2d(d_in, d, p, p), nn.ReLU())
        self.positional_encoding = nn.Sequential(nn.Identity(), nn.Linear(4 * self.octaves, d))
        self.transformer = Transformer(d, cfg["num_layers"], cfg["num_heads"], cfg["d_dot"], cfg["d_mlp"])
        self.resampler = nn.ConvTranspose2d(d, d_out, p, p)

    def forward(self, image):  # (n, c, h, w) -> (n, c_out, h, w)
        tokens = self.patch_embedder(image)
        n, d, nh, nw = tokens.shape
        xy = geo.image_grid(nh, nw, image.device)
        tokens = tokens.permute(0, 2, 3, 1) + self.positional_encoding(geo.positional_encoding(xy, self.octaves))
        tokens = self.transformer(tokens.reshape(n, nh * nw, d)).reshape(n, nh, nw, d)
        return self.resampler(tokens.permute(0, 3, 1, 2))


class ImageSelfAttentionFF(nn.Module):
    def __init__(self, cfg: dict, dim: int):
        super().__init__()
        self.self_attention = ImageSelfAttention(cfg, dim, dim)

    def forward(self, x, n, h, w):  # x: (n*h*w, 1, c), pixels row-major per image
        img = x.reshape(n, h, w, -1).permute(0, 3, 1, 2)
        img = self.self_attention(img) + img
        return img.permute(0, 2, 3, 1).reshape(x.shape)


class EpipolarTransformer(nn.Module):
    def __init__(self, cfg: dict, d_in: int, num_views: int):
        super().__init__()
        self.cfg, self.d_in = cfg, d_in
        ds = cfg["downscale"]
        self.downscaler = nn.Conv2d(d_in, d_in, ds, ds)
        self.upscaler = nn.ConvTranspose2d(d_in, d_in, ds, ds)
        self.upscale_refinement = nn.Sequential(
            nn.Conv2d(d_in, 2 * d_in, 7, 1, 3), nn.GELU(), nn.Conv2d(2 * d_in, d_in, 7, 1, 3)
        )
        self.depth_encoding = nn.Sequential(nn.Identity(), nn.Linear(2 * cfg["num_octaves"], d_in))
        if num_views > 2:
            self.view_embeddings = nn.Embedding(num_views, d_in)
        self.transformer = Transformer(
            d_in, cfg["num_layers"], cfg["num_heads"], cfg["d_dot"], cfg["d_mlp"], selfatt=False, kv_dim=d_in,
            ff=lambda: ImageSelfAttentionFF(cfg["self_attention"], d_in),
        )

    def forward(self, features, extrinsics, intrinsics, near, far, view_order):
        """features (b, v, c, H, W) -> (b, v, c, H, W)."""
        cfg = self.cfg
        b, v, c, hf, wf = features.shape
        x = self.downscaler(features.reshape(b * v, c, hf, wf))
        h, w = x.shape[-2:]
        x = x.reshape(b, v, c, h, w)
        s = cfg["num_samples"]

        # Rays through the feature grid, their segments in every other view,
        # and s evenly spaced samples along each.
        xy = geo.image_grid(h, w, x.device).reshape(h * w, 2)
        origins, directions = geo.world_rays(xy, extrinsics[:, :, None], intrinsics[:, :, None])  # (b, v, r, 3)
        other_e = geo.other_views(extrinsics, v)
        other_k = geo.other_views(intrinsics, v)
        xy_min, xy_max, overlaps = geo.epipolar_segments(
            origins[:, :, None], directions[:, :, None], other_e[:, :, :, None], other_k[:, :, :, None],
            near[:, :, None, None], far[:, :, None, None],
        )  # (b, v, ov, r, ...)
        keep = overlaps[..., None].to(x.dtype)
        xy_min = torch.nan_to_num(xy_min, nan=0.0, posinf=0.0, neginf=0.0) * keep
        xy_max = torch.nan_to_num(xy_max, nan=0.0, posinf=0.0, neginf=0.0) * keep
        frac = ((torch.arange(s, device=x.device, dtype=x.dtype) + 0.5) / s)[:, None]
        xy_sample = xy_min[..., None, :] + frac * (xy_max - xy_min)[..., None, :]  # (b, v, ov, r, s, 2)
        src = geo.other_views(x, v).reshape(b * v * (v - 1), c, h, w)
        grid = (2.0 * xy_sample - 1.0).reshape(b * v * (v - 1), h * w * s, 1, 2)
        samples = F.grid_sample(src, grid, mode="bilinear", padding_mode="zeros", align_corners=False)
        samples = samples[..., 0].reshape(b, v, v - 1, c, h * w, s).permute(0, 1, 2, 4, 5, 3)
        samples = samples * keep[..., None, :]  # (b, v, ov, r, s, c)

        # Each sample's depth along its ray, as relative disparity, encoded.
        near_b, far_b = near[:, :, None, None, None], far[:, :, None, None, None]
        depth = geo.sample_depths(
            origins[:, :, None, :, None], directions[:, :, None, :, None], xy_sample,
            other_e[:, :, :, None, None], other_k[:, :, :, None, None],
        )
        depth = torch.minimum(torch.maximum(depth, near_b), far_b)
        disp = 1.0 - (1.0 / (depth + 1e-10) - 1.0 / (far_b + 1e-10)) / (
            1.0 / (near_b + 1e-10) - 1.0 / (far_b + 1e-10) + 1e-10
        )
        kv = samples + self.depth_encoding(geo.positional_encoding(disp[..., None], cfg["num_octaves"]))
        if v > 2:
            kv = kv + self.view_embeddings(view_order)[None, None, :, None, None, :]

        q = x.permute(0, 1, 3, 4, 2).reshape(b * v * h * w, 1, c)
        kv = kv.permute(0, 1, 3, 4, 2, 5).reshape(b * v * h * w, s * (v - 1), c)
        out = self.transformer(q, z=kv, n=b * v, h=h, w=w)
        out = out.reshape(b * v, h, w, c).permute(0, 3, 1, 2)
        up = self.upscaler(out)
        up = up + self.upscale_refinement(up)
        return up.reshape(b, v, c, hf, wf)


# --------------------------------------------------------------------------
# Spherical harmonics (the 3DGS sign convention)

SH_C = (
    0.28209479177387814, 0.4886025119029199, 1.0925484305920792, 0.31539156525252005,
    0.5462742152960396, 0.5900435899266435, 2.890611442640554, 0.4570457994644658,
    0.3731763325901154, 1.445305721320277, 2.5033429417967046, 1.7701307697799304,
    0.9461746957575601, 0.6690465435572892, 0.10578554691520431, 0.47308734787878004,
    0.6258357354491761,
)


def sh_basis(x, y, z, degree: int) -> list:
    """Real SH basis values up to `degree`, one array per coefficient."""
    c = SH_C
    one = torch.ones_like(x) if isinstance(x, torch.Tensor) else np.ones_like(x)
    out = [c[0] * one]
    if degree >= 1:
        out += [-c[1] * y, c[1] * z, -c[1] * x]
    if degree >= 2:
        xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
        out += [c[2] * xy, -c[2] * yz, c[3] * (2 * zz - xx - yy), -c[2] * xz, c[4] * (xx - yy)]
    if degree >= 3:
        out += [
            -c[5] * y * (3 * xx - yy), c[6] * xy * z, -c[7] * y * (4 * zz - xx - yy),
            c[8] * z * (2 * zz - 3 * xx - 3 * yy), -c[7] * x * (4 * zz - xx - yy), c[9] * z * (xx - yy),
            -c[5] * x * (xx - 3 * yy),
        ]
    if degree >= 4:
        out += [
            c[10] * xy * (xx - yy), -c[11] * yz * (3 * xx - yy), c[12] * xy * (7 * zz - 1),
            -c[13] * yz * (7 * zz - 3), c[14] * (35 * zz * zz - 30 * zz + 3), -c[13] * xz * (7 * zz - 3),
            c[15] * (xx - yy) * (7 * zz - 1), -c[11] * xz * (xx - 3 * yy), c[16] * (xx * xx - 6 * xx * yy + yy * yy),
        ]
    return out


@lru_cache(maxsize=None)
def _sh_fit(degree: int):
    """Fibonacci directions D and pinv(B_l(D)) in float64: a degree-l SH
    rotation is B_l(R D) pinv(B_l(D))."""
    n = 2 * (2 * degree + 1)
    i = np.arange(n, dtype=np.float64) + 0.5
    phi = np.arccos(1 - 2 * i / n)
    theta = np.pi * (1 + 5**0.5) * i
    dirs = np.stack([np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta), np.cos(phi)], -1)
    basis = np.stack(sh_basis(dirs[:, 0], dirs[:, 1], dirs[:, 2], degree), -1)[:, degree**2:]
    return dirs, np.linalg.pinv(basis)


def sh_rotation(rot: torch.Tensor, degree: int) -> torch.Tensor:
    """(..., 3, 3) -> block-diagonal (..., n, n) rotation of SH coefficients."""
    n = (degree + 1) ** 2
    m = torch.zeros((*rot.shape[:-2], n, n), dtype=rot.dtype, device=rot.device)
    m[..., 0, 0] = 1.0
    for l in range(1, degree + 1):
        dirs, pinv = _sh_fit(l)
        d = torch.as_tensor(dirs, dtype=rot.dtype, device=rot.device) @ rot.transpose(-1, -2)
        b = torch.stack(sh_basis(d[..., 0], d[..., 1], d[..., 2], l)[l**2:], -1)
        m[..., l**2:(l + 1) ** 2, l**2:(l + 1) ** 2] = b.transpose(-1, -2) @ torch.as_tensor(
            pinv, dtype=rot.dtype, device=rot.device
        ).T
    return m


def eval_sh_colors(harmonics: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """(g, 3, d_sh) coefficients at (g, 3) unit directions -> (g, 3) colours,
    +0.5 and clamped at 0."""
    degree = int(math.isqrt(harmonics.shape[-1])) - 1
    basis = torch.stack(sh_basis(dirs[:, 0], dirs[:, 1], dirs[:, 2], degree), -1)
    return torch.clamp((harmonics * basis[:, None, :]).sum(-1) + 0.5, min=0.0)


# --------------------------------------------------------------------------
# The encoder


def quaternion_matrix(q: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """(..., 4) xyzw -> (..., 3, 3)."""
    i, j, k, r = q.unbind(-1)
    s = 2.0 / ((q * q).sum(-1) + eps)
    return torch.stack(
        [
            1 - s * (j * j + k * k), s * (i * j - k * r), s * (i * k + j * r),
            s * (i * j + k * r), 1 - s * (i * i + k * k), s * (j * k - i * r),
            s * (i * k - j * r), s * (j * k + i * r), 1 - s * (i * i + j * j),
        ],
        -1,
    ).reshape(*q.shape[:-1], 3, 3)


class DepthPredictor(nn.Module):
    def __init__(self, d_in: int, samples: int, surfaces: int):
        super().__init__()
        self.samples, self.surfaces = samples, surfaces
        self.projection = nn.Sequential(nn.ReLU(), nn.Linear(d_in, 2 * samples * surfaces))


class Encoder(nn.Module):
    """pixelSplat's encoder for a configuration's `encoder` section."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        bb = cfg["backbone"]
        d = cfg["d_feature"]
        self.backbone = Backbone(bb["model"], bb["d_out"], bb.get("pos_grid"))
        self.backbone_projection = nn.Sequential(nn.ReLU(), nn.Linear(bb["d_out"], d))
        self.epipolar_transformer = EpipolarTransformer(cfg["epipolar_transformer"], d, cfg["num_context_views"])
        self.high_resolution_skip = nn.Sequential(nn.Conv2d(3, d, 7, 1, 3), nn.ReLU())
        self.depth_predictor = DepthPredictor(d, cfg["num_monocular_samples"], cfg["num_surfaces"])
        self.sh_degree = cfg["gaussian_adapter"]["sh_degree"]
        self.d_sh = (self.sh_degree + 1) ** 2
        self.to_gaussians = nn.Sequential(nn.ReLU(), nn.Linear(d, cfg["num_surfaces"] * (9 + 3 * self.d_sh)))

    def depth_distribution(self, context: dict, view_order: torch.Tensor | None = None):
        """(features (b, v, h*w, d), normalized pdf over the disparity buckets
        and the offset in each, both (b, v, h*w, surfaces, buckets))."""
        cfg = self.cfg
        image, extr, intr = context["image"], context["extrinsics"], context["intrinsics"]
        b, v, _, h, w = image.shape
        d = cfg["d_feature"]
        if view_order is None:
            view_order = torch.arange(v - 1, device=image.device)
        feats = self.backbone_projection(self.backbone(image))  # (b, v, h, w, d)
        feats = self.epipolar_transformer(
            feats.permute(0, 1, 4, 2, 3), extr, intr, context["near"], context["far"], view_order.to(image.device)
        )
        feats = feats + self.high_resolution_skip(image.reshape(b * v, 3, h, w)).reshape(b, v, d, h, w)
        feats = feats.permute(0, 1, 3, 4, 2).reshape(b, v, h * w, d)
        s, srf = cfg["num_monocular_samples"], cfg["num_surfaces"]
        x = self.depth_predictor.projection(feats).reshape(b, v, h * w, s, srf, 2)
        pdf = torch.softmax(x[..., 0].transpose(-1, -2), dim=-1)
        offset = torch.sigmoid(x[..., 1].transpose(-1, -2))
        return feats, pdf / (geo.F32_EPS + pdf.sum(-1, keepdim=True)), offset

    def forward(self, context: dict, step: int, u: torch.Tensor, view_order: torch.Tensor | None = None):
        """context: image (b, v, 3, h, w), extrinsics, intrinsics, near, far;
        u: (b, v, h*w, surfaces, gpp) uniforms of the depth sampling.
        Returns (means (b, g, 3), covariances (b, g, 3, 3), harmonics
        (b, g, 3, d_sh), opacities (b, g))."""
        cfg = self.cfg
        image, extr, intr = context["image"], context["extrinsics"], context["intrinsics"]
        near, far = context["near"], context["far"]
        b, v, _, h, w = image.shape
        srf, gpp = cfg["num_surfaces"], cfg["gaussians_per_pixel"]
        s = cfg["num_monocular_samples"]

        # Depth: a pdf over disparity buckets and an offset in each; gpp
        # buckets drawn by inverse CDF from u.
        feats, pdf, offset = self.depth_distribution(context, view_order)
        index = (torch.cumsum(pdf, -1)[..., :, None] <= u[..., None, :]).sum(-2).clamp(0, s - 1)
        density = torch.gather(pdf, -1, index)
        disparity = (index.to(pdf.dtype) + torch.gather(offset, -1, index)) / s
        near_b, far_b = near[:, :, None, None, None], far[:, :, None, None, None]
        dn, df = 1.0 / (near_b + 1e-10), 1.0 / (far_b + 1e-10)
        depth = 1.0 / ((1.0 - disparity) * (dn - df) + df + 1e-10)  # (b, v, r, srf, gpp)

        om = cfg["opacity_mapping"]
        exponent = 2.0 ** (om["initial"] + min(step / om["warm_up"], 1.0) * (om["final"] - om["initial"]))
        opacity = 0.5 * (1.0 - (1.0 - density) ** exponent + density ** (1.0 / exponent)) / gpp

        raw = self.to_gaussians(feats).reshape(b, v, h * w, srf, 9 + 3 * self.d_sh)
        pixel = torch.tensor([1.0 / w, 1.0 / h], dtype=raw.dtype, device=raw.device)
        xy = geo.image_grid(h, w, raw.device).reshape(h * w, 1, 2) + (torch.sigmoid(raw[..., :2]) - 0.5) * pixel

        # Gaussian adapter, with the sample axis last-but-one.
        ga = cfg["gaussian_adapter"]
        raw = raw[..., None, 2:]  # (b, v, r, srf, 1, 7 + 3 d_sh)
        e5, k5 = extr[:, :, None, None, None], intr[:, :, None, None, None]
        scale = ga["gaussian_scale_min"] + (ga["gaussian_scale_max"] - ga["gaussian_scale_min"]) * torch.sigmoid(
            raw[..., :3]
        )
        kinv = geo.inverse_intrinsics(k5)[..., :2, :2]
        multiplier = 0.1 * (kinv[..., 0, 0] * pixel[0] + kinv[..., 0, 1] * pixel[1]) + 0.1 * (
            kinv[..., 1, 0] * pixel[0] + kinv[..., 1, 1] * pixel[1]
        )
        scale = scale * depth[..., None] * multiplier[..., None]  # (b, v, r, srf, gpp, 3)
        rot = raw[..., 3:7]
        rot = rot / (torch.linalg.vector_norm(rot, dim=-1, keepdim=True) + 1e-8)
        m = e5[..., :3, :3] @ quaternion_matrix(rot)
        cov = (m * (scale * scale)[..., None, :]) @ m.transpose(-1, -2)

        mask = torch.ones(self.d_sh, dtype=raw.dtype, device=raw.device)
        for l in range(1, self.sh_degree + 1):
            mask[l**2:(l + 1) ** 2] = 0.1 * 0.25**l
        sh = raw[..., 7:].reshape(*raw.shape[:-1], 3, self.d_sh) * mask
        harmonics = sh @ sh_rotation(extr[..., :3, :3], self.sh_degree)[:, :, None, None, None].transpose(-1, -2)

        origins, dirs = geo.world_rays(xy[..., None, :], e5, k5)
        means = origins + dirs * depth[..., None]

        g = v * h * w * srf * gpp
        harmonics = harmonics.expand(b, v, h * w, srf, gpp, 3, self.d_sh)
        return (
            means.reshape(b, g, 3),
            cov.reshape(b, g, 3, 3),
            harmonics.reshape(b, g, 3, self.d_sh),
            opacity.reshape(b, g),
        )


def apply_shims(batch: dict, cfg: dict) -> dict:
    """Centre-crop to the epipolar transformer's patch multiple and set
    near/far from the widest context baseline (disparity 3 x image size
    pixels near, 0.5 far)."""
    et = cfg["epipolar_transformer"]
    patch = et["self_attention"]["patch_size"] * et["downscale"]
    out = {}
    for key, views in batch.items():
        *_, h, w = views["image"].shape
        hn, wn = h // patch * patch, w // patch * patch
        r0, c0 = (h - hn) // 2, (w - wn) // 2
        k = views["intrinsics"].clone()
        k[..., 0, 0] *= w / wn
        k[..., 1, 1] *= h / hn
        out[key] = {**views, "image": views["image"][..., r0:r0 + hn, c0:c0 + wn], "intrinsics": k}
    ctx = out["context"]
    h, w = ctx["image"].shape[-2:]
    origins = ctx["extrinsics"][..., :3, 3]
    baseline = torch.linalg.vector_norm(origins[:, None] - origins[:, :, None], dim=-1).clamp(min=1e-6).amax((1, 2))
    k = ctx["intrinsics"]
    pix = torch.stack([(1.0 / w) / k[..., 0, 0], (1.0 / h) / k[..., 1, 1]], -1).mean((1, 2))
    near = baseline / (cfg["near_disparity"] * min(h, w) * pix)
    far = baseline / (0.5 * pix)
    for key in out:
        n = out[key]["image"].shape[1]
        out[key] = {**out[key], "near": near[:, None].expand(-1, n), "far": far[:, None].expand(-1, n)}
    return out


# Margin of a depth sample's uniform from the reference's bucket edges, far
# above float32 rounding of the cumulative distribution (~1e-6).
EDGE_MARGIN = 1e-5


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device) for k, v in tree.items()}


def settle_draws(units: list, encoder: Encoder, cfg: dict, device) -> list:
    """`units` with every depth uniform that lies within EDGE_MARGIN of an
    edge of the reference's cumulative bucket distribution moved to the
    middle of the nearest bucket at least twice the margin wide.

    Inverse-CDF sampling is discontinuous at the edges: there two correct
    float32 programs, which round the distribution differently, draw
    neighbouring buckets and place a Gaussian at another depth. The
    benchmark chooses its inputs away from the edges, so that the check
    measures the arithmetic and not where rounding falls."""
    out = []
    for unit in units:
        context = apply_shims(_to(unit.batch, device), cfg)["context"]
        with torch.no_grad():
            _, pdf, _ = encoder.depth_distribution(context, unit.view_order)
        upper = torch.cumsum(pdf, -1)  # (b, v, r, srf, buckets)
        lower = torch.cat([torch.zeros_like(upper[..., :1]), upper[..., :-1]], -1)
        middle = (0.5 * (lower + upper))[..., None, :]
        u = unit.u[..., :, None]  # (b, v, r, srf, gpp, 1)
        near_edge = (upper[..., None, :] - u).abs().amin(-1) < EDGE_MARGIN
        wide = ((upper - lower) >= 2 * EDGE_MARGIN)[..., None, :]
        choice = torch.where(wide, (middle - u).abs(), torch.full_like(middle.expand_as(wide), math.inf)).argmin(-1)
        settled = torch.gather(middle.expand(*choice.shape, middle.shape[-1]), -1, choice[..., None])[..., 0]
        out.append(replace(unit, u=torch.where(near_edge, settled, unit.u)))
    return out
