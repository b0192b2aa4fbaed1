"""MVSplat's multi-view backbone: a CNN to 1/4 resolution and a transformer
of windowed self-attention and cross-view attention over its features.

The CNN is UniMatch's `CNNEncoder` at 1/4 resolution: a 7x7 stride-2
convolution to 64 channels, residual stages of 64, 96 (stride 2) and 128
channels with instance norms, and a 1x1 convolution to `d_feature`. The
transformer (`MultiViewFeatureTransformer`, one head) adds a sine position
encoding of each attention window's own pixel grid, then runs 6 blocks of a
self-attention layer and a cross-view attention layer with a feed-forward on
`cat[x, message]`. Attention runs inside `splits` x `splits` windows,
shifted by half a window on odd blocks with the Swin mask (-100 across the
shifted regions); the cross-view layer of a view attends to the same window
of every other view, as those views came into the block.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ....ops.conv3x3_kernel import Conv3x3
from ....utils.device_constants import on_device
from ..epipolar.epipolar_sampler import collect_other_views

# ImageNet statistics: UniMatch's CNN takes normalized images.
IMAGE_MEAN = (0.485, 0.456, 0.406)
IMAGE_STD = (0.229, 0.224, 0.225)


def _image_statistics() -> list:
    return [IMAGE_MEAN, IMAGE_STD]
CNN_WIDTHS = (64, 96, 128)


class ResidualBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv3x3(in_planes, planes, stride, bias=False)
        self.conv2 = Conv3x3(planes, planes, bias=False)
        self.norm1 = nn.InstanceNorm2d(planes)
        self.norm2 = nn.InstanceNorm2d(planes)
        self.downsample = None
        if stride != 1 or in_planes != planes:
            self.downsample = nn.Sequential(nn.Conv2d(in_planes, planes, 1, stride), nn.InstanceNorm2d(planes))

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class CNNEncoder(nn.Module):
    """(n, 3, h, w) normalized images -> (n, d_out, h / 4, w / 4)."""

    def __init__(self, d_out: int):
        super().__init__()
        w1, w2, w3 = CNN_WIDTHS
        self.conv1 = nn.Conv2d(3, w1, 7, 2, 3, bias=False)
        self.norm1 = nn.InstanceNorm2d(w1)
        self.layer1 = nn.Sequential(ResidualBlock(w1, w1), ResidualBlock(w1, w1))
        self.layer2 = nn.Sequential(ResidualBlock(w1, w2, 2), ResidualBlock(w2, w2))
        self.layer3 = nn.Sequential(ResidualBlock(w2, w3), ResidualBlock(w3, w3))
        self.conv2 = nn.Conv2d(w3, d_out, 1)

    def forward(self, x):
        x = F.relu(self.norm1(self.conv1(x)))
        return self.conv2(self.layer3(self.layer2(self.layer1(x))))


def window_position_encoding(h: int, w: int, channels: int, device, dtype=torch.float32) -> torch.Tensor:
    """(channels, h, w) sine encoding of an h x w grid (DETR's, normalized
    to 2 pi, temperature 10,000): the first half encodes y, the second x."""
    feats = channels // 2
    y = torch.arange(1, h + 1, device=device, dtype=dtype) / (h + 1e-6) * (2 * math.pi)
    x = torch.arange(1, w + 1, device=device, dtype=dtype) / (w + 1e-6) * (2 * math.pi)
    dim_t = torch.arange(feats, device=device, dtype=dtype)
    dim_t = 10000.0 ** (2 * torch.div(dim_t, 2, rounding_mode="floor") / feats)

    def encode(t):  # (n,) -> (n, feats): sin at even, cos at odd channels
        p = t[:, None] / dim_t
        return torch.stack((p[:, 0::2].sin(), p[:, 1::2].cos()), dim=-1).flatten(1)

    pos_y = encode(y)[:, None, :].expand(h, w, feats)
    pos_x = encode(x)[None, :, :].expand(h, w, feats)
    return torch.cat((pos_y, pos_x), dim=-1).permute(2, 0, 1)


def to_windows(x: torch.Tensor, splits: int) -> torch.Tensor:
    """(..., h, w, c) -> (..., splits * splits, h / splits * w / splits, c),
    windows in row-major order."""
    *lead, h, w, c = x.shape
    x = x.reshape(*lead, splits, h // splits, splits, w // splits, c)
    n = len(lead)
    x = x.permute(*range(n), n, n + 2, n + 1, n + 3, n + 4)
    return x.reshape(*lead, splits * splits, (h // splits) * (w // splits), c)


def from_windows(x: torch.Tensor, splits: int, h: int, w: int) -> torch.Tensor:
    """The inverse of `to_windows`."""
    *lead, _, _, c = x.shape
    x = x.reshape(*lead, splits, splits, h // splits, w // splits, c)
    n = len(lead)
    x = x.permute(*range(n), n, n + 2, n + 1, n + 3, n + 4)
    return x.reshape(*lead, h, w, c)


def shifted_window_mask(h: int, w: int, splits: int, device) -> torch.Tensor:
    """(splits^2, L, L) additive mask of the shifted windows (Swin's): 0
    between pixels of one region of the rolled image, -100 across regions."""
    wh, ww = h // splits, w // splits
    sh, sw = wh // 2, ww // 2
    label = torch.zeros((h, w, 1), device=device)
    count = 0
    for rows in (slice(0, -wh), slice(-wh, -sh), slice(-sh, None)):
        for cols in (slice(0, -ww), slice(-ww, -sw), slice(-sw, None)):
            label[rows, cols] = count
            count += 1
    windows = to_windows(label, splits)[..., 0]  # (splits^2, L)
    diff = windows[:, None, :] - windows[:, :, None]
    return torch.where(diff != 0, torch.full_like(diff, -100.0), torch.zeros_like(diff))


def window_attention(q, k, v, splits: int, shift: bool, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Single-head attention of q (n, h, w, c) over k, v (n, m, h, w, c)
    (m key views) inside `splits` x `splits` windows, the keys of a window
    being that window of every key view; with `shift`, the windows are
    rolled by half their size and `mask` keeps each query to its region."""
    n, h, w, c = q.shape
    m = k.shape[1]
    if shift:
        sh, sw = h // splits // 2, w // splits // 2
        q = torch.roll(q, shifts=(-sh, -sw), dims=(1, 2))
        k = torch.roll(k, shifts=(-sh, -sw), dims=(2, 3))
        v = torch.roll(v, shifts=(-sh, -sw), dims=(2, 3))
    qw = to_windows(q, splits)  # (n, s2, L, c)
    s2, length = qw.shape[1], qw.shape[2]

    def keys(t):  # (n, m, h, w, c) -> (n, s2, m * L, c)
        return to_windows(t, splits).transpose(1, 2).reshape(n, s2, m * length, c)

    bias = mask.repeat(1, 1, m) if shift else None  # (s2, L, m * L)
    out = F.scaled_dot_product_attention(qw, keys(k), keys(v), attn_mask=bias, scale=1.0 / math.sqrt(c))
    out = from_windows(out, splits, h, w)
    if shift:
        out = torch.roll(out, shifts=(sh, sw), dims=(1, 2))
    return out


class TransformerLayer(nn.Module):
    """One attention layer: bias-free q, k, v and merge, a LayerNorm after
    merge, and (with `ffn`) the feed-forward on `cat[x, message]`."""

    def __init__(self, d: int, ffn: bool, expansion: int = 4):
        super().__init__()
        self.q_proj = nn.Linear(d, d, bias=False)
        self.k_proj = nn.Linear(d, d, bias=False)
        self.v_proj = nn.Linear(d, d, bias=False)
        self.merge = nn.Linear(d, d, bias=False)
        self.norm1 = nn.LayerNorm(d)
        self.ffn = ffn
        if ffn:
            self.mlp = nn.Sequential(
                nn.Linear(2 * d, 2 * d * expansion, bias=False), nn.GELU(), nn.Linear(2 * d * expansion, d, bias=False)
            )
            self.norm2 = nn.LayerNorm(d)

    def forward(self, x, kv, splits, shift, mask):
        """x (n, h, w, c) attends to kv (n, m, h, w, c)."""
        message = window_attention(self.q_proj(x), self.k_proj(kv), self.v_proj(kv), splits, shift, mask)
        message = self.norm1(self.merge(message))
        if self.ffn:
            message = self.norm2(self.mlp(torch.cat([x, message], dim=-1)))
        return x + message


class TransformerBlock(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.self_attn = TransformerLayer(d, ffn=False)
        self.cross_attn_ffn = TransformerLayer(d, ffn=True)

    def forward(self, x, splits, shift, mask):
        """x: (b, v, h, w, c), every view's tokens."""
        b, v, h, w, c = x.shape
        others = collect_other_views(x, v).reshape(b * v, v - 1, h, w, c)
        flat = x.reshape(b * v, h, w, c)
        flat = self.self_attn(flat, flat[:, None], splits, shift, mask)
        flat = self.cross_attn_ffn(flat, others, splits, shift, mask)
        return flat.reshape(b, v, h, w, c)


class MultiViewFeatureTransformer(nn.Module):
    def __init__(self, d: int, num_layers: int = 6):
        super().__init__()
        self.layers = nn.ModuleList([TransformerBlock(d) for _ in range(num_layers)])

    def forward(self, features: torch.Tensor, splits: int) -> torch.Tensor:
        """(b, v, c, h, w) -> (b, v, c, h, w), position added first."""
        b, v, c, h, w = features.shape
        pos = window_position_encoding(h // splits, w // splits, c, features.device, features.dtype)
        x = features.permute(0, 1, 3, 4, 2)  # (b, v, h, w, c)
        x = from_windows(to_windows(x, splits) + pos.permute(1, 2, 0).reshape(-1, c), splits, h, w)
        mask = shifted_window_mask(h, w, splits, features.device) if splits > 1 else None
        for i, block in enumerate(self.layers):
            x = block(x, splits, splits > 1 and i % 2 == 1, mask)
        return x.permute(0, 1, 4, 2, 3)


class BackboneMultiview(nn.Module):
    """Images (b, v, 3, h, w) in [0, 1] -> the CNN's features and the
    transformer's, both (b, v, d, h / 4, w / 4)."""

    def __init__(self, d_feature: int):
        super().__init__()
        self.backbone = CNNEncoder(d_feature)
        self.transformer = MultiViewFeatureTransformer(d_feature)

    def cnn(self, images: torch.Tensor) -> torch.Tensor:
        b, v, _, h, w = images.shape
        mean, std = on_device("image_statistics", _image_statistics, device=images.device, dtype=images.dtype)
        x = (images.reshape(b * v, 3, h, w) - mean[:, None, None]) / std[:, None, None]
        x = self.backbone(x)
        return x.reshape(b, v, *x.shape[1:])
