"""MVSplat's 2D U-Net (the latent-diffusion `UNetModel` without timestep
embedding), whose attention blocks attend over every view's tokens at once.

`channel_mult` sets the levels, each at half the resolution of the one
above; a level is one residual block (then attention where its stride is in
`attention_res`) and, but for the last, a stride-2 convolution down. The
middle is a residual block, attention and a residual block. Going up, each
level takes two residual blocks, each on the features concatenated with the
skip of the same place going down, attention where the down path had it,
and, but for the top, a nearest x2 upsampling and a 3x3 convolution. The
output is GroupNorm, SiLU and a 3x3 convolution. Normalizations are
GroupNorm of 32 groups (of one channel each where there are fewer than 32
channels), attention heads are 32 channels wide, and the features are laid
out (v b) as in MVSplat, the views of an attention block told apart by
`num_views`.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ....ops.conv3x3_kernel import Conv3x3

HEAD_CHANNELS = 32


def normalization(channels: int) -> nn.GroupNorm:
    return nn.GroupNorm(min(32, channels), channels)


class ResBlock(nn.Module):
    def __init__(self, channels: int, out_channels: int):
        super().__init__()
        self.in_layers = nn.Sequential(normalization(channels), nn.SiLU(), Conv3x3(channels, out_channels))
        self.out_layers = nn.Sequential(
            normalization(out_channels), nn.SiLU(), nn.Dropout(0.0), Conv3x3(out_channels, out_channels)
        )
        self.skip_connection = nn.Identity() if out_channels == channels else nn.Conv2d(channels, out_channels, 1)

    def forward(self, x):
        return self.skip_connection(x) + self.out_layers(self.in_layers(x))


class AttentionBlock(nn.Module):
    """Self-attention over the tokens of all `num_views` views of a scene
    (the input's leading axis is (v b)), heads of 32 channels, with the
    latent-diffusion "legacy" order of q, k and v within a head's channels."""

    def __init__(self, channels: int, num_views: int):
        super().__init__()
        self.num_views = num_views
        self.heads = max(1, channels // HEAD_CHANNELS)
        self.norm = normalization(channels)
        self.qkv = nn.Conv1d(channels, 3 * channels, 1)
        self.proj_out = nn.Conv1d(channels, channels, 1)

    def forward(self, x):
        vb, c, h, w = x.shape
        v, b = self.num_views, vb // self.num_views
        tokens = x.reshape(v, b, c, h * w).permute(1, 2, 0, 3).reshape(b, c, v * h * w)
        qkv = self.qkv(self.norm(tokens))  # (b, 3c, n)
        d = c // self.heads
        q, k, val = qkv.reshape(b, self.heads, 3 * d, v * h * w).transpose(-1, -2).split(d, dim=-1)
        out = F.scaled_dot_product_attention(q, k, val, scale=1.0 / math.sqrt(d))  # (b, heads, n, d)
        out = self.proj_out(out.transpose(-1, -2).reshape(b, c, v * h * w))
        out = out.reshape(b, c, v, h * w).permute(2, 0, 1, 3).reshape(vb, c, h, w)
        return x + out


class Downsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.op = Conv3x3(channels, channels, stride=2)

    def forward(self, x):
        return self.op(x)


class Upsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv3x3(channels, channels)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class UNetModel(nn.Module):
    def __init__(self, channels: int, channel_mult: tuple, attention_res: tuple, num_views: int):
        super().__init__()

        def attention(ch):
            return [AttentionBlock(ch, num_views)]

        self.input_blocks = nn.ModuleList([nn.Sequential(Conv3x3(channels, channels))])
        skips = [channels]
        ch, ds = channels, 1
        for level, mult in enumerate(channel_mult):
            out = mult * channels
            layers = [ResBlock(ch, out)] + (attention(out) if ds in attention_res else [])
            self.input_blocks.append(nn.Sequential(*layers))
            ch = out
            skips.append(ch)
            if level != len(channel_mult) - 1:
                self.input_blocks.append(nn.Sequential(Downsample(ch)))
                skips.append(ch)
                ds *= 2
        self.middle_block = nn.Sequential(ResBlock(ch, ch), *attention(ch), ResBlock(ch, ch))
        self.output_blocks = nn.ModuleList()
        for level, mult in list(enumerate(channel_mult))[::-1]:
            for i in range(2):
                out = mult * channels
                layers = [ResBlock(ch + skips.pop(), out)] + (attention(out) if ds in attention_res else [])
                ch = out
                if level and i == 1:
                    layers.append(Upsample(ch))
                    ds //= 2
                self.output_blocks.append(nn.Sequential(*layers))
        self.out = nn.Sequential(normalization(ch), nn.SiLU(), Conv3x3(ch, channels))

    def forward(self, x):
        skips = []
        for block in self.input_blocks:
            x = block(x)
            skips.append(x)
        x = self.middle_block(x)
        for block in self.output_blocks:
            x = block(torch.cat([x, skips.pop()], dim=1))
        return self.out(x)
