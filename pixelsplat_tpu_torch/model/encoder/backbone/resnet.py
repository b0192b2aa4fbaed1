"""ResNet backbone with multi-scale feature fusion.

Port of `pixelsplat_tpu/model/encoder/backbone/resnet.py` for the
`dino_resnet50` trunk the DINO backbone uses: a torchvision-layout
ResNet-50 whose BatchNorm layers are frozen (inference mode), a 1x1
projection of every stage to `d_out`, an align-corners bilinear upsample
of each to full resolution, and their sum. Parameter names are the
reference's (`model.layer1.0.conv1`, `projections.layer0`, ...).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Literal

import numpy as np
import torch
from torch import nn

RESNET_SPECS: dict[str, tuple[str, tuple[int, ...]]] = {
    "resnet18": ("basic", (2, 2, 2, 2)),
    "resnet34": ("basic", (3, 4, 6, 3)),
    "resnet50": ("bottleneck", (3, 4, 6, 3)),
    "resnet101": ("bottleneck", (3, 4, 23, 3)),
    "resnet152": ("bottleneck", (3, 8, 36, 3)),
    "dino_resnet50": ("bottleneck", (3, 4, 6, 3)),
}


@dataclass(frozen=True)
class BackboneResnetCfg:
    name: Literal["resnet"] = "resnet"
    model: str = "resnet50"
    num_layers: int = 5
    use_first_pool: bool = False
    d_out: int = 512


class FrozenBatchNorm2d(nn.Module):
    """Inference-mode BatchNorm: (x - mean) * rsqrt(var + 1e-5) * w + b.

    It never takes batch statistics, in `train()` mode either. The
    statistics are parameters, under the names of BatchNorm's buffers: the
    JAX package declares `mean` and `var` as parameters
    (`backbone/resnet.py:66-69`) and its optimizer masks nothing, so a
    training step differentiates and updates them like any weight.
    """

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.running_mean = nn.Parameter(torch.zeros(channels))
        self.running_var = nn.Parameter(torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (n, c, h, w)
        scale = torch.rsqrt(self.running_var + 1e-5)
        shape = (1, -1, 1, 1)
        return (x - self.running_mean.view(shape)) * scale.view(shape) * self.weight.view(
            shape
        ) + self.bias.view(shape)


class Bottleneck(nn.Module):
    """torchvision Bottleneck (stride on the 3x3 conv), frozen BN."""

    def __init__(self, in_channels: int, channels: int, stride: int = 1):
        super().__init__()
        out_ch = channels * 4
        self.conv1 = nn.Conv2d(in_channels, channels, 1, bias=False)
        self.bn1 = FrozenBatchNorm2d(channels)
        self.conv2 = nn.Conv2d(channels, channels, 3, stride=stride, padding=1, bias=False)
        self.bn2 = FrozenBatchNorm2d(channels)
        self.conv3 = nn.Conv2d(channels, out_ch, 1, bias=False)
        self.bn3 = FrozenBatchNorm2d(out_ch)
        self.downsample = None
        if stride != 1 or in_channels != out_ch:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_channels, out_ch, 1, stride=stride, bias=False),
                FrozenBatchNorm2d(out_ch),
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + residual)


class _Trunk(nn.Module):
    """The torchvision module tree the reference keeps under `model`."""

    def __init__(self, stage_sizes: tuple[int, ...], num_stages: int):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm2d(64)
        in_ch = 64
        for stage in range(1, num_stages + 1):
            width = (64, 128, 256, 512)[stage - 1]
            blocks = []
            for i in range(stage_sizes[stage - 1]):
                stride = 2 if (stage > 1 and i == 0) else 1
                blocks.append(Bottleneck(in_ch, width, stride))
                in_ch = width * 4
            self.add_module(f"layer{stage}", nn.Sequential(*blocks))


def _resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """Dense align_corners=True bilinear interpolation matrix (n_out, n_in)."""
    m = np.zeros((n_out, n_in), np.float32)
    if n_out == 1 or n_in == 1:
        m[:, 0] = 1.0
        return m
    coords = np.arange(n_out, dtype=np.float64) * (n_in - 1) / (n_out - 1)
    lo = np.clip(np.floor(coords).astype(np.int64), 0, n_in - 1)
    hi = np.clip(lo + 1, 0, n_in - 1)
    frac = (coords - lo).astype(np.float32)
    m[np.arange(n_out), lo] += 1.0 - frac
    m[np.arange(n_out), hi] += frac
    return m


def _bilinear_resize(x: torch.Tensor, shape: tuple[int, int]) -> torch.Tensor:
    """align_corners=True bilinear resize of (n, c, h, w) to `shape`, as
    two products with constant interpolation matrices."""
    h, w = x.shape[-2:]
    h_out, w_out = shape
    if h != h_out:
        mh = torch.as_tensor(_resize_matrix(h, h_out), device=x.device, dtype=x.dtype)
        x = mh @ x
    if w != w_out:
        mw = torch.as_tensor(_resize_matrix(w, w_out), device=x.device, dtype=x.dtype)
        x = x @ mw.T
    return x


def _resize_and_sum(features: list[torch.Tensor], shape: tuple[int, int]) -> torch.Tensor:
    """sum(_bilinear_resize(f, shape) for f in features)."""
    out = _bilinear_resize(features[0], shape)
    for f in features[1:]:
        out = out + _bilinear_resize(f, shape)
    return out


class BackboneResnet(nn.Module):
    def __init__(self, cfg: BackboneResnetCfg):
        super().__init__()
        if cfg.model != "dino_resnet50":
            raise NotImplementedError(
                f"{cfg.model}: the port has the frozen-BatchNorm dino_resnet50 trunk; "
                "the InstanceNorm torchvision trunks come with the resnet-backbone slice"
            )
        if cfg.use_first_pool:
            raise NotImplementedError("use_first_pool (no shipped config sets it)")
        self.cfg = cfg
        _, stage_sizes = RESNET_SPECS[cfg.model]
        self.model = _Trunk(stage_sizes, cfg.num_layers - 1)
        widths = [64] + [w * 4 for w in (64, 128, 256, 512)[: cfg.num_layers - 1]]
        self.projections = nn.ModuleDict(
            {f"layer{i}": nn.Conv2d(c, cfg.d_out, 1) for i, c in enumerate(widths)}
        )

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images: (b, v, 3, h, w) -> (b, v, h, w, d_out), channels-last."""
        b, v, _, h, w = images.shape
        x = images.reshape(b * v, 3, h, w)
        x = torch.relu(self.model.bn1(self.model.conv1(x)))
        features = [self.projections["layer0"](x)]
        for stage in range(1, self.cfg.num_layers):
            x = getattr(self.model, f"layer{stage}")(x)
            features.append(self.projections[f"layer{stage}"](x))
        fused = _resize_and_sum(features, (h, w))  # (bv, d_out, h, w)
        return fused.permute(0, 2, 3, 1).reshape(b, v, h, w, self.cfg.d_out)

    @property
    def d_out(self) -> int:
        return self.cfg.d_out
