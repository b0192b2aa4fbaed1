"""ResNet backbone with multi-scale feature fusion.

Port of `pixelsplat_tpu/model/encoder/backbone/resnet.py`: a
torchvision-layout ResNet trunk, a 1x1 projection of every stage to
`d_out`, an align-corners bilinear upsample of each to full resolution, and
their sum. The trunks of `RESNET_SPECS` normalize with a parameter-free
InstanceNorm, as the reference's torchvision models do; `dino_resnet50`
(the DINO backbone's branch) with frozen, inference-mode BatchNorm. Both
norms work in f32 whatever the compute dtype; the convolutions run in the
compute `dtype` (`model/precision.py`), the projections in f32.
`use_first_pool` applies torchvision's 3x3 stride-2 max pool before the
first stage, as the JAX package does (the reference never applied it).
Parameter names are the reference's (`model.layer1.0.conv1`,
`projections.layer0`, ...).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Literal, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ....utils.device_constants import on_device
from ... import precision

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


class InstanceNorm2d(nn.Module):
    """Parameter-free InstanceNorm over each map's H x W, in f32: biased
    variance, eps 1e-5."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (n, c, h, w)
        return F.instance_norm(x.float(), eps=1e-5)


class FrozenBatchNorm2d(nn.Module):
    """Inference-mode BatchNorm, in f32: (x - mean) * rsqrt(var + 1e-5) * w + b.

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
        return (x.float() - self.running_mean.view(shape)) * scale.view(shape) * self.weight.view(
            shape
        ) + self.bias.view(shape)


def _norm(kind: str, channels: int) -> nn.Module:
    return FrozenBatchNorm2d(channels) if kind == "batch" else InstanceNorm2d()


def _conv(in_ch: int, out_ch: int, k: int, stride: int, dtype) -> nn.Module:
    return precision.Conv2d(in_ch, out_ch, k, stride=stride, padding=k // 2, bias=False, compute_dtype=dtype)


class BasicBlock(nn.Module):
    """torchvision BasicBlock (two 3x3 convolutions); resnet18 and resnet34."""

    expansion = 1

    def __init__(self, in_channels: int, channels: int, stride: int = 1, norm: str = "instance",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = _conv(in_channels, channels, 3, stride, dtype)
        self.bn1 = _norm(norm, channels)
        self.conv2 = _conv(channels, channels, 3, 1, dtype)
        self.bn2 = _norm(norm, channels)
        self.downsample = None
        if stride != 1 or in_channels != channels:
            self.downsample = nn.Sequential(_conv(in_channels, channels, 1, stride, dtype), _norm(norm, channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + residual)


class Bottleneck(nn.Module):
    """torchvision Bottleneck (stride on the 3x3 conv)."""

    expansion = 4

    def __init__(self, in_channels: int, channels: int, stride: int = 1, norm: str = "instance",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        out_ch = channels * 4
        self.conv1 = _conv(in_channels, channels, 1, 1, dtype)
        self.bn1 = _norm(norm, channels)
        self.conv2 = _conv(channels, channels, 3, stride, dtype)
        self.bn2 = _norm(norm, channels)
        self.conv3 = _conv(channels, out_ch, 1, 1, dtype)
        self.bn3 = _norm(norm, out_ch)
        self.downsample = None
        if stride != 1 or in_channels != out_ch:
            self.downsample = nn.Sequential(_conv(in_channels, out_ch, 1, stride, dtype), _norm(norm, out_ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + residual)


class _Trunk(nn.Module):
    """The torchvision module tree the reference keeps under `model`."""

    def __init__(self, block_kind: str, stage_sizes: tuple[int, ...], num_stages: int, norm: str, dtype):
        super().__init__()
        block = BasicBlock if block_kind == "basic" else Bottleneck
        self.conv1 = precision.Conv2d(3, 64, 7, stride=2, padding=3, bias=False, compute_dtype=dtype)
        self.bn1 = _norm(norm, 64)
        in_ch = 64
        self.widths = [64]
        for stage in range(1, num_stages + 1):
            width = (64, 128, 256, 512)[stage - 1]
            blocks = []
            for i in range(stage_sizes[stage - 1]):
                stride = 2 if (stage > 1 and i == 0) else 1
                blocks.append(block(in_ch, width, stride, norm, dtype))
                in_ch = width * block.expansion
            self.add_module(f"layer{stage}", nn.Sequential(*blocks))
            self.widths.append(in_ch)


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
        x = on_device("resize_matrix", _resize_matrix, h, h_out, device=x.device, dtype=x.dtype) @ x
    if w != w_out:
        x = x @ on_device("resize_matrix", _resize_matrix, w, w_out, device=x.device, dtype=x.dtype).T
    return x


def _resize_and_sum(features: list[torch.Tensor], shape: tuple[int, int]) -> torch.Tensor:
    """sum(_bilinear_resize(f, shape) for f in features)."""
    out = _bilinear_resize(features[0], shape)
    for f in features[1:]:
        out = out + _bilinear_resize(f, shape)
    return out


class BackboneResnet(nn.Module):
    def __init__(self, cfg: BackboneResnetCfg, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg = cfg
        block_kind, stage_sizes = RESNET_SPECS[cfg.model]
        norm = "batch" if cfg.model == "dino_resnet50" else "instance"
        self.model = _Trunk(block_kind, stage_sizes, cfg.num_layers - 1, norm, dtype)
        # In f32: Flax's Conv without a dtype promotes its (f32) input and kernel.
        self.projections = nn.ModuleDict(
            {f"layer{i}": precision.Conv2d(c, cfg.d_out, 1) for i, c in enumerate(self.model.widths)}
        )

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images: (b, v, 3, h, w) -> (b, v, h, w, d_out), channels-last."""
        b, v, _, h, w = images.shape
        x = images.reshape(b * v, 3, h, w)
        x = torch.relu(self.model.bn1(self.model.conv1(x)))
        features = [self.projections["layer0"](x)]
        if self.cfg.use_first_pool:
            x = F.max_pool2d(x, 3, stride=2, padding=1)
        for stage in range(1, self.cfg.num_layers):
            x = getattr(self.model, f"layer{stage}")(x)
            features.append(self.projections[f"layer{stage}"](x))
        fused = _resize_and_sum(features, (h, w))  # (bv, d_out, h, w)
        return fused.permute(0, 2, 3, 1).reshape(b, v, h, w, self.cfg.d_out)

    @property
    def d_out(self) -> int:
        return self.cfg.d_out
