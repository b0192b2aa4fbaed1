"""Layers that compute in a chosen dtype, as Flax's do with `dtype=`.

The JAX package's bf16 compute policy (`EncoderEpipolarCfg.compute_dtype`)
hands `dtype=bfloat16` to the Dense and Conv layers of the backbone, the
epipolar transformer and the heads. Flax then casts the input, the kernel
and the bias of such a layer to bf16 and returns bf16; a layer without a
`dtype` promotes its input and its f32 parameters to their common type, so
it computes in f32 and turns a bf16 input back into f32 (LayerNorm too).
`torch.autocast` keeps other lists of ops in f32 and leaves the adds
alone, so the port mirrors each cast point instead with these layers: the
parameters stay f32 and one set of weights serves both policies; the
gradient of the cast carries each weight's gradient back in f32. With
`compute_dtype=None` each is its `torch.nn` parent on f32 inputs.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def resolve_dtype(name: Optional[str]) -> Optional[torch.dtype]:
    """A config's `compute_dtype` ("bfloat16", "float32" or None) as a torch dtype."""
    if name is None:
        return None
    dtype = getattr(torch, str(name), None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"compute_dtype {name!r} is not a floating-point torch dtype")
    return dtype


def _compute(x: torch.Tensor, weight: torch.Tensor, dtype: Optional[torch.dtype]) -> Optional[torch.dtype]:
    """The dtype a layer computes in, or None where the input and the
    parameters already share it: then the layer is its parent, without
    three no-op casts per call on the encoder's host-bound dispatch."""
    if dtype is None:
        if x.dtype == weight.dtype:
            return None
        return torch.promote_types(x.dtype, weight.dtype)
    return dtype


def _cast(p: Optional[torch.Tensor], dtype: torch.dtype) -> Optional[torch.Tensor]:
    return None if p is None else p.to(dtype)


class Linear(nn.Linear):
    """Flax `Dense(dtype=compute_dtype)`."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _compute(x, self.weight, self.compute_dtype)
        if dt is None:
            return super().forward(x)
        return F.linear(x.to(dt), self.weight.to(dt), _cast(self.bias, dt))


class Conv2d(nn.Conv2d):
    """Flax `Conv(dtype=compute_dtype)`, channels-first."""

    def __init__(self, *args, compute_dtype: Optional[torch.dtype] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _compute(x, self.weight, self.compute_dtype)
        if dt is None:
            return super().forward(x)
        return self._conv_forward(x.to(dt), self.weight.to(dt), _cast(self.bias, dt))


class ConvTranspose2d(nn.ConvTranspose2d):
    """Flax `ConvTranspose(dtype=compute_dtype)`, channels-first."""

    def __init__(self, *args, compute_dtype: Optional[torch.dtype] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _compute(x, self.weight, self.compute_dtype)
        if dt is None:
            return super().forward(x)
        return F.conv_transpose2d(
            x.to(dt), self.weight.to(dt), _cast(self.bias, dt), self.stride, self.padding,
            self.output_padding, self.groups, self.dilation,
        )


class LayerNorm(nn.LayerNorm):
    """Flax `LayerNorm()` without a dtype: a bf16 input comes out f32."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _compute(x, self.weight, None)
        return super().forward(x if dt is None else x.to(dt))
