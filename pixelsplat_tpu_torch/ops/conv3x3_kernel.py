"""MVSplat's stride-1 3x3 convolutions, `act(conv(x, weight) + bias)` on
NCHW feature maps: K11's wrapper (`csrc/conv3x3.cu`), its plain twin, its
gradient, and `Conv3x3`, the module MVSplat's encoder builds its 3x3
convolutions with.

`Conv3x3` is an `nn.Conv2d` (the same parameters under the same names) with
an optional exact-erf GELU after it, for the convolutions that an `nn.GELU`
directly follows. Its forward asks `takes` whether K11 runs the call: CUDA
float32 input and weights under the float32 compute policy, a 3x3 kernel
at stride 1, pad 1, no dilation, one group, zero padding, and at least 8
output channels. Everything else (the stride-2 convolutions, the 64 -> 2
head, every CPU tensor) runs `nn.Conv2d`'s own forward and then `F.gelu`, so
the CPU tests see the same numbers as before. With a gradient to take, the
launch goes through `Conv3x3Split`, whose backward is plain PyTorch in
float32.

K11 computes in split precision, as K9 and K10 do: each operand a = hi + lo
with hi = tf32(a) and lo = tf32(a - hi), and lo*hi + hi*lo + hi*hi
accumulated in float32 on the tensor cores. `conv3x3_split_plain` is that
arithmetic in plain PyTorch (three float32 convolutions over the parts, TF32
off), so the tests can hold the split to float32 on the CPU.

K11 reads the module's NCHW input and weights as they are and writes NCHW,
so no copy goes around a launch. Where a small image leaves SMs idle, K11
splits K over blocks (`plan`) into a scratch tensor the wrapper allocates,
and a second kernel of the same launch adds the splits up. Each launch is inside a `kernel.conv3x3`
span and counted by `conv3x3_launches`; inside the encoder's CUDA graphs
there is no span, and each replay counts the launches its graph holds
(`model/encoder/graphs.py`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .. import kernel_build
from ..utils import tracing
from .conv7_kernel import tf32_split

MIN_OUT = 8  # K11 takes at least this many output channels

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    return kernel_build.declare(kernel_build.load("conv3x3"), (
        ("conv3x3", [_P] * 5 + [_I] * 8 + [_P]),
        ("conv3x3_plan", [_I] * 6 + [ctypes.POINTER(_I)] * 2),
    ))


@functools.cache
def _sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.cache
def plan(n: int, c_in: int, h: int, w: int, c_out: int, sms: int) -> tuple[int, int, int]:
    """(output channels a block, blocks of output channels, splits of K) that
    K11 takes for this shape on `sms` SMs (`csrc/conv3x3.cu::conv3x3_plan`)."""
    n_tiles, splits = _I(), _I()
    width = _lib().conv3x3_plan(n, c_in, h, w, c_out, sms, ctypes.byref(n_tiles), ctypes.byref(splits))
    return width, n_tiles.value, splits.value


def launch(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], gelu: bool = False,
           terms: int = 3) -> torch.Tensor:
    """One K11 launch: act(conv3x3(x, weight) + bias), stride 1, pad 1, on
    CUDA float32 NCHW `x`; the GELU where `gelu`. `terms` 1 is the plain
    TF32 product, for tests."""
    if x.device.type != "cuda":
        raise ValueError(f"K11 runs on CUDA tensors, got {x.device}")
    for name, t in (("x", x), ("weight", weight), ("bias", bias)):
        if t is not None and (t.dtype != torch.float32 or t.device != x.device):
            raise ValueError(f"{name} must be float32 on {x.device}, got {t.dtype} on {t.device}")
    if x.dim() != 4:
        raise ValueError(f"K11 takes an (n, c, h, w) input, got {tuple(x.shape)}")
    n, c_in, h, w = x.shape
    c_out = weight.shape[0]
    if tuple(weight.shape) != (c_out, c_in, 3, 3) or (bias is not None and tuple(bias.shape) != (c_out,)):
        raise ValueError(f"K11 takes a ({c_out}, {c_in}, 3, 3) weight and a ({c_out},) bias or none, got "
                         f"{tuple(weight.shape)} and {None if bias is None else tuple(bias.shape)}")
    if c_out < MIN_OUT:
        raise ValueError(f"K11 takes at least {MIN_OUT} output channels, got {c_out}")
    x = x.contiguous()
    wt = weight.detach().contiguous()
    b = None if bias is None else bias.detach().contiguous()
    device = x.get_device()
    sms = _sm_count(device)
    out = torch.empty((n, c_out, h, w), dtype=torch.float32, device=x.device)
    splits = plan(n, c_in, h, w, c_out, sms)[2]
    partial = torch.empty((splits, n, c_out, h, w), dtype=torch.float32, device=x.device) if splits > 1 else None
    with tracing.span("kernel.conv3x3"):
        kernel_build.launch(
            "conv3x3", _lib().conv3x3, device,
            x.data_ptr(), wt.data_ptr(), None if b is None else b.data_ptr(), out.data_ptr(),
            None if partial is None else partial.data_ptr(), n, c_in, h, w, c_out, int(gelu), terms, sms,
        )
    tracing.count_launch("conv3x3_launches")
    return out


def computes(conv: nn.Module) -> bool:
    """Whether `conv` is a convolution K11 computes: 3x3, stride 1, pad 1,
    no dilation, one group, zero padding, at least `MIN_OUT` output
    channels."""
    return (tuple(conv.kernel_size) == (3, 3) and tuple(conv.stride) == (1, 1) and tuple(conv.padding) == (1, 1)
            and tuple(conv.dilation) == (1, 1) and conv.groups == 1 and conv.padding_mode == "zeros"
            and conv.out_channels >= MIN_OUT)


def takes(x: torch.Tensor, conv: nn.Module) -> bool:
    """Whether K11 runs `conv` on `x`: CUDA float32 input and parameters
    under the float32 compute policy, and a convolution K11 `computes`."""
    if x.device.type != "cuda" or x.dtype != torch.float32 or x.dim() != 4 or x.shape[1] != conv.in_channels:
        return False
    if getattr(conv, "compute_dtype", None) not in (None, torch.float32) or conv.weight.dtype != torch.float32:
        return False
    if conv.bias is not None and conv.bias.dtype != torch.float32:
        return False
    return computes(conv)


class Conv3x3Split(torch.autograd.Function):
    """act(conv3x3(x) + bias): K11 forward, plain float32 backward from the
    saved pre-activation."""

    @staticmethod
    def forward(ctx, x, weight, bias, gelu):
        pre = launch(x, weight, bias)
        ctx.gelu = gelu
        ctx.has_bias = bias is not None
        ctx.save_for_backward(x, weight, pre)
        return F.gelu(pre) if gelu else pre

    @staticmethod
    def backward(ctx, grad):
        x, weight, pre = ctx.saved_tensors
        d_pre = torch.ops.aten.gelu_backward(grad, pre) if ctx.gelu else grad
        d_x = torch.nn.grad.conv2d_input(x.shape, weight, d_pre, padding=1)
        d_w = torch.nn.grad.conv2d_weight(x, weight.shape, d_pre, padding=1)
        d_b = d_pre.sum((0, 2, 3)) if ctx.has_bias else None
        return d_x, d_w, d_b, None


class Conv3x3(nn.Conv2d):
    """A 3x3 convolution at pad 1, `nn.Conv2d`'s parameters under its names,
    and with `gelu` the exact GELU after it: K11 where it `takes` the call,
    else `nn.Conv2d`'s own forward."""

    def __init__(self, c_in: int, c_out: int, stride: int = 1, bias: bool = True, gelu: bool = False):
        super().__init__(c_in, c_out, 3, stride, 1, bias=bias)
        self.gelu = gelu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not takes(x, self):
            y = super().forward(x)
            return F.gelu(y) if self.gelu else y
        params = (self.weight,) if self.bias is None else (self.weight, self.bias)
        if torch.is_grad_enabled() and (x.requires_grad or any(p.requires_grad for p in params)):
            return Conv3x3Split.apply(x, self.weight, self.bias, self.gelu)
        return launch(x, self.weight, self.bias, self.gelu)

    def extra_repr(self) -> str:
        return super().extra_repr() + (", gelu=True" if self.gelu else "")


def conv3x3_split_plain(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], gelu: bool = False,
                        terms: int = 3) -> torch.Tensor:
    """K11's arithmetic in plain PyTorch on NCHW `x`: the convolution as
    lo*hi + hi*lo + hi*hi over TF32 parts (`terms` 1: hi*hi alone, plain
    TF32), in float32 with TF32 off, then the bias and the GELU."""
    xh, xl = tf32_split(x)
    wh, wl = tf32_split(weight.detach())
    flags = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        z = F.conv2d(xh, wh, padding=1)
        if terms == 3:
            z = F.conv2d(xl, wh, padding=1) + F.conv2d(xh, wl, padding=1) + z
    finally:
        torch.backends.cudnn.allow_tf32 = flags
    if bias is not None:
        z = z + bias[:, None, None]
    return F.gelu(z) if gelu else z
