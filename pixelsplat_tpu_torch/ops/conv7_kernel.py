"""The epipolar transformer's refinement, `x + conv2(gelu(conv1(x)))` with
two 7x7 convolutions (stride 1, pad 3), on channels-last feature maps: K9's
wrapper (`csrc/conv7.cu`), its plain twin and its gradient.

`refine` decides which version a call runs. CUDA float32 tensors under the
float32 compute policy launch K9 twice, once a convolution, for all views
together: conv1 with its bias and the exact-erf GELU, conv2 with its bias
and the residual, both reading and writing channels-last. CPU tensors take
the plain float32 route the encoder always ran (`F.conv2d` on a
channels-first copy, `nn.GELU`, the residual add), so the CPU tests see the
same numbers as before; the bf16 compute policy keeps `precision.Conv2d`.
With a gradient to take, the launches go through `Conv7Refine`, whose
backward is plain PyTorch in float32: the JAX package has no kernel here.

K9 computes in split precision: each operand a = hi + lo with hi = tf32(a),
lo = tf32(a - hi), and lo*hi + hi*lo + hi*hi accumulated in float32 on the
tensor cores. `conv7_split_plain` is that arithmetic in plain PyTorch
(three float32 convolutions over the parts, TF32 off), so the tests can
hold the split to float32 on the CPU.

Each launch repacks its weights into the order the kernel reads them
(`pack_weight`: K-major, in the tensor cores' fragment order), a 6.4 MB
copy at d_feature 128 that lives as long as the launch. It is not cached:
the encoder's peak memory falls in the epipolar transformer, before the
refinement, where a cached copy of both convolutions' weights raised an
evaluation scene's peak by 11.8 MB on an H100, while the copy costs a few
microseconds a launch; and optimizer updates are seen without a check.
Each launch is inside a `kernel.conv7` span and counted by
`conv7_launches`; inside the encoder's CUDA graphs there is no span, and
each replay counts the launches its graph holds (`model/encoder/graphs.py`).
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

KSIZE = 7
PAD = 3
CHUNK = 16  # K9 takes c_in in multiples of this
BLOCK_M = 64  # and c_out in multiples of this

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    return kernel_build.declare(kernel_build.load("conv7"), (("conv7", [_P] * 6 + [_I] * 7 + [_P]),))


def pack_weight(weight: torch.Tensor) -> torch.Tensor:
    """`weight` (c_out, c_in, 7, 7) in the order K9 reads it as the A operand
    of its tensor-core products: (c_out / 16, c_in / 16, 49, 2, 32, 4),
    (16 output channels, 16 input channels, tap, k8 step, lane 4 g + t,
    fragment register e), register e holding output channel 8 (e % 2) + g
    and input channel 8 step + 4 (e // 2) + t of its block."""
    c_out, c_in = weight.shape[:2]
    w = weight.detach().reshape(c_out // 16, 2, 8, c_in // 16, 2, 2, 4, KSIZE, KSIZE)
    # (ob, e % 2, g, c, step, e // 2, t, ky, kx) -> (ob, c, ky, kx, step, g, t, e // 2, e % 2)
    return w.permute(0, 3, 7, 8, 4, 2, 6, 5, 1).reshape(c_out // 16, c_in // 16, KSIZE * KSIZE, 2, 32, 4).contiguous()


def launch(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, residual: Optional[torch.Tensor] = None,
           gelu: bool = False, pre: bool = False, terms: int = 3) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One K9 launch: act(conv(x, weight) + bias) [+ residual] on
    channels-last CUDA float32 `x` (n, h, w, c_in); returns (out, the
    pre-activation where `pre`, else None). `terms` 1 is the plain TF32
    build, for tests."""
    n, h, w, c_in = x.shape
    c_out = weight.shape[0]
    if x.device.type != "cuda":
        raise ValueError(f"K9 runs on CUDA tensors, got {x.device}")
    for name, t in (("x", x), ("weight", weight), ("bias", bias), ("residual", residual)):
        if t is not None and (t.dtype != torch.float32 or t.device != x.device):
            raise ValueError(f"{name} must be float32 on {x.device}, got {t.dtype} on {t.device}")
    if tuple(weight.shape) != (c_out, c_in, KSIZE, KSIZE) or bias is None or tuple(bias.shape) != (c_out,):
        raise ValueError(f"K9 takes a ({c_out}, {c_in}, 7, 7) weight and a ({c_out},) bias, "
                         f"got {tuple(weight.shape)} and {None if bias is None else tuple(bias.shape)}")
    if c_in % CHUNK or c_out % BLOCK_M:
        raise ValueError(f"K9 takes c_in a multiple of {CHUNK} and c_out of {BLOCK_M}, got {c_in} -> {c_out}")
    if residual is not None and tuple(residual.shape) != (n, h, w, c_out):
        raise ValueError(f"residual must be {(n, h, w, c_out)}, got {tuple(residual.shape)}")
    x = x.contiguous()
    residual = None if residual is None else residual.contiguous()
    if x.data_ptr() % 16:
        raise ValueError("K9 reads x 16 bytes at a time: its data must be 16-byte aligned")
    wp, b = pack_weight(weight), bias.detach().contiguous()
    out = torch.empty((n, h, w, c_out), dtype=torch.float32, device=x.device)
    z = torch.empty_like(out) if pre else None
    with tracing.span("kernel.conv7"):
        kernel_build.launch(
            "conv7", _lib().conv7, x.get_device(),
            x.data_ptr(), wp.data_ptr(), b.data_ptr(), None if residual is None else residual.data_ptr(),
            out.data_ptr(), None if z is None else z.data_ptr(), n, h, w, c_in, c_out, int(gelu), terms,
        )
    tracing.count_launch("conv7_launches")
    return out, z


def _conv_plain(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """A 7x7 convolution of channels-last `x` in plain float32, channels-last out."""
    return F.conv2d(x.permute(0, 3, 1, 2).contiguous(), weight, bias, padding=PAD).permute(0, 2, 3, 1)


def refine_plain(x: torch.Tensor, conv1: nn.Module, conv2: nn.Module) -> torch.Tensor:
    """The refinement through the modules themselves on a channels-first
    copy, so that a compute dtype casts as `precision.Conv2d` does, then the
    residual: the route of CPU tensors and of the bf16 policy."""
    y = conv2(F.gelu(conv1(x.permute(0, 3, 1, 2).contiguous())))
    return x + y.permute(0, 2, 3, 1)


def takes(x: torch.Tensor, conv1: nn.Module, conv2: nn.Module) -> bool:
    """Whether `refine` launches K9: CUDA float32 input and weights under the
    float32 compute policy."""
    if x.device.type != "cuda" or x.dtype != torch.float32:
        return False
    return all(getattr(c, "compute_dtype", None) in (None, torch.float32) and c.weight.dtype == torch.float32
               for c in (conv1, conv2))


def refine(x: torch.Tensor, conv1: nn.Module, conv2: nn.Module) -> torch.Tensor:
    """x + conv2(gelu(conv1(x))) on channels-last `x` (n, h, w, c)."""
    if not takes(x, conv1, conv2):
        return refine_plain(x, conv1, conv2)
    params = (conv1.weight, conv1.bias, conv2.weight, conv2.bias)
    if torch.is_grad_enabled() and (x.requires_grad or any(p.requires_grad for p in params)):
        return Conv7Refine.apply(x, *params)
    hidden, _ = launch(x, conv1.weight, conv1.bias, gelu=True)
    return launch(hidden, conv2.weight, conv2.bias, residual=x)[0]


class Conv7Refine(torch.autograd.Function):
    """x + conv2(gelu(conv1(x))), channels-last: K9 forward on CUDA tensors
    (plain float32 on the CPU), plain float32 backward from conv1's saved
    pre-activation."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        if x.device.type == "cuda":
            hidden, pre = launch(x, w1, b1, gelu=True, pre=True)
            out = launch(hidden, w2, b2, residual=x)[0]
        else:
            pre = _conv_plain(x, w1, b1)
            out = x + _conv_plain(F.gelu(pre), w2, b2)
        ctx.save_for_backward(x, w1, w2, pre)
        return out

    @staticmethod
    def backward(ctx, grad):
        x, w1, w2, pre = ctx.saved_tensors
        grad_cf = grad.permute(0, 3, 1, 2).contiguous()
        pre_cf = pre.permute(0, 3, 1, 2).contiguous()
        hidden_cf = F.gelu(pre_cf)
        d_w2 = torch.nn.grad.conv2d_weight(hidden_cf, w2.shape, grad_cf, padding=PAD)
        d_hidden = torch.nn.grad.conv2d_input(hidden_cf.shape, w2, grad_cf, padding=PAD)
        d_pre = torch.ops.aten.gelu_backward(d_hidden, pre_cf)
        x_cf = x.permute(0, 3, 1, 2).contiguous()
        d_w1 = torch.nn.grad.conv2d_weight(x_cf, w1.shape, d_pre, padding=PAD)
        d_x = grad + torch.nn.grad.conv2d_input(x_cf.shape, w1, d_pre, padding=PAD).permute(0, 2, 3, 1)
        return d_x, d_w1, d_pre.sum((0, 2, 3)), d_w2, grad_cf.sum((0, 2, 3))


def tf32_split(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of float32 `t`: hi rounded to TF32's 10 mantissa bits, to
    nearest with ties away from zero, lo the remainder rounded the same
    way; K9's `split`."""
    def tf32(v):
        return ((v.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)

    hi = tf32(t)
    return hi, tf32(t - hi)


def conv7_split_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                      residual: Optional[torch.Tensor] = None, gelu: bool = False, terms: int = 3) -> torch.Tensor:
    """K9's arithmetic in plain PyTorch on channels-last `x`: the convolution
    as lo*hi + hi*lo + hi*hi over TF32 parts (`terms` 1: hi*hi alone, plain
    TF32), in float32 with TF32 off, then the bias, GELU and residual."""
    xh, xl = tf32_split(x)
    wh, wl = tf32_split(weight)
    flags = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        z = _conv_plain(xh, wh, None)
        if terms == 3:
            z = _conv_plain(xl, wh, None) + _conv_plain(xh, wl, None) + z
    finally:
        torch.backends.cudnn.allow_tf32 = flags
    z = z + bias
    if gelu:
        z = F.gelu(z)
    return z if residual is None else residual + z
