"""The DINO ViT's linear layers, `epi(x @ weight.T + bias)`: K10's wrapper
(`csrc/linear_split.cu`), its plain twin and its gradient. GS-LRM's encoder
(`model/encoder/encoder_gslrm.py`) runs its blocks, its patch layer and its
head through it too.

`linear` decides which version a call runs. CUDA float32 tensors under the
float32 compute policy launch K10 once for all the views' tokens: `qkv`
with its bias, `fc1` with its bias and the exact-erf GELU, `proj` and `fc2`
with their bias and the block's residual, so the separate GELU and residual
passes go. CPU tensors and the bf16 compute policy call the module itself
(`precision.Linear`), then the GELU and the residual as separate ops, so the
CPU tests see the same numbers as before. With a gradient to take, the
launch goes through `LinearSplit`, whose backward is plain PyTorch in
float32: the JAX package has no kernel here.

K10 computes in split precision, as K9 does (`conv7_kernel`): each operand
a = hi + lo, both TF32, and lo*hi + hi*lo + hi*hi accumulated in float32 on
the tensor cores. For x, hi = tf32(x) and lo = tf32(x - hi), rounded to
nearest; the weight tile serves as its own hi, which the tensor cores read
by dropping its low 13 bits (hi = trunc(w), `weight_split`), and lo =
tf32(w - hi). `linear_split_plain` is that arithmetic in plain PyTorch
(three float32 matrix products over the parts, TF32 off), so the tests can
hold the split to float32 on the CPU; with the parts summed in float64 it
is K10's reference on the card.

A block of K10 computes 128 rows by `tile_n` columns, 128 or 64, chosen from
the output's shape and the card's SM count: the width whose blocks finish
in the fewest rounds over the SMs. Each launch is inside a
`kernel.linear_split` span and counted by `linear_split_launches`, its
2 M K N FLOP by `linear_split_flops.traced` while tracing is on; inside the
encoder's CUDA graphs there is no span, and each replay counts the launches
its graph holds (`model/encoder/graphs.py`). A float32 layer on the card at
a shape K10 does not take runs the plain route and is counted by
`linear_plain_on_card`, which every benchmarked path holds at 0.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .. import kernel_build
from ..utils import tracing
from .conv7_kernel import tf32_split

BLOCK_M = 128  # rows a block
BLOCK_K = 32  # K10 takes K in multiples of this
WIDTHS = (128, 64)  # a block's columns; N a multiple of the one taken
# A 64-wide block's time over a 128-wide one's at the same K, more than half
# since its x operand is split for half the products: 0.62-0.64 a round of
# blocks at the ViT's shapes on an H100.
NARROW_COST = 0.64

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    return kernel_build.declare(kernel_build.load("linear_split"), (("linear_split", [_P] * 6 + [_I] * 6 + [_P]),))


@functools.cache
def _sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def tile_n(m: int, n: int, sms: int) -> int:
    """The columns of K10's block for an (m, n) output on `sms` SMs: of the
    widths that divide n, the one whose rounds of blocks over the SMs take
    the least time, the wider on a tie."""
    rows = math.ceil(m / BLOCK_M)

    def time(width: int) -> float:
        return math.ceil(rows * (n // width) / sms) * (1.0 if width == WIDTHS[0] else NARROW_COST)

    widths = [w for w in WIDTHS if n % w == 0]
    if not widths:
        raise ValueError(f"K10 takes N a multiple of {WIDTHS[-1]}, got {n}")
    return min(widths, key=time)


def launch(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, residual: Optional[torch.Tensor] = None,
           gelu: bool = False, pre: bool = False, terms: int = 3,
           block_n: Optional[int] = None) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One K10 launch: epi(x @ weight.T + bias) on CUDA float32 `x` (..., K),
    the GELU where `gelu`, `residual` (..., N) added where given; returns
    (out (..., N), the pre-activation where `pre`, else None). `terms` 1 is
    the plain TF32 build and `block_n` a forced block width, for tests."""
    n, k = weight.shape if weight.dim() == 2 else (None, None)
    for name, t in (("x", x), ("weight", weight), ("bias", bias), ("residual", residual)):
        if t is not None and (t.dtype != torch.float32 or t.device != x.device):
            raise ValueError(f"{name} must be float32 on {x.device}, got {t.dtype} on {t.device}")
    if n is None or x.shape[-1] != k or bias is None or tuple(bias.shape) != (n,):
        raise ValueError(f"K10 takes an (N, {x.shape[-1]}) weight and an (N,) bias, got {tuple(weight.shape)} and "
                         f"{None if bias is None else tuple(bias.shape)}")
    if k % BLOCK_K or n % WIDTHS[-1]:
        raise ValueError(f"K10 takes K a multiple of {BLOCK_K} and N of {WIDTHS[-1]}, got {k} -> {n}")
    lead = tuple(x.shape[:-1])
    if residual is not None and tuple(residual.shape) != lead + (n,):
        raise ValueError(f"residual must be {lead + (n,)}, got {tuple(residual.shape)}")
    if x.device.type != "cuda":
        raise ValueError(f"K10 runs on CUDA tensors, got {x.device}")
    x = x.contiguous()
    m = x.numel() // k
    w, b = weight.detach().contiguous(), bias.detach().contiguous()
    residual = None if residual is None else residual.contiguous()
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("K10 reads x and the weight by TMA: their data must be 16-byte aligned")
    if b.data_ptr() % 8 or (residual is not None and residual.data_ptr() % 8):
        raise ValueError("K10 reads the bias and the residual 8 bytes at a time: they must be 8-byte aligned")
    device = x.get_device()
    width = block_n or tile_n(m, n, _sm_count(device))
    out = torch.empty(lead + (n,), dtype=torch.float32, device=x.device)
    z = torch.empty_like(out) if pre else None
    with tracing.span("kernel.linear_split"):
        kernel_build.launch(
            "linear_split", _lib().linear_split, device,
            x.data_ptr(), w.data_ptr(), b.data_ptr(), None if residual is None else residual.data_ptr(),
            out.data_ptr(), None if z is None else z.data_ptr(), m, n, k, int(gelu), width, terms,
        )
    tracing.count_launch("linear_split_launches")
    tracing.count_launch("linear_split_flops.traced", 2 * m * n * k)
    return out, z


def linear_plain(module: nn.Module, x: torch.Tensor, residual: Optional[torch.Tensor] = None,
                 gelu: bool = False) -> torch.Tensor:
    """The module itself, so that a compute dtype casts as `precision.Linear`
    does, then the GELU and the residual: the route of CPU tensors and of
    the bf16 policy."""
    y = module(x)
    if gelu:
        y = F.gelu(y)
    return y if residual is None else residual + y


def _float32_on_card(x: torch.Tensor, module: nn.Module) -> bool:
    """CUDA float32 input and parameters under the float32 compute policy."""
    if x.device.type != "cuda" or x.dtype != torch.float32:
        return False
    return (getattr(module, "compute_dtype", None) in (None, torch.float32) and module.weight.dtype == torch.float32
            and module.bias is not None and module.bias.dtype == torch.float32)


def takes(x: torch.Tensor, module: nn.Module) -> bool:
    """Whether `linear` launches K10: a float32 layer on the card at a shape
    K10 takes (K a multiple of `BLOCK_K`, N of the narrower block width)."""
    n, k = module.weight.shape
    return _float32_on_card(x, module) and k % BLOCK_K == 0 and n % WIDTHS[-1] == 0


def linear(module: nn.Module, x: torch.Tensor, residual: Optional[torch.Tensor] = None,
           gelu: bool = False) -> torch.Tensor:
    """residual + gelu(module(x)), each part where asked for."""
    if not takes(x, module):
        if _float32_on_card(x, module):
            tracing.count_launch("linear_plain_on_card")
        return linear_plain(module, x, residual, gelu)
    params = (module.weight, module.bias)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, residual, *params)):
        return LinearSplit.apply(x, *params, residual, gelu)
    return launch(x, *params, residual, gelu)[0]


class LinearSplit(torch.autograd.Function):
    """residual + gelu(x @ weight.T + bias): K10 forward on CUDA tensors
    (plain float32 on the CPU), plain float32 backward, from the saved
    pre-activation where there is a GELU."""

    @staticmethod
    def forward(ctx, x, weight, bias, residual, gelu):
        if x.device.type == "cuda":
            out, pre = launch(x, weight, bias, residual, gelu, pre=gelu)
        else:
            pre = F.linear(x, weight, bias)
            out = F.gelu(pre) if gelu else pre
            out = out if residual is None else residual + out
            pre = pre if gelu else None
        ctx.gelu, ctx.residual = gelu, residual is not None
        ctx.save_for_backward(x, weight, pre)
        return out

    @staticmethod
    def backward(ctx, grad):
        x, weight, pre = ctx.saved_tensors
        d_z = torch.ops.aten.gelu_backward(grad, pre) if ctx.gelu else grad
        d_z2 = d_z.reshape(-1, d_z.shape[-1])
        d_x = d_z @ weight
        d_w = d_z2.T @ x.reshape(-1, x.shape[-1])
        return d_x, d_w, d_z2.sum(0), grad if ctx.residual else None, None


def weight_split(weight: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of the weight as K10 takes them: hi the float32 itself, which
    the tensor cores read as TF32 by dropping its low 13 bits, so trunc(w);
    lo = w - hi rounded to TF32 to nearest."""
    hi = (weight.contiguous().view(torch.int32) & -0x2000).view(torch.float32)
    return hi, tf32_split(weight - hi)[0]


def linear_split_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                       residual: Optional[torch.Tensor] = None, gelu: bool = False, terms: int = 3,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """K10's arithmetic in plain PyTorch: x @ weight.T as lo*hi + hi*lo +
    hi*hi over TF32 parts (`terms` 1: hi*hi alone, plain TF32), in float32
    with TF32 off, then the bias, GELU and residual. `dtype` float64 sums
    the same parts exactly: the card's reference for K10, since at K 4096
    float32's own rounding of the products differs from K10's by 1.2e-6."""
    xh, xl = tf32_split(x)
    wh, wl = weight_split(weight)
    xh, xl, wh, wl, bias = (t.to(dtype) for t in (xh, xl, wh, wl, bias))
    residual = None if residual is None else residual.to(dtype)
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        z = xh @ wh.T
        if terms == 3:
            z = xl @ wh.T + xh @ wl.T + z
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag
    z = z + bias
    if gelu:
        z = F.gelu(z)
    return z if residual is None else residual + z
