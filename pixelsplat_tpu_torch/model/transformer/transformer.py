"""Generic pre-norm transformer stack.

Port of `pixelsplat_tpu/model/transformer/transformer.py`: LayerNorm
pre-norm residual blocks of multi-head attention (self, or cross through
a separate kv input) and a pluggable feed-forward module. Parameter names
are the reference's (`layers.N.0.norm`, `layers.N.0.fn.to_q` ...,
`layers.N.1.fn.net.0`), which `interop/from_jax.py` fills.

Cross attention keeps the JAX package's reassociation: logits =
(q Wk^T) z^T and out = (attn z) Wv, so k and v are never formed. With one
query per pixel against 32 samples of 128 channels that is a few MB where
`to_kv(z)` would be 1 GiB at full width, and it is the JAX side's own
summation order.

`dtype` is the compute policy (`model/precision.py`): the projections and
the attention products run in it, the softmax in f32, the LayerNorms give
f32, and each block's output is cast back to its input's dtype, at the
JAX module's cast points.

`Attention.capture`, a list when set (None by default), receives each
attention map (b, heads, queries, keys) after the softmax and the cast to
the compute dtype: what the JAX `Attention` sows into `intermediates`.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from .. import precision


class Attention(nn.Module):
    """Multi-head attention; self-attention if `z` is None, else cross."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64, selfatt: bool = True,
                 kv_dim: Optional[int] = None, dtype: Optional[torch.dtype] = None):
        super().__init__()
        inner = dim_head * heads
        self.heads = heads
        self.dim_head = dim_head
        self.scale = dim_head**-0.5
        self.dtype = dtype
        self.capture: Optional[list] = None
        if selfatt:
            self.to_qkv = precision.Linear(dim, inner * 3, bias=False, compute_dtype=dtype)
        else:
            self.to_q = precision.Linear(dim, inner, bias=False, compute_dtype=dtype)
            self.to_kv = nn.Linear(dim if kv_dim is None else kv_dim, inner * 2, bias=False)
        project_out = not (heads == 1 and dim_head == dim)
        self.to_out = (
            nn.Sequential(precision.Linear(inner, dim, compute_dtype=dtype)) if project_out else nn.Identity()
        )

    def _split_heads(self, t: torch.Tensor) -> torch.Tensor:
        b, n, _ = t.shape
        return t.reshape(b, n, self.heads, self.dim_head).transpose(1, 2)

    def forward(self, x: torch.Tensor, z: Optional[torch.Tensor] = None) -> torch.Tensor:
        inner = self.dim_head * self.heads

        def softmax(logits):  # in f32, then in the compute dtype
            attn = torch.softmax(logits.float(), dim=-1)
            attn = attn if self.dtype is None else attn.to(self.dtype)
            if self.capture is not None:
                self.capture.append(attn)
            return attn

        if z is None:
            q, k, v = (self._split_heads(t) for t in self.to_qkv(x).chunk(3, dim=-1))
            logits = (q @ k.transpose(-1, -2)) * self.scale
            out = softmax(logits) @ v
        else:
            q = self._split_heads(self.to_q(x))
            kv_dim = z.shape[-1]
            weight = self.to_kv.weight  # (2 * inner, kv_dim)
            if self.dtype is not None:
                weight, z = weight.to(self.dtype), z.to(self.dtype)
            wk = weight[:inner].reshape(self.heads, self.dim_head, kv_dim)
            wv = weight[inner:].reshape(self.heads, self.dim_head, kv_dim)
            q_proj = torch.einsum("bhid,hdc->bhic", q, wk)  # (b, h, nq, kv_dim)
            logits = torch.einsum("bhic,bjc->bhij", q_proj, z) * self.scale
            ctx = torch.einsum("bhij,bjc->bhic", softmax(logits), z)
            out = torch.einsum("bhic,hdc->bhid", ctx, wv)
        b, _, n, _ = out.shape
        return self.to_out(out.transpose(1, 2).reshape(b, n, inner)).to(x.dtype)


class FeedForward(nn.Module):
    def __init__(self, dim: int, hidden_dim: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        # Indices 0 and 3, as in the reference's Linear, GELU, Dropout, Linear.
        self.net = nn.Sequential(
            precision.Linear(dim, hidden_dim, compute_dtype=dtype), nn.GELU(), nn.Identity(),
            precision.Linear(hidden_dim, dim, compute_dtype=dtype),
        )

    def forward(self, x: torch.Tensor, **_) -> torch.Tensor:
        return self.net(x).to(x.dtype)


class PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm = precision.LayerNorm(dim, eps=1e-5)
        self.fn = fn

    def forward(self, x: torch.Tensor, **kwargs) -> torch.Tensor:
        return self.fn(self.norm(x), **kwargs)


class Transformer(nn.Module):
    """depth x (pre-norm attention + pre-norm feed-forward), both residual.

    `feed_forward_factory(dim, mlp_dim) -> nn.Module`; the feed-forward's
    forward receives **ff_kwargs (the image-self-attention feed-forward
    takes the image's shape that way).
    """

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int, mlp_dim: int,
                 selfatt: bool = True, kv_dim: Optional[int] = None,
                 feed_forward_factory: Optional[Callable[[int, int], nn.Module]] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        factory = feed_forward_factory or (lambda d, m: FeedForward(d, m, dtype=dtype))
        self.layers = nn.ModuleList(
            nn.ModuleList([
                PreNorm(dim, Attention(dim, heads=heads, dim_head=dim_head, selfatt=selfatt, kv_dim=kv_dim,
                                       dtype=dtype)),
                PreNorm(dim, factory(dim, mlp_dim)),
            ])
            for _ in range(depth)
        )

    def forward(self, x: torch.Tensor, z: Optional[torch.Tensor] = None, **ff_kwargs) -> torch.Tensor:
        for attn, ff in self.layers:
            x = attn(x, z=z) + x
            x = ff(x, **ff_kwargs) + x
        return x
