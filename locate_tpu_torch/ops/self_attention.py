"""Full spatial self-attention block (`attention.kind="self"`), counterpart
of `locate_tpu/ops/self_attention.py` (SAGAN, arXiv 1805.08318):

    q = conv1x1(x) : C -> dk        (dk = C / sa_qk_bottleneck)
    k = conv1x1(x) : C -> dk
    v = conv1x1(x) : C -> dv        (dv = C / sa_v_bottleneck)
    a = softmax_s(q_t . k_s * scale)            [scale = 1/sqrt(dk/heads)]
    o = conv1x1(a @ v) : dv -> C
    y = x + gamma * o               (gamma a zero-init scalar: the block is
                                     the identity at init)

The attention itself runs as the plain composition `attention_reference`,
which holds the (T, T) matrix in memory, or, under `use_pallas`, as
`flash_attention` (`ops/flash_attention.py`), whose kernels never do: the
reason for the kernel is memory, so with `use_pallas` a CUDA tensor always
goes to it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from locate_tpu_torch.config import AttentionConfig
from locate_tpu_torch.ops import initializers
from locate_tpu_torch.ops.conv import Conv2d
from locate_tpu_torch.ops.flash_attention import attention_reference, flash_attention


def _head_dims(channels: int, cfg: AttentionConfig) -> Tuple[int, int]:
    """(dk, dv), each >= heads, rounded up to a multiple of 8 * heads."""
    unit = 8 * cfg.heads
    dk = max(unit, channels // cfg.sa_qk_bottleneck)
    dv = max(unit, channels // cfg.sa_v_bottleneck)
    dk = ((dk + unit - 1) // unit) * unit
    dv = ((dv + unit - 1) // unit) * unit
    return dk, dv


def _split_heads(x2d: torch.Tensor, heads: int) -> torch.Tensor:
    """(N, T, D) -> (N*heads, T, D/heads)."""
    if heads == 1:
        return x2d
    n, t, d = x2d.shape
    x = x2d.reshape(n, t, heads, d // heads)
    return x.permute(0, 2, 1, 3).reshape(n * heads, t, d // heads)


def _merge_heads(x2d: torch.Tensor, heads: int) -> torch.Tensor:
    """(N*heads, T, Dh) -> (N, T, Dh*heads)."""
    if heads == 1:
        return x2d
    nh, t, dh = x2d.shape
    x = x2d.reshape(nh // heads, heads, t, dh)
    return x.permute(0, 2, 1, 3).reshape(nh // heads, t, heads * dh)


class SelfAttention(nn.Module):
    """SAGAN-style self-attention block for NHWC maps of `channels`. Params
    `q.{w,b}`, `k.{w,b}`, `v.{w,b}`, `o.{w,b}` (1x1 convs, OIHW) and the 0-d
    f32 `gamma`, the JAX pytree's names."""

    def __init__(self, channels: int, cfg: AttentionConfig,
                 compute_dtype: Optional[torch.dtype] = None, use_pallas: bool = False,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.heads = cfg.heads
        self.dk, self.dv = _head_dims(channels, cfg)
        self.compute_dtype = compute_dtype
        self.use_pallas = use_pallas
        self.scale = (self.dk // cfg.heads) ** -0.5 if cfg.sa_scale else 1.0
        kw = dict(compute_dtype=compute_dtype, gen=gen)
        self.q = Conv2d(channels, self.dk, (1, 1), **kw)
        self.k = Conv2d(channels, self.dk, (1, 1), **kw)
        self.v = Conv2d(channels, self.dv, (1, 1), **kw)
        self.o = Conv2d(self.dv, channels, (1, 1), **kw)
        self.gamma = nn.Parameter(initializers.zeros(gen, ()))

    def attend(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        if self.use_pallas:
            return flash_attention(q, k, v, scale=self.scale)
        return attention_reference(q, k, v, scale=self.scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, h, w, _ = x.shape
        t = h * w
        xc = x.to(self.compute_dtype or x.dtype)
        q = _split_heads(self.q(xc).reshape(n, t, self.dk), self.heads)
        k = _split_heads(self.k(xc).reshape(n, t, self.dk), self.heads)
        v = _split_heads(self.v(xc).reshape(n, t, self.dv), self.heads)
        o2 = _merge_heads(self.attend(q, k, v), self.heads).reshape(n, h, w, self.dv)
        o = self.o(o2)
        return (x.float() + self.gamma.float() * o.float()).to(x.dtype)
