"""Convolution & resampling layers, counterpart of `locate_tpu/ops/conv.py`.

Activations keep the JAX package's NHWC layout at every public function,
so tests compare like with like. A convolution views its NHWC input as
NCHW in channels_last memory (a permute, no copy), which is the layout
cuDNN prefers, and permutes its result back. Weights are stored OIHW (the
`F.conv2d` layout; `io/export.py` transposes JAX's HWIO) in float32 and
cast to the compute dtype at apply time, as the JAX layers do.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from locate_tpu_torch.ops import initializers


def conv_nhwc(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SAME-padded stride-1 convolution of an NHWC tensor with an OIHW
    kernel; returns NHWC."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w, padding="same")
    return y.permute(0, 2, 3, 1)


class Conv2d(nn.Module):
    """Plain 2-D convolution, SAME padding, stride 1. Params `w` (OIHW)
    and, with `use_bias`, `b`. The bias is added in the compute dtype
    after the conv, as `locate_tpu/ops/conv.py:56-57` does."""

    def __init__(self, in_ch: int, out_ch: int, kernel: Tuple[int, int] = (3, 3),
                 use_bias: bool = True,
                 weight_init: Callable = initializers.he_normal,
                 compute_dtype: Optional[torch.dtype] = None,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        w = weight_init(gen, (*kernel, in_ch, out_ch))      # HWIO draw
        self.w = nn.Parameter(w.permute(3, 2, 0, 1).contiguous())
        self.b = nn.Parameter(initializers.zeros(gen, (out_ch,))) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype or x.dtype
        y = conv_nhwc(x.to(cd), self.w.to(cd))
        if self.b is not None:
            y = y + self.b.to(cd)
        return y


class FactorizedConv2d(nn.Module):
    """Factorized k*k conv as a bias-free (1,k) conv then a biased (k,1)
    conv, linear between the halves (`locate_tpu/ops/conv.py:63-85`)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 use_bias: bool = True, compute_dtype: Optional[torch.dtype] = None,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.row = Conv2d(in_ch, out_ch, (1, kernel_size), use_bias=False,
                          compute_dtype=compute_dtype, gen=gen)
        self.col = Conv2d(out_ch, out_ch, (kernel_size, 1), use_bias=use_bias,
                          compute_dtype=compute_dtype, gen=gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.col(self.row(x))


class Dense(nn.Module):
    """Fully-connected layer on the trailing axis; `w` is [in, out] and
    consumed as x @ w + b (the JAX convention, kept for weight transfer)."""

    def __init__(self, in_dim: int, out_dim: int, use_bias: bool = True,
                 weight_init: Callable = initializers.he_normal,
                 compute_dtype: Optional[torch.dtype] = None,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.w = nn.Parameter(weight_init(gen, (in_dim, out_dim)))
        self.b = nn.Parameter(initializers.zeros(gen, (out_dim,))) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype or x.dtype
        y = x.to(cd) @ self.w.to(cd)
        if self.b is not None:
            y = y + self.b.to(cd)
        return y


def upsample_nearest(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Nearest-neighbour upsample of an NHWC tensor."""
    n, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(n, h, factor, w, factor, c)
    return x.reshape(n, h * factor, w * factor, c)


class UpsampleNearest(nn.Module):
    def __init__(self, factor: int = 2):
        super().__init__()
        self.factor = factor

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return upsample_nearest(x, self.factor)


def downsample_avg(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Average-pool downsample of an NHWC tensor by reshape-mean; the mean
    sums and divides in f32 and rounds to x's dtype, as `jnp.mean` does."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // factor, factor, w // factor, factor, c)
    return x.float().mean(dim=(2, 4)).to(x.dtype)


class DownsampleAvg(nn.Module):
    def __init__(self, factor: int = 2):
        super().__init__()
        self.factor = factor

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return downsample_avg(x, self.factor)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N, C): the spatial mean, in f32 rounded to x's dtype."""
    return x.float().mean(dim=(1, 2)).to(x.dtype)


class GlobalAvgPool(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return global_avg_pool(x)
