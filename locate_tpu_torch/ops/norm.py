"""Stateless normalizations, counterpart of `locate_tpu/ops/norm.py`.

Statistics are float32 whatever the compute dtype: biased variance,
eps 1e-5, and the affine applied in float32 before the cast."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


def effective_groups(channels: int, groups: int) -> int:
    """The group count group_norm actually uses: clipped to `channels` and
    reduced to the nearest divisor."""
    groups_ = min(groups, channels)
    while channels % groups_ != 0:
        groups_ -= 1
    return groups_


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               groups: int, eps: float = 1e-5,
               compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """GroupNorm of an NHWC tensor over (H, W, C//G) per group."""
    cd = compute_dtype or x.dtype
    n, h, w, c = x.shape
    xf = x.float().reshape(n, h, w, groups, c // groups)
    var, mean = torch.var_mean(xf, dim=(1, 2, 4), unbiased=False, keepdim=True)
    xf = ((xf - mean) * torch.rsqrt(var + eps)).reshape(n, h, w, c)
    return (xf * scale + bias).to(cd)


class GroupNorm(nn.Module):
    def __init__(self, channels: int, groups: int = 8, eps: float = 1e-5,
                 compute_dtype: Optional[torch.dtype] = None,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.groups = effective_groups(channels, groups)
        self.eps = eps
        self.compute_dtype = compute_dtype
        self.scale = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm(x, self.scale, self.bias, self.groups, self.eps,
                          self.compute_dtype)


class PixelNorm(nn.Module):
    """Normalize each location to unit RMS over channels (no params)."""

    def __init__(self, eps: float = 1e-8, compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.eps = eps
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype or x.dtype
        xf = x.float()
        ms = (xf * xf).mean(dim=-1, keepdim=True)
        return (xf / torch.sqrt(ms + self.eps)).to(cd)


def make_norm(kind: str, channels: int, groups: int = 8,
              compute_dtype: Optional[torch.dtype] = None,
              device: Optional[torch.device] = None) -> nn.Module:
    if kind == "group":
        return GroupNorm(channels, groups, compute_dtype=compute_dtype, device=device)
    if kind == "pixel":
        return PixelNorm(compute_dtype=compute_dtype)
    if kind == "none":
        return nn.Identity()
    raise ValueError(f"unknown norm {kind!r}")
