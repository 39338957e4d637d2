"""Parameter initializers, counterpart of `locate_tpu/ops/initializers.py`.

Draws come from an explicit `torch.Generator`, so they differ from JAX's
threefry draws for the same seed; weights carried across come through
`io/export.py` instead. Shapes follow the JAX layouts (HWIO for convs,
[in, out] for dense); callers transpose convs to OIHW."""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch


def he_normal(gen: torch.Generator, shape: Sequence[int],
              fan_in: Optional[int] = None) -> torch.Tensor:
    """Kaiming-normal for weights in HWIO / [in, out] layout
    (fan_in = product of all but the last dim)."""
    if fan_in is None:
        fan_in = math.prod(shape[:-1])
    std = math.sqrt(2.0 / max(1, fan_in))
    return torch.randn(tuple(shape), generator=gen, device=gen.device) * std


def normal(gen: torch.Generator, shape: Sequence[int],
           stddev: float = 0.02) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=gen, device=gen.device) * stddev


def zeros(gen: torch.Generator, shape: Sequence[int]) -> torch.Tensor:
    return torch.zeros(tuple(shape), device=gen.device)
