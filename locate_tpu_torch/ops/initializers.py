"""Parameter initializers, counterpart of `locate_tpu/ops/initializers.py`.

Draws come from an explicit `torch.Generator`, so they differ from JAX's
threefry draws for the same seed; weights carried across come through
`io/export.py` instead. Shapes follow the JAX layouts (HWIO for convs,
[in, out] for dense); callers transpose convs to OIHW."""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch


def device_of(gen: Optional[torch.Generator]) -> Optional[torch.device]:
    """The generator's device; with no generator, torch's default one (CPU)."""
    return None if gen is None else gen.device


def he_normal(gen: Optional[torch.Generator], shape: Sequence[int],
              fan_in: Optional[int] = None) -> torch.Tensor:
    """Kaiming-normal for weights in HWIO / [in, out] layout
    (fan_in = product of all but the last dim)."""
    if fan_in is None:
        fan_in = math.prod(shape[:-1])
    std = math.sqrt(2.0 / max(1, fan_in))
    return torch.randn(tuple(shape), generator=gen, device=device_of(gen)) * std


def normal(gen: Optional[torch.Generator], shape: Sequence[int],
           stddev: float = 0.02) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=gen, device=device_of(gen)) * stddev


def zeros(gen: Optional[torch.Generator], shape: Sequence[int]) -> torch.Tensor:
    return torch.zeros(tuple(shape), device=device_of(gen))
