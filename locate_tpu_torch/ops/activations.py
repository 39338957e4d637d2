"""Activation functions, counterpart of `locate_tpu/ops/activations.py`."""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn


def act_fn(kind: str, leaky_slope: float = 0.2) -> Callable[[torch.Tensor], torch.Tensor]:
    """The raw elementwise function. `jax.nn.leaky_relu` is
    where(x >= 0, x, slope*x) and `jax.nn.gelu` defaults to the tanh
    approximation; both are mirrored exactly."""
    if kind == "leaky_relu":
        return lambda x: torch.where(x >= 0, x, x * leaky_slope)
    if kind == "relu":
        return F.relu
    if kind == "silu":
        return F.silu
    if kind == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    if kind == "tanh":
        return torch.tanh
    if kind == "none":
        return lambda x: x
    raise ValueError(f"unknown activation {kind!r}")


class Act(nn.Module):
    """Parameter-free activation layer (holds no state_dict entries, as
    the JAX layer holds an empty params tuple)."""

    def __init__(self, kind: str, leaky_slope: float = 0.2):
        super().__init__()
        self.kind = kind
        self.fn = act_fn(kind, leaky_slope)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(x)

    def extra_repr(self) -> str:
        return self.kind
