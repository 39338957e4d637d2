"""EMA shadow of the generator's parameters, counterpart of
`locate_tpu/objectives/ema.py`, in float32. The bfloat16 shadow with
stochastic rounding is not ported yet (ROADMAP.md Queue 1 item 11)."""

from __future__ import annotations

from typing import Union

import torch

from locate_tpu_torch.objectives.optim import device_scalar


def ema_init(params: torch.Tensor, dtype: str = "float32") -> torch.Tensor:
    """A copy of `params` (never an alias: a shadow sharing the buffer
    would track the live parameters exactly)."""
    if dtype != "float32":
        raise NotImplementedError(
            f"train.ema_dtype={dtype!r} (stochastic bf16 rounding) is not ported "
            "yet (ROADMAP.md Queue 1 item 11)")
    return params.detach().float().clone()


def ema_update(ema: torch.Tensor, params: torch.Tensor,
               decay: Union[float, torch.Tensor]) -> torch.Tensor:
    """ema * d + params * (1 - d), in f32 with d rounded to f32 first, as
    the JAX update computes it (not `torch.lerp`, which rounds otherwise).
    Returns a new tensor. A float decay becomes a device tensor once
    (`device_scalar`), so an update copies nothing from the host."""
    if isinstance(decay, torch.Tensor):
        d = decay.to(device=ema.device, dtype=torch.float32)
    else:
        d = device_scalar(float(decay), str(ema.device))
    return ema.float() * d + params.float() * (1.0 - d)
