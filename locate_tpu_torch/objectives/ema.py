"""EMA shadow of the generator's parameters, counterpart of
`locate_tpu/objectives/ema.py`: one flat buffer in `train.ema_dtype`.

float32 accumulates plainly. bfloat16 halves the shadow's memory: the f32
update is rounded to bf16 stochastically (unbiased; a deterministic
rounding would stall once (1 - d)(p - e) drops under half an ulp), with
16 random bits an element, drawn by the step (`ema_bits`) or given by the
caller, which is how tests feed the JAX package's bits.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch

from locate_tpu_torch.objectives.optim import device_scalar

_BF16_MAX_ROUNDABLE = 3.3895e38  # f32's top binade: the bit add would carry out


def ema_init(params: torch.Tensor, dtype: str = "float32") -> torch.Tensor:
    """A copy of `params` in `dtype` (never an alias: a shadow sharing the
    buffer would track the live parameters exactly)."""
    if dtype not in ("float32", "bfloat16"):
        raise ValueError(f"unknown train.ema_dtype {dtype!r}")
    return params.detach().to(getattr(torch, dtype), copy=True)


def ema_bits(gen: torch.Generator, numel: int) -> torch.Tensor:
    """Random bits U[0, 2^16) for one stochastic rounding of `numel`
    elements, int32, from `gen`."""
    return torch.randint(0, 1 << 16, (numel,), generator=gen, device=gen.device,
                         dtype=torch.int32)


def stochastic_round_bf16(x: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """f32 -> bf16, rounding up with probability equal to the dropped
    fraction: add `bits` (U[0, 2^16), one an element) to the f32 bit
    pattern and drop its low 16 bits (the carry reaches the exponent at a
    binade's edge, as it should). Non-finite values and f32's top binade,
    where the carry would leave the exponent field, take a plain cast, a
    NaN the quiet NaN 0x7FC0 with its sign (XLA's cast; PyTorch's
    vectorized cast writes 0xFFFF)."""
    assert x.dtype == torch.float32
    u = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    r = (u + (bits.to(torch.int64) & 0xFFFF)) & 0xFFFF0000
    r = torch.where(r >= 1 << 31, r - (1 << 32), r).to(torch.int32)
    sr = r.view(torch.float32).to(torch.bfloat16)
    keep = torch.isfinite(x) & (x.abs() < _BF16_MAX_ROUNDABLE)
    out = torch.where(keep, sr, x.to(torch.bfloat16))
    nan = ((u >> 16) & 0x8000) | 0x7FC0
    nan = torch.where(nan >= 1 << 15, nan - (1 << 16), nan).to(torch.int16)
    return torch.where(torch.isnan(x), nan.view(torch.bfloat16), out)


def ema_update(ema: torch.Tensor, params: torch.Tensor,
               decay: Union[float, torch.Tensor],
               bits: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ema * d + params * (1 - d), in f32 with d rounded to f32 first, as
    the JAX update computes it (not `torch.lerp`, which rounds otherwise);
    a bf16 shadow's result is rounded back by `stochastic_round_bf16` with
    `bits`. Returns a new tensor in the shadow's dtype. A float decay
    becomes a device tensor once (`device_scalar`), so an update copies
    nothing from the host."""
    if isinstance(decay, torch.Tensor):
        d = decay.to(device=ema.device, dtype=torch.float32)
    else:
        d = device_scalar(float(decay), str(ema.device))
    new = ema.float() * d + params.float() * (1.0 - d)
    if ema.dtype == torch.bfloat16:
        if bits is None:
            raise ValueError("a bfloat16 EMA needs random bits for its stochastic rounding")
        return stochastic_round_bf16(new, bits)
    return new


def rampup_decay(step: torch.Tensor, ema_decay: float, rampup: float) -> torch.Tensor:
    """StyleGAN2-ADA's ema_rampup as a per-step decay: the half-life is
    min(target, (step + 1) * rampup), the target ema_decay's; `step` a
    device tensor (the step count before this step), the decay an f32
    device tensor (`locate_tpu/train/step.py:507-518`)."""
    hl_target = math.log(0.5) / math.log(ema_decay)
    hl = torch.clamp((step.float() + 1.0) * rampup, max=hl_target)
    return torch.exp2(-1.0 / hl)
