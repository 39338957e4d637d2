"""Optimizers, counterpart of `locate_tpu/objectives/optim.py`.

The JAX package chains, per network,

    skip_if_too_large(apply_if_finite(chain(clip_by_global_norm, adam)))

The port keeps that nesting over one flat f32 vector of a network's
parameters (`train/state.py:FlatParams`): `Optimizer.update(grads, state)`
returns the update to add and the new state, with optax's arithmetic

    mu = (1 - b1) g + b1 mu          nu = (1 - b2) g^2 + b2 nu
    u  = -lr * (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)

Both guards decide on the card, as `jnp.where` does in JAX: a skipped
update is zero and leaves Adam's moments and count untouched, and nothing
waits for the host. The non-finite guard counts its consecutive skips; the
size guard, outside it, reads the safe norm of the raw gradient and counts
its skips in total and in a row.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict

import torch

from locate_tpu_torch.config import OptimConfig, TrainConfig

# apply_if_finite's max_consecutive_errors: effectively never give up
# (`make_optimizer`); the train loop aborts on the streak instead
_MAX_CONSECUTIVE_ERRORS = 10**9
_INT32_MAX = 2**31 - 1


def safe_global_norm(grads: torch.Tensor) -> torch.Tensor:
    """Overflow-proof L2 norm in f32: every element is divided by the
    largest magnitude first, so the sum of squares is at most the element
    count. A non-finite element gives a non-finite norm."""
    g = grads.float()
    if g.numel() == 0:
        return torch.zeros((), device=g.device)
    scale = g.abs().amax().clamp_min(torch.finfo(torch.float32).tiny)
    return scale * (g / scale).square().sum().sqrt()


@functools.lru_cache(maxsize=None)
def device_scalar(value: float, device: str) -> torch.Tensor:
    """`value` as an f32 0-d tensor on `device`, made once: a step that
    reuses it copies nothing from the host (which a captured CUDA graph
    refuses, and which would stall an eager step)."""
    return torch.tensor(value, dtype=torch.float32, device=device)


def _safe_increment(count: torch.Tensor) -> torch.Tensor:
    """count + 1, held at the int32 maximum (optax's safe_increment)."""
    return torch.where(count < _INT32_MAX, count + 1, count)


@dataclasses.dataclass
class OptState:
    """optax's ScaleByAdamState, ApplyIfFiniteState and SkipLargeState in
    one record; every field is a tensor on the parameters' device."""

    count: torch.Tensor             # int32, Adam steps taken
    mu: torch.Tensor                # f32, flat first moment
    nu: torch.Tensor                # f32, flat second moment
    notfinite_count: torch.Tensor   # int32, consecutive non-finite skips
    last_finite: torch.Tensor       # bool
    total_notfinite: torch.Tensor   # int32
    toolarge_count: torch.Tensor    # int32, updates skipped for size
    toolarge_streak: torch.Tensor   # int32, consecutive such skips
    grad_norm: torch.Tensor         # f32, the size guard's last reading

    def copy_(self, other: "OptState") -> "OptState":
        """Write `other`'s values into this state's own tensors, which keep
        their addresses (a captured step reads and writes them there)."""
        for f in dataclasses.fields(self):
            mine, theirs = getattr(self, f.name), getattr(other, f.name)
            if mine is not theirs:
                mine.copy_(theirs)
        return self

    def inner_fields(self):
        """The fields inside skip_if_too_large (what a size skip leaves)."""
        return ("count", "mu", "nu", "notfinite_count", "last_finite",
                "total_notfinite")


class Optimizer:
    """`make_optimizer`: Adam with optional global-norm clip, non-finite
    skip (`max_nonfinite_skips > 0`) and size skip (`grad_norm_limit > 0`),
    on a constant learning rate."""

    def __init__(self, ocfg: OptimConfig, max_nonfinite_skips: int = 0,
                 grad_norm_limit: float = 0.0, lr_schedule: str = "constant"):
        if lr_schedule != "constant":
            raise NotImplementedError(
                f"train.lr_schedule={lr_schedule!r} is not ported yet "
                "(ROADMAP.md Queue 1 item 11); the port runs 'constant'")
        self.cfg = ocfg
        self.guard_finite = max_nonfinite_skips > 0
        self.grad_norm_limit = grad_norm_limit

    def init(self, params: torch.Tensor) -> OptState:
        def i32():
            return torch.zeros((), dtype=torch.int32, device=params.device)

        return OptState(
            count=i32(), mu=torch.zeros_like(params), nu=torch.zeros_like(params),
            notfinite_count=i32(),
            last_finite=torch.ones((), dtype=torch.bool, device=params.device),
            total_notfinite=i32(), toolarge_count=i32(), toolarge_streak=i32(),
            grad_norm=torch.zeros((), device=params.device))

    def _adam(self, g: torch.Tensor, s: OptState):
        c = self.cfg
        if c.clip_grad_norm > 0:
            norm = g.square().sum().sqrt()  # optax.global_norm
            g = torch.where(norm < c.clip_grad_norm, g, g / norm * c.clip_grad_norm)
        mu = (1 - c.beta1) * g + c.beta1 * s.mu
        nu = (1 - c.beta2) * g.square() + c.beta2 * s.nu
        count = _safe_increment(s.count)
        t = count.float()
        b1 = device_scalar(c.beta1, str(g.device))
        b2 = device_scalar(c.beta2, str(g.device))
        mu_hat = mu / (1 - b1 ** t)
        nu_hat = nu / (1 - b2 ** t)
        updates = mu_hat / (nu_hat.sqrt() + c.eps) * -c.lr
        return updates, dict(count=count, mu=mu, nu=nu)

    def update(self, grads: torch.Tensor, state: OptState):
        """(updates, new state) for the flat f32 gradient `grads`."""
        new = dataclasses.replace(state)
        if self.grad_norm_limit > 0:
            norm = safe_global_norm(grads)
            too_large = torch.isfinite(norm) & (norm > self.grad_norm_limit)
        updates, adam = self._adam(grads, state)
        if self.guard_finite:
            finite = torch.isfinite(grads).all()
            notfinite = torch.where(finite, torch.zeros_like(state.notfinite_count),
                                    _safe_increment(state.notfinite_count))
            apply = finite | (notfinite > _MAX_CONSECUTIVE_ERRORS)
            updates = torch.where(apply, updates, torch.zeros_like(updates))
            adam = {k: torch.where(apply, v, getattr(state, k)) for k, v in adam.items()}
            adam.update(
                notfinite_count=notfinite, last_finite=finite,
                total_notfinite=torch.where(finite, state.total_notfinite,
                                            _safe_increment(state.total_notfinite)))
        for k, v in adam.items():
            setattr(new, k, v)
        if self.grad_norm_limit > 0:
            updates = torch.where(too_large, torch.zeros_like(updates), updates)
            for k in state.inner_fields():
                setattr(new, k, torch.where(too_large, getattr(state, k), getattr(new, k)))
            new.toolarge_count = state.toolarge_count + too_large.int()
            new.toolarge_streak = torch.where(too_large, state.toolarge_streak + 1,
                                              torch.zeros_like(state.toolarge_streak))
            new.grad_norm = norm
        return updates, new


def make_optimizers(tcfg: TrainConfig):
    """The (G, D) optimizer pair."""
    if tcfg.grad_accum > 1:
        raise NotImplementedError(
            "train.grad_accum > 1 (optax.MultiSteps) is not ported yet "
            "(ROADMAP.md Queue 1 item 11)")
    return tuple(Optimizer(o, tcfg.max_nonfinite_skips, tcfg.grad_norm_limit,
                           tcfg.lr_schedule) for o in (tcfg.g_opt, tcfg.d_opt))


def guard_stats(state: OptState, tcfg: TrainConfig) -> Dict[str, torch.Tensor]:
    """The update guards' counters, only those whose guard is on:
    nonfinite_streak, grad_limit_count, grad_limit_streak and the size
    guard's own norm reading grad_norm_guard."""
    out = {}
    if tcfg.grad_norm_limit > 0.0:
        out["grad_limit_count"] = state.toolarge_count
        out["grad_limit_streak"] = state.toolarge_streak
        out["grad_norm_guard"] = state.grad_norm
    if tcfg.max_nonfinite_skips > 0:
        out["nonfinite_streak"] = state.notfinite_count
    return out
