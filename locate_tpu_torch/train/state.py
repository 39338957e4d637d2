"""Train state, counterpart of `locate_tpu/train/state.py`: the step count,
the random generator of the step's draws, both networks' parameters, both
optimizer states and the EMA shadow.

Each network's parameters live in one contiguous f32 buffer
(`FlatParams`): the module's parameters are views of it, so the optimizer
and the EMA update a network with a few whole-buffer operations, in
place, and the module sees the new values. Optimizer moments and the EMA
shadow are flat buffers of the same layout; `FlatParams.named` views one
under the JAX dotted names.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from locate_tpu_torch.config import Config
from locate_tpu_torch.io.export import flatten_tree, params_from_jax
from locate_tpu_torch.models.gan import GAN
from locate_tpu_torch.objectives.ema import ema_init
from locate_tpu_torch.objectives.optim import OptState, make_optimizers


class FlatParams:
    """`module`'s parameters moved into one f32 buffer `flat`; each
    parameter becomes a view of it (same object, same requires_grad)."""

    def __init__(self, module: nn.Module):
        named = list(module.named_parameters())
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.flat = torch.cat([p.detach().float().reshape(-1) for p in self.params])
        for p, view in zip(self.params, self.split(self.flat)):
            p.data = view

    def split(self, vec: torch.Tensor) -> List[torch.Tensor]:
        """Views of a flat vector, one per parameter, in its shape."""
        return [v.view(p.shape) for v, p in
                zip(vec.split([p.numel() for p in self.params]), self.params)]

    def named(self, vec: torch.Tensor) -> Dict[str, torch.Tensor]:
        return dict(zip(self.names, self.split(vec)))

    def flatten(self, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        """One f32 vector of per-parameter tensors (gradients), in order."""
        return torch.cat([t.float().reshape(-1) for t in tensors])

    def from_named(self, tensors: Mapping[str, Any]) -> torch.Tensor:
        """One f32 vector of a name -> array mapping, in the buffer's order."""
        dev = self.flat.device
        return self.flatten([torch.as_tensor(tensors[n]).to(dev) for n in self.names])


@dataclasses.dataclass
class TrainState:
    step: int                     # optimizer steps taken (host integer)
    rng: torch.Generator          # the step's latent and label draws
    g_params: FlatParams          # of gan.generator
    d_params: FlatParams          # of gan.discriminator
    g_opt_state: OptState
    d_opt_state: OptState
    ema_params: Optional[torch.Tensor]  # flat f32 EMA of g_params.flat, or None


def state_tensors(state: TrainState) -> Dict[str, torch.Tensor]:
    """Every tensor the step updates in place, by name: both networks' flat
    parameters, both optimizer states' fields and the EMA shadow."""
    out = {"g_params": state.g_params.flat, "d_params": state.d_params.flat}
    for net, opt in (("g", state.g_opt_state), ("d", state.d_opt_state)):
        for f in dataclasses.fields(opt):
            out[f"{net}_opt.{f.name}"] = getattr(opt, f.name)
    if state.ema_params is not None:
        out["ema_params"] = state.ema_params
    return out


@dataclasses.dataclass
class Snapshot:
    """A copy of a state's values: its tensors, step and generator state."""
    tensors: Dict[str, torch.Tensor]
    step: int
    rng: torch.Tensor


def snapshot(state: TrainState) -> Snapshot:
    return Snapshot({k: t.clone() for k, t in state_tensors(state).items()}, state.step,
                    state.rng.get_state())


def restore(state: TrainState, snap: Snapshot) -> TrainState:
    """Put a snapshot's values back into the state's own tensors (which
    keep their addresses), its step and its generator."""
    with torch.no_grad():
        for k, t in state_tensors(state).items():
            t.copy_(snap.tensors[k])
    state.step = snap.step
    state.rng.set_state(snap.rng)
    return state


def create_train_state(cfg: Config, gan: GAN, seed: int = 0) -> TrainState:
    """The state of a fresh run of `gan`, whose modules hold their initial
    weights; `seed` seeds the step's random generator."""
    g_opt, d_opt = make_optimizers(cfg.train)
    g_params, d_params = FlatParams(gan.generator), FlatParams(gan.discriminator)
    rng = torch.Generator(device=gan.device)
    rng.manual_seed(seed)
    ema = (ema_init(g_params.flat, cfg.train.ema_dtype)
           if cfg.train.ema_decay > 0 else None)
    return TrainState(step=0, rng=rng, g_params=g_params, d_params=d_params,
                      g_opt_state=g_opt.init(g_params.flat),
                      d_opt_state=d_opt.init(d_params.flat), ema_params=ema)


def _find(tree: Any, field: str) -> Any:
    """The first field named `field` of the named tuples nested in an optax
    state (ScaleByAdamState, ApplyIfFiniteState, SkipLargeState), or None."""
    if hasattr(tree, "_fields"):
        if field in tree._fields:
            return getattr(tree, field)
        children = [getattr(tree, f) for f in tree._fields]
    elif isinstance(tree, (list, tuple)):
        children = tree
    else:
        return None
    for child in children:
        found = _find(child, field)
        if found is not None:
            return found
    return None


def _opt_state_from_jax(jax_opt: Any, params: FlatParams, fresh: OptState) -> OptState:
    def moment(name):
        return params.from_named(params_from_jax(flatten_tree(_find(jax_opt, name))))

    def scalar(name, like):
        value = _find(jax_opt, name)
        if value is None:  # the guard is off: keep the fresh value
            return like
        return torch.as_tensor(np.array(value)).to(like.device, like.dtype)

    out = dataclasses.replace(fresh, mu=moment("mu"), nu=moment("nu"))
    for f in dataclasses.fields(OptState):
        if f.name not in ("mu", "nu"):
            setattr(out, f.name, scalar(f.name, getattr(fresh, f.name)))
    return out


def state_from_jax(jax_state: Any, cfg: Config, gan: GAN, seed: int = 0) -> TrainState:
    """A port state holding a JAX `TrainState`'s values: G, D and EMA
    params, both optimizers' Adam mu, nu and count, and the guard
    counters. Reads the JAX state's arrays through numpy (no JAX import).
    JAX's threefry key has no counterpart: the port's generator is seeded
    with `seed`, and a step that must draw JAX's latents takes them as
    arguments."""
    gan.generator.load_state_dict(params_from_jax(flatten_tree(jax_state.g_params)))
    gan.discriminator.load_state_dict(params_from_jax(flatten_tree(jax_state.d_params)))
    state = create_train_state(cfg, gan, seed)
    state.step = int(np.asarray(jax_state.step))
    state.g_opt_state = _opt_state_from_jax(jax_state.g_opt_state, state.g_params,
                                            state.g_opt_state)
    state.d_opt_state = _opt_state_from_jax(jax_state.d_opt_state, state.d_params,
                                            state.d_opt_state)
    if jax_state.ema_params is not None:
        state.ema_params = state.g_params.from_named(
            params_from_jax(flatten_tree(jax_state.ema_params)))
    return state
