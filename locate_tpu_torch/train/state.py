"""Train state, counterpart of `locate_tpu/train/state.py`: the step count,
the random generator of the step's draws, both networks' parameters, both
optimizer states and the EMA shadow, and, each only while its option is
on, ADA's p, the path-length running mean, LeCam's two trackers and the
step count on the device (what `train.ema_rampup` reads), all device
tensors that the step updates in place.

Each network's parameters live in one contiguous f32 buffer
(`FlatParams`): the module's parameters are views of it, so the optimizer
and the EMA update a network with a few whole-buffer operations, in
place, and the module sees the new values. Optimizer moments and the EMA
shadow are flat buffers of the same layout; `FlatParams.named` views one
under the JAX dotted names.

Under ZeRO (`parallel/sharding.py:place_train_state`) a rank keeps the
moments and the EMA shadow as its slice of the vector; the parameters
stay whole on every rank, in a buffer that each update all-gathers
(`FlatParams.apply_update`). In a group, `create_train_state` gives every
rank rank 0's values.
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
        self._view(self.flat)
        self.shard = None      # ZeRO: this rank's slice (`parallel/sharding.py:Shard`)
        self.padded = None     # ZeRO: `flat` padded to the ranks' slices (flat views it)

    def _view(self, flat: torch.Tensor) -> None:
        for p, view in zip(self.params, self.split(flat)):
            p.data = view

    def shard_over(self, shard) -> None:
        """Move `flat` into a buffer padded to `shard`'s ranks (the modules'
        parameters follow it), which the updates all-gather into."""
        n = self.flat.numel()
        self.padded = torch.zeros(shard.padded, dtype=self.flat.dtype, device=self.flat.device)
        self.padded[:n].copy_(self.flat)
        self.flat = self.padded[:n]
        self._view(self.flat)
        self.shard = shard

    def local(self, vec: torch.Tensor) -> torch.Tensor:
        """The rank's slice of a full vector of this layout (the vector
        itself without ZeRO)."""
        return vec if self.shard is None else self.shard.take(vec)

    def apply_update(self, updates: torch.Tensor) -> None:
        """Add an optimizer update in place: the whole vector's, or under
        ZeRO the rank's slice's, then all-gather every rank's new slice
        into the buffer the modules view."""
        if self.shard is None:
            self.flat.add_(updates)
            return
        self.shard.gather_into(self.padded, self.shard.take(self.flat) + updates)

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
    ema_params: Optional[torch.Tensor]  # flat EMA of g_params.flat in ema_dtype, or None
    ada_p: Optional[torch.Tensor] = None    # f32 augmentation probability (ADA)
    pl_mean: Optional[torch.Tensor] = None  # f32 path-length running mean
    lecam: Optional[torch.Tensor] = None    # f32 [ema_real, ema_fake] logit trackers
    step_tensor: Optional[torch.Tensor] = None  # int32 step count (ema_rampup)
    zero_stage: int = 0           # ZeRO stage the state is sharded at (parallel/sharding.py)


# the optional tensors of a state, each present only while its option is on
OPTIONAL = ("ema_params", "ada_p", "pl_mean", "lecam", "step_tensor")


def state_tensors(state: TrainState) -> Dict[str, torch.Tensor]:
    """Every tensor the step updates in place, by name: both networks' flat
    parameters, both optimizer states' fields and the optional tensors
    that are on."""
    out = {"g_params": state.g_params.flat, "d_params": state.d_params.flat}
    for net, opt in (("g", state.g_opt_state), ("d", state.d_opt_state)):
        for name, t in opt.tensors().items():
            out[f"{net}_opt.{name}"] = t
    for name in OPTIONAL:
        if getattr(state, name) is not None:
            out[name] = getattr(state, name)
    return out


def fresh_optional(cfg: Config, name: str, state: TrainState) -> torch.Tensor:
    """The value an optional tensor starts from (also what a resume that
    turns its option on fills it with): p = train.augment_p, a zero
    path-length mean and zero LeCam trackers (the JAX package's), the
    state's step count; the EMA shadow from the live G."""
    dev = state.g_params.flat.device
    if name == "ema_params":
        return state.g_params.local(ema_init(state.g_params.flat, cfg.train.ema_dtype)).clone()
    if name == "ada_p":
        return torch.tensor(cfg.train.augment_p, dtype=torch.float32, device=dev)
    if name == "pl_mean":
        return torch.zeros((), dtype=torch.float32, device=dev)
    if name == "lecam":
        return torch.zeros((2,), dtype=torch.float32, device=dev)
    if name == "step_tensor":
        return torch.tensor(state.step, dtype=torch.int32, device=dev)
    raise KeyError(name)


def optional_on(cfg: Config) -> Dict[str, bool]:
    """Which optional tensors `cfg` keeps."""
    t = cfg.train
    return {"ema_params": t.ema_decay > 0, "ada_p": t.augment_p > 0.0 or t.ada_target > 0.0,
            "pl_mean": t.pl_gamma > 0.0, "lecam": t.lecam_gamma > 0.0,
            "step_tensor": t.ema_rampup > 0.0}


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


def serving_vector(state: TrainState) -> torch.Tensor:
    """The flat generator weights a state serves: its EMA shadow, or G's
    own where the run keeps no EMA; a ZeRO shadow all-gathered (a
    collective: every rank calls it)."""
    if state.ema_params is None:
        return state.g_params.flat
    if state.zero_stage:
        return state.g_params.shard.gather(state.ema_params)
    return state.ema_params


def create_train_state(cfg: Config, gan: GAN, seed: int = 0, mesh=None) -> TrainState:
    """The state of a fresh run of `gan`, whose modules hold their initial
    weights; `seed` seeds the step's random generator. On a mesh with a
    group every rank takes rank 0's tensors."""
    g_opt, d_opt = make_optimizers(cfg.train)
    g_params, d_params = FlatParams(gan.generator), FlatParams(gan.discriminator)
    rng = torch.Generator(device=gan.device)
    rng.manual_seed(seed)
    state = TrainState(step=0, rng=rng, g_params=g_params, d_params=d_params,
                       g_opt_state=g_opt.init(g_params.flat),
                       d_opt_state=d_opt.init(d_params.flat), ema_params=None)
    for name, on in optional_on(cfg).items():
        if on:
            setattr(state, name, fresh_optional(cfg, name, state))
    if mesh is not None:
        with torch.no_grad():
            for t in state_tensors(state).values():
                mesh.broadcast_(t)
    return state


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

    vectors = ("mu", "nu", "acc_grads")
    out = dataclasses.replace(fresh, mu=moment("mu"), nu=moment("nu"))
    if fresh.acc_grads is not None:  # optax.MultiStepsState
        out.acc_grads = moment("acc_grads")
    for name, like in fresh.tensors().items():
        if name not in vectors:
            setattr(out, name, scalar(name, like))
    return out


def state_from_jax(jax_state: Any, cfg: Config, gan: GAN, seed: int = 0) -> TrainState:
    """A port state holding a JAX `TrainState`'s values: G, D and EMA
    params, both optimizers' Adam mu, nu and count, the guard counters and
    MultiSteps' fields, ADA's p, the path-length mean and LeCam's
    trackers. Reads the JAX state's arrays through numpy (no JAX import).
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
            params_from_jax(flatten_tree(jax_state.ema_params))).to(state.ema_params.dtype)
    for name in ("ada_p", "pl_mean", "lecam"):
        value = getattr(jax_state, name, None)
        if value is not None:
            setattr(state, name, torch.as_tensor(np.array(value, np.float32)).to(gan.device))
    if state.step_tensor is not None:
        state.step_tensor.fill_(state.step)
    return state
