"""The data-parallel train step's two backends and ZeRO state sharding,
counterpart of `locate_tpu/parallel/sharding.py`.

`make_step_for(cfg, gan, mesh)` dispatches on `parallel.backend`; both
backends are one `train/step.py:TrainStep` that runs on each rank's rows of
the global batch, with its collectives written out at the JAX step's
points (the gradients' and metrics' means, the global means of the
relativistic losses and of feature matching, top-k's gathered logits):

  * "gspmd" keeps the global program's semantics: every random draw is
    made for the global batch from the same generator stream on every
    rank, and each rank takes its rows, so a run on N ranks is the
    one-process run up to the order of reductions;
  * "shard_map" keeps the explicit per-replica semantics of the JAX
    package's shard_map step: augmentation, bCR and the style family's
    noise draw per replica, `r1_batch_fraction` takes each replica's own
    leading rows, feature matching is scaled by the axis size.

Tensor parallelism (`parallel.model_parallel` = mp > 1, "gspmd" only, as
in the JAX package) splits the trailing channel dimension of every
eligible leaf over the mesh's model axis (`parallel/tp.py`: the JAX
rule `_leaf_spec`, on the leaf's JAX-layout shape): each rank's flat
vector of a network holds its slice of every split leaf and every other
leaf whole, and Adam's moments and the EMA shadow follow the same layout
(`train/state.py:FlatParams.slice_model`). The model ranks of a data row
see the same rows; the gradients' and metrics' means run over the data
group.

ZeRO (`parallel.zero_stage`) is written for the port's one flat f32
vector a network, the rank's layout under TP: rank d of the data axis
owns the slice [d s, (d + 1) s) of the vector padded to a multiple of
dp, s = ceil(n / dp) (`Shard`). Stages 1 and 3 keep Adam's mu and nu and
the EMA shadow as the rank's slice. The update all-reduces the whole
gradient over the data group (the guards' and the clip's norms read the
whole reduced gradient, summed over the model group under TP), runs Adam
on the rank's slice of it and all-gathers the new parameters: an
elementwise split of stage 0's arithmetic, so the trajectory is stage
0's bit for bit. Stage 3 keeps the parameters whole within the model
slice on every rank, as stage 1 does: the step and its captured CUDA
graph read them at one address, and sharding them between steps
(freeing the gathered buffer outside the step) is ROADMAP.md Queue 1
item 15. `info` reports these resident bytes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from locate_tpu_torch.parallel.mesh import Mesh, all_gather_into


@dataclasses.dataclass(frozen=True, eq=False)
class Shard:
    """This rank's slice over the data axis of a flat vector of `n`
    elements."""
    n: int
    mesh: Mesh

    @property
    def size(self) -> int:
        return -(-self.n // self.mesh.dp)

    @property
    def lo(self) -> int:
        return self.mesh.data_index * self.size

    @property
    def hi(self) -> int:
        return self.lo + self.size

    @property
    def padded(self) -> int:
        return self.size * self.mesh.dp

    def take(self, vec: torch.Tensor) -> torch.Tensor:
        """The rank's slice of a full vector (a view where it lies inside
        the vector, else a copy padded with zeros)."""
        if self.hi <= self.n:
            return vec[self.lo:self.hi]
        inside = vec[min(self.lo, self.n):self.n]
        return torch.cat([inside, vec.new_zeros(self.size - inside.numel())])

    def gather_into(self, out: torch.Tensor, shard: torch.Tensor) -> torch.Tensor:
        """Every data rank's slice into `out` (the padded vector), in place."""
        m = self.mesh
        if m.data_group is None:
            return out.copy_(shard)
        return all_gather_into(out, shard, m.data_group, m.dp, m.data_index)

    def gather(self, shard: torch.Tensor) -> torch.Tensor:
        """The full vector of every rank's slice (a new tensor)."""
        out = torch.empty(self.padded, dtype=shard.dtype, device=shard.device)
        return self.gather_into(out, shard)[:self.n]


def make_step_for(cfg, gan, mesh: Mesh):
    """The train step of `gan` on `mesh` in the backend `cfg.parallel.backend`
    names; an unknown backend raises with the JAX function's words."""
    from locate_tpu_torch.train.step import TrainStep

    backend = cfg.parallel.backend
    if backend == "gspmd":
        return TrainStep(cfg, gan, mesh=mesh)
    if backend == "shard_map":
        if mesh.mp != 1:
            raise ValueError("shard_map step is DP-only (model_parallel must be 1)")
        return TrainStep(cfg, gan, mesh=mesh, per_replica=True)
    raise ValueError(
        f"unknown parallel.backend {backend!r}; expected 'gspmd' or 'shard_map'")


def place_train_state(state, mesh: Mesh, zero_stage: int):
    """Lay a (replicated, one-process) state out on `mesh`, in place: under
    a model axis each rank keeps its model slice of the parameters, the
    moments and the EMA shadow (`FlatParams.slice_model`); then at
    `zero_stage` 1 and 3 its data-axis slice of the moments and the EMA
    shadow (the parameters stay whole within the model slice: ROADMAP.md
    Queue 1 item 15). Run it before a checkpoint is restored into the
    state and before a step graph is captured (both bind the tensors it
    makes). Returns `state`."""
    if zero_stage not in (0, 1, 3):
        raise ValueError(f"parallel.zero_stage={zero_stage}; expected 0, 1, or 3")
    if mesh.mp > 1:
        if state.g_params.layout is not None:
            raise ValueError("the state is already split over the model axis")
        _slice_model(state, mesh)
    if zero_stage == 0:
        return state
    if state.zero_stage:
        raise ValueError(f"the state is already sharded (zero_stage={state.zero_stage})")
    with torch.no_grad():
        for params, opt in ((state.g_params, state.g_opt_state),
                            (state.d_params, state.d_opt_state)):
            shard = Shard(params.flat.numel(), mesh)
            params.shard_over(shard)
            opt.mu, opt.nu = shard.take(opt.mu).clone(), shard.take(opt.nu).clone()
            opt.shard = shard
        if state.ema_params is not None:
            state.ema_params = state.g_params.shard.take(state.ema_params).clone()
    state.zero_stage = zero_stage
    return state


# the optimizer fields that are vectors of the parameters' layout
VECTOR_FIELDS = ("mu", "nu", "acc_grads")


def _slice_model(state, mesh: Mesh) -> None:
    with torch.no_grad():
        for params, opt in ((state.g_params, state.g_opt_state),
                            (state.d_params, state.d_opt_state)):
            params.slice_model(mesh)
            for name in VECTOR_FIELDS:
                vec = getattr(opt, name)
                if vec is not None:
                    setattr(opt, name, params.model_slice(vec))
            opt.layout = params.layout
        if state.ema_params is not None:
            state.ema_params = state.g_params.model_slice(state.ema_params)


def sharded_tensors(state) -> Dict[str, Shard]:
    """The names of `train/state.py:state_tensors` that hold a rank's
    ZeRO slice, with their `Shard`."""
    if not state.zero_stage:
        return {}
    out = {}
    for net, opt in (("g", state.g_opt_state), ("d", state.d_opt_state)):
        out[f"{net}_opt.mu"] = out[f"{net}_opt.nu"] = opt.shard
    if state.ema_params is not None:
        out["ema_params"] = state.g_params.shard
    return out


def model_tensors(state) -> Dict[str, object]:
    """The names of `train/state.py:state_tensors` that are vectors of a
    network's model-axis layout (under TP), with that network's
    `FlatParams`."""
    if state.g_params.layout is None:
        return {}
    out = {}
    for net, params, opt in (("g", state.g_params, state.g_opt_state),
                             ("d", state.d_params, state.d_opt_state)):
        out[f"{net}_params"] = params
        for name in VECTOR_FIELDS:
            if getattr(opt, name) is not None:
                out[f"{net}_opt.{name}"] = params
    if state.ema_params is not None:
        out["ema_params"] = state.g_params
    return out


def gathered_tensors(state) -> Dict[str, torch.Tensor]:
    """`state_tensors(state)` with every ZeRO slice all-gathered over the
    data group and every model slice gathered over the model group: the
    world-size-independent (one-process) tensors a checkpoint holds. A
    collective under ZeRO or TP: every rank calls it."""
    from locate_tpu_torch.train.state import state_tensors

    shards, models = sharded_tensors(state), model_tensors(state)
    out = {}
    for k, t in state_tensors(state).items():
        if k in shards:
            t = shards[k].gather(t)
        if k in models:
            t = models[k].model_full(t)
        out[k] = t
    return out


def own_tensor(state, name: str, full: torch.Tensor) -> torch.Tensor:
    """This rank's part of the whole (one-process) tensor `full` of
    `state_tensors`' `name`: its model slice, then its ZeRO slice."""
    models, shards = model_tensors(state), sharded_tensors(state)
    if name in models:
        full = models[name].model_slice(full)
    if name in shards:
        full = shards[name].take(full)
    return full


def full_shape(state, name: str, t: torch.Tensor):
    """The whole (one-process) shape of `state_tensors`' `name`, the
    rank's `t`."""
    models, shards = model_tensors(state), sharded_tensors(state)
    if name in models:
        return (models[name].full_numel,)
    if name in shards:
        return (shards[name].n,)
    return tuple(t.shape)
