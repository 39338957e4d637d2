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

ZeRO (`parallel.zero_stage`) is written for the port's one flat f32
vector a network (`train/state.py:FlatParams`): rank r owns the slice
[r s, (r + 1) s) of the vector padded to a multiple of the world, s =
ceil(n / world) (`Shard`). Stages 1 and 3 keep Adam's mu and nu and the
EMA shadow as the rank's slice. The update all-reduces the whole gradient
(the guards' and the clip's norms read the whole reduced gradient), runs
Adam on the rank's slice and all-gathers the new parameters: an
elementwise split of stage 0's arithmetic, so the trajectory is stage 0's
bit for bit. Stage 3 keeps the parameters whole on every rank, as stage 1
does: the step and its captured CUDA graph read them at one address, and
sharding them between steps (freeing the gathered buffer outside the
step) is ROADMAP.md Queue 1 item 15. `info` reports these resident bytes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from locate_tpu_torch.parallel.mesh import Mesh


@dataclasses.dataclass(frozen=True, eq=False)
class Shard:
    """This rank's slice of a flat vector of `n` elements."""
    n: int
    mesh: Mesh

    @property
    def size(self) -> int:
        return -(-self.n // self.mesh.world)

    @property
    def lo(self) -> int:
        return self.mesh.rank * self.size

    @property
    def hi(self) -> int:
        return self.lo + self.size

    @property
    def padded(self) -> int:
        return self.size * self.mesh.world

    def take(self, vec: torch.Tensor) -> torch.Tensor:
        """The rank's slice of a full vector (a view where it lies inside
        the vector, else a copy padded with zeros)."""
        if self.hi <= self.n:
            return vec[self.lo:self.hi]
        inside = vec[min(self.lo, self.n):self.n]
        return torch.cat([inside, vec.new_zeros(self.size - inside.numel())])

    def gather_into(self, out: torch.Tensor, shard: torch.Tensor) -> torch.Tensor:
        """Every rank's slice into `out` (the padded vector), in place."""
        if self.mesh.group is None:
            return out.copy_(shard)
        import torch.distributed as dist

        dist.all_gather_into_tensor(out, shard.contiguous(), group=self.mesh.group)
        return out

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
    """Shard a (replicated) state over `mesh` as `zero_stage` says, in
    place: the optimizers' moments and the EMA shadow at 1 and 3 (the
    parameters stay whole: ROADMAP.md Queue 1 item 15). Run it before a
    checkpoint is restored into the state and before a step graph is
    captured (both bind the tensors it makes). Returns `state`."""
    if zero_stage not in (0, 1, 3):
        raise ValueError(f"parallel.zero_stage={zero_stage}; expected 0, 1, or 3")
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


def sharded_tensors(state) -> Dict[str, Shard]:
    """The names of `train/state.py:state_tensors` that hold a rank's
    slice, with their `Shard`."""
    if not state.zero_stage:
        return {}
    out = {}
    for net, opt in (("g", state.g_opt_state), ("d", state.d_opt_state)):
        out[f"{net}_opt.mu"] = out[f"{net}_opt.nu"] = opt.shard
    if state.ema_params is not None:
        out["ema_params"] = state.g_params.shard
    return out


def gathered_tensors(state) -> Dict[str, torch.Tensor]:
    """`state_tensors(state)` with every slice all-gathered into its full
    vector: the world-size-independent tensors a checkpoint holds. A
    collective under ZeRO: every rank calls it."""
    from locate_tpu_torch.train.state import state_tensors

    shards = sharded_tensors(state)
    return {k: shards[k].gather(t) if k in shards else t
            for k, t in state_tensors(state).items()}
