"""The device mesh, counterpart of `locate_tpu/parallel/mesh.py`, and the
collectives the data-parallel step, ZeRO, sampling and the eval call.

The mesh is the JAX mesh's (data, model) shape over the processes of the
group (`parallel/distributed.py`: one process a device). Data parallelism
is the only axis the port runs: `model_parallel > 1`, the tensor-parallel
slot, raises. A mesh without a group (one process) has no collectives:
each helper returns its input. A group of one runs every collective, on
one rank, so the code under a group is the same at every world size.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

import torch
import torch.distributed as dist

TP_TODO = ("tensor parallelism (model_parallel > 1, the TP slot) is not ported: "
           "ROADMAP.md Queue 1 item 14")


@dataclasses.dataclass(frozen=True)
class Mesh:
    dp: int = 1                 # the data axis: ranks that split the batch
    mp: int = 1                 # the model axis (1: the TP slot is not ported)
    rank: int = 0
    world: int = 1
    group: Any = None           # the process group, or None in one process

    @property
    def primary(self) -> bool:
        """Whether this rank writes the run's files."""
        return self.rank == 0

    # ------------------------------------------------------- collectives
    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        """All-reduce `t` in place (sum over ranks), no gradient."""
        if self.group is not None:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def mean_(self, t: torch.Tensor) -> torch.Tensor:
        """All-reduce `t` in place to its mean over ranks (JAX's pmean:
        the sum, divided by the world size), no gradient."""
        if self.group is not None:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
            t.div_(self.world)
        return t

    def gmean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean over ranks of `x`, differentiable: the backward pass
        sums the cotangents of every rank (JAX's pmean under shard_map,
        whose transpose is a psum), so a loss built on a global mean has,
        averaged over ranks, the global program's gradient."""
        if self.group is None:
            return x
        from torch.distributed.nn.functional import all_reduce

        return all_reduce(x, op=dist.ReduceOp.SUM, group=self.group) / self.world

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's `t`, concatenated along dim 0 in rank order."""
        if self.group is None:
            return t
        out = torch.empty((self.world * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype,
                          device=t.device)
        dist.all_gather_into_tensor(out, t.contiguous(), group=self.group)
        return out

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        if self.group is not None:
            dist.broadcast(t, src=src, group=self.group)
        return t

    def broadcast_object(self, obj: Any, src: int = 0) -> Any:
        """`obj` of rank `src` on every rank (a picklable host value)."""
        if self.group is None:
            return obj
        box: List[Any] = [obj]
        dist.broadcast_object_list(box, src=src, group=self.group)
        return box[0]


def _divisible(n: int, mp: int, data_parallel: int) -> int:
    """The data axis of `make_mesh`, with its errors."""
    if n % mp:
        raise ValueError(f"{n} devices not divisible by model_parallel={mp}")
    dp = data_parallel if data_parallel > 0 else n // mp
    if dp * mp != n:
        raise ValueError(f"mesh {dp}x{mp} != {n} devices (data_parallel={data_parallel})")
    return dp


def make_mesh(cfg, world: Optional[int] = None) -> Mesh:
    """The (data, model) mesh of `cfg` (a ParallelConfig) over the group's
    ranks (`world` of them; by default the group's size, 1 without one).
    `data_parallel == -1` takes every rank the model axis leaves. The
    divisibility errors are the JAX function's words; a model axis over 1
    raises NotImplementedError (the TP slot)."""
    grouped = dist.is_initialized()
    n = dist.get_world_size() if grouped else 1
    if world is not None and grouped and world != n:
        raise ValueError(f"world {world} != the process group's {n} ranks")
    n = n if world is None else world
    mp = max(1, cfg.model_parallel)
    dp = _divisible(n, mp, cfg.data_parallel)
    if mp > 1:
        raise NotImplementedError(f"mesh {dp}x{mp}: {TP_TODO}")
    return Mesh(dp=dp, mp=mp, rank=dist.get_rank() if grouped else 0, world=n,
                group=dist.group.WORLD if grouped else None)


# the JAX function's name for the 1x1 mesh with no group (no collective runs)
single_device_mesh = Mesh
