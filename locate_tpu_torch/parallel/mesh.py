"""The device mesh, counterpart of `locate_tpu/parallel/mesh.py`, and the
collectives of the train step, ZeRO, sampling and the eval.

The mesh is the JAX mesh's (data, model) shape over the processes of the
group (`parallel/distributed.py`: one process a device), laid out as
JAX's `reshape(dp, mp)`: rank r sits at data row `r // mp` and model
column `r % mp`. The ranks of one model column form the **data group**
(they split the batch); the ranks of one data row form the **model
group** (they hold the channel slices of the tensor-parallel leaves,
`parallel/tp.py`, and see the same rows). The batch-side collectives
(`sum_`, `mean_`, `gmean`, `all_gather`) run over the data group, the
model-side ones (`model_sum_`, `model_max_`, `model_gather`) over the
model group; broadcasts run over the world. At `mp = 1` the data group is
the world's group and nothing runs on the model axis.

A mesh without a group (one process) has no collectives: each helper
returns its input. A group of one runs every collective, on one rank, so
the code under a group is the same at every world size.

gloo carries `all_reduce` and `broadcast` of CUDA tensors but no
all-gather: an all-gather of a CUDA tensor under gloo is an `all_reduce`
of a zero-filled buffer holding the rank's piece at its offset (exact:
each element is its piece's value plus zeros). NCCL, and gloo on CPU
tensors, use `all_gather_into_tensor`; another backend raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist


def all_gather_into(out: torch.Tensor, piece: torch.Tensor, group, size: int,
                     index: int) -> torch.Tensor:
    """Every member's `piece` into `out` (size pieces, in the group's rank
    order; `index` is this rank's) over `group`, in place."""
    piece = piece.contiguous()
    backend = dist.get_backend(group)
    if backend == "gloo" and piece.is_cuda:
        out.zero_()
        out.view(size, -1)[index].copy_(piece.reshape(-1))
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out
    if backend not in ("gloo", "nccl"):
        raise NotImplementedError(f"all-gather over a {backend!r} group: the port runs "
                                  "gloo and nccl")
    dist.all_gather_into_tensor(out.view(-1), piece.view(-1), group=group)
    return out


@dataclasses.dataclass(frozen=True)
class Mesh:
    dp: int = 1                 # the data axis: ranks that split the batch
    mp: int = 1                 # the model axis: ranks that split the channels
    rank: int = 0
    world: int = 1
    group: Any = None           # the world's process group, or None in one process
    data_group: Any = None      # this rank's model column (the world's group at mp = 1)
    model_group: Any = None     # this rank's data row (None at mp = 1)

    @property
    def primary(self) -> bool:
        """Whether this rank writes the run's files."""
        return self.rank == 0

    @property
    def data_index(self) -> int:
        """This rank's row of the mesh: which rows of the batch it sees."""
        return self.rank // self.mp

    @property
    def model_index(self) -> int:
        """This rank's column of the mesh: which channel slice it holds."""
        return self.rank % self.mp

    def groups(self) -> List[Any]:
        """Every distinct process group this rank's collectives run on."""
        out = []
        for g in (self.group, self.data_group, self.model_group):
            if g is not None and all(g is not h for h in out):
                out.append(g)
        return out

    # ---------------------------------------------- the data axis (batch)
    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        """All-reduce `t` in place (sum over the data axis), no gradient."""
        if self.data_group is not None:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.data_group)
        return t

    def mean_(self, t: torch.Tensor) -> torch.Tensor:
        """All-reduce `t` in place to its mean over the data axis (JAX's
        pmean: the sum, divided by the axis size), no gradient."""
        if self.data_group is not None:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.data_group)
            t.div_(self.dp)
        return t

    def gmean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean over the data axis of `x`, differentiable: the backward
        pass sums the cotangents of every data rank (JAX's pmean under
        shard_map, whose transpose is a psum), so a loss built on a global
        mean has, averaged over ranks, the global program's gradient."""
        if self.data_group is None:
            return x
        from torch.distributed.nn.functional import all_reduce

        return all_reduce(x, op=dist.ReduceOp.SUM, group=self.data_group) / self.dp

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every data rank's `t`, concatenated along dim 0 in data order."""
        if self.data_group is None:
            return t
        out = torch.empty((self.dp * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype,
                          device=t.device)
        return all_gather_into(out, t, self.data_group, self.dp, self.data_index)

    # ------------------------------------------- the model axis (channels)
    def model_sum_(self, t: torch.Tensor) -> torch.Tensor:
        """All-reduce `t` in place (sum over the model axis), no gradient."""
        if self.model_group is not None:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.model_group)
        return t

    def model_max_(self, t: torch.Tensor) -> torch.Tensor:
        """All-reduce `t` in place (max over the model axis), no gradient."""
        if self.model_group is not None:
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.model_group)
        return t

    def model_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every model rank's `t`, concatenated along `dim` in model order,
        no gradient."""
        if self.model_group is None:
            return t
        out = torch.empty((self.mp,) + tuple(t.shape), dtype=t.dtype, device=t.device)
        all_gather_into(out, t, self.model_group, self.mp, self.model_index)
        if dim % t.dim() == 0:
            return out.reshape((self.mp * t.shape[0],) + tuple(t.shape[1:]))
        return torch.cat(out.unbind(0), dim=dim)

    # ------------------------------------------------- the world (broadcast)
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


# the subgroups of each (dp, mp) shape, made once for the world group they
# split: every rank makes every subgroup, in the same order
_SUBGROUPS: Dict[Tuple[int, int], Tuple[list, list]] = {}
_SUBGROUPS_OF: List[Any] = [None]


def _subgroups(dp: int, mp: int, rank: int) -> Tuple[Any, Any]:
    """(data group, model group) of `rank` on the (dp, mp) mesh."""
    if _SUBGROUPS_OF[0] is not dist.group.WORLD:
        _SUBGROUPS.clear()
        _SUBGROUPS_OF[0] = dist.group.WORLD
    if (dp, mp) not in _SUBGROUPS:
        data = [dist.new_group([d * mp + m for d in range(dp)]) for m in range(mp)]
        model = [dist.new_group([d * mp + m for m in range(mp)]) for d in range(dp)]
        _SUBGROUPS[(dp, mp)] = (data, model)
    data, model = _SUBGROUPS[(dp, mp)]
    return data[rank % mp], model[rank // mp]


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
    divisibility errors are the JAX function's words. A model axis over 1
    makes the data and model subgroups (every rank makes all of them)."""
    grouped = dist.is_initialized()
    n = dist.get_world_size() if grouped else 1
    if world is not None and grouped and world != n:
        raise ValueError(f"world {world} != the process group's {n} ranks")
    n = n if world is None else world
    mp = max(1, cfg.model_parallel)
    dp = _divisible(n, mp, cfg.data_parallel)
    if not grouped:
        return Mesh(dp=dp, mp=mp, rank=0, world=n)
    rank = dist.get_rank()
    data, model = _subgroups(dp, mp, rank) if mp > 1 else (dist.group.WORLD, None)
    return Mesh(dp=dp, mp=mp, rank=rank, world=n, group=dist.group.WORLD, data_group=data,
                model_group=model)


# the JAX function's name for the 1x1 mesh with no group (no collective runs)
single_device_mesh = Mesh
