"""Tensor parallelism, the model axis of the (data, model) mesh: the port's
counterpart of the TP slot of `locate_tpu/parallel/sharding.py`.

**The layout.** `leaf_dim` is the JAX package's `_leaf_spec` rule: a leaf
of two or more dimensions whose trailing dimension (HWIO's O, a dense
layer's out) is divisible by `mp` and at least `MIN_SHARD` has that
dimension split over the model axis; every other leaf is whole on every
rank. The rule reads the leaf's JAX-layout shape: the port's conv kernels
are OIHW (`io/export.py` transposes every 4-d `w`), so their trailing O
is the port's dim 0. `ModelLayout` applies it to one network's flat
parameter vector (`train/state.py:FlatParams`): a rank's vector holds its
slice of every split leaf, in the leaf's local shape, and every other
leaf whole; Adam's moments and the EMA shadow are vectors of the same
layout.

**The compute.** A split parameter carries its `ModelSlice` (the
attribute `model_slice`, which the plain twins of R1 and PL share with
the parameter itself). `ops/conv.py`'s `Conv2d` and `Dense` are
column-parallel on a split weight (Megatron's): the input enters through
`copy_to_model` (identity; the backward sums the input's gradient over
the model group), the rank computes its output channels, and
`gather_from_model` all-gathers them along the channel axis (the backward
keeps the rank's slice). Every other reader of a split leaf reads
`whole(p)`: the leaf gathered, differentiably, whose backward keeps the
rank's slice of the gradient with no sum, because the ranks of a model
group compute the same whole gradient from the same rows. This is what
XLA does with a Pallas call: the kernels run on whole, gathered weights.

Every Function's backward is itself made of these Functions, so the
second-order terms (R1, R2, GP, PL) differentiate through them: the
transpose of a gather is a split and back, of a copy a sum and back.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch

from locate_tpu_torch.parallel.mesh import Mesh

MIN_SHARD = 128  # `make_sharded_train_step`'s min_shard


def jax_trailing_dim(name: str, shape: Sequence[int]) -> int:
    """The port dimension that is the trailing one of the leaf's JAX
    layout: 0 for a conv kernel (OIHW here, HWIO there), else the last."""
    return 0 if name.rsplit(".", 1)[-1] == "w" and len(shape) == 4 else len(shape) - 1


def leaf_dim(name: str, shape: Sequence[int], mp: int,
             min_shard: int = MIN_SHARD) -> Optional[int]:
    """The port dimension of leaf `name` (port shape `shape`) split over a
    model axis of `mp`, or None where the leaf stays whole (`_leaf_spec`)."""
    if mp <= 1 or len(shape) < 2:
        return None
    d = jax_trailing_dim(name, shape)
    return d if shape[d] % mp == 0 and shape[d] >= min_shard else None


@dataclasses.dataclass(frozen=True, eq=False)
class ModelSlice:
    """How a parameter is split: along port dimension `dim` over `mesh`'s
    model axis, rank m holding the m-th of `mesh.mp` equal slices."""
    mesh: Mesh
    dim: int


def slice_of(t: torch.Tensor) -> Optional[ModelSlice]:
    """The parameter's `ModelSlice`, or None for a whole one."""
    return getattr(t, "model_slice", None)


def tag_like(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """`t` (a function of the parameter `like`, elementwise) marked with
    `like`'s slice: what `torch.func.functional_call` puts in a
    parameter's place keeps its layout."""
    s = slice_of(like)
    if s is not None:
        t.model_slice = s
    return t


class _Copy(torch.autograd.Function):
    """Identity forward; the backward sums the cotangent over the model
    group (each rank's use of the input is partial)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _Reduce.apply(g, ctx.mesh), None


class _Reduce(torch.autograd.Function):
    """Sum over the model group forward; identity backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.model_sum_(x.clone())

    @staticmethod
    def backward(ctx, g):
        return _Copy.apply(g, ctx.mesh), None


class _Gather(torch.autograd.Function):
    """The ranks' slices concatenated along `dim` forward; the backward
    keeps the rank's slice of the (whole, same on every rank) cotangent."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return mesh.model_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return _Split.apply(g, ctx.mesh, ctx.dim), None, None


class _Split(torch.autograd.Function):
    """The rank's slice along `dim` forward; the backward gathers."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        k = x.shape[dim] // mesh.mp
        return x.narrow(dim, mesh.model_index * k, k).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _Gather.apply(g, ctx.mesh, ctx.dim), None, None


def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The input of a column-parallel layer (`_Copy`)."""
    return _Copy.apply(x, mesh)


def gather_from_model(y: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    """A column-parallel layer's output channels, gathered (`_Gather`)."""
    return _Gather.apply(y, mesh, dim % y.dim())


def whole(p: torch.Tensor) -> torch.Tensor:
    """A parameter as a whole tensor: a split one all-gathered over its
    model group (differentiable; the backward keeps the rank's slice),
    any other one as it is."""
    s = slice_of(p)
    return p if s is None else _Gather.apply(p, s.mesh, s.dim)


class ModelLayout:
    """One network's flat vector on a rank of `mesh`'s model axis: the
    leaves `names` (whole port shapes `shapes`, in the vector's order),
    each split as `leaf_dim` says. `local` takes a rank's vector from a
    whole one; `full` gathers a whole one (a collective over the model
    group); `total` sums a per-element quantity over the whole vector."""

    def __init__(self, mesh: Mesh, names: Sequence[str], shapes: Sequence[Sequence[int]]):
        self.mesh = mesh
        self.full_shapes = [tuple(s) for s in shapes]
        self.dims = [leaf_dim(n, s, mesh.mp) for n, s in zip(names, self.full_shapes)]
        self.local_shapes = []
        for s, d in zip(self.full_shapes, self.dims):
            s = list(s)
            if d is not None:
                s[d] //= mesh.mp
            self.local_shapes.append(tuple(s))
        self.full_numel = sum(math.prod(s) for s in self.full_shapes)
        self.local_numel = sum(math.prod(s) for s in self.local_shapes)
        self._masks = {}

    def local(self, vec: torch.Tensor) -> torch.Tensor:
        """The rank's vector of a whole one (a new tensor)."""
        m = self.mesh
        out = []
        for piece, shape, d in zip(vec.split([math.prod(s) for s in self.full_shapes]),
                                   self.full_shapes, self.dims):
            if d is not None:
                k = shape[d] // m.mp
                piece = piece.view(shape).narrow(d, m.model_index * k, k)
            out.append(piece.reshape(-1))
        return torch.cat(out)

    def full(self, vec: torch.Tensor) -> torch.Tensor:
        """The whole vector of every model rank's vector (a collective over
        the model group; a new tensor)."""
        m = self.mesh
        ranks = m.model_gather(vec.contiguous(), 0).view(m.mp, -1)
        out = []
        sizes = [math.prod(s) for s in self.local_shapes]
        for i, (shape, d) in enumerate(zip(self.local_shapes, self.dims)):
            lo = sum(sizes[:i])
            if d is None:
                out.append(vec[lo:lo + sizes[i]])
                continue
            parts = [ranks[r, lo:lo + sizes[i]].view(shape) for r in range(m.mp)]
            out.append(torch.cat(parts, dim=d).reshape(-1))
        return torch.cat(out)

    def mask(self, device) -> torch.Tensor:
        """A bool vector of the rank's layout: True on the split leaves."""
        key = str(device)
        if key not in self._masks:
            self._masks[key] = torch.cat([
                torch.full((math.prod(s),), d is not None, dtype=torch.bool, device=device)
                for s, d in zip(self.local_shapes, self.dims)])
        return self._masks[key]

    def total(self, per_element: torch.Tensor) -> torch.Tensor:
        """The sum of `per_element` (the rank's layout) over the whole
        vector: the split leaves' part summed over the model group, the
        whole leaves' part counted once. The same on every model rank."""
        mask = self.mask(per_element.device)
        zero = per_element.new_zeros(())
        split = torch.where(mask, per_element, zero).sum()
        self.mesh.model_sum_(split)
        return split + torch.where(mask, zero, per_element).sum()

    def all_(self, flag: torch.Tensor) -> torch.Tensor:
        """Whether a bool 0-d tensor holds on every model rank."""
        bad = (~flag).float().reshape(())
        return self.mesh.model_sum_(bad.clone()) == 0

    def max_(self, value: torch.Tensor) -> torch.Tensor:
        """The largest of a 0-d tensor over the model ranks."""
        return self.mesh.model_max_(value.clone())
