"""`first_order`: the decorator of the kernels' autograd Functions'
backward, PyTorch's `once_differentiable` with its error made reachable.

`once_differentiable` ties the backward's outputs to a node that raises
when differentiated again, but it hangs that node on detached copies of
the outputs: `torch.autograd.grad(penalty, params)` of a penalty built on
a gradient through the Function (R1, GP, path lengths) never visits it,
and the terms through the Function drop out of the parameters' gradients
without a word. Here the node also takes the incoming gradients as inputs,
so any gradient of a gradient that reaches parameters through them runs
it and raises ("... marked with @once_differentiable"). Second-order terms
go through the plain composition instead (`train/step.py:plain_twin`).
"""

from __future__ import annotations

import functools

import torch
from torch._C import _functions

_MESSAGE = (b"trying to differentiate twice a function that was marked with "
            b"@once_differentiable (a kernel Function is first-order: second-order "
            b"terms take the plain composition)")


def first_order(fn):
    @functools.wraps(fn)
    def wrapper(ctx, *args):
        with torch.no_grad():
            outputs = fn(ctx, *args)
        if not torch.is_grad_enabled():
            return outputs
        deps = [a for a in args if isinstance(a, torch.Tensor) and a.requires_grad]
        if not deps:
            return outputs
        single = not isinstance(outputs, tuple)
        outs = (outputs,) if single else outputs

        def fake_requires_grad(v):
            if v is not None:
                v = v.detach()
                v.requires_grad = True
            return v

        err_fn = _functions.DelayedError(_MESSAGE, len(outs) + len(deps))
        tied = err_fn(*[fake_requires_grad(v) for v in outs], *deps)[:len(outs)]
        return tied[0] if single else tuple(tied)

    return wrapper
