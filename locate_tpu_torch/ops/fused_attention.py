"""Softmax location-attention gate: plain PyTorch version and the wrappers
of its Hopper kernels. Counterpart of `locate_tpu/ops/pallas/fused_attention.py`.

The gate is the per-location MLP

    u = x @ W1x + pos_proj + b1      (HW, Hd)   per location
    h = act(u)                       rounded to the compute dtype
    l = h @ W2 + b2                  (HW, Cout) per location, f32
    g = min(softmax_HW(l) * HW, gate_max)
    y = x * g

with x (N, HW, C) in the compute dtype, W1x (C, Hd) and W2 (Hd, Cout)
cast to it, and pos_proj, the biases and the gate math in f32.

Four wrappers launch the kernels of `csrc/fused_attention.cu` for CUDA
tensors and run the plain version for CPU tensors; nothing falls back
from one to the other. Forward: `softmax_gate_stats` and
`softmax_gate_apply`. Backward: `softmax_gate_csum` (pass A, the
per-(n, channel) sum c of the softmax Jacobian) and
`softmax_gate_backward` (pass B, dx and every weight gradient). Each
wrapper counts its kernel launches in its `launches` attribute.
`fused_locate_attention` runs the four through a first-order
`torch.autograd.Function`, as `_make_fused_core` does in JAX. The sigmoid
gate's kernels are not ported yet (ROADMAP.md, Queue 2).
"""

from __future__ import annotations

import ctypes
from typing import Callable, Tuple

import torch
from torch.autograd.function import once_differentiable

from locate_tpu_torch.ops.activations import act_fn
from locate_tpu_torch.ops.cuda import build

# activation codes of csrc/fused_attention.cu
ACT_CODES = {"leaky_relu": 0, "relu": 1, "silu": 2, "gelu": 3}

# activations whose backward runs the kernels (`_PALLAS_BWD_ACTS`); the
# others take the vjp of the plain composition, as JAX does
BWD_ACTS = ("leaky_relu", "relu")

# shared memory a block may use on sm_90 (227 KB)
_MAX_SMEM = 232448

# blocks the backward kernel aims for: two per SM of the H100's 132
_BWD_TARGET_BLOCKS = 264


def _act(kind: str, slope: float) -> Callable[[torch.Tensor], torch.Tensor]:
    """The four activations the kernels implement (`_act` of the JAX module)."""
    if kind not in ACT_CODES:
        raise ValueError(f"unsupported activation for fused attention: {kind!r}")
    return act_fn(kind, slope)


def _clamp_gate(g: torch.Tensor, gate_max: float) -> torch.Tensor:
    """Cap the gate at `gate_max` (0 = off)."""
    return g.clamp(max=gate_max) if gate_max > 0.0 else g


def _gate_mask(g: torch.Tensor, gate_max: float):
    """d(clamped gate)/d(gate): 1 where g <= gate_max, 0 above (1.0 when
    the clamp is off)."""
    return (g <= gate_max).float() if gate_max > 0.0 else 1.0


def _act_grad(kind: str, slope: float) -> Callable[[torch.Tensor], torch.Tensor]:
    """act'(u) with the subgradients of `_act_grad`: leaky_relu is 1 at
    u >= 0, relu is 0 at 0."""
    if kind == "leaky_relu":
        return lambda u: torch.where(u >= 0, 1.0, slope)
    if kind == "relu":
        return lambda u: torch.where(u > 0, 1.0, 0.0)
    raise ValueError(f"no backward kernel for activation {kind!r}")


# ---------------------------------------------------------------------------
# plain version (CPU tensors, tests, and the card-side comparison)
# ---------------------------------------------------------------------------


def gate_logits_reference(x2d, pos_proj, w1x, b1, w2, b2, *, act, leaky_slope):
    """l (N, HW, Cout) in f32: compute-dtype operands, f32 products and
    sums, as `preferred_element_type=float32` gives in JAX."""
    cd = x2d.dtype
    u = x2d.float() @ w1x.to(cd).float() + pos_proj.float() + b1.float()
    h = _act(act, leaky_slope)(u).to(cd)
    return h.float() @ w2.to(cd).float() + b2.float()


def locate_attention_core_reference(
    x2d: torch.Tensor,       # (N, HW, C)
    pos_proj: torch.Tensor,  # (HW, Hd) f32
    w1x: torch.Tensor,       # (C, Hd)
    b1: torch.Tensor,        # (Hd,)
    w2: torch.Tensor,        # (Hd, Cout)
    b2: torch.Tensor,        # (Cout,)
    *,
    mode: str,
    act: str,
    leaky_slope: float,
    hw_scale: float,
    gate_max: float = 0.0,
) -> torch.Tensor:
    """Plain composition, mirroring `locate_attention_xla_core`."""
    l = gate_logits_reference(x2d, pos_proj, w1x, b1, w2, b2, act=act,
                              leaky_slope=leaky_slope)
    if mode == "sigmoid":
        g = torch.sigmoid(l) * 2.0
    elif mode == "softmax":
        g = torch.softmax(l, dim=1) * hw_scale
    else:
        raise ValueError(f"unknown attention mode {mode!r}")
    g = _clamp_gate(g, gate_max)
    return (x2d.float() * g).to(x2d.dtype)


def softmax_gate_stats_reference(x2d, pos_proj, w1x, b1, w2, b2, *, act,
                                 leaky_slope) -> Tuple[torch.Tensor, torch.Tensor]:
    """(m, se), each (N, 1, Cout) f32: max and sum-exp of l over HW."""
    l = gate_logits_reference(x2d, pos_proj, w1x, b1, w2, b2, act=act,
                              leaky_slope=leaky_slope)
    m = l.amax(dim=1, keepdim=True)
    return m, torch.exp(l - m).sum(dim=1, keepdim=True)


def softmax_gate_apply_reference(x2d, pos_proj, w1x, b1, w2, b2, m, se, *, act,
                                 leaky_slope, hw_scale, gate_max) -> torch.Tensor:
    l = gate_logits_reference(x2d, pos_proj, w1x, b1, w2, b2, act=act,
                              leaky_slope=leaky_slope)
    g = _clamp_gate(torch.exp(l - m) / se * hw_scale, gate_max)
    return (x2d.float() * g).to(x2d.dtype)


def _dgate(xf, dyf, cout):
    """dL/dg: x * dy, summed over channels for a broadcast gate (Cout = 1)."""
    dg = xf * dyf
    if cout == 1 and dg.shape[-1] != 1:
        dg = dg.sum(dim=-1, keepdim=True)
    return dg


def softmax_gate_csum_reference(x2d, dy2d, pos_proj, w1x, b1, w2, b2, m, se, *, act,
                                leaky_slope, hw_scale, gate_max) -> torch.Tensor:
    """c (N, 1, Cout) f32 = sum over HW of g * mask * dg, mirroring
    `_softmax_csum_kernel`."""
    l = gate_logits_reference(x2d, pos_proj, w1x, b1, w2, b2, act=act,
                              leaky_slope=leaky_slope)
    g = torch.exp(l - m) / se * hw_scale
    dg = _dgate(x2d.float(), dy2d.float(), l.shape[-1]) * _gate_mask(g, gate_max)
    return (g * dg).sum(dim=1, keepdim=True)


def softmax_gate_backward_reference(x2d, dy2d, pos_proj, w1x, b1, w2, b2, m, se, c, *,
                                    act, leaky_slope, hw_scale, gate_max):
    """(dx, dpos_proj, dW1x, db1, dW2, db2), mirroring `_bwd_body` step by
    step: h, dl and du are rounded to the compute dtype before their
    products; dx is in the compute dtype; the parameter gradients sum in
    f32 and are cast to their parameters' dtypes."""
    cd = x2d.dtype
    xf, dyf = x2d.float(), dy2d.float()
    w1c, w2c = w1x.to(cd).float(), w2.to(cd).float()
    u = xf @ w1c + pos_proj.float() + b1.float()
    h = _act(act, leaky_slope)(u).to(cd).float()
    l = h @ w2c + b2.float()
    g = torch.exp(l - m) / se * hw_scale
    ghat = _clamp_gate(g, gate_max)
    # c was summed from the masked dg, so only the local dg needs the mask
    dl = g * (_gate_mask(g, gate_max) * _dgate(xf, dyf, l.shape[-1])) - (g / hw_scale) * c
    dlc = dl.to(cd).float()
    du = _act_grad(act, leaky_slope)(u) * (dlc @ w2c.t())
    duc = du.to(cd).float()
    dx = (ghat * dyf + duc @ w1c.t()).to(cd)
    dw1 = torch.einsum("nsc,nsh->ch", xf, duc)
    dw2 = torch.einsum("nsh,nsc->hc", h, dlc)
    return (dx, du.sum(dim=0).to(pos_proj.dtype), dw1.to(w1x.dtype),
            du.sum(dim=(0, 1)).to(b1.dtype), dw2.to(w2.dtype),
            dl.sum(dim=(0, 1)).to(b2.dtype))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def tile_rows(channels: int) -> int:
    """Locations per block: a multiple of 4 in [4, 64], about 4096
    elements of x per tile (16 KB of f32 in shared memory)."""
    return max(4, min(64, (4096 // channels) // 4 * 4))


def _library() -> ctypes.CDLL:
    lib = build.load_library("fused_attention")
    if not getattr(lib, "_locate_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.locate_softmax_stats.argtypes = [i] + [p] * 10 + [i] * 7 + [f, p]
        lib.locate_softmax_stats.restype = i
        lib.locate_softmax_apply.argtypes = [i] + [p] * 9 + [i] * 7 + [f, f, f, p]
        lib.locate_softmax_apply.restype = i
        lib.locate_softmax_csum.argtypes = [i] + [p] * 11 + [i] * 7 + [f, f, f, p]
        lib.locate_softmax_csum.restype = i
        lib.locate_softmax_bwd.argtypes = [i] + [p] * 15 + [i] * 8 + [f, f, f, p]
        lib.locate_softmax_bwd.restype = i
        lib.locate_softmax_smem_bytes.argtypes = [i] * 4
        lib.locate_softmax_smem_bytes.restype = ctypes.c_size_t
        lib.locate_softmax_bwd_smem_bytes.argtypes = [i] * 4
        lib.locate_softmax_bwd_smem_bytes.restype = ctypes.c_size_t
        lib.locate_cuda_error_string.argtypes = [i]
        lib.locate_cuda_error_string.restype = ctypes.c_char_p
        lib._locate_typed = True
    return lib


def _check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.locate_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err} ({msg})")


def _kernel_operands(x2d, pos_proj, w1x, b1, w2, b2, act):
    """Validate a CUDA call and cast its operands as the kernels take
    them: weights in the compute dtype, pos_proj and biases in f32, all
    contiguous on x's device."""
    if x2d.dim() != 3:
        raise ValueError(f"x2d must be (N, HW, C), got {tuple(x2d.shape)}")
    n, hw, c = x2d.shape
    if x2d.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"kernels take float32 or bfloat16 x, got {x2d.dtype}")
    hd = w1x.shape[1]
    cout = w2.shape[1]
    expect = {"pos_proj": (hw, hd), "w1x": (c, hd), "b1": (hd,),
              "w2": (hd, cout), "b2": (cout,)}
    tensors = {"pos_proj": pos_proj, "w1x": w1x, "b1": b1, "w2": w2, "b2": b2}
    for name, t in tensors.items():
        if tuple(t.shape) != expect[name]:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {expect[name]}")
        if t.device != x2d.device:
            raise ValueError(f"{name} on {t.device}, x on {x2d.device}")
    if cout not in (1, c):
        raise ValueError(f"gate channels must be 1 or C={c}, got {cout}")
    if act not in ACT_CODES:
        raise ValueError(f"unsupported activation for fused attention: {act!r}")
    if n > 65535:
        raise ValueError(f"batch {n} exceeds the kernel grid's 65535 rows")
    cd = x2d.dtype
    return tuple(t.detach().contiguous() for t in (
        x2d, pos_proj.float(), w1x.to(cd), b1.float(), w2.to(cd), b2.float()))


def _tile_for(lib, c, hd, cout) -> int:
    t = tile_rows(c)
    smem = lib.locate_softmax_smem_bytes(c, hd, cout, t)
    if smem > _MAX_SMEM:
        raise ValueError(
            f"C={c}, Hd={hd}, Cout={cout} needs {smem} bytes of shared memory "
            f"per block, over the card's {_MAX_SMEM}"
        )
    return t


def softmax_gate_stats(x2d, pos_proj, w1x, b1, w2, b2, *, act, leaky_slope):
    """(m, se), each (N, 1, Cout) f32. CUDA tensors: the stats kernel
    (replaces `_softmax_stats_kernel`); CPU tensors: the plain version."""
    if x2d.device.type == "cpu":
        return softmax_gate_stats_reference(x2d, pos_proj, w1x, b1, w2, b2,
                                            act=act, leaky_slope=leaky_slope)
    if x2d.device.type != "cuda":
        raise ValueError(f"no kernel for device {x2d.device}")
    ops = _kernel_operands(x2d, pos_proj, w1x, b1, w2, b2, act)
    n, hw, c = x2d.shape
    hd, cout = w1x.shape[1], w2.shape[1]
    lib = _library()
    t = _tile_for(lib, c, hd, cout)
    tiles = -(-hw // t)
    with torch.cuda.device(x2d.device):
        f32 = dict(dtype=torch.float32, device=x2d.device)
        part_m = torch.empty((n, tiles, cout), **f32)
        part_s = torch.empty((n, tiles, cout), **f32)
        m = torch.empty((n, 1, cout), **f32)
        se = torch.empty((n, 1, cout), **f32)
        stream = torch.cuda.current_stream(x2d.device).cuda_stream
        err = lib.locate_softmax_stats(
            int(x2d.dtype == torch.bfloat16), *(o.data_ptr() for o in ops),
            part_m.data_ptr(), part_s.data_ptr(), m.data_ptr(), se.data_ptr(),
            n, hw, c, hd, cout, t, ACT_CODES[act], float(leaky_slope), stream)
    _check(lib, err, "softmax stats")
    softmax_gate_stats.launches += 1
    return m, se


softmax_gate_stats.launches = 0


def softmax_gate_apply(x2d, pos_proj, w1x, b1, w2, b2, m, se, *, act,
                       leaky_slope, hw_scale, gate_max):
    """y (N, HW, C) in x's dtype. CUDA tensors: the apply kernel (replaces
    `_softmax_apply_kernel`); CPU tensors: the plain version."""
    if x2d.device.type == "cpu":
        return softmax_gate_apply_reference(
            x2d, pos_proj, w1x, b1, w2, b2, m, se, act=act,
            leaky_slope=leaky_slope, hw_scale=hw_scale, gate_max=gate_max)
    if x2d.device.type != "cuda":
        raise ValueError(f"no kernel for device {x2d.device}")
    ops = _kernel_operands(x2d, pos_proj, w1x, b1, w2, b2, act)
    n, hw, c = x2d.shape
    hd, cout = w1x.shape[1], w2.shape[1]
    m = _stats_operand("m", m, n, cout, x2d.device)
    se = _stats_operand("se", se, n, cout, x2d.device)
    lib = _library()
    t = _tile_for(lib, c, hd, cout)
    with torch.cuda.device(x2d.device):
        y = torch.empty_like(ops[0])
        stream = torch.cuda.current_stream(x2d.device).cuda_stream
        err = lib.locate_softmax_apply(
            int(x2d.dtype == torch.bfloat16), *(o.data_ptr() for o in ops),
            m.data_ptr(), se.data_ptr(), y.data_ptr(),
            n, hw, c, hd, cout, t, ACT_CODES[act], float(leaky_slope),
            float(hw_scale), float(gate_max), stream)
    _check(lib, err, "softmax apply")
    softmax_gate_apply.launches += 1
    return y


softmax_gate_apply.launches = 0


def _stats_operand(name, s, n, cout, device):
    if tuple(s.shape) != (n, 1, cout) or s.device != device:
        raise ValueError(f"{name} must be (N, 1, Cout) on {device}")
    return s.detach().float().contiguous()


def _grad_operand(x2d, dy2d):
    if tuple(dy2d.shape) != tuple(x2d.shape) or dy2d.device != x2d.device:
        raise ValueError(f"dy must be {tuple(x2d.shape)} on {x2d.device}")
    return dy2d.detach().to(x2d.dtype).contiguous()


def _bwd_operands(x2d, dy2d, pos_proj, w1x, b1, w2, b2, m, se, act):
    if act not in BWD_ACTS:
        raise ValueError(f"no backward kernel for activation {act!r} "
                         f"(kernels: {BWD_ACTS})")
    ops = _kernel_operands(x2d, pos_proj, w1x, b1, w2, b2, act)
    n, _, _ = x2d.shape
    cout = w2.shape[1]
    return (ops[0], _grad_operand(x2d, dy2d), *ops[1:],
            _stats_operand("m", m, n, cout, x2d.device),
            _stats_operand("se", se, n, cout, x2d.device))


def softmax_gate_csum(x2d, dy2d, pos_proj, w1x, b1, w2, b2, m, se, *, act,
                      leaky_slope, hw_scale, gate_max):
    """c (N, 1, Cout) f32, backward pass A. CUDA tensors: the csum kernel
    and a fixed-order reduction of its per-tile partials (replaces
    `_softmax_csum_kernel`); CPU tensors: the plain version."""
    if x2d.device.type == "cpu":
        return softmax_gate_csum_reference(
            x2d, dy2d, pos_proj, w1x, b1, w2, b2, m, se, act=act,
            leaky_slope=leaky_slope, hw_scale=hw_scale, gate_max=gate_max)
    if x2d.device.type != "cuda":
        raise ValueError(f"no kernel for device {x2d.device}")
    ops = _bwd_operands(x2d, dy2d, pos_proj, w1x, b1, w2, b2, m, se, act)
    n, hw, c = x2d.shape
    hd, cout = w1x.shape[1], w2.shape[1]
    lib = _library()
    t = _tile_for(lib, c, hd, cout)
    tiles = -(-hw // t)
    with torch.cuda.device(x2d.device):
        f32 = dict(dtype=torch.float32, device=x2d.device)
        part_c = torch.empty((n, tiles, cout), **f32)
        csum = torch.empty((n, 1, cout), **f32)
        stream = torch.cuda.current_stream(x2d.device).cuda_stream
        err = lib.locate_softmax_csum(
            int(x2d.dtype == torch.bfloat16), *(o.data_ptr() for o in ops),
            part_c.data_ptr(), csum.data_ptr(), n, hw, c, hd, cout, t,
            ACT_CODES[act], float(leaky_slope), float(hw_scale), float(gate_max),
            stream)
    _check(lib, err, "softmax csum")
    softmax_gate_csum.launches += 1
    return csum


softmax_gate_csum.launches = 0


def bwd_grid(n: int, hw: int, c: int) -> Tuple[int, int]:
    """(tile rows, batch rows per block) of the backward kernel: the
    forward's tile, halved (to a multiple of 4, at least 4) while the grid
    has fewer than `_BWD_TARGET_BLOCKS` one-row blocks; then as many batch
    rows per block as keep it at about that many blocks. Every extra row
    per block shrinks the weight-gradient workspace by one block's slice."""
    t = tile_rows(c)
    while t > 4 and -(-hw // t) * n < _BWD_TARGET_BLOCKS:
        t = max(4, t // 2 // 4 * 4)
    tiles = -(-hw // t)
    nb = min(n, max(1, -(-_BWD_TARGET_BLOCKS // tiles)))
    return t, -(-n // nb)


def softmax_gate_backward(x2d, dy2d, pos_proj, w1x, b1, w2, b2, m, se, csum, *, act,
                          leaky_slope, hw_scale, gate_max):
    """(dx, dpos_proj, dW1x, db1, dW2, db2), backward pass B, each cast to
    its input's dtype. CUDA tensors: the backward kernel and two
    fixed-order reductions of its per-block partials (replaces
    `_bwd_kernel_softmax`); CPU tensors: the plain version."""
    if x2d.device.type == "cpu":
        return softmax_gate_backward_reference(
            x2d, dy2d, pos_proj, w1x, b1, w2, b2, m, se, csum, act=act,
            leaky_slope=leaky_slope, hw_scale=hw_scale, gate_max=gate_max)
    if x2d.device.type != "cuda":
        raise ValueError(f"no kernel for device {x2d.device}")
    ops = _bwd_operands(x2d, dy2d, pos_proj, w1x, b1, w2, b2, m, se, act)
    n, hw, c = x2d.shape
    hd, cout = w1x.shape[1], w2.shape[1]
    csum = _stats_operand("c", csum, n, cout, x2d.device)
    lib = _library()
    t, rows = bwd_grid(n, hw, c)
    smem = lib.locate_softmax_bwd_smem_bytes(c, hd, cout, t)
    if smem > _MAX_SMEM:
        raise ValueError(f"C={c}, Hd={hd}, Cout={cout} needs {smem} bytes of shared "
                         f"memory per backward block, over the card's {_MAX_SMEM}")
    tiles, nb = -(-hw // t), -(-n // rows)
    sizes = (c * hd, hd * cout, hd, cout)
    with torch.cuda.device(x2d.device):
        f32 = dict(dtype=torch.float32, device=x2d.device)
        dx = torch.empty_like(ops[0])
        part_w = torch.empty((tiles * nb, sum(sizes)), **f32)
        part_pp = torch.empty((nb, hw, hd), **f32)
        dw = torch.empty(sum(sizes), **f32)
        dpp = torch.empty((hw, hd), **f32)
        stream = torch.cuda.current_stream(x2d.device).cuda_stream
        err = lib.locate_softmax_bwd(
            int(x2d.dtype == torch.bfloat16), *(o.data_ptr() for o in ops),
            csum.data_ptr(), dx.data_ptr(), part_w.data_ptr(), part_pp.data_ptr(),
            dw.data_ptr(), dpp.data_ptr(), n, hw, c, hd, cout, t, rows,
            ACT_CODES[act], float(leaky_slope), float(hw_scale), float(gate_max),
            stream)
    _check(lib, err, "softmax backward")
    softmax_gate_backward.launches += 1
    dw1, dw2, db1, db2 = dw.split(sizes)
    return (dx, dpp.to(pos_proj.dtype), dw1.view(c, hd).to(w1x.dtype), db1.to(b1.dtype),
            dw2.view(hd, cout).to(w2.dtype), db2.to(b2.dtype))


softmax_gate_backward.launches = 0


class SoftmaxGate(torch.autograd.Function):
    """y = x * min(softmax_HW(l) * HW, gate_max), first-order only: the
    counterpart of `_make_fused_core`'s custom_vjp. Forward: the stats and
    apply passes, saving (x, pos_proj, w1x, b1, w2, b2, m, se). Backward:
    the csum and backward passes for leaky_relu and relu; for the other
    activations the vjp of the plain composition. Differentiating the
    backward again raises (`once_differentiable`): second-order terms
    such as R1 go through the plain composition instead."""

    @staticmethod
    def forward(ctx, x2d, pos_proj, w1x, b1, w2, b2, act, leaky_slope, hw_scale,
                gate_max):
        kw = dict(act=act, leaky_slope=leaky_slope)
        m, se = softmax_gate_stats(x2d, pos_proj, w1x, b1, w2, b2, **kw)
        y = softmax_gate_apply(x2d, pos_proj, w1x, b1, w2, b2, m, se,
                               hw_scale=hw_scale, gate_max=gate_max, **kw)
        ctx.save_for_backward(x2d, pos_proj, w1x, b1, w2, b2, m, se)
        ctx.options = dict(act=act, leaky_slope=leaky_slope, hw_scale=hw_scale,
                           gate_max=gate_max)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x2d, pos_proj, w1x, b1, w2, b2, m, se = ctx.saved_tensors
        opts = ctx.options
        if opts["act"] in BWD_ACTS:
            c = softmax_gate_csum(x2d, dy, pos_proj, w1x, b1, w2, b2, m, se, **opts)
            grads = softmax_gate_backward(x2d, dy, pos_proj, w1x, b1, w2, b2, m, se,
                                          c, **opts)
        else:
            inputs = [t.detach().requires_grad_(True)
                      for t in (x2d, pos_proj, w1x, b1, w2, b2)]
            with torch.enable_grad():
                y = locate_attention_core_reference(*inputs, mode="softmax", **opts)
                grads = torch.autograd.grad(y, inputs, dy)
        return (*grads, None, None, None, None)


def fused_locate_attention(
    x: torch.Tensor,         # (N, H, W, C)
    pos_proj: torch.Tensor,  # (H*W, Hd)
    w1x: torch.Tensor,       # (C, Hd)
    b1: torch.Tensor,        # (Hd,)
    w2: torch.Tensor,        # (Hd, Cout)
    b2: torch.Tensor,        # (Cout,)
    *,
    mode: str = "softmax",
    act: str = "leaky_relu",
    leaky_slope: float = 0.2,
    gate_max: float = 0.0,
) -> torch.Tensor:
    """Residual-form location attention of an NHWC tensor through
    `SoftmaxGate`: the four kernels for CUDA tensors, their plain versions
    for CPU ones. Differentiable to first order only."""
    n, h, w, c = x.shape
    hw = float(h * w)
    x2d = x.reshape(n, h * w, c)
    if mode != "softmax":
        if x.device.type != "cpu":
            raise NotImplementedError(
                f"mode={mode!r}: the sigmoid gate's kernel (_sigmoid_kernel) is "
                "not ported yet (ROADMAP.md, Queue 2)")
        y = locate_attention_core_reference(
            x2d, pos_proj, w1x, b1, w2, b2, mode=mode, act=act,
            leaky_slope=leaky_slope, hw_scale=hw, gate_max=gate_max)
        return y.reshape(x.shape)
    y = SoftmaxGate.apply(x2d, pos_proj, w1x, b1, w2, b2, act, float(leaky_slope),
                          hw, float(gate_max))
    return y.reshape(x.shape)
