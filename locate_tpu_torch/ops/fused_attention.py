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

`softmax_gate_stats` and `softmax_gate_apply` launch the kernels of
`csrc/fused_attention.cu` for CUDA tensors (forward only) and run the
plain version for CPU tensors; nothing falls back from one to the other.
Each wrapper counts its kernel launches in its `launches` attribute.
The sigmoid gate's one-pass kernel and every backward kernel are not
ported yet (ROADMAP.md, Queue 2).
"""

from __future__ import annotations

import ctypes
from typing import Callable, Tuple

import torch

from locate_tpu_torch.ops.activations import act_fn
from locate_tpu_torch.ops.cuda import build

# activation codes of csrc/fused_attention.cu
ACT_CODES = {"leaky_relu": 0, "relu": 1, "silu": 2, "gelu": 3}

# shared memory a block may use on sm_90 (227 KB)
_MAX_SMEM = 232448


def _act(kind: str, slope: float) -> Callable[[torch.Tensor], torch.Tensor]:
    """The four activations the kernels implement (`_act` of the JAX module)."""
    if kind not in ACT_CODES:
        raise ValueError(f"unsupported activation for fused attention: {kind!r}")
    return act_fn(kind, slope)


def _clamp_gate(g: torch.Tensor, gate_max: float) -> torch.Tensor:
    """Cap the gate at `gate_max` (0 = off)."""
    return g.clamp(max=gate_max) if gate_max > 0.0 else g


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
        lib.locate_softmax_smem_bytes.argtypes = [i] * 4
        lib.locate_softmax_smem_bytes.restype = ctypes.c_size_t
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
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (x2d, *tensors.values())
    ):
        raise NotImplementedError(
            "the CUDA location-attention kernels are forward-only: run under "
            "torch.inference_mode() (the backward kernels come with the "
            "training slice, ROADMAP.md Queue 2)"
        )
    cd = x2d.dtype
    return (
        x2d.contiguous(),
        pos_proj.float().contiguous(),
        w1x.to(cd).contiguous(),
        b1.float().contiguous(),
        w2.to(cd).contiguous(),
        b2.float().contiguous(),
    )


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
    for name, s in (("m", m), ("se", se)):
        if tuple(s.shape) != (n, 1, cout) or s.device != x2d.device:
            raise ValueError(f"{name} must be (N, 1, Cout) on {x2d.device}")
    m = m.float().contiguous()
    se = se.float().contiguous()
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
    """Residual-form location attention of an NHWC tensor: the two kernels
    (stats, then apply) for CUDA tensors, the plain version for CPU ones."""
    n, h, w, c = x.shape
    hw = float(h * w)
    x2d = x.reshape(n, h * w, c)
    if x.device.type == "cpu":
        y = locate_attention_core_reference(
            x2d, pos_proj, w1x, b1, w2, b2, mode=mode, act=act,
            leaky_slope=leaky_slope, hw_scale=hw, gate_max=gate_max)
        return y.reshape(x.shape)
    if mode != "softmax":
        raise NotImplementedError(
            f"mode={mode!r}: the sigmoid gate's kernel (_sigmoid_kernel) is not "
            "ported yet (ROADMAP.md, Queue 2)"
        )
    m, se = softmax_gate_stats(x2d, pos_proj, w1x, b1, w2, b2, act=act,
                               leaky_slope=leaky_slope)
    y = softmax_gate_apply(x2d, pos_proj, w1x, b1, w2, b2, m, se, act=act,
                           leaky_slope=leaky_slope, hw_scale=hw,
                           gate_max=gate_max)
    return y.reshape(x.shape)
