"""Location-attention gate, softmax and sigmoid: plain PyTorch versions and
the wrappers of their Hopper kernels. Counterpart of
`locate_tpu/ops/pallas/fused_attention.py`.

The gate is the per-location MLP

    u = x @ W1x + pos_proj + b1      (HW, Hd)   per location
    h = act(u)                       rounded to the compute dtype
    l = h @ W2 + b2                  (HW, Cout) per location, f32
    g = min(softmax_HW(l) * HW, gate_max)   or   min(2 sigmoid(l), gate_max)
    y = x * g

with x (N, HW, C) in the compute dtype, W1x (C, Hd) and W2 (Hd, Cout)
cast to it, and pos_proj, the biases and the gate math in f32.

Six wrappers launch the kernels of `csrc/fused_attention.cu` for CUDA
tensors and run the plain version for CPU tensors; nothing falls back
from one to the other. Softmax forward: `softmax_gate_stats` and
`softmax_gate_apply`; backward: `softmax_gate_csum` (pass A, the
per-(n, channel) sum c of the softmax Jacobian) and
`softmax_gate_backward` (pass B, dx and every weight gradient). Sigmoid,
each one pass: `sigmoid_gate` and `sigmoid_gate_backward`. Each wrapper
counts its kernel launches in its `launches` attribute.

The softmax gate's forward pair, `softmax_gate_stats` and
`softmax_gate_apply`, and its csum pass, `softmax_gate_csum`, have two
routes, which `gate_fwd_route` picks: "mma" on the tensor cores for bf16
at (C, Hd, Cout) = (64, 16, 64) with HW a multiple of 128
(`softmax_stats_mma`, `softmax_apply_mma` and `softmax_csum_mma`, one body
on the backward's logit core, so that stats, apply, csum and backward see
one l there), and "simt" for everything else, C = 512 included.
`sigmoid_gate` has two routes, which `sigmoid_gate_route` picks: "mma" for
bf16 at (512, 128, 512) with HW a multiple of 16
(`sigmoid_gate_wide_mma`, on the sigmoid backward's logit code), "simt"
for everything else.

The two backward wrappers, `softmax_gate_backward` and
`sigmoid_gate_backward`, have two routes each, which `gate_bwd_route` picks
from the dtype and the widths: "mma" on the tensor cores (bf16 at the
widths of `GATE_MMA_WIDTHS`: (C, Hd, Cout) = (64, 16, 64) with HW a
multiple of 128, `softmax_bwd_mma` and `sigmoid_bwd_mma`, one body; and
(512, 128, 512) with HW a multiple of 16, `softmax_bwd_wide_mma` and
`sigmoid_bwd_wide_mma`, one body, then the weight-gradient pass
`gate_wgrad_wide_mma`) and "simt" (f32 FMAs on the CUDA cores: f32, every
other width, a gate with Cout 1). Each route's launches are counted
apart too (`launches_mma`, `launches_simt`); `route="simt"` sends a bf16
call to the simt kernel, to compare the two on one card.
`fused_locate_attention` runs them through a first-order
`torch.autograd.Function` per mode, `SoftmaxGate` or `SigmoidGate`, as
`_make_fused_core` does in JAX.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Optional, Tuple

import torch

from locate_tpu_torch.ops.activations import act_fn
from locate_tpu_torch.ops.cuda import build
from locate_tpu_torch.ops.first_order import first_order
# the two routes and their launch counting are the flash wrappers' own
from locate_tpu_torch.ops.flash_attention import _ROUTE_CODE, MMA, SIMT, _count, define_op

# activation codes of csrc/fused_attention.cu
ACT_CODES = {"leaky_relu": 0, "relu": 1, "silu": 2, "gelu": 3}

# activations whose backward runs the kernels (`_PALLAS_BWD_ACTS`); the
# others take the vjp of the plain composition, as JAX does
BWD_ACTS = ("leaky_relu", "relu")

# shared memory a block may use on sm_90 (227 KB)
_MAX_SMEM = 232448

# blocks the backward kernel aims for: two per SM of the H100's 132
_BWD_TARGET_BLOCKS = 264

# the (C, Hd, Cout) of the backward's mma templates (csrc/fused_attention.cu),
# each with the locations that must divide HW: gate_bwd_mma's 128-location
# tile at the 64-channel stages' gate, gate_bwd_wide's 16-row m-tiles at
# the 512-channel stages' gate
GATE_MMA_TILE = 128
GATE_WIDE = (512, 128, 512)
GATE_MMA_WIDTHS = {(64, 16, 64): GATE_MMA_TILE, GATE_WIDE: 16}
# rows of the wide template's location block, and of a weight-gradient stage
GATE_WIDE_ROWS = 32
GATE_WIDE_STAGE = 64
# the (C, Hd, Cout) of the forward pair's mma template (gate_fwd_mma), whose
# 128-location tile must divide HW
GATE_FWD_MMA_WIDTHS = (64, 16, 64)
# the passes of gate_fwd_mma, as the C interface numbers them
_FWD_PASS = {"stats": 0, "apply": 1, "csum": 2}


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


def _recompute(x2d, pos_proj, w1x, b1, w2, b2, act, leaky_slope):
    """(xf, w1c, w2c, u, h, l) of `_bwd_body`'s recomputed forward in f32,
    h rounded to the compute dtype."""
    cd = x2d.dtype
    xf = x2d.float()
    w1c, w2c = w1x.to(cd).float(), w2.to(cd).float()
    u = xf @ w1c + pos_proj.float() + b1.float()
    h = _act(act, leaky_slope)(u).to(cd).float()
    return xf, w1c, w2c, u, h, h @ w2c + b2.float()


def _mlp_backward(x2d, dyf, pos_proj, w1x, b1, w2, b2, xf, w1c, w2c, u, h, ghat, dl, act,
                  leaky_slope):
    """`_bwd_body` after dl: dl and du rounded to the compute dtype before
    their products; dx in the compute dtype; the parameter gradients summed
    in f32 and cast to their parameters' dtypes."""
    cd = x2d.dtype
    dlc = dl.to(cd).float()
    du = _act_grad(act, leaky_slope)(u) * (dlc @ w2c.t())
    duc = du.to(cd).float()
    dx = (ghat * dyf + duc @ w1c.t()).to(cd)
    dw1 = torch.einsum("nsc,nsh->ch", xf, duc)
    dw2 = torch.einsum("nsh,nsc->hc", h, dlc)
    return (dx, du.sum(dim=0).to(pos_proj.dtype), dw1.to(w1x.dtype),
            du.sum(dim=(0, 1)).to(b1.dtype), dw2.to(w2.dtype),
            dl.sum(dim=(0, 1)).to(b2.dtype))


def softmax_gate_backward_reference(x2d, dy2d, pos_proj, w1x, b1, w2, b2, m, se, c, *,
                                    act, leaky_slope, hw_scale, gate_max):
    """(dx, dpos_proj, dW1x, db1, dW2, db2), mirroring `_bwd_body`'s softmax
    branch step by step."""
    xf, w1c, w2c, u, h, l = _recompute(x2d, pos_proj, w1x, b1, w2, b2, act, leaky_slope)
    dyf = dy2d.float()
    g = torch.exp(l - m) / se * hw_scale
    # c was summed from the masked dg, so only the local dg needs the mask
    dl = g * (_gate_mask(g, gate_max) * _dgate(xf, dyf, l.shape[-1])) - (g / hw_scale) * c
    return _mlp_backward(x2d, dyf, pos_proj, w1x, b1, w2, b2, xf, w1c, w2c, u, h,
                         _clamp_gate(g, gate_max), dl, act, leaky_slope)


def sigmoid_gate_reference(x2d, pos_proj, w1x, b1, w2, b2, *, act, leaky_slope,
                           gate_max) -> torch.Tensor:
    """`_sigmoid_kernel`: y = x * min(2 sigmoid(l), gate_max) in x's dtype."""
    return locate_attention_core_reference(x2d, pos_proj, w1x, b1, w2, b2, mode="sigmoid",
                                           act=act, leaky_slope=leaky_slope, hw_scale=1.0,
                                           gate_max=gate_max)


def sigmoid_gate_backward_reference(x2d, dy2d, pos_proj, w1x, b1, w2, b2, *, act,
                                    leaky_slope, gate_max):
    """(dx, dpos_proj, dW1x, db1, dW2, db2), mirroring `_bwd_body`'s sigmoid
    branch step by step: p = sigmoid(l), g = 2p, dl = 2p(1 - p) * mask * dg."""
    xf, w1c, w2c, u, h, l = _recompute(x2d, pos_proj, w1x, b1, w2, b2, act, leaky_slope)
    dyf = dy2d.float()
    p = torch.sigmoid(l)
    g = 2.0 * p
    dl = 2.0 * p * (1.0 - p) * (_gate_mask(g, gate_max) * _dgate(xf, dyf, l.shape[-1]))
    return _mlp_backward(x2d, dyf, pos_proj, w1x, b1, w2, b2, xf, w1c, w2c, u, h,
                         _clamp_gate(g, gate_max), dl, act, leaky_slope)


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
        lib.locate_softmax_stats.argtypes = [i, i] + [p] * 10 + [i] * 7 + [f, p]
        lib.locate_softmax_stats.restype = i
        lib.locate_softmax_apply.argtypes = [i, i] + [p] * 9 + [i] * 7 + [f, f, f, p]
        lib.locate_softmax_apply.restype = i
        lib.locate_softmax_csum.argtypes = [i, i] + [p] * 11 + [i] * 7 + [f, f, f, p]
        lib.locate_softmax_csum.restype = i
        lib.locate_softmax_bwd.argtypes = [i, i] + [p] * 15 + [i] * 8 + [f, f, f, p]
        lib.locate_softmax_bwd.restype = i
        lib.locate_sigmoid_gate.argtypes = [i, i] + [p] * 7 + [i] * 8 + [f, f, p]
        lib.locate_sigmoid_gate.restype = i
        lib.locate_sigmoid_bwd.argtypes = [i, i] + [p] * 12 + [i] * 8 + [f, f, p]
        lib.locate_sigmoid_bwd.restype = i
        lib.locate_softmax_smem_bytes.argtypes = [i] * 4
        lib.locate_softmax_smem_bytes.restype = ctypes.c_size_t
        lib.locate_softmax_bwd_smem_bytes.argtypes = [i] * 4
        lib.locate_softmax_bwd_smem_bytes.restype = ctypes.c_size_t
        lib.locate_softmax_fwd_mma_smem_bytes.argtypes = [i] * 4
        lib.locate_softmax_fwd_mma_smem_bytes.restype = ctypes.c_size_t
        lib.locate_softmax_fwd_mma_blocks_per_sm.argtypes = [i] * 4
        lib.locate_softmax_fwd_mma_blocks_per_sm.restype = i
        lib.locate_softmax_bwd_mma_smem_bytes.argtypes = [i] * 3
        lib.locate_softmax_bwd_mma_smem_bytes.restype = ctypes.c_size_t
        lib.locate_softmax_bwd_mma_blocks_per_sm.argtypes = [i] * 4
        lib.locate_softmax_bwd_mma_blocks_per_sm.restype = i
        lib.locate_sigmoid_gate_mma_smem_bytes.argtypes = [i] * 3
        lib.locate_sigmoid_gate_mma_smem_bytes.restype = ctypes.c_size_t
        lib.locate_sigmoid_gate_mma_blocks_per_sm.argtypes = [i] * 3
        lib.locate_sigmoid_gate_mma_blocks_per_sm.restype = i
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


def gate_fwd_route(dtype: torch.dtype, hw: int, c: int, hd: int, cout: int) -> str:
    """The kernel of the softmax gate's forward pair and its csum pass
    (`softmax_gate_stats`, `softmax_gate_apply`, `softmax_gate_csum`): "mma"
    for bf16 at (C, Hd, Cout) = `GATE_FWD_MMA_WIDTHS` with HW a multiple of
    `GATE_MMA_TILE`, "simt" otherwise (f32, a gate with Cout 1, C = 128, 256
    and 512). Only that width: there the forward's l is the backward's
    (`gate_mlp_mma`, the stats, apply, csum and mma backward all computing
    it alike), so m, se, c and the backward's g come from one l. At C = 512
    the backward's mma route recomputes l in the simt stats pass's FMA
    order, bit for bit the l that gave m, se and c, because a saturated gate
    moves with any other summation order; a tensor-core stats or csum pass
    there would break that, so C = 512's forward and csum move only
    together with its backward."""
    if (dtype == torch.bfloat16 and (c, hd, cout) == GATE_FWD_MMA_WIDTHS
            and hw % GATE_MMA_TILE == 0):
        return MMA
    return SIMT


def _fwd_route_of(route: Optional[str], x2d, w1x, w2) -> str:
    """`route` of a forward call, or `gate_fwd_route`'s choice where it is
    None; a route the call cannot take raises."""
    if x2d.dim() != 3:
        raise ValueError(f"x2d must be (N, HW, C), got {tuple(x2d.shape)}")
    _, hw, c = x2d.shape
    hd, cout = w1x.shape[1], w2.shape[1]
    return _route_of(route, gate_fwd_route, {GATE_FWD_MMA_WIDTHS: GATE_MMA_TILE}, x2d.dtype,
                     hw, c, hd, cout)


def fwd_mma_rows(n: int, hw: int, slots: int) -> int:
    """Locations a block of the forward's mma route takes (whole
    128-location tiles of one batch row): as many as keep the grid
    (ceil(HW / rows), N) within `slots` blocks (the blocks that fit on the
    card at once) where the batch allows, one tile at least."""
    tiles = hw // GATE_MMA_TILE
    groups = max(1, min(tiles, slots // n))
    return -(-tiles // groups) * GATE_MMA_TILE


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _fwd_slots(device_index: int, kind: str) -> int:
    """Blocks of the forward body's mma kernel of pass `kind` ("stats",
    "apply" or "csum": `softmax_stats_mma`, `softmax_apply_mma`,
    `softmax_csum_mma`) that fit on the card at once."""
    per_sm = _library().locate_softmax_fwd_mma_blocks_per_sm(_FWD_PASS[kind],
                                                             *GATE_FWD_MMA_WIDTHS)
    if per_sm < 1:
        raise RuntimeError(f"softmax {kind} (mma): no block fits on an SM ({per_sm})")
    return _sm_count(device_index) * per_sm


def _fwd_rows(lib, x2d, w1x, w2, route: str, kind: str) -> int:
    """Locations a block of pass `kind` takes on `route`: the mma route's
    run of tiles (`fwd_mma_rows`), or the simt kernels' tile."""
    n, hw, c = x2d.shape
    if route == MMA:
        return fwd_mma_rows(n, hw, _fwd_slots(x2d.device.index, kind))
    return _tile_for(lib, c, w1x.shape[1], w2.shape[1])


def _fwd_launch(x2d, pos_proj, w1x, b1, w2, b2, act, route: str, kind: str):
    """(operands, library, locations a block) of a forward call on the
    card on `route`."""
    ops = _aligned(_kernel_operands(x2d, pos_proj, w1x, b1, w2, b2, act), route)
    lib = _library()
    return ops, lib, _fwd_rows(lib, x2d, w1x, w2, route, kind)


def _stats_shape(x2d, w2):
    return (x2d.shape[0], 1, w2.shape[1])


def _softmax_gate_stats_cpu(x2d, pos_proj, w1x, b1, w2, b2, act, leaky_slope, route):
    _fwd_route_of(route, x2d, w1x, w2)
    return softmax_gate_stats_reference(x2d, pos_proj, w1x, b1, w2, b2, act=act,
                                        leaky_slope=leaky_slope)


def _softmax_gate_stats_fake(x2d, pos_proj, w1x, b1, w2, b2, act, leaky_slope, route):
    _fwd_route_of(route, x2d, w1x, w2)
    shape = _stats_shape(x2d, w2)
    return (x2d.new_empty(shape, dtype=torch.float32),
            x2d.new_empty(shape, dtype=torch.float32))


def _softmax_gate_stats_cuda(x2d, pos_proj, w1x, b1, w2, b2, act, leaky_slope, route):
    route = _fwd_route_of(route, x2d, w1x, w2)
    ops, lib, t = _fwd_launch(x2d, pos_proj, w1x, b1, w2, b2, act, route, "stats")
    n, hw, c = x2d.shape
    hd, cout = w1x.shape[1], w2.shape[1]
    blocks = -(-hw // t)
    with torch.cuda.device(x2d.device):
        f32 = dict(dtype=torch.float32, device=x2d.device)
        part_m = torch.empty((n, blocks, cout), **f32)
        part_s = torch.empty((n, blocks, cout), **f32)
        m = torch.empty((n, 1, cout), **f32)
        se = torch.empty((n, 1, cout), **f32)
        stream = torch.cuda.current_stream(x2d.device).cuda_stream
        err = lib.locate_softmax_stats(
            _ROUTE_CODE[route], int(x2d.dtype == torch.bfloat16), *(o.data_ptr() for o in ops),
            part_m.data_ptr(), part_s.data_ptr(), m.data_ptr(), se.data_ptr(),
            n, hw, c, hd, cout, t, ACT_CODES[act], float(leaky_slope), stream)
    _check(lib, err, f"softmax stats ({route})")
    _count(softmax_gate_stats, route)
    return m, se


_GATE = "Tensor pos_proj, Tensor w1x, Tensor b1, Tensor w2, Tensor b2"
_SOFTMAX_GATE_STATS = define_op(
    f"softmax_gate_stats(Tensor x2d, {_GATE}, str act, float leaky_slope, str? route) "
    "-> (Tensor, Tensor)",
    _softmax_gate_stats_cpu, _softmax_gate_stats_cuda, _softmax_gate_stats_fake)


def softmax_gate_stats(x2d, pos_proj, w1x, b1, w2, b2, *, act, leaky_slope, route=None):
    """(m, se), each (N, 1, Cout) f32, `torch.ops.locate.softmax_gate_stats`.
    CUDA tensors: the stats kernel on `route` (`gate_fwd_route`'s choice
    unless given: `softmax_stats_mma` on the tensor cores or the simt
    `softmax_stats_partial`) and the merge of its per-block partials
    (replaces `_softmax_stats_kernel`); CPU tensors: the plain version (a
    route the call cannot take raises on both)."""
    return _SOFTMAX_GATE_STATS(x2d, pos_proj, w1x, b1, w2, b2, act, float(leaky_slope), route)


softmax_gate_stats.launches = 0
softmax_gate_stats.launches_mma = softmax_gate_stats.launches_simt = 0


def _softmax_gate_apply_cpu(x2d, pos_proj, w1x, b1, w2, b2, m, se, act, leaky_slope,
                            hw_scale, gate_max, route):
    _fwd_route_of(route, x2d, w1x, w2)
    return softmax_gate_apply_reference(x2d, pos_proj, w1x, b1, w2, b2, m, se, act=act,
                                        leaky_slope=leaky_slope, hw_scale=hw_scale,
                                        gate_max=gate_max)


def _softmax_gate_apply_fake(x2d, pos_proj, w1x, b1, w2, b2, m, se, act, leaky_slope,
                             hw_scale, gate_max, route):
    _fwd_route_of(route, x2d, w1x, w2)
    return x2d.new_empty(x2d.shape)


def _softmax_gate_apply_cuda(x2d, pos_proj, w1x, b1, w2, b2, m, se, act, leaky_slope,
                             hw_scale, gate_max, route):
    route = _fwd_route_of(route, x2d, w1x, w2)
    ops, lib, t = _fwd_launch(x2d, pos_proj, w1x, b1, w2, b2, act, route, "apply")
    n, hw, c = x2d.shape
    hd, cout = w1x.shape[1], w2.shape[1]
    m = _stats_operand("m", m, n, cout, x2d.device)
    se = _stats_operand("se", se, n, cout, x2d.device)
    with torch.cuda.device(x2d.device):
        y = torch.empty_like(ops[0])
        stream = torch.cuda.current_stream(x2d.device).cuda_stream
        err = lib.locate_softmax_apply(
            _ROUTE_CODE[route], int(x2d.dtype == torch.bfloat16), *(o.data_ptr() for o in ops),
            m.data_ptr(), se.data_ptr(), y.data_ptr(),
            n, hw, c, hd, cout, t, ACT_CODES[act], float(leaky_slope),
            float(hw_scale), float(gate_max), stream)
    _check(lib, err, f"softmax apply ({route})")
    _count(softmax_gate_apply, route)
    return y


_SOFTMAX_GATE_APPLY = define_op(
    f"softmax_gate_apply(Tensor x2d, {_GATE}, Tensor m, Tensor se, str act, "
    "float leaky_slope, float hw_scale, float gate_max, str? route) -> Tensor",
    _softmax_gate_apply_cpu, _softmax_gate_apply_cuda, _softmax_gate_apply_fake)


def softmax_gate_apply(x2d, pos_proj, w1x, b1, w2, b2, m, se, *, act,
                       leaky_slope, hw_scale, gate_max, route=None):
    """y (N, HW, C) in x's dtype, `torch.ops.locate.softmax_gate_apply`.
    CUDA tensors: the apply kernel on `route` (`gate_fwd_route`'s choice
    unless given: `softmax_apply_mma` on the tensor cores or the simt
    `softmax_apply`; replaces `_softmax_apply_kernel`); CPU tensors: the
    plain version (a route the call cannot take raises on both)."""
    return _SOFTMAX_GATE_APPLY(x2d, pos_proj, w1x, b1, w2, b2, m, se, act, float(leaky_slope),
                               float(hw_scale), float(gate_max), route)


softmax_gate_apply.launches = 0
softmax_gate_apply.launches_mma = softmax_gate_apply.launches_simt = 0


def _stats_operand(name, s, n, cout, device):
    if tuple(s.shape) != (n, 1, cout) or s.device != device:
        raise ValueError(f"{name} must be (N, 1, Cout) on {device}")
    return s.detach().float().contiguous()


def _grad_operand(x2d, dy2d):
    if tuple(dy2d.shape) != tuple(x2d.shape) or dy2d.device != x2d.device:
        raise ValueError(f"dy must be {tuple(x2d.shape)} on {x2d.device}")
    return dy2d.detach().to(x2d.dtype).contiguous()


def _bwd_operands(x2d, dy2d, pos_proj, w1x, b1, w2, b2, m, se, act):
    """The backward kernels' operands: x, dy, the gate's, and the softmax
    statistics m and se (None for the sigmoid gate, which has none)."""
    if act not in BWD_ACTS:
        raise ValueError(f"no backward kernel for activation {act!r} "
                         f"(kernels: {BWD_ACTS})")
    ops = _kernel_operands(x2d, pos_proj, w1x, b1, w2, b2, act)
    n, _, _ = x2d.shape
    cout = w2.shape[1]
    stats = () if m is None else (_stats_operand("m", m, n, cout, x2d.device),
                                  _stats_operand("se", se, n, cout, x2d.device))
    return (ops[0], _grad_operand(x2d, dy2d), *ops[1:], *stats)


def _softmax_gate_csum_cpu(x2d, dy2d, pos_proj, w1x, b1, w2, b2, m, se, act, leaky_slope,
                           hw_scale, gate_max, route):
    _fwd_route_of(route, x2d, w1x, w2)
    return softmax_gate_csum_reference(x2d, dy2d, pos_proj, w1x, b1, w2, b2, m, se, act=act,
                                       leaky_slope=leaky_slope, hw_scale=hw_scale,
                                       gate_max=gate_max)


def _softmax_gate_csum_fake(x2d, dy2d, pos_proj, w1x, b1, w2, b2, m, se, act, leaky_slope,
                            hw_scale, gate_max, route):
    _fwd_route_of(route, x2d, w1x, w2)
    return x2d.new_empty(_stats_shape(x2d, w2), dtype=torch.float32)


def _softmax_gate_csum_cuda(x2d, dy2d, pos_proj, w1x, b1, w2, b2, m, se, act, leaky_slope,
                            hw_scale, gate_max, route):
    route = _fwd_route_of(route, x2d, w1x, w2)
    ops = _aligned(_bwd_operands(x2d, dy2d, pos_proj, w1x, b1, w2, b2, m, se, act), route)
    n, hw, c = x2d.shape
    hd, cout = w1x.shape[1], w2.shape[1]
    lib = _library()
    t = _fwd_rows(lib, x2d, w1x, w2, route, "csum")
    blocks = -(-hw // t)
    with torch.cuda.device(x2d.device):
        f32 = dict(dtype=torch.float32, device=x2d.device)
        part_c = torch.empty((n, blocks, cout), **f32)
        csum = torch.empty((n, 1, cout), **f32)
        stream = torch.cuda.current_stream(x2d.device).cuda_stream
        err = lib.locate_softmax_csum(
            _ROUTE_CODE[route], int(x2d.dtype == torch.bfloat16), *(o.data_ptr() for o in ops),
            part_c.data_ptr(), csum.data_ptr(), n, hw, c, hd, cout, t,
            ACT_CODES[act], float(leaky_slope), float(hw_scale), float(gate_max),
            stream)
    _check(lib, err, f"softmax csum ({route})")
    _count(softmax_gate_csum, route)
    return csum


_SOFTMAX_GATE_CSUM = define_op(
    f"softmax_gate_csum(Tensor x2d, Tensor dy2d, {_GATE}, Tensor m, Tensor se, str act, "
    "float leaky_slope, float hw_scale, float gate_max, str? route) -> Tensor",
    _softmax_gate_csum_cpu, _softmax_gate_csum_cuda, _softmax_gate_csum_fake)


def softmax_gate_csum(x2d, dy2d, pos_proj, w1x, b1, w2, b2, m, se, *, act,
                      leaky_slope, hw_scale, gate_max, route=None):
    """c (N, 1, Cout) f32, backward pass A, `torch.ops.locate.softmax_gate_csum`.
    CUDA tensors: the csum kernel on `route` (`gate_fwd_route`'s choice
    unless given, the forward pair's route, so that c comes from the l
    that gave m and se: `softmax_csum_mma` on the tensor cores or the
    simt `softmax_csum_partial`) and a fixed-order reduction of its
    per-block partials (replaces `_softmax_csum_kernel`); CPU tensors:
    the plain version (a route the call cannot take raises on both)."""
    return _SOFTMAX_GATE_CSUM(x2d, dy2d, pos_proj, w1x, b1, w2, b2, m, se, act,
                              float(leaky_slope), float(hw_scale), float(gate_max), route)


softmax_gate_csum.launches = 0
softmax_gate_csum.launches_mma = softmax_gate_csum.launches_simt = 0


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


def gate_bwd_route(dtype: torch.dtype, hw: int, c: int, hd: int, cout: int) -> str:
    """The kernel of both gates' backward (`softmax_gate_backward`,
    `sigmoid_gate_backward`): "mma" for bf16 at a template's (C, Hd, Cout)
    (`GATE_MMA_WIDTHS`) with HW a multiple of its tile, "simt" otherwise
    (f32 keeps its f32 products, every other width and a gate with Cout 1
    the simt kernel)."""
    tile = GATE_MMA_WIDTHS.get((c, hd, cout))
    if dtype == torch.bfloat16 and tile and hw % tile == 0:
        return MMA
    return SIMT


def _route_of(route: Optional[str], pick: Callable[..., str], widths: dict,
              dtype: torch.dtype, hw: int, c: int, hd: int, cout: int) -> str:
    """`route`, or `pick`'s choice (`gate_fwd_route` or `gate_bwd_route`)
    where it is None; a route the call cannot take raises, naming the
    mma templates' `widths` ({(C, Hd, Cout): the tile that divides HW})."""
    if route is None:
        return pick(dtype, hw, c, hd, cout)
    if route not in _ROUTE_CODE:
        raise ValueError(f"route must be {MMA!r} or {SIMT!r}, got {route!r}")
    if route == MMA and pick(dtype, hw, c, hd, cout) != MMA:
        names = ", ".join(f"{w} with HW a multiple of {t}" for w, t in widths.items())
        raise ValueError(f"the mma route takes bf16 at (C, Hd, Cout) = {names}; got {dtype}, "
                         f"HW={hw}, C={c}, Hd={hd}, Cout={cout}")
    return route


def _gate_route_of(route: Optional[str], dtype: torch.dtype, hw: int, c: int, hd: int,
                   cout: int) -> str:
    """`route` of a backward call, or `gate_bwd_route`'s choice where it is
    None; a route the call cannot take raises."""
    return _route_of(route, gate_bwd_route, GATE_MMA_WIDTHS, dtype, hw, c, hd, cout)


def bwd_mma_grid(n: int, hw: int, slots: int) -> int:
    """Batch rows per block of the mma route, whose grid is (HW / 128
    tiles, ceil(N / rows)): as many batch groups as keep the grid within
    `slots` blocks (the blocks that fit on the card at once), at least one,
    so that a block's weight-gradient sums stay in its registers over as
    many rows as one wave allows."""
    nb = min(n, max(1, slots // (hw // GATE_MMA_TILE)))
    return -(-n // nb)


def bwd_wide_grid(n: int, hw: int, c: int, hd: int, cout: int) -> Tuple[int, int, int]:
    """(splits, part_w floats, part_pp floats) of the mma route at the wide
    widths (`GATE_WIDE`). The location pass has ceil(N HW / 32) blocks;
    the weight-gradient pass splits the N HW locations (stages of 64) over
    as many blocks as make `_BWD_TARGET_BLOCKS` with the 64 x 64 tiles of
    dW1x and dW2, at most one a stage. part_w holds the splits' [dW1x | dW2]
    partials and the 16-row m-tiles' db2 partials; part_pp du in f32 and
    the bf16 scratches h, du (N HW, Hd) and dl (N HW, Cout), two to a
    float. A few MB where the simt kernel's slices take 135 MB."""
    rows = n * hw
    stages = -(-rows // GATE_WIDE_STAGE)
    tiles = (c // 64) * (hd // 64) + (hd // 64) * (cout // 64)
    splits = max(1, min(stages, _BWD_TARGET_BLOCKS // tiles))
    part_w = splits * (c * hd + hd * cout) + rows // 16 * cout
    part_pp = rows * hd + (2 * rows * hd + rows * cout) // 2
    return splits, part_w, part_pp


@functools.lru_cache(maxsize=None)
def _mma_slots(device_index: int, sigmoid: bool) -> int:
    """Blocks of the gate's mma backward kernel at (64, 16, 64)
    (`sigmoid_bwd_mma` or `softmax_bwd_mma`) that fit on the card at once."""
    per_sm = _library().locate_softmax_bwd_mma_blocks_per_sm(int(sigmoid), 64, 16, 64)
    if per_sm < 1:
        gate = "sigmoid" if sigmoid else "softmax"
        raise RuntimeError(f"{gate} backward (mma): no block fits on an SM ({per_sm})")
    return torch.cuda.get_device_properties(device_index).multi_processor_count * per_sm


def _launch_backward(fn: str, ops, x2d, w1x, w2, act, floats, route: str):
    """Run the backward kernel `fn` of the C interface (the softmax's or the
    sigmoid's) on `route` with its operands `ops` (x, dy, the gate's, and
    the softmax's statistics and c) and reduce its per-block partials:
    (dx, dpos_proj, dW1x, db1, dW2, db2) in f32 but dx, which is in x's
    dtype. `floats` follow the activation code in the kernel's
    arguments."""
    n, hw, c = x2d.shape
    hd, cout = w1x.shape[1], w2.shape[1]
    sizes = (c * hd, hd * cout, hd, cout)
    lib = _library()
    if route == MMA and (c, hd, cout) == GATE_WIDE:
        # rows: the weight-gradient pass's splits
        t, (rows, w_floats, pp_floats) = GATE_WIDE_ROWS, bwd_wide_grid(n, hw, c, hd, cout)
        smem = lib.locate_softmax_bwd_mma_smem_bytes(c, hd, cout)
    else:
        if route == MMA:
            slots = _mma_slots(x2d.device.index, fn == "locate_sigmoid_bwd")
            t, rows = GATE_MMA_TILE, bwd_mma_grid(n, hw, slots)
            smem = lib.locate_softmax_bwd_mma_smem_bytes(c, hd, cout)
        else:
            t, rows = bwd_grid(n, hw, c)
            smem = lib.locate_softmax_bwd_smem_bytes(c, hd, cout, t)
        nb = -(-n // rows)
        w_floats, pp_floats = -(-hw // t) * nb * sum(sizes), nb * hw * hd
    if smem > _MAX_SMEM:
        raise ValueError(f"C={c}, Hd={hd}, Cout={cout} needs {smem} bytes of shared "
                         f"memory per backward block, over the card's {_MAX_SMEM}")
    with torch.cuda.device(x2d.device):
        f32 = dict(dtype=torch.float32, device=x2d.device)
        dx = torch.empty_like(ops[0])
        part_w = torch.empty(w_floats, **f32)
        part_pp = torch.empty(pp_floats, **f32)
        dw = torch.empty(sum(sizes), **f32)
        dpp = torch.empty((hw, hd), **f32)
        stream = torch.cuda.current_stream(x2d.device).cuda_stream
        err = getattr(lib, fn)(
            _ROUTE_CODE[route], int(x2d.dtype == torch.bfloat16), *(o.data_ptr() for o in ops),
            dx.data_ptr(), part_w.data_ptr(), part_pp.data_ptr(), dw.data_ptr(), dpp.data_ptr(),
            n, hw, c, hd, cout, t, rows, ACT_CODES[act], *floats, stream)
    _check(lib, err, f"{fn} ({route})")
    dw1, dw2, db1, db2 = dw.split(sizes)
    return dx, dpp, dw1.view(c, hd), db1, dw2.view(hd, cout), db2


def _aligned(ops, route: str):
    """`ops`, each 16-byte aligned on the mma route (cp.async and ldmatrix
    move 16 bytes at a time)."""
    if route != MMA:
        return ops
    return tuple(o if o.data_ptr() % 16 == 0 else o.clone() for o in ops)


def _cast_grads(grads, pos_proj, w1x, b1, w2, b2):
    dx, dpp, dw1, db1, dw2, db2 = grads
    return (dx, dpp.to(pos_proj.dtype), dw1.to(w1x.dtype), db1.to(b1.dtype),
            dw2.to(w2.dtype), db2.to(b2.dtype))


def _bwd_route_of(route, x2d, w1x, w2) -> str:
    """`route` of a backward call, or `gate_bwd_route`'s choice (see
    `_gate_route_of`)."""
    if x2d.dim() != 3:
        raise ValueError(f"x2d must be (N, HW, C), got {tuple(x2d.shape)}")
    return _gate_route_of(route, x2d.dtype, x2d.shape[1], x2d.shape[2], w1x.shape[1],
                          w2.shape[1])


def _grads_fake(x2d, pos_proj, w1x, b1, w2, b2):
    """Empty (dx, dpos_proj, dW1x, db1, dW2, db2), each like its input."""
    return tuple(t.new_empty(t.shape) for t in (x2d, pos_proj, w1x, b1, w2, b2))


def _softmax_gate_backward_cpu(x2d, dy2d, pos_proj, w1x, b1, w2, b2, m, se, csum, act,
                               leaky_slope, hw_scale, gate_max, route):
    _bwd_route_of(route, x2d, w1x, w2)
    return softmax_gate_backward_reference(
        x2d, dy2d, pos_proj, w1x, b1, w2, b2, m, se, csum, act=act,
        leaky_slope=leaky_slope, hw_scale=hw_scale, gate_max=gate_max)


def _softmax_gate_backward_fake(x2d, dy2d, pos_proj, w1x, b1, w2, b2, m, se, csum, act,
                                leaky_slope, hw_scale, gate_max, route):
    _bwd_route_of(route, x2d, w1x, w2)
    return _grads_fake(x2d, pos_proj, w1x, b1, w2, b2)


def _softmax_gate_backward_cuda(x2d, dy2d, pos_proj, w1x, b1, w2, b2, m, se, csum, act,
                                leaky_slope, hw_scale, gate_max, route):
    route = _bwd_route_of(route, x2d, w1x, w2)
    ops = (*_bwd_operands(x2d, dy2d, pos_proj, w1x, b1, w2, b2, m, se, act),
           _stats_operand("c", csum, x2d.shape[0], w2.shape[1], x2d.device))
    grads = _launch_backward("locate_softmax_bwd", _aligned(ops, route), x2d, w1x, w2, act,
                             (float(leaky_slope), float(hw_scale), float(gate_max)), route)
    _count(softmax_gate_backward, route)
    return _cast_grads(grads, pos_proj, w1x, b1, w2, b2)


_GRADS = "(Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)"
_SOFTMAX_GATE_BACKWARD = define_op(
    f"softmax_gate_backward(Tensor x2d, Tensor dy2d, {_GATE}, Tensor m, Tensor se, "
    f"Tensor csum, str act, float leaky_slope, float hw_scale, float gate_max, str? route) "
    f"-> {_GRADS}",
    _softmax_gate_backward_cpu, _softmax_gate_backward_cuda, _softmax_gate_backward_fake)


def softmax_gate_backward(x2d, dy2d, pos_proj, w1x, b1, w2, b2, m, se, csum, *, act,
                          leaky_slope, hw_scale, gate_max, route=None):
    """(dx, dpos_proj, dW1x, db1, dW2, db2), backward pass B, each cast to
    its input's dtype, `torch.ops.locate.softmax_gate_backward`. CUDA
    tensors: the backward kernel on `route` (`gate_bwd_route`'s choice
    unless given: `softmax_bwd_mma` on the tensor cores or the simt
    `softmax_bwd`) and two fixed-order reductions of its per-block
    partials (replaces `_bwd_kernel_softmax`); CPU tensors: the plain
    version (a route the call cannot take raises on both)."""
    return _SOFTMAX_GATE_BACKWARD(x2d, dy2d, pos_proj, w1x, b1, w2, b2, m, se, csum, act,
                                  float(leaky_slope), float(hw_scale), float(gate_max), route)


softmax_gate_backward.launches = 0
softmax_gate_backward.launches_mma = softmax_gate_backward.launches_simt = 0


def sigmoid_gate_route(dtype: torch.dtype, hw: int, c: int, hd: int, cout: int) -> str:
    """The kernel of the sigmoid gate's forward (`sigmoid_gate`): "mma" for
    bf16 at (C, Hd, Cout) = `GATE_WIDE` with HW a multiple of the wide
    template's 16-row m-tile (`sigmoid_gate_wide_mma`, whose u, h and l are
    the sigmoid backward's code on the same route), "simt" otherwise (f32,
    a gate with Cout 1, C = 64, 128 and 256)."""
    if (dtype == torch.bfloat16 and (c, hd, cout) == GATE_WIDE
            and hw % GATE_MMA_WIDTHS[GATE_WIDE] == 0):
        return MMA
    return SIMT


def sigmoid_wide_splits(n: int, hw: int, sms: int) -> int:
    """Blocks a 32-row location block of the sigmoid gate's wide forward is
    split over (Cout's eight 64-column chunks shared out): the most of 8,
    4 and 2 that keeps the grid, ceil(N HW / 32) row blocks times the
    splits, within one block an SM of the card's `sms`, else 1. Each split
    computes u over all of W1x again, so blocks past one an SM share an SM
    and cost more than they hide."""
    rows = -(-n * hw // GATE_WIDE_ROWS)
    return next((s for s in (8, 4, 2) if rows * s <= sms), 1)


def _sigmoid_route_of(route, x2d, w1x, w2) -> str:
    """`route` of a `sigmoid_gate` call, or `sigmoid_gate_route`'s choice
    where it is None; a route the call cannot take raises."""
    if x2d.dim() != 3:
        raise ValueError(f"x2d must be (N, HW, C), got {tuple(x2d.shape)}")
    _, hw, c = x2d.shape
    return _route_of(route, sigmoid_gate_route, {GATE_WIDE: GATE_MMA_WIDTHS[GATE_WIDE]},
                     x2d.dtype, hw, c, w1x.shape[1], w2.shape[1])


def _sigmoid_gate_cpu(x2d, pos_proj, w1x, b1, w2, b2, act, leaky_slope, gate_max, route):
    _sigmoid_route_of(route, x2d, w1x, w2)
    return sigmoid_gate_reference(x2d, pos_proj, w1x, b1, w2, b2, act=act,
                                  leaky_slope=leaky_slope, gate_max=gate_max)


def _sigmoid_gate_fake(x2d, pos_proj, w1x, b1, w2, b2, act, leaky_slope, gate_max, route):
    _sigmoid_route_of(route, x2d, w1x, w2)
    return x2d.new_empty(x2d.shape)


def _sigmoid_gate_cuda(x2d, pos_proj, w1x, b1, w2, b2, act, leaky_slope, gate_max, route):
    route = _sigmoid_route_of(route, x2d, w1x, w2)
    ops = _aligned(_kernel_operands(x2d, pos_proj, w1x, b1, w2, b2, act), route)
    n, hw, c = x2d.shape
    hd, cout = w1x.shape[1], w2.shape[1]
    lib = _library()
    if route == MMA:
        t = GATE_WIDE_ROWS
        splits = sigmoid_wide_splits(n, hw, _sm_count(x2d.device.index))
    else:
        t, splits = _tile_for(lib, c, hd, cout), 1
    with torch.cuda.device(x2d.device):
        y = torch.empty_like(ops[0])
        stream = torch.cuda.current_stream(x2d.device).cuda_stream
        err = lib.locate_sigmoid_gate(
            _ROUTE_CODE[route], int(x2d.dtype == torch.bfloat16), *(o.data_ptr() for o in ops),
            y.data_ptr(), n, hw, c, hd, cout, t, splits, ACT_CODES[act], float(leaky_slope),
            float(gate_max), stream)
    _check(lib, err, f"sigmoid gate ({route})")
    _count(sigmoid_gate, route)
    return y


_SIGMOID_GATE = define_op(
    f"sigmoid_gate(Tensor x2d, {_GATE}, str act, float leaky_slope, float gate_max, "
    "str? route) -> Tensor", _sigmoid_gate_cpu, _sigmoid_gate_cuda, _sigmoid_gate_fake)


def sigmoid_gate(x2d, pos_proj, w1x, b1, w2, b2, *, act, leaky_slope, gate_max, route=None):
    """y (N, HW, C) in x's dtype, y = x * min(2 sigmoid(l), gate_max),
    `torch.ops.locate.sigmoid_gate`. CUDA tensors: the one-pass kernel on
    `route` (`sigmoid_gate_route`'s choice unless given:
    `sigmoid_gate_wide_mma` on the tensor cores, its grid split over Cout
    as `sigmoid_wide_splits` picks, or the simt `sigmoid_gate`; replaces
    `_sigmoid_kernel`); CPU tensors: the plain version (a route the call
    cannot take raises on both)."""
    return _SIGMOID_GATE(x2d, pos_proj, w1x, b1, w2, b2, act, float(leaky_slope),
                         float(gate_max), route)


sigmoid_gate.launches = 0
sigmoid_gate.launches_mma = sigmoid_gate.launches_simt = 0


def _sigmoid_gate_backward_cpu(x2d, dy2d, pos_proj, w1x, b1, w2, b2, act, leaky_slope,
                               gate_max, route):
    _bwd_route_of(route, x2d, w1x, w2)
    return sigmoid_gate_backward_reference(x2d, dy2d, pos_proj, w1x, b1, w2, b2, act=act,
                                           leaky_slope=leaky_slope, gate_max=gate_max)


def _sigmoid_gate_backward_fake(x2d, dy2d, pos_proj, w1x, b1, w2, b2, act, leaky_slope,
                                gate_max, route):
    _bwd_route_of(route, x2d, w1x, w2)
    return _grads_fake(x2d, pos_proj, w1x, b1, w2, b2)


def _sigmoid_gate_backward_cuda(x2d, dy2d, pos_proj, w1x, b1, w2, b2, act, leaky_slope,
                                gate_max, route):
    route = _bwd_route_of(route, x2d, w1x, w2)
    ops = _bwd_operands(x2d, dy2d, pos_proj, w1x, b1, w2, b2, None, None, act)
    grads = _launch_backward("locate_sigmoid_bwd", _aligned(ops, route), x2d, w1x, w2, act,
                             (float(leaky_slope), float(gate_max)), route)
    _count(sigmoid_gate_backward, route)
    return _cast_grads(grads, pos_proj, w1x, b1, w2, b2)


_SIGMOID_GATE_BACKWARD = define_op(
    f"sigmoid_gate_backward(Tensor x2d, Tensor dy2d, {_GATE}, str act, float leaky_slope, "
    f"float gate_max, str? route) -> {_GRADS}",
    _sigmoid_gate_backward_cpu, _sigmoid_gate_backward_cuda, _sigmoid_gate_backward_fake)


def sigmoid_gate_backward(x2d, dy2d, pos_proj, w1x, b1, w2, b2, *, act, leaky_slope,
                          gate_max, route=None):
    """(dx, dpos_proj, dW1x, db1, dW2, db2) of the sigmoid gate in one pass,
    each cast to its input's dtype, `torch.ops.locate.sigmoid_gate_backward`.
    CUDA tensors: the backward kernel on `route` (`gate_bwd_route`'s choice
    unless given: `sigmoid_bwd_mma` on the tensor cores or the simt
    `sigmoid_bwd`) and two fixed-order reductions of its per-block
    partials (replaces `_bwd_kernel_sigmoid`); CPU tensors: the plain
    version (a route the call cannot take raises on both)."""
    return _SIGMOID_GATE_BACKWARD(x2d, dy2d, pos_proj, w1x, b1, w2, b2, act,
                                  float(leaky_slope), float(gate_max), route)


sigmoid_gate_backward.launches = 0
sigmoid_gate_backward.launches_mma = sigmoid_gate_backward.launches_simt = 0


def _vjp_of_plain(mode, x2d, pos_proj, w1x, b1, w2, b2, dy, opts):
    """The vjp of `locate_attention_core_reference`: the backward of the
    activations without a backward kernel, as `jax.vjp` of the XLA
    composition is in JAX."""
    inputs = [t.detach().requires_grad_(True) for t in (x2d, pos_proj, w1x, b1, w2, b2)]
    with torch.enable_grad():
        y = locate_attention_core_reference(*inputs, mode=mode, **opts)
        return torch.autograd.grad(y, inputs, dy)


class SoftmaxGate(torch.autograd.Function):
    """y = x * min(softmax_HW(l) * HW, gate_max), first-order only: the
    counterpart of `_make_fused_core`'s custom_vjp. Forward: the stats and
    apply passes, saving (x, pos_proj, w1x, b1, w2, b2, m, se). Backward:
    the csum and backward passes for leaky_relu and relu; for the other
    activations the vjp of the plain composition. Differentiating the
    backward again raises (`ops/first_order.py`): second-order terms
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
    @first_order
    def backward(ctx, dy):
        x2d, pos_proj, w1x, b1, w2, b2, m, se = ctx.saved_tensors
        opts = ctx.options
        if opts["act"] in BWD_ACTS:
            c = softmax_gate_csum(x2d, dy, pos_proj, w1x, b1, w2, b2, m, se, **opts)
            grads = softmax_gate_backward(x2d, dy, pos_proj, w1x, b1, w2, b2, m, se,
                                          c, **opts)
        else:
            grads = _vjp_of_plain("softmax", x2d, pos_proj, w1x, b1, w2, b2, dy, opts)
        return (*grads, None, None, None, None)


class SigmoidGate(torch.autograd.Function):
    """y = x * min(2 sigmoid(l), gate_max), first-order only: the
    counterpart of `_make_fused_core`'s custom_vjp for mode="sigmoid".
    Forward: the one-pass gate, saving (x, pos_proj, w1x, b1, w2, b2).
    Backward: the one-pass backward kernel for leaky_relu and relu; for
    the other activations the vjp of the plain composition."""

    @staticmethod
    def forward(ctx, x2d, pos_proj, w1x, b1, w2, b2, act, leaky_slope, gate_max):
        ctx.save_for_backward(x2d, pos_proj, w1x, b1, w2, b2)
        ctx.options = dict(act=act, leaky_slope=leaky_slope, gate_max=gate_max)
        return sigmoid_gate(x2d, pos_proj, w1x, b1, w2, b2, **ctx.options)

    @staticmethod
    @first_order
    def backward(ctx, dy):
        saved = ctx.saved_tensors
        opts = ctx.options
        if opts["act"] in BWD_ACTS:
            grads = sigmoid_gate_backward(saved[0], dy, *saved[1:], **opts)
        else:
            grads = _vjp_of_plain("sigmoid", *saved, dy, dict(opts, hw_scale=1.0))
        return (*grads, None, None, None)


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
    `SoftmaxGate` or `SigmoidGate`: the kernels for CUDA tensors, their
    plain versions for CPU ones. Differentiable to first order only."""
    n, h, w, c = x.shape
    x2d = x.reshape(n, h * w, c)
    if mode == "sigmoid":
        y = SigmoidGate.apply(x2d, pos_proj, w1x, b1, w2, b2, act, float(leaky_slope),
                              float(gate_max))
    elif mode == "softmax":
        y = SoftmaxGate.apply(x2d, pos_proj, w1x, b1, w2, b2, act, float(leaky_slope),
                              float(h * w), float(gate_max))
    else:
        raise ValueError(f"unknown attention mode {mode!r}")
    return y.reshape(x.shape)
