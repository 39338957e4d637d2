"""Flash (memory-linear) dot-product attention: plain PyTorch versions and
the wrappers of its Hopper kernels. Counterpart of
`locate_tpu/ops/pallas/flash_attention.py`.

    O = softmax(Q K^T * scale) V      q (B, T, dh), k (B, S, dh), v (B, S, dv)

with B = batch * heads and S = T for self-attention (S != T stays legal).
Operands are in the compute dtype; scores, softmax and every accumulator in
f32; P and dS are rounded to the compute dtype before their second product.

Three wrappers launch the kernels of `csrc/flash_attention.cu` for CUDA
tensors and run the plain version for CPU tensors; nothing falls back from
one to the other: `flash_fwd` (O and the per-row logsumexp `ell`),
`flash_dq` and `flash_dkv` (the two backward passes, from `ell` and
`delta = rowsum(dO * O)`). Each counts its kernel launches in its
`launches` attribute. Each has two routes, which `flash_route` picks from
the dtype and the head widths: "mma" (bf16 on the tensor cores, widths
padded to a template of `MMA_WIDTHS`) and "simt" (f32 FMAs on the CUDA
cores: f32, and widths no template takes); each route's launches are
counted apart too (`launches_mma`, `launches_simt`). Only an explicit
`route="simt"` sends a bf16 call the mma route takes to the simt kernels,
for comparing the two. `flash_attention` runs the
kernels through `FlashAttention`, a first-order `torch.autograd.Function`
that saves q, k, v, o and ell (all O(T)) and never the (T, S) matrix.
`attention_reference` is the composition that materializes it: the path
without kernels, and the one a second derivative (R1) takes.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from locate_tpu_torch.ops.cuda import build
from locate_tpu_torch.ops.first_order import first_order

# shared memory a block may use on sm_90 (227 KB)
_MAX_SMEM = 232448
# blocks that fill the H100's 132 SMs
_FILL_BLOCKS = 132
# kernel kinds of `locate_flash_smem_bytes`
_FWD, _DQ, _DKV = 0, 1, 2
# the two q tiles the simt kernels are built for (a kv tile is 64 rows)
Q_TILES = (64, 16)
# the two routes of the three passes, and their codes in the C interface
MMA, SIMT = "mma", "simt"
_ROUTE_CODE = {SIMT: 0, MMA: 1}
# (dh, dv) of the mma kernels' templates, narrowest first: a call's widths
# (multiples of 8) are padded, in shared memory, up to the first pair that
# holds both (`mma_widths`), and the library launches the pair it is given;
# each must be instantiated in csrc/flash_attention.cu:FLASH_MMA_WIDTHS
MMA_WIDTHS = ((16, 16), (16, 32), (16, 64), (32, 128), (64, 256))


# ---------------------------------------------------------------------------
# plain versions (CPU tensors, tests, and the card-side comparison)
# ---------------------------------------------------------------------------


def _wide(x: torch.Tensor) -> torch.Tensor:
    """x in the accumulation dtype: f32 (f64 operands stay f64, which a
    numerical gradient check needs)."""
    return x if x.dtype == torch.float64 else x.float()


def _scores(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """q k^T * scale in f32 from compute-dtype operands (their products are
    exact in f32, so this is `preferred_element_type=float32`)."""
    return torch.matmul(_wide(q), _wide(k).transpose(1, 2)) * scale


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        scale: float) -> torch.Tensor:
    """The plain composition softmax(q k^T * scale) v, differentiable to any
    order: f32 scores and softmax, probabilities cast to the compute dtype
    for the value product, f32 sums, output in the compute dtype."""
    cd = q.dtype
    p = torch.softmax(_scores(q, k, scale), dim=-1).to(cd)  # one (T, S) f32 matrix at a time
    return torch.matmul(_wide(p), _wide(v)).to(cd)


def flash_forward_reference(q, k, v, scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, ell) as `flash_fwd` computes them, on whole (T, S) matrices:
    p = exp(s - max), l = rowsum(p), o = ((p as cd) v) / l, ell = max + log l."""
    cd = q.dtype
    s = _scores(q, k, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(_wide(p.to(cd)), _wide(v)) / l
    return o.to(cd), (m + torch.log(l)).squeeze(-1)


def _p_and_ds(q, k, v, do, ell, delta, scale):
    """(p, ds) of `_recompute_p_ds`, f32 rounded to the compute dtype:
    p = exp(s - ell), ds = p * (do v^T - delta)."""
    cd = q.dtype
    p = torch.exp(_scores(q, k, scale) - ell.unsqueeze(-1))
    dov = torch.matmul(_wide(do), _wide(v).transpose(1, 2))
    ds = p * (dov - delta.unsqueeze(-1))
    return _wide(p.to(cd)), _wide(ds.to(cd))


def row_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta (B, T) f32 = rowsum(do * o), outside any kernel as in JAX."""
    return (_wide(do) * _wide(o)).sum(dim=-1)


def flash_dq_reference(q, k, v, do, ell, delta, scale: float) -> torch.Tensor:
    """dq as `flash_dq` computes it: (ds as cd) k * scale, f32 sums, one cast."""
    _, ds = _p_and_ds(q, k, v, do.to(q.dtype), ell, delta, scale)
    return (torch.matmul(ds, _wide(k)) * scale).to(q.dtype)


def flash_dkv_reference(q, k, v, do, ell, delta, scale: float):
    """(dk, dv) as `flash_dkv` computes them: dk = (ds as cd)^T q * scale,
    dv = (p as cd)^T do, f32 sums, one cast each."""
    do = do.to(q.dtype)
    p, ds = _p_and_ds(q, k, v, do, ell, delta, scale)
    dk = torch.matmul(ds.transpose(1, 2), _wide(q)) * scale
    return dk.to(q.dtype), torch.matmul(p.transpose(1, 2), _wide(do)).to(q.dtype)


def flash_backward_reference(q, k, v, o, ell, do, scale: float):
    """(dq, dk, dv) of the two passes from the forward's residuals, on whole
    (T, S) matrices, p and ds computed once."""
    cd = q.dtype
    do = do.to(cd)
    p, ds = _p_and_ds(q, k, v, do, ell, row_delta(o, do), scale)
    dq = torch.matmul(ds, _wide(k)) * scale
    dv = torch.matmul(p.transpose(1, 2), _wide(do))
    dk = torch.matmul(ds.transpose(1, 2), _wide(q)) * scale
    return dq.to(cd), dk.to(cd), dv.to(cd)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _library() -> ctypes.CDLL:
    lib = build.load_library("flash_attention")
    if not getattr(lib, "_locate_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.locate_flash_smem_bytes.argtypes = [i] * 4
        lib.locate_flash_smem_bytes.restype = ctypes.c_size_t
        lib.locate_flash_fwd.argtypes = [i, i] + [p] * 5 + [i] * 8 + [f, p]
        lib.locate_flash_fwd.restype = i
        lib.locate_flash_mma_smem_bytes.argtypes = [i] * 3
        lib.locate_flash_mma_smem_bytes.restype = ctypes.c_size_t
        lib.locate_flash_blocks_per_sm.argtypes = [i] * 6
        lib.locate_flash_blocks_per_sm.restype = i
        lib.locate_flash_dq.argtypes = [i, i] + [p] * 7 + [i] * 8 + [f, p]
        lib.locate_flash_dq.restype = i
        lib.locate_flash_dkv.argtypes = [i, i] + [p] * 8 + [i] * 8 + [f, p]
        lib.locate_flash_dkv.restype = i
        lib.locate_flash_error_string.argtypes = [i]
        lib.locate_flash_error_string.restype = ctypes.c_char_p
        lib._locate_typed = True
    return lib


def _check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.locate_flash_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err} ({msg})")


def _on_card(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (the kernel), False for a CPU one (the plain
    version); any other device raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")
    return True


def mma_widths(dh: int, dv: int) -> Optional[Tuple[int, int]]:
    """The (DH, DV) template the mma kernels run (dh, dv) on: the first pair
    of `MMA_WIDTHS` that holds both, for widths that are multiples of 8 (the
    16-byte copies of a bf16 row); None where no template takes them."""
    if dh < 1 or dv < 1 or dh % 8 or dv % 8:
        return None
    return next(((a, b) for a, b in MMA_WIDTHS if dh <= a and dv <= b), None)


def flash_route(dtype: torch.dtype, dh: int, dv: int) -> str:
    """The kernels of the three passes: "mma" for bf16 at widths a template
    takes, "simt" otherwise (f32 keeps its f32 products, since TF32 would
    miss the f32 rule of 1e-4)."""
    return MMA if dtype == torch.bfloat16 and mma_widths(dh, dv) else SIMT


def tile_candidates(kind: int, b: int, t: int) -> Tuple[int, ...]:
    """The q tiles to try, in order. flash_fwd and flash_dq own one q tile a
    block: 64 rows where that still gives the card's 132 SMs a block each,
    else 16 (more blocks, and T = 16 is one whole tile). flash_dkv owns a kv
    tile and walks q tiles: 64 rows unless T is shorter."""
    if kind == _DKV:
        return Q_TILES if t >= Q_TILES[0] else Q_TILES[::-1]
    return Q_TILES if b * -(-t // Q_TILES[0]) >= _FILL_BLOCKS else Q_TILES[::-1]


def pick_tile(kind: int, b: int, t: int, dh: int, dv: int,
              lib: Optional[ctypes.CDLL] = None, route: str = SIMT) -> int:
    """The first q tile of `tile_candidates` whose block fits in an SM's
    shared memory (the library says how much a block takes). The mma route
    has no tile to pick (its blocks are the template's): the library's
    bytes for the template `mma_widths` names must fit, and 0 is
    returned."""
    lib = lib or _library()
    if route == MMA:
        wide = mma_widths(dh, dv)
        nbytes = lib.locate_flash_mma_smem_bytes(kind, *wide) if wide else 0
        if nbytes == 0:
            raise ValueError(f"dh={dh}, dv={dv}: no mma template takes these widths")
        if nbytes > _MAX_SMEM:
            raise ValueError(f"dh={dh}, dv={dv}: the mma block takes {nbytes} bytes of "
                             f"shared memory, more than {_MAX_SMEM}")
        return 0
    for bq in tile_candidates(kind, b, t):
        if lib.locate_flash_smem_bytes(kind, dh, dv, bq) <= _MAX_SMEM:
            return bq
    raise ValueError(f"dh={dh}, dv={dv}: no tile of the flash kernels fits in "
                     f"{_MAX_SMEM} bytes of shared memory")


def _operands(q, k, v, *more):
    """Validate a CUDA call: q (B, T, dh), k (B, S, dh), v (B, S, dv) of one
    dtype on one device. Returns them, and `more` cast to that dtype,
    detached and contiguous, and (B, T, S, dh, dv)."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"q, k, v must be (B, T, d): got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, t, dh = q.shape
    s, dv = v.shape[1], v.shape[2]
    if tuple(k.shape) != (b, s, dh) or v.shape[0] != b:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not match "
                         f"q {tuple(q.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"kernels take float32 or bfloat16, got {q.dtype}")
    if min(b, t, s, dh, dv) < 1:
        raise ValueError(f"empty attention operands: B={b}, T={t}, S={s}, dh={dh}, dv={dv}")
    for name, x in (("k", k), ("v", v)):
        if x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{name} is {x.dtype} on {x.device}, q {q.dtype} on {q.device}")
    out = [x.detach().contiguous() for x in (q, k, v)]
    for x in more:
        if x.device != q.device:
            raise ValueError(f"operand on {x.device}, q on {q.device}")
        out.append(x.detach().to(q.dtype).contiguous())
    return out, (b, t, s, dh, dv)


def _row_stat(name: str, x: torch.Tensor, b: int, t: int, device) -> torch.Tensor:
    if tuple(x.shape) != (b, t) or x.device != device:
        raise ValueError(f"{name} must be (B, T) = ({b}, {t}) on {device}")
    return x.detach().float().contiguous()


def _route_of(route: Optional[str], dtype: torch.dtype, dh: int, dv: int) -> str:
    """`route`, or `flash_route`'s choice where it is None; a route the
    call cannot take raises."""
    if route is None:
        return flash_route(dtype, dh, dv)
    if route not in _ROUTE_CODE:
        raise ValueError(f"route must be {MMA!r} or {SIMT!r}, got {route!r}")
    if route == MMA and flash_route(dtype, dh, dv) != MMA:
        raise ValueError(f"the mma route takes bf16 with widths a template of {MMA_WIDTHS} "
                         f"holds (multiples of 8), got {dtype}, dh={dh}, dv={dv}")
    return route


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x at a 16-byte boundary, where the mma kernels' 16-byte copies need
    it (a view into a larger tensor may start elsewhere)."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _plan(kind, tensors, b, t, dh, dv, route):
    """How a pass (`kind`) runs on the card: (its operands, 16-byte aligned
    on the mma route; the route; (q tile, DH, DV), the simt route's q tile
    or the mma route's template, the other zero; the library)."""
    route = _route_of(route, tensors[0].dtype, dh, dv)
    if route == MMA:
        tensors = [_aligned(x) for x in tensors]
    lib = _library()
    bq = pick_tile(kind, b, t, dh, dv, lib, route)
    wide = mma_widths(dh, dv) if route == MMA else (0, 0)
    return tensors, route, (bq, *wide), lib


def _backward_call(kind, q, k, v, do, ell, delta, route):
    """The checked operands of a backward pass (`kind` _DQ or _DKV) on the
    card: ((q, k, v, do), ell, delta, (b, t, s, dh, dv), route, (q tile,
    DH, DV), library), as `_plan` gives them."""
    (q, k, v, do), (b, t, s, dh, dv) = _operands(q, k, v, do)
    if tuple(do.shape) != (b, t, dv):
        raise ValueError(f"do must be {(b, t, dv)}, got {tuple(do.shape)}")
    ell, delta = _row_stat("ell", ell, b, t, q.device), _row_stat("delta", delta, b, t, q.device)
    (q, k, v, do), route, tile, lib = _plan(kind, (q, k, v, do), b, t, dh, dv, route)
    return (q, k, v, do), ell, delta, (b, t, s, dh, dv), route, tile, lib


def _count(fn, route: str) -> None:
    fn.launches += 1
    if route == MMA:
        fn.launches_mma += 1
    else:
        fn.launches_simt += 1


def flash_fwd(q, k, v, scale: float,
              route: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o (B, T, dv) in q's dtype, ell (B, T) f32). CUDA tensors: the
    `flash_fwd` kernel (replaces `_fwd_kernel`) on `route`, `flash_route`'s
    choice unless given; CPU tensors: the plain version (a route the call
    cannot take raises on both)."""
    if not _on_card(q):
        _route_of(route, q.dtype, q.shape[-1], v.shape[-1])
        return flash_forward_reference(q, k, v, scale)
    (q, k, v), (b, t, s, dh, dv) = _operands(q, k, v)
    (q, k, v), route, tile, lib = _plan(_FWD, (q, k, v), b, t, dh, dv, route)
    with torch.cuda.device(q.device):
        o = torch.empty((b, t, dv), dtype=q.dtype, device=q.device)
        ell = torch.empty((b, t), dtype=torch.float32, device=q.device)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.locate_flash_fwd(
            _ROUTE_CODE[route], int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), o.data_ptr(), ell.data_ptr(), b, t, s, dh, dv, *tile, float(scale),
            stream)
    _check(lib, err, f"flash_fwd ({route})")
    _count(flash_fwd, route)
    return o, ell


flash_fwd.launches = flash_fwd.launches_mma = flash_fwd.launches_simt = 0


def flash_dq(q, k, v, do, ell, delta, scale: float, route: Optional[str] = None) -> torch.Tensor:
    """dq (B, T, dh) in q's dtype. CUDA tensors: the `flash_dq` kernel
    (replaces `_dq_kernel`) on `route`, `flash_route`'s choice unless
    given; CPU tensors: the plain version (a route the call cannot take
    raises on both)."""
    if not _on_card(q):
        _route_of(route, q.dtype, q.shape[-1], v.shape[-1])
        return flash_dq_reference(q, k, v, do, ell, delta, scale)
    (q, k, v, do), ell, delta, (b, t, s, dh, dv), route, tile, lib = _backward_call(
        _DQ, q, k, v, do, ell, delta, route)
    with torch.cuda.device(q.device):
        dq = torch.empty_like(q)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.locate_flash_dq(
            _ROUTE_CODE[route], int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), do.data_ptr(), ell.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, t,
            s, dh, dv, *tile, float(scale), stream)
    _check(lib, err, f"flash_dq ({route})")
    _count(flash_dq, route)
    return dq


flash_dq.launches = flash_dq.launches_mma = flash_dq.launches_simt = 0


def flash_dkv(q, k, v, do, ell, delta, scale: float,
              route: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk (B, S, dh), dv (B, S, dv)) in q's dtype. CUDA tensors: the
    `flash_dkv` kernel (replaces `_dkv_kernel`) on `route`,
    `flash_route`'s choice unless given; CPU tensors: the plain version
    (a route the call cannot take raises on both)."""
    if not _on_card(q):
        _route_of(route, q.dtype, q.shape[-1], v.shape[-1])
        return flash_dkv_reference(q, k, v, do, ell, delta, scale)
    (q, k, v, do), ell, delta, (b, t, s, dh, dv), route, tile, lib = _backward_call(
        _DKV, q, k, v, do, ell, delta, route)
    with torch.cuda.device(q.device):
        dk, dv_out = torch.empty_like(k), torch.empty_like(v)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.locate_flash_dkv(
            _ROUTE_CODE[route], int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), do.data_ptr(), ell.data_ptr(), delta.data_ptr(), dk.data_ptr(),
            dv_out.data_ptr(), b, t, s, dh, dv, *tile, float(scale), stream)
    _check(lib, err, f"flash_dkv ({route})")
    _count(flash_dkv, route)
    return dk, dv_out


flash_dkv.launches = flash_dkv.launches_mma = flash_dkv.launches_simt = 0


def flash_backward(q, k, v, o, ell, do, scale: float):
    """(dq, dk, dv) from the forward's residuals: the dQ and dK/dV kernels
    for CUDA tensors, `flash_backward_reference` for CPU ones."""
    if not _on_card(q):
        return flash_backward_reference(q, k, v, o, ell, do, scale)
    do = do.to(q.dtype).contiguous()
    delta = row_delta(o, do)
    dq = flash_dq(q, k, v, do, ell, delta, scale)
    return (dq, *flash_dkv(q, k, v, do, ell, delta, scale))


class FlashAttention(torch.autograd.Function):
    """o = softmax(q k^T * scale) v, first-order only: the counterpart of
    `_make_flash_core`'s custom_vjp. Forward saves (q, k, v, o, ell), all
    O(T); backward runs the dQ and dK/dV passes. Differentiating the
    backward again raises (`ops/first_order.py`): second-order terms such
    as R1 go through `attention_reference` instead."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, ell = flash_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, ell)
        ctx.scale = scale
        return o

    @staticmethod
    @first_order
    def backward(ctx, do):
        q, k, v, o, ell = ctx.saved_tensors
        return (*flash_backward(q, k, v, o, ell, do, ctx.scale), None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v without the (T, S) matrix in device memory,
    for q (B, T, dh), k (B, S, dh), v (B, S, dv): the kernels for CUDA
    tensors, their plain versions for CPU ones. Differentiable to first
    order only."""
    return FlashAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(), float(scale))
