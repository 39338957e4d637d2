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
`launches` attribute. `flash_attention` runs them through `FlashAttention`,
a first-order `torch.autograd.Function` that saves q, k, v, o and ell (all
O(T)) and never the (T, S) matrix. `attention_reference` is the
composition that materializes it: the path without kernels, and the one a
second derivative (R1) takes.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from locate_tpu_torch.ops.cuda import build

# shared memory a block may use on sm_90 (227 KB)
_MAX_SMEM = 232448
# blocks that fill the H100's 132 SMs
_FILL_BLOCKS = 132
# kernel kinds of `locate_flash_smem_bytes`
_FWD, _DQ, _DKV = 0, 1, 2
# the two q tiles the kernels are built for (a kv tile is 64 rows)
Q_TILES = (64, 16)


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
        lib.locate_flash_fwd.argtypes = [i] + [p] * 5 + [i] * 6 + [f, p]
        lib.locate_flash_fwd.restype = i
        lib.locate_flash_dq.argtypes = [i] + [p] * 7 + [i] * 6 + [f, p]
        lib.locate_flash_dq.restype = i
        lib.locate_flash_dkv.argtypes = [i] + [p] * 8 + [i] * 6 + [f, p]
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


def tile_candidates(kind: int, b: int, t: int) -> Tuple[int, ...]:
    """The q tiles to try, in order. flash_fwd and flash_dq own one q tile a
    block: 64 rows where that still gives the card's 132 SMs a block each,
    else 16 (more blocks, and T = 16 is one whole tile). flash_dkv owns a kv
    tile and walks q tiles: 64 rows unless T is shorter."""
    if kind == _DKV:
        return Q_TILES if t >= Q_TILES[0] else Q_TILES[::-1]
    return Q_TILES if b * -(-t // Q_TILES[0]) >= _FILL_BLOCKS else Q_TILES[::-1]


def pick_tile(kind: int, b: int, t: int, dh: int, dv: int,
              lib: Optional[ctypes.CDLL] = None) -> int:
    """The first q tile of `tile_candidates` whose block fits in an SM's
    shared memory (the library says how much a block takes)."""
    lib = lib or _library()
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


def flash_fwd(q, k, v, scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o (B, T, dv) in q's dtype, ell (B, T) f32). CUDA tensors: the
    `flash_fwd` kernel (replaces `_fwd_kernel`); CPU tensors: the plain
    version."""
    if not _on_card(q):
        return flash_forward_reference(q, k, v, scale)
    (q, k, v), (b, t, s, dh, dv) = _operands(q, k, v)
    lib = _library()
    bq = pick_tile(_FWD, b, t, dh, dv, lib)
    with torch.cuda.device(q.device):
        o = torch.empty((b, t, dv), dtype=q.dtype, device=q.device)
        ell = torch.empty((b, t), dtype=torch.float32, device=q.device)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.locate_flash_fwd(
            int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), ell.data_ptr(), b, t, s, dh, dv, bq, float(scale), stream)
    _check(lib, err, "flash_fwd")
    flash_fwd.launches += 1
    return o, ell


flash_fwd.launches = 0


def flash_dq(q, k, v, do, ell, delta, scale: float) -> torch.Tensor:
    """dq (B, T, dh) in q's dtype. CUDA tensors: the `flash_dq` kernel
    (replaces `_dq_kernel`); CPU tensors: the plain version."""
    if not _on_card(q):
        return flash_dq_reference(q, k, v, do, ell, delta, scale)
    (q, k, v, do), (b, t, s, dh, dv) = _operands(q, k, v, do)
    if tuple(do.shape) != (b, t, dv):
        raise ValueError(f"do must be {(b, t, dv)}, got {tuple(do.shape)}")
    ell, delta = _row_stat("ell", ell, b, t, q.device), _row_stat("delta", delta, b, t, q.device)
    lib = _library()
    bq = pick_tile(_DQ, b, t, dh, dv, lib)
    with torch.cuda.device(q.device):
        dq = torch.empty_like(q)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.locate_flash_dq(
            int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), ell.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, t, s, dh, dv,
            bq, float(scale), stream)
    _check(lib, err, "flash_dq")
    flash_dq.launches += 1
    return dq


flash_dq.launches = 0


def flash_dkv(q, k, v, do, ell, delta, scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk (B, S, dh), dv (B, S, dv)) in q's dtype. CUDA tensors: the
    `flash_dkv` kernel (replaces `_dkv_kernel`); CPU tensors: the plain
    version."""
    if not _on_card(q):
        return flash_dkv_reference(q, k, v, do, ell, delta, scale)
    (q, k, v, do), (b, t, s, dh, dv) = _operands(q, k, v, do)
    if tuple(do.shape) != (b, t, dv):
        raise ValueError(f"do must be {(b, t, dv)}, got {tuple(do.shape)}")
    ell, delta = _row_stat("ell", ell, b, t, q.device), _row_stat("delta", delta, b, t, q.device)
    lib = _library()
    bq = pick_tile(_DKV, b, t, dh, dv, lib)
    with torch.cuda.device(q.device):
        dk, dv_out = torch.empty_like(k), torch.empty_like(v)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.locate_flash_dkv(
            int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), ell.data_ptr(), delta.data_ptr(), dk.data_ptr(),
            dv_out.data_ptr(), b, t, s, dh, dv, bq, float(scale), stream)
    _check(lib, err, "flash_dkv")
    flash_dkv.launches += 1
    return dk, dv_out


flash_dkv.launches = 0


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
    backward again raises (`once_differentiable`): second-order terms such
    as R1 go through `attention_reference` instead."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, ell = flash_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, ell)
        ctx.scale = scale
        return o

    @staticmethod
    @once_differentiable
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
