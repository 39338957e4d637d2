"""Fused stage group: plain PyTorch versions and the wrappers of its Hopper
kernels. Counterpart of `locate_tpu/ops/pallas/fused_stage.py`.

One pass over a tile of the stage computes the pre-activation residual
conv block with its GroupNorm folded into a per-(n, c) affine (a, b):

    u = act(x * a + b)                      f32, one cast to the compute dtype
    v = (1,3)-conv(u)                       f32 sums, cast
    w = (3,1)-conv(v) + b_col               f32 sums, cast, + b_col in cd
    w = (w + skip(x)) * 1/sqrt(2)           skip: identity or a 1x1 conv

optionally behind a nearest-2x upsample of x (`upsample`: x is the coarse
tensor; the expanded tensor never exists) or in front of a 2x2 average pool
(`downsample`: pooled in f32 before the write), and optionally followed by
the softmax or sigmoid location-attention gate of `ops/fused_attention.py`
on w.

Five wrappers launch the kernels of `csrc/fused_stage.cu` for CUDA tensors
and run their plain versions for CPU tensors; nothing falls back from one
to the other, and each counts its launches in `launches`:

    stage_conv                 replaces `_kernel_conv_only`
    stage_sigmoid              replaces `_kernel_sigmoid`
    stage_softmax_stats        replaces `_kernel_softmax_stats`
    stage_softmax_apply_pool   replaces `_kernel_softmax_apply_pool`
    stage_conv_bwd             replaces `_kernel_conv_bwd`

Every wrapper has two routes, which `stage_route` picks from the dtype
and the widths: "mma" (bf16 at the (C, Co) of `STAGE_MMA_WIDTHS`, on the
tensor cores: `stage_conv_mma`, `stage_sigmoid_mma`,
`stage_softmax_stats_mma`, `stage_conv_bwd_mma` and, at (Co, Hd, Cout) =
(64, 16, 64), `stage_softmax_apply_pool_mma`) and "simt" (f32 FMAs on the
CUDA cores: f32, and every other width). Each
route's launches are counted apart too (`launches_mma`, `launches_simt`);
`route="simt"` sends a bf16 call to the simt kernel, to compare the two on
one card.

Each plain version repeats its kernel's own rounding order, which in bf16
differs from `stage_oracle`'s (the exact layer composition, where the
activation runs after the cast): a kernel is held to its plain version.
`FusedStage` chains them as `_make_stage_core` does: forward (the sigmoid
gate in one pass, the softmax gate's stats pass then its apply pass), then
a first-order backward that recomputes w, runs the gate's backward kernels
on it (softmax: stats, csum, backward; sigmoid: its one-pass backward) and
then the conv-block backward, with the act' and GroupNorm backward as a
plain epilogue. Other activations, and `oracle_bwd=True`, take the vjp of
`stage_oracle`.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import torch

from locate_tpu_torch.ops.first_order import first_order
from locate_tpu_torch.ops import fused_attention as fa
# the two routes and their launch counting are the flash wrappers' own
from locate_tpu_torch.ops.flash_attention import _ROUTE_CODE, MMA, SIMT, _count
from locate_tpu_torch.ops.activations import act_fn
from locate_tpu_torch.ops.cuda import build

SQRT_HALF = 0.7071067811865476

# kinds of csrc/fused_stage.cu's shared-memory layouts
_CONV, _STATS, _APPLY_POOL, _BWD, _SIGMOID = 0, 1, 2, 3, 4

# tile candidates (rows, cols) in order of preference: the largest whose
# shared memory lets two blocks share an SM, else the largest that fits
_FWD_TILES = ((8, 16), (8, 8), (4, 8), (4, 4), (2, 4))
_BWD_TILES = ((4, 16), (4, 8), (2, 8), (2, 4))
_TWO_PER_SM = 232448 // 2 - 1024

# blocks of the backward kernel: two per SM of the H100's 132, each
# looping over its share of the tiles into its own slice of the workspace
_BWD_TARGET_BLOCKS = 264

# (C, Co) of the mma route's templates (csrc/fused_stage.cu:mma_widths_ok):
# every fused 512^2 stage of ffhq_512 (64, 64), and the 1x1-skip form
# (32, 64); a 1x1 skip exactly where C != Co. The gate there: Hd 16 and
# Cout = Co. Its tile is fixed: 8 rows x 16 columns.
STAGE_MMA_WIDTHS = ((64, 64), (32, 64))
MMA_HD = 16
_MMA_TILE = (8, 16)


def _inv_sqrt2(dtype: torch.dtype) -> float:
    """1/sqrt(2) rounded to `dtype`, as `jnp.asarray(SQRT_HALF, cd)`."""
    return float(torch.tensor(SQRT_HALF, dtype=dtype))


# ---------------------------------------------------------------------------
# layout helpers (NHWC)
# ---------------------------------------------------------------------------


def up2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-2x upsample (`_up2x`)."""
    n, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(n, h, 2, w, 2, c).reshape(n, 2 * h, 2 * w, c)


def _pool2x_sum(t: torch.Tensor) -> torch.Tensor:
    """2x2 sum-pool (`_pool2x`), in t's dtype: the vjp of `up2x`."""
    n, h, w, c = t.shape
    return t.reshape(n, h // 2, 2, w // 2, 2, c).sum(dim=(2, 4))


def down2x(y: torch.Tensor) -> torch.Tensor:
    """2x2 average pool in f32, cast back (`_down2x`, `_pool_avg`)."""
    return (_pool2x_sum(y.float()) * 0.25).to(y.dtype)


def _shift(t: torch.Tensor, dim: int, s: int) -> torch.Tensor:
    """out[..., i, ...] = t[..., i + s, ...] along `dim` (1 = H, 2 = W),
    zero where i + s leaves the image (SAME padding)."""
    if s == 0:
        return t
    n = t.shape[dim]
    body = t.narrow(dim, max(s, 0), n - abs(s))
    pad = torch.zeros_like(t.narrow(dim, 0, abs(s)))
    return torch.cat([body, pad] if s > 0 else [pad, body], dim=dim)


def _taps(t: torch.Tensor, dim: int, sign: int = 1) -> torch.Tensor:
    """The three taps of a SAME 3-wide conv along `dim`, tap k holding
    t[i + sign * (k - 1)], concatenated on the channels."""
    return torch.cat([_shift(t, dim, sign * (k - 1)) for k in range(3)], dim=-1)


def _conv3(t: torch.Tensor, w3: torch.Tensor, dim: int, sign: int = 1) -> torch.Tensor:
    """sum_k t[i + sign * (k - 1)] @ w3[k] in f32: one K=3C product of the
    shifted taps, as `_stage_tile` runs it."""
    return _taps(t.float(), dim, sign) @ w3.float().reshape(-1, w3.shape[-1])


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def stage_oracle(ops: dict, *, h: int, w: int, groups: int, eps: float, act: str,
                 leaky_slope: float, mode: Optional[str], gate_max: float = 0.0,
                 upsample: bool = False, downsample: bool = False) -> torch.Tensor:
    """The exact layer composition (`stage_oracle`): f32 GroupNorm, cast,
    activation, two convs with f32 sums, + b_col in the compute dtype, skip,
    x 1/sqrt(2), then the optional gate and pool. Weights in the port's
    OIHW layout: w_row (Co, C, 1, 3), w_col (Co, Co, 3, 1), w_skip
    (Co, C, 1, 1); gate operands as `fused_locate_attention` takes them.
    (h, w) are the fine dims; with `upsample` ops["x"] is coarse."""
    from locate_tpu_torch.ops.conv import conv_nhwc

    x = ops["x"]
    if upsample:
        x = up2x(x)
    n, _, _, c = x.shape
    cd = x.dtype
    afn = act_fn(act, leaky_slope)
    xf = x.float().reshape(n, h, w, groups, c // groups)
    var, mean = torch.var_mean(xf, dim=(1, 2, 4), unbiased=False, keepdim=True)
    xf = ((xf - mean) * torch.rsqrt(var + eps)).reshape(n, h, w, c)
    u = afn((xf * ops["gn_scale"] + ops["gn_bias"]).to(cd))
    v = conv_nhwc(u.float(), ops["w_row"].to(cd).float()).to(cd)
    y = conv_nhwc(v.float(), ops["w_col"].to(cd).float()).to(cd)
    y = y + ops["b_col"].to(cd)
    if ops.get("w_skip") is not None:
        skip = conv_nhwc(x.float(), ops["w_skip"].to(cd).float()).to(cd)
    else:
        skip = x
    y = (y + skip) * _inv_sqrt2(cd)
    if mode is not None:
        co = y.shape[-1]
        y = fa.locate_attention_core_reference(
            y.reshape(n, h * w, co), ops["pos_proj"], ops["w1x"], ops["b1"], ops["w2"],
            ops["b2"], mode=mode, act=act, leaky_slope=leaky_slope, hw_scale=float(h * w),
            gate_max=gate_max).reshape(n, h, w, co)
    return down2x(y) if downsample else y


def fold_groupnorm(x, gn_scale, gn_bias, groups: int, eps: float):
    """(a, b), each (N, C) f32, with norm(x) * scale + bias == x * a + b
    (`_fold_groupnorm`); x is the kernel's x, coarse under upsample."""
    n, h, w, c = x.shape
    xf = x.float().reshape(n, h * w, groups, c // groups)
    var, mean = torch.var_mean(xf, dim=(1, 3), unbiased=False)
    cg = c // groups
    a = torch.rsqrt(var + eps).repeat_interleave(cg, dim=1) * gn_scale.float()[None]
    b = gn_bias.float()[None] - mean.repeat_interleave(cg, dim=1) * a
    return a, b


def _norm_act(x, a, b, act, leaky_slope):
    """act(x * a + b) in f32, one cast to x's dtype (`norm_act`)."""
    return act_fn(act, leaky_slope)(x.float() * a[:, None, None, :]
                                    + b[:, None, None, :]).to(x.dtype)


def _conv_block(x, a, b, wr, wc, bc, ws, *, act, leaky_slope, upsample):
    """`_stage_tile`'s w: (N, H, W, Co) in x's dtype. u runs at coarse
    resolution and is expanded (the cast commutes with duplication); the
    1x1 skip runs at coarse resolution too."""
    cd = x.dtype
    u = _norm_act(x, a, b, act, leaky_slope)
    if upsample:
        u = up2x(u)
    v = _conv3(u, wr, dim=2).to(cd)
    y = _conv3(v, wc, dim=1).to(cd) + bc.to(cd)
    skip = x if ws is None else (x.float() @ ws.float()).to(cd)
    if upsample:
        skip = up2x(skip)
    return (y + skip) * _inv_sqrt2(cd)


def stage_conv_reference(x, a, b, wr, wc, bc, ws, *, act, leaky_slope,
                         upsample=False, downsample=False):
    """`_kernel_conv_only`: the conv block, pooled under `downsample`."""
    y = _conv_block(x, a, b, wr, wc, bc, ws, act=act, leaky_slope=leaky_slope,
                    upsample=upsample)
    return down2x(y) if downsample else y


def stage_sigmoid_reference(x, a, b, wr, wc, bc, ws, pp, w1x, b1, w2, b2, *, act,
                            leaky_slope, gate_max, upsample=False, downsample=False):
    """`_kernel_sigmoid`: the sigmoid gate on the conv block's w, the gated
    values cast to the compute dtype, then (under `downsample`) pooled in
    f32 and cast again, as the kernel pools its cd-cast values."""
    w_pre = _conv_block(x, a, b, wr, wc, bc, ws, act=act, leaky_slope=leaky_slope,
                        upsample=upsample)
    n, h, w, co = w_pre.shape
    y = fa.sigmoid_gate_reference(w_pre.reshape(n, h * w, co), pp, w1x, b1, w2, b2, act=act,
                                  leaky_slope=leaky_slope, gate_max=gate_max)
    y = y.reshape(w_pre.shape)
    return down2x(y) if downsample else y


def stage_softmax_stats_reference(x, a, b, wr, wc, bc, ws, pp, w1x, b1, w2, b2, *, act,
                                  leaky_slope, upsample=False):
    """`_kernel_softmax_stats`: (w_pre (N, H, W, Co), m, se (N, 1, Cout))."""
    w_pre = _conv_block(x, a, b, wr, wc, bc, ws, act=act, leaky_slope=leaky_slope,
                        upsample=upsample)
    n, h, w, co = w_pre.shape
    m, se = fa.softmax_gate_stats_reference(w_pre.reshape(n, h * w, co), pp, w1x, b1, w2,
                                            b2, act=act, leaky_slope=leaky_slope)
    return w_pre, m, se


def stage_softmax_apply_pool_reference(w_pre, pp, w1x, b1, w2, b2, m, se, *, act,
                                       leaky_slope, hw_scale, gate_max):
    """`_kernel_softmax_apply_pool`: the gate applied to w_pre, then the
    2x2 pool in f32 of the compute-dtype gated values."""
    n, h, w, co = w_pre.shape
    y = fa.softmax_gate_apply_reference(w_pre.reshape(n, h * w, co), pp, w1x, b1, w2, b2,
                                        m, se, act=act, leaky_slope=leaky_slope,
                                        hw_scale=hw_scale, gate_max=gate_max)
    return down2x(y.reshape(n, h, w, co))


def stage_conv_bwd_reference(x, dw, a, b, wr, wc, ws, *, act, leaky_slope, upsample=False):
    """`_kernel_conv_bwd`: given dw = dL/dw (N, H, W, Co), the fine stage
    output's cotangent, returns (du, dxs, dWr, dWc, db_col, dWskip):
    du = dL/d(act(norm(x))) and dxs = the skip path's dL/dx, both on x's
    grid in x's dtype (2x2 sum-pooled under upsample), and the weight
    gradients in f32 in the kernel's layout ((3, C, Co), (3, Co, Co),
    (Co,), (C, Co) or None). Every conv transpose is the forward's shifted
    product with the shift reversed."""
    cd = x.dtype
    u = _norm_act(x, a, b, act, leaky_slope)
    if upsample:
        u = up2x(u)
    v = _conv3(u, wr, dim=2).to(cd)
    dwf = dw.float() * SQRT_HALF
    dy0 = dwf.to(cd)
    # column conv transpose: dv[i] = sum_k dy0[i + 1 - k] @ Wc[k]^T
    dv = _conv3(dy0, wc.transpose(1, 2), dim=1, sign=-1).to(cd)
    dwc = torch.einsum("nhwkj,nhwc->kjc", _taps(v.float(), 1).unflatten(-1, (3, -1)),
                       dy0.float())
    # row conv transpose: du[j] = sum_k (dv @ Wr[k]^T)[j + 1 - k]
    du = _conv3(dv, wr.transpose(1, 2), dim=2, sign=-1)
    dwr = torch.einsum("nhwkc,nhwo->kco", _taps(u.float(), 2).unflatten(-1, (3, -1)),
                       dv.float())
    dbc = dwf.sum(dim=(0, 1, 2))
    if upsample:
        du = _pool2x_sum(du)
        dy0 = _pool2x_sum(dwf).to(cd)
    if ws is None:
        return du.to(cd), dy0, dwr, dwc, dbc, None
    dxs = (dy0.float() @ ws.float().t()).to(cd)
    dws = torch.einsum("nhwc,nhwo->co", x.float(), dy0.float())
    return du.to(cd), dxs, dwr, dwc, dbc, dws


def groupnorm_act_backward(x, du, dxs, gn_scale, gn_bias, *, groups, eps, act, leaky_slope):
    """The f32 act' and GroupNorm backward epilogue (`_pallas_conv_backward`
    :947-985): (dx in x's dtype, d gn_scale, d gn_bias). act' is taken at
    the compute-dtype pre-activation, as the forward evaluated act there."""
    n, h, w, c = x.shape
    cd = x.dtype
    cg = c // groups
    xf = x.float().reshape(n, h * w, groups, cg)
    var, mean = torch.var_mean(xf, dim=(1, 3), unbiased=False, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    xhat = ((xf - mean) * rstd).reshape(n, h * w, c)
    z_cd = (xhat * gn_scale.float() + gn_bias.float()).to(cd)
    dz = du.reshape(n, h * w, c).float() * fa._act_grad(act, leaky_slope)(z_cd.float())
    d_scale = (dz * xhat).sum(dim=(0, 1))
    d_bias = dz.sum(dim=(0, 1))
    dzs = (dz * gn_scale.float()).reshape(n, h * w, groups, cg)
    xhat_g = xhat.reshape(n, h * w, groups, cg)
    m1 = dzs.mean(dim=(1, 3), keepdim=True)
    m2 = (dzs * xhat_g).mean(dim=(1, 3), keepdim=True)
    dx = (rstd * (dzs - m1 - xhat_g * m2)).reshape(n, h * w, c)
    dx = (dx + dxs.reshape(n, h * w, c).float()).to(cd)
    return dx.reshape(x.shape), d_scale, d_bias


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _library() -> ctypes.CDLL:
    lib = build.load_library("fused_stage")
    if not getattr(lib, "_locate_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.locate_stage_smem_bytes.argtypes = [i] * 8
        lib.locate_stage_smem_bytes.restype = ctypes.c_size_t
        lib.locate_stage_blocks_per_sm.argtypes = [i] * 8
        lib.locate_stage_blocks_per_sm.restype = i
        lib.locate_stage_conv.argtypes = [i, i] + [p] * 8 + [i] * 8 + [f, i, i, p]
        lib.locate_stage_conv.restype = i
        lib.locate_stage_sigmoid.argtypes = [i, i] + [p] * 13 + [i] * 10 + [f, f, i, i, p]
        lib.locate_stage_sigmoid.restype = i
        lib.locate_stage_softmax_stats.argtypes = [i, i] + [p] * 17 + [i] * 10 + [f, i, p]
        lib.locate_stage_softmax_stats.restype = i
        lib.locate_stage_softmax_apply_pool.argtypes = [i, i] + [p] * 9 + [i] * 9 + [f] * 3 + [p]
        lib.locate_stage_softmax_apply_pool.restype = i
        lib.locate_stage_conv_bwd.argtypes = [i, i] + [p] * 14 + [i] * 9 + [f, i, p]
        lib.locate_stage_conv_bwd.restype = i
        lib.locate_stage_error_string.argtypes = [i]
        lib.locate_stage_error_string.restype = ctypes.c_char_p
        lib._locate_typed = True
    return lib


def _check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.locate_stage_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err} ({msg})")


def _on_card(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (the kernel), False for a CPU one (the plain
    version); any other device raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")
    return True


def stage_route(dtype: torch.dtype, c: int, co: int, *, skip: Optional[bool] = None,
                h: Optional[int] = None, w: Optional[int] = None, hd: Optional[int] = None,
                cout: Optional[int] = None) -> str:
    """The kernel of the five routed wrappers: "mma" for bf16 at the
    (C, Co) of a template (`STAGE_MMA_WIDTHS`), "simt" otherwise (f32
    keeps its f32 products, since TF32 would miss the f32 rule of 1e-4).
    What a call also names must fit the template: a 1x1 skip (`skip`)
    exactly where C != Co, fine dims (h, w) that the 8 x 16 tile divides
    (a `downsample` output's too: the tile pools to 4 x 8), the gate's
    (`hd`, `cout`) Hd 16 and Cout = Co (a gate per channel)."""
    if dtype != torch.bfloat16 or (c, co) not in STAGE_MMA_WIDTHS:
        return SIMT
    if skip is not None and skip != (c != co):
        return SIMT
    if h is not None and (h % _MMA_TILE[0] or w % _MMA_TILE[1]):
        return SIMT
    if hd is not None and (hd != MMA_HD or cout != co):
        return SIMT
    return MMA


def _route_of(route: Optional[str], dtype: torch.dtype, c: int, co: int, **shape) -> str:
    """`route`, or `stage_route`'s choice where it is None; a route the call
    cannot take raises."""
    if route is None:
        return stage_route(dtype, c, co, **shape)
    if route not in _ROUTE_CODE:
        raise ValueError(f"route must be {MMA!r} or {SIMT!r}, got {route!r}")
    if route == MMA and stage_route(dtype, c, co, **shape) != MMA:
        raise ValueError(f"the mma route takes bf16 at (C, Co) in {STAGE_MMA_WIDTHS} (a 1x1 "
                         f"skip where C != Co, an image the {_MMA_TILE} tile divides, the "
                         f"gate's Hd {MMA_HD} and Cout = Co), got {dtype}, C={c}, Co={co}, "
                         f"{shape}")
    return route


def pick_tile(kind: int, h: int, w: int, c: int, co: int, hd: int = 0, cout: int = 0,
              lib: Optional[ctypes.CDLL] = None, route: str = SIMT) -> Tuple[int, int]:
    """(rows, cols) of a block's tile of fine pixels. On the simt route the
    first candidate that divides the image and lets two blocks share an
    SM, else the first that fits in one SM's shared memory. The mma route
    has one tile, 8 x 16: the library's bytes for it (0 where no template
    takes the widths) must fit in an SM."""
    lib = lib or _library()
    if route == MMA:
        th, tw = _MMA_TILE
        nbytes = lib.locate_stage_smem_bytes(_ROUTE_CODE[MMA], kind, c, co, hd, cout, th, tw)
        if nbytes == 0:
            raise ValueError(f"C={c}, Co={co}, Hd={hd}, Cout={cout}: no mma template of kind "
                             f"{kind} takes these widths")
        if nbytes > fa._MAX_SMEM:
            raise ValueError(f"C={c}, Co={co}: the mma block takes {nbytes} bytes of shared "
                             f"memory, more than {fa._MAX_SMEM}")
        if h % th or w % tw:
            raise ValueError(f"the mma route's {th}x{tw} tile does not divide {h}x{w}")
        return th, tw
    fits = []
    for th, tw in (_BWD_TILES if kind == _BWD else _FWD_TILES):
        if h % th or w % tw:
            continue
        smem = lib.locate_stage_smem_bytes(_ROUTE_CODE[SIMT], kind, c, co, hd, cout, th, tw)
        if smem <= _TWO_PER_SM:
            return th, tw
        if smem <= fa._MAX_SMEM:
            fits.append((th, tw))
    if not fits:
        raise ValueError(f"no tile of a {h}x{w} image with C={c}, Co={co}, Hd={hd} "
                         f"fits in {fa._MAX_SMEM} bytes of shared memory")
    return fits[0]


def _call_route(route: Optional[str], x: torch.Tensor, wr: torch.Tensor,
                ws: Optional[torch.Tensor], upsample: bool, w1x: Optional[torch.Tensor] = None,
                w2: Optional[torch.Tensor] = None) -> str:
    """The route of a call on x (NHWC, coarse under `upsample`) with these
    conv weights and, for the gated passes, gate weights: `route`, or
    `stage_route`'s choice where it is None (see `_route_of`); the fine
    dims (H, W) are x's, doubled under upsample."""
    if x.dim() != 4:
        raise ValueError(f"x must be NHWC, got {tuple(x.shape)}")
    _, h, w, c = x.shape
    if upsample:
        h, w = 2 * h, 2 * w
    gate = {} if w1x is None else dict(hd=w1x.shape[1], cout=w2.shape[1])
    return _route_of(route, x.dtype, c, wr.shape[-1], skip=ws is not None, h=h, w=w, **gate)


def _conv_operands(x, a, b, wr, wc, bc, ws, upsample):
    """Validate a CUDA call of the conv pass and cast its operands as the
    kernels take them: (x, a, b, wr, wc, bc, ws) contiguous, weights in
    x's dtype, a, b and b_col in f32 (b_col None for the backward, which
    takes none); and (N, H, W, C, Co) with (H, W) the fine dims."""
    if x.dim() != 4:
        raise ValueError(f"x must be NHWC, got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"kernels take float32 or bfloat16 x, got {x.dtype}")
    n, h, w, c = x.shape
    if upsample:
        h, w = 2 * h, 2 * w
    co = wr.shape[-1]
    expect = {"a": (n, c), "b": (n, c), "wr": (3, c, co), "wc": (3, co, co)}
    tensors = {"a": a, "b": b, "wr": wr, "wc": wc}
    if bc is not None:
        expect["bc"], tensors["bc"] = (co,), bc
    if ws is not None:
        expect["ws"], tensors["ws"] = (c, co), ws
    elif c != co:
        raise ValueError(f"an identity skip needs C == Co, got {c} and {co}")
    for name, t in tensors.items():
        if tuple(t.shape) != expect[name]:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {expect[name]}")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
    if c % 8 or co % 8:
        raise ValueError(f"kernels take C and Co that are multiples of 8, got C={c}, Co={co}")
    if h % 2 or w % 4:
        raise ValueError(f"kernels take an even height and a width % 4 == 0, got {h}x{w}")
    if n > 65535:
        raise ValueError(f"batch {n} exceeds the kernel grid's 65535 rows")
    cd = x.dtype
    ops = [_dense(x), _dense(a, torch.float32), _dense(b, torch.float32), _dense(wr, cd),
           _dense(wc, cd), None if bc is None else _dense(bc, torch.float32),
           None if ws is None else _dense(ws, cd)]
    return ops, (n, h, w, c, co)


def _dense(t: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """t detached, in `dtype`, contiguous and 16-byte aligned, as the
    kernels' vector loads take it."""
    t = t.detach().to(dtype or t.dtype).contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def stage_conv(x, a, b, wr, wc, bc, ws, *, act, leaky_slope, upsample=False,
               downsample=False, route=None):
    """The conv block's output w (N, H, W, Co), (N, H/2, W/2, Co) under
    `downsample`, in x's dtype. CUDA tensors: the `stage_conv` kernel (on
    the mma route `stage_conv_mma`, see `stage_route`; replaces
    `_kernel_conv_only`); CPU tensors: the plain version on any route."""
    if upsample and downsample:
        raise ValueError("upsample and downsample are mutually exclusive")
    route = _call_route(route, x, wr, ws, upsample)
    if not _on_card(x):
        return stage_conv_reference(x, a, b, wr, wc, bc, ws, act=act, leaky_slope=leaky_slope,
                                    upsample=upsample, downsample=downsample)
    if act not in fa.ACT_CODES:
        raise ValueError(f"unsupported activation for the fused stage: {act!r}")
    ops, (n, h, w, c, co) = _conv_operands(x, a, b, wr, wc, bc, ws, upsample)
    lib = _library()
    th, tw = pick_tile(_CONV, h, w, c, co, lib=lib, route=route)
    oh, ow = (h // 2, w // 2) if downsample else (h, w)
    with torch.cuda.device(x.device):
        out = torch.empty((n, oh, ow, co), dtype=x.dtype, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.locate_stage_conv(
            _ROUTE_CODE[route], int(x.dtype == torch.bfloat16), *(_ptr(o) for o in ops),
            out.data_ptr(), n, h, w, c, co, th, tw, fa.ACT_CODES[act], float(leaky_slope),
            int(upsample), int(downsample), stream)
    _check(lib, err, f"stage conv ({route})")
    _count(stage_conv, route)
    return out


stage_conv.launches = 0
stage_conv.launches_mma = stage_conv.launches_simt = 0


def stage_sigmoid(x, a, b, wr, wc, bc, ws, pp, w1x, b1, w2, b2, *, act, leaky_slope,
                  gate_max, upsample=False, downsample=False, route=None):
    """The conv block's output with the sigmoid gate applied, (N, H, W, Co),
    (N, H/2, W/2, Co) under `downsample`, in x's dtype; pp is at the fine
    resolution. CUDA tensors: the one-pass `stage_sigmoid` kernel (on the
    mma route `stage_sigmoid_mma`, see `stage_route`; replaces
    `_kernel_sigmoid`); CPU tensors: the plain version on any route."""
    if upsample and downsample:
        raise ValueError("upsample and downsample are mutually exclusive")
    route = _call_route(route, x, wr, ws, upsample, w1x, w2)
    if not _on_card(x):
        return stage_sigmoid_reference(x, a, b, wr, wc, bc, ws, pp, w1x, b1, w2, b2, act=act,
                                       leaky_slope=leaky_slope, gate_max=gate_max,
                                       upsample=upsample, downsample=downsample)
    if act not in fa.ACT_CODES:
        raise ValueError(f"unsupported activation for the fused stage: {act!r}")
    ops, (n, h, w, c, co) = _conv_operands(x, a, b, wr, wc, bc, ws, upsample)
    gate, (hd, cout) = _gate_operands(x, pp, w1x, b1, w2, b2, co, h * w)
    lib = _library()
    th, tw = pick_tile(_SIGMOID, h, w, c, co, hd, cout, lib=lib, route=route)
    oh, ow = (h // 2, w // 2) if downsample else (h, w)
    with torch.cuda.device(x.device):
        out = torch.empty((n, oh, ow, co), dtype=x.dtype, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.locate_stage_sigmoid(
            _ROUTE_CODE[route], int(x.dtype == torch.bfloat16),
            *(_ptr(o) for o in ops + gate), out.data_ptr(), n, h, w, c, co, hd, cout, th, tw,
            fa.ACT_CODES[act], float(leaky_slope), float(gate_max), int(upsample),
            int(downsample), stream)
    _check(lib, err, f"stage sigmoid ({route})")
    _count(stage_sigmoid, route)
    return out


stage_sigmoid.launches = 0
stage_sigmoid.launches_mma = stage_sigmoid.launches_simt = 0


def _gate_operands(x, pp, w1x, b1, w2, b2, co, hw):
    """The gate's operands as the kernels take them (checked like
    `fused_attention._kernel_operands`)."""
    hd, cout = w1x.shape[1], w2.shape[1]
    expect = {"pos_proj": (hw, hd), "w1x": (co, hd), "b1": (hd,), "w2": (hd, cout),
              "b2": (cout,)}
    for name, t in zip(expect, (pp, w1x, b1, w2, b2)):
        if tuple(t.shape) != expect[name]:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {expect[name]}")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
    if cout not in (1, co):
        raise ValueError(f"gate channels must be 1 or Co={co}, got {cout}")
    cd = x.dtype
    return [_dense(pp, torch.float32), _dense(w1x, cd), _dense(b1, torch.float32),
            _dense(w2, cd), _dense(b2, torch.float32)], (hd, cout)


def stage_softmax_stats(x, a, b, wr, wc, bc, ws, pp, w1x, b1, w2, b2, *, act, leaky_slope,
                        upsample=False, route=None):
    """(w_pre (N, H, W, Co) in x's dtype, m, se (N, 1, Cout) f32): the conv
    block's output and the max and sum-exp over H*W of the gate logits on
    it. CUDA tensors: the `stage_softmax_stats` kernel (on the mma route
    `stage_softmax_stats_mma`, see `stage_route`) and the merge of its
    per-tile statistics, `softmax_stats_merge` (replaces
    `_kernel_softmax_stats`); CPU tensors: the plain version on any
    route."""
    route = _call_route(route, x, wr, ws, upsample, w1x, w2)
    if not _on_card(x):
        return stage_softmax_stats_reference(x, a, b, wr, wc, bc, ws, pp, w1x, b1, w2, b2,
                                             act=act, leaky_slope=leaky_slope,
                                             upsample=upsample)
    if act not in fa.ACT_CODES:
        raise ValueError(f"unsupported activation for the fused stage: {act!r}")
    ops, (n, h, w, c, co) = _conv_operands(x, a, b, wr, wc, bc, ws, upsample)
    gate, (hd, cout) = _gate_operands(x, pp, w1x, b1, w2, b2, co, h * w)
    lib = _library()
    th, tw = pick_tile(_STATS, h, w, c, co, hd, cout, lib=lib, route=route)
    tiles = (h // th) * (w // tw)
    with torch.cuda.device(x.device):
        f32 = dict(dtype=torch.float32, device=x.device)
        w_pre = torch.empty((n, h, w, co), dtype=x.dtype, device=x.device)
        part_m = torch.empty((n, tiles, cout), **f32)
        part_s = torch.empty((n, tiles, cout), **f32)
        m = torch.empty((n, 1, cout), **f32)
        se = torch.empty((n, 1, cout), **f32)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.locate_stage_softmax_stats(
            _ROUTE_CODE[route], int(x.dtype == torch.bfloat16), *(_ptr(o) for o in ops + gate),
            w_pre.data_ptr(), part_m.data_ptr(), part_s.data_ptr(), m.data_ptr(),
            se.data_ptr(), n, h, w, c, co, hd, cout, th, tw, fa.ACT_CODES[act],
            float(leaky_slope), int(upsample), stream)
    _check(lib, err, f"stage softmax stats ({route})")
    _count(stage_softmax_stats, route)
    return w_pre, m, se


stage_softmax_stats.launches = 0
stage_softmax_stats.launches_mma = stage_softmax_stats.launches_simt = 0


def stage_softmax_apply_pool(w_pre, pp, w1x, b1, w2, b2, m, se, *, act, leaky_slope,
                             hw_scale, gate_max, route=None):
    """The gate applied to w_pre (N, H, W, Co) and 2x2 average-pooled:
    (N, H/2, W/2, Co) in w_pre's dtype. CUDA tensors: the
    `stage_softmax_apply_pool` kernel (on the mma route
    `stage_softmax_apply_pool_mma`, see `stage_route`; replaces
    `_kernel_softmax_apply_pool`); CPU tensors: the plain version on any
    route."""
    if w_pre.dim() != 4:
        raise ValueError(f"w_pre must be NHWC, got {tuple(w_pre.shape)}")
    n, h, w, co = w_pre.shape
    route = _route_of(route, w_pre.dtype, co, co, h=h, w=w, hd=w1x.shape[1], cout=w2.shape[1])
    if not _on_card(w_pre):
        return stage_softmax_apply_pool_reference(
            w_pre, pp, w1x, b1, w2, b2, m, se, act=act, leaky_slope=leaky_slope,
            hw_scale=hw_scale, gate_max=gate_max)
    if act not in fa.ACT_CODES:
        raise ValueError(f"unsupported activation for the fused stage: {act!r}")
    if w_pre.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"w_pre must be float32 or bfloat16, got {w_pre.dtype}")
    if co % 8 or h % 2 or w % 4 or n > 65535:
        raise ValueError(f"kernels take Co % 8 == 0, an even height, a width % 4 == 0 and "
                         f"a batch up to 65535, got {n}x{h}x{w}x{co}")
    gate, (hd, cout) = _gate_operands(w_pre, pp, w1x, b1, w2, b2, co, h * w)
    m = _dense(fa._stats_operand("m", m, n, cout, w_pre.device))
    se = _dense(fa._stats_operand("se", se, n, cout, w_pre.device))
    lib = _library()
    th, tw = pick_tile(_APPLY_POOL, h, w, co, co, hd, cout, lib=lib, route=route)
    xw = _dense(w_pre)
    with torch.cuda.device(w_pre.device):
        out = torch.empty((n, h // 2, w // 2, co), dtype=w_pre.dtype, device=w_pre.device)
        stream = torch.cuda.current_stream(w_pre.device).cuda_stream
        err = lib.locate_stage_softmax_apply_pool(
            _ROUTE_CODE[route], int(w_pre.dtype == torch.bfloat16), xw.data_ptr(),
            *(o.data_ptr() for o in gate), m.data_ptr(), se.data_ptr(), out.data_ptr(), n, h, w,
            co, hd, cout, th, tw, fa.ACT_CODES[act], float(leaky_slope), float(hw_scale),
            float(gate_max), stream)
    _check(lib, err, f"stage softmax apply-pool ({route})")
    _count(stage_softmax_apply_pool, route)
    return out


stage_softmax_apply_pool.launches = 0
stage_softmax_apply_pool.launches_mma = stage_softmax_apply_pool.launches_simt = 0


def bwd_blocks(n: int, h: int, w: int, th: int, tw: int,
               target: int = _BWD_TARGET_BLOCKS) -> int:
    """Blocks of the backward kernel: at most `target` (the simt route's
    `_BWD_TARGET_BLOCKS`; on the mma route the blocks that fit on the
    card at once), each owning one slice of the weight-gradient
    workspace."""
    return min(n * (h // th) * (w // tw), target)


def stage_conv_bwd(x, dw, a, b, wr, wc, ws, *, act, leaky_slope, upsample=False, route=None):
    """(du, dxs, dWr, dWc, db_col, dWskip) of `stage_conv_bwd_reference`.
    CUDA tensors: the `stage_conv_bwd` kernel (on the mma route
    `stage_conv_bwd_mma`, see `stage_route`) and `reduce_partials`, a
    fixed-order sum of its per-block weight-gradient partials, bitwise
    repeatable (replaces `_kernel_conv_bwd`); CPU tensors: the plain
    version on any route."""
    route = _call_route(route, x, wr, ws, upsample)
    if not _on_card(x):
        return stage_conv_bwd_reference(x, dw, a, b, wr, wc, ws, act=act,
                                        leaky_slope=leaky_slope, upsample=upsample)
    if act not in fa.ACT_CODES:
        raise ValueError(f"unsupported activation for the fused stage: {act!r}")
    ops, (n, h, w, c, co) = _conv_operands(x, a, b, wr, wc, None, ws, upsample)
    if tuple(dw.shape) != (n, h, w, co) or dw.device != x.device:
        raise ValueError(f"dw must be {(n, h, w, co)} on {x.device}, got {tuple(dw.shape)}")
    x_, a_, b_, wr_, wc_, _, ws_ = ops
    dw_ = _dense(dw, x.dtype)
    wr_t = wc_t = ws_t = None
    if route == SIMT:
        # the transposes run the forward's shifted products: tap t of the
        # column transpose is Wc[2 - t]^T, of the row transpose Wr[2 - t]^T
        # (the mma kernel reads wr, wc and ws both ways itself)
        wr_t = wr_.flip(0).transpose(1, 2).contiguous()
        wc_t = wc_.flip(0).transpose(1, 2).contiguous()
        ws_t = None if ws_ is None else ws_.t().contiguous()
    lib = _library()
    th, tw = pick_tile(_BWD, h, w, c, co, lib=lib, route=route)
    target = _BWD_TARGET_BLOCKS
    if route == MMA:  # persistent blocks: as many as fit on the card at once
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        per_sm = lib.locate_stage_blocks_per_sm(_ROUTE_CODE[MMA], _BWD, c, co, 0, 0, th, tw)
        if per_sm < 1:
            raise RuntimeError(f"stage conv backward (mma): no block fits on an SM ({per_sm})")
        target = sms * per_sm
    blocks = bwd_blocks(n, h, w, th, tw, target)
    sizes = [3 * c * co, 3 * co * co, co] + ([c * co] if ws_ is not None else [])
    with torch.cuda.device(x.device):
        du = torch.empty_like(x_)
        dxs = torch.empty_like(x_)
        part = torch.empty((blocks, sum(sizes)), dtype=torch.float32, device=x.device)
        grads = torch.empty(sum(sizes), dtype=torch.float32, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.locate_stage_conv_bwd(
            _ROUTE_CODE[route], int(x.dtype == torch.bfloat16), x_.data_ptr(), dw_.data_ptr(),
            a_.data_ptr(), b_.data_ptr(), wr_.data_ptr(), wc_.data_ptr(), _ptr(ws_), _ptr(wr_t),
            _ptr(wc_t), _ptr(ws_t), du.data_ptr(), dxs.data_ptr(), part.data_ptr(), grads.data_ptr(),
            n, h, w, c, co, th, tw, blocks, fa.ACT_CODES[act], float(leaky_slope),
            int(upsample), stream)
    _check(lib, err, f"stage conv backward ({route})")
    _count(stage_conv_bwd, route)
    parts = grads.split(sizes)
    dws = parts[3].view(c, co) if ws_ is not None else None
    return du, dxs, parts[0].view(3, c, co), parts[1].view(3, co, co), parts[2], dws


stage_conv_bwd.launches = 0
stage_conv_bwd.launches_mma = stage_conv_bwd.launches_simt = 0


# ---------------------------------------------------------------------------
# the stage as one first-order autograd Function
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StageOptions:
    h: int                      # fine output dims (before any pool)
    w: int
    groups: int
    eps: float
    act: str
    leaky_slope: float
    mode: Optional[str]
    gate_max: float
    upsample: bool
    downsample: bool
    oracle_bwd: bool

    @property
    def hand_written(self) -> bool:
        """Whether the backward runs the kernels (`_PALLAS_BWD_ACTS`)."""
        return self.act in fa.BWD_ACTS and not self.oracle_bwd


_NAMES = ("x", "gn_scale", "gn_bias", "w_row", "w_col", "b_col", "w_skip", "pos_proj",
          "w1x", "b1", "w2", "b2")


def kernel_weights(w_row, w_col, w_skip, dtype):
    """OIHW weights in the kernels' layout and dtype: wr (3, C, Co),
    wc (3, Co, Co), ws (C, Co) or None."""
    wr = w_row[:, :, 0, :].permute(2, 1, 0).to(dtype)
    wc = w_col[:, :, :, 0].permute(2, 1, 0).to(dtype)
    ws = None if w_skip is None else w_skip[:, :, 0, 0].t().to(dtype)
    return wr, wc, ws


def _forward(o: StageOptions, x, gn_scale, gn_bias, w_row, w_col, b_col, w_skip, gate):
    kw = dict(act=o.act, leaky_slope=o.leaky_slope)
    a, b = fold_groupnorm(x, gn_scale, gn_bias, o.groups, o.eps)
    wr, wc, ws = kernel_weights(w_row, w_col, w_skip, x.dtype)
    if o.mode is None:
        return stage_conv(x, a, b, wr, wc, b_col, ws, upsample=o.upsample,
                          downsample=o.downsample, **kw)
    if o.mode == "sigmoid":
        return stage_sigmoid(x, a, b, wr, wc, b_col, ws, *gate, gate_max=o.gate_max,
                             upsample=o.upsample, downsample=o.downsample, **kw)
    w_pre, m, se = stage_softmax_stats(x, a, b, wr, wc, b_col, ws, *gate,
                                       upsample=o.upsample, **kw)
    opts = dict(hw_scale=float(o.h * o.w), gate_max=o.gate_max, **kw)
    if o.downsample:
        return stage_softmax_apply_pool(w_pre, *gate, m, se, **opts)
    n, h, w, co = w_pre.shape
    y = fa.softmax_gate_apply(w_pre.reshape(n, h * w, co), *gate, m, se, **opts)
    return y.reshape(w_pre.shape)


def _backward(o: StageOptions, gy, x, gn_scale, gn_bias, w_row, w_col, b_col, w_skip, gate):
    """The chain of `bwd_op`: (dx, d gn_scale, d gn_bias, dw_row, dw_col,
    db_col, dw_skip, dpos_proj, dw1x, db1, dw2, db2), None where absent."""
    kw = dict(act=o.act, leaky_slope=o.leaky_slope)
    if o.downsample:  # the pool's vjp: the coarse cotangent, expanded, x 1/4
        gy = up2x(gy.float() * 0.25).to(gy.dtype)
    a, b = fold_groupnorm(x, gn_scale, gn_bias, o.groups, o.eps)
    wr, wc, ws = kernel_weights(w_row, w_col, w_skip, x.dtype)
    gate_grads = (None,) * 5
    dw = gy
    if o.mode is not None:
        w_pre = stage_conv(x, a, b, wr, wc, b_col, ws, upsample=o.upsample, **kw)
        n, h, w, co = w_pre.shape
        w2d, gy2 = w_pre.reshape(n, h * w, co), gy.reshape(n, h * w, co)
        if o.mode == "softmax":
            opts = dict(hw_scale=float(h * w), gate_max=o.gate_max, **kw)
            m, se = fa.softmax_gate_stats(w2d, *gate, **kw)
            c = fa.softmax_gate_csum(w2d, gy2, *gate, m, se, **opts)
            dw2d, *gate_grads = fa.softmax_gate_backward(w2d, gy2, *gate, m, se, c, **opts)
        else:
            dw2d, *gate_grads = fa.sigmoid_gate_backward(w2d, gy2, *gate, gate_max=o.gate_max,
                                                         **kw)
        dw = dw2d.reshape(w_pre.shape)
    du, dxs, dwr, dwc, dbc, dws = stage_conv_bwd(x, dw, a, b, wr, wc, ws,
                                                 upsample=o.upsample, **kw)
    dx, d_scale, d_bias = groupnorm_act_backward(x, du, dxs, gn_scale, gn_bias,
                                                 groups=o.groups, eps=o.eps, **kw)
    return (dx, d_scale.to(gn_scale.dtype), d_bias.to(gn_bias.dtype),
            dwr.permute(2, 1, 0)[:, :, None, :].to(w_row.dtype),
            dwc.permute(2, 1, 0)[:, :, :, None].to(w_col.dtype), dbc.to(b_col.dtype),
            None if dws is None else dws.t()[:, :, None, None].to(w_skip.dtype),
            *gate_grads)


def _oracle_backward(o: StageOptions, gy, inputs):
    """The vjp of `stage_oracle` (`jax.vjp` of the oracle in JAX)."""
    leaves = [None if t is None else t.detach().requires_grad_(True) for t in inputs]
    ops = {k: t for k, t in zip(_NAMES, leaves) if t is not None}
    with torch.enable_grad():
        y = stage_oracle(ops, h=o.h, w=o.w, groups=o.groups, eps=o.eps, act=o.act,
                         leaky_slope=o.leaky_slope, mode=o.mode, gate_max=o.gate_max,
                         upsample=o.upsample, downsample=o.downsample)
        live = [t for t in leaves if t is not None]
        grads = iter(torch.autograd.grad(y, live, gy, allow_unused=True))
    return tuple(None if t is None else next(grads) for t in leaves)


class FusedStage(torch.autograd.Function):
    """The fused stage, first-order only: the counterpart of
    `_make_stage_core`'s custom_vjp. It saves its inputs and recomputes
    w in the backward; differentiating the backward again raises
    (`ops/first_order.py`), so second-order terms such as R1 go through
    the plain composition."""

    @staticmethod
    def forward(ctx, o: StageOptions, x, gn_scale, gn_bias, w_row, w_col, b_col, w_skip,
                pos_proj, w1x, b1, w2, b2):
        ctx.options = o
        ctx.save_for_backward(x, gn_scale, gn_bias, w_row, w_col, b_col, w_skip, pos_proj,
                              w1x, b1, w2, b2)
        return _forward(o, x, gn_scale, gn_bias, w_row, w_col, b_col, w_skip,
                        (pos_proj, w1x, b1, w2, b2))

    @staticmethod
    @first_order
    def backward(ctx, gy):
        o = ctx.options
        saved = ctx.saved_tensors
        if o.hand_written:
            grads = _backward(o, gy, *saved[:7], saved[7:])
        else:
            grads = _oracle_backward(o, gy, saved)
        return (None, *grads)


def fused_stage(
    x: torch.Tensor,                        # (N, H, W, C), coarse under upsample
    gn_scale: torch.Tensor,                 # (C,)
    gn_bias: torch.Tensor,                  # (C,)
    w_row: torch.Tensor,                    # (Co, C, 1, 3)
    w_col: torch.Tensor,                    # (Co, Co, 3, 1)
    b_col: torch.Tensor,                    # (Co,)
    w_skip: Optional[torch.Tensor],         # (Co, C, 1, 1) or None (identity)
    *,
    groups: int,
    eps: float = 1e-5,
    act: str = "leaky_relu",
    leaky_slope: float = 0.2,
    mode: Optional[str] = None,             # None: the conv block only
    pos_proj: Optional[torch.Tensor] = None,  # (H*W, Hd) at the fine resolution
    w1x: Optional[torch.Tensor] = None,     # (Co, Hd)
    b1: Optional[torch.Tensor] = None,      # (Hd,)
    w2: Optional[torch.Tensor] = None,      # (Hd, Cout)
    b2: Optional[torch.Tensor] = None,      # (Cout,)
    gate_max: float = 0.0,
    oracle_bwd: bool = False,
    upsample: bool = False,
    downsample: bool = False,
) -> torch.Tensor:
    """The fused pre-activation residual conv block with the optional
    residual-form location gate, behind an optional nearest-2x upsample or
    before an optional 2x2 average pool (`fused_stage` of the JAX package,
    with the port's OIHW weights). CUDA tensors run the kernels, CPU
    tensors their plain versions. Differentiable to first order."""
    if upsample and downsample:
        raise ValueError("upsample and downsample are mutually exclusive")
    if mode not in (None, "softmax", "sigmoid"):
        raise ValueError(f"unknown gate mode {mode!r}")
    n, h, w, c = x.shape
    if upsample:
        h, w = 2 * h, 2 * w
    if mode is not None and pos_proj is None:
        pos_proj = torch.zeros((h * w, w1x.shape[1]), dtype=torch.float32, device=x.device)
    o = StageOptions(h=h, w=w, groups=int(groups), eps=float(eps), act=act,
                     leaky_slope=float(leaky_slope), mode=mode, gate_max=float(gate_max),
                     upsample=bool(upsample), downsample=bool(downsample),
                     oracle_bwd=bool(oracle_bwd))
    gate = (pos_proj, w1x, b1, w2, b2) if mode is not None else (None,) * 5
    return FusedStage.apply(o, x, gn_scale, gn_bias, w_row, w_col, b_col, w_skip, *gate)
