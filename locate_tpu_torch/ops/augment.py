"""Discriminator augmentation (StyleGAN2-ADA), counterpart of
`locate_tpu/ops/augment.py`: D sees `aug(x)` for reals and fakes, each op
applied to a sample with probability p, and G's step differentiates
through the augmentation of its fakes.

The draws and the application are apart. `draw_params(gen, x_shape, p,
ops)` draws a batch's parameters from a `torch.Generator` (p may be a
device tensor, ADA's; nothing reads it on the host, so a CUDA graph can
capture the draw), and `augment(x, params, ops)` applies given
parameters, differentiably in x, with the JAX package's arithmetic: one
gather for flip, rot90 and integer translation, a bilinear gather with
reflect-101 padding for the affine group (not `F.grid_sample`, whose
corner conventions differ), then color, noise and cutout. Tests feed the
parameters the JAX package draws from its key splits.

Categories ("geom", "affine", "color", "noise", "cutout") and their
parameters, each (N,) unless said:
  geom:   flip (bool), ty, tx (int64, 0 where translation is off), rk
          (int64 quarter turns, 0 where off; square images only);
  affine: iso, theta, aniso, atx, aty (f32, the identity where off);
  color:  b_on, c_on, s_on (bool), b, cfac, sfac (f32; s only for RGB);
  noise:  n_on (bool), sigma (f32), noise (f32 of x's shape, N(0, 1));
  cutout: cut_on (bool), cy, cx (int64 box centres).
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Sequence, Tuple, Union

import torch

CATEGORIES = ("geom", "affine", "color", "noise", "cutout")

Params = Dict[str, torch.Tensor]


def parse_ops(spec: str) -> Tuple[str, ...]:
    """`train.augment_ops` / `bcr_ops` ("geom,color,cutout") as a tuple."""
    ops = tuple(s.strip() for s in spec.split(",") if s.strip())
    unknown = set(ops) - set(CATEGORIES)
    if unknown:
        raise ValueError(f"unknown augmentation categories {sorted(unknown)}")
    return ops


def draw_params(gen: torch.Generator, shape: Sequence[int], p: Union[float, torch.Tensor],
                ops: Sequence[str]) -> Params:
    """One batch's augmentation parameters for images of NHWC `shape`,
    drawn from `gen` on its device; each op is on for a sample with
    probability `p`."""
    n, h, w, c = shape
    dev = gen.device

    def on():
        return torch.rand((n,), generator=gen, device=dev) < p

    def normal():
        return torch.randn((n,), generator=gen, device=dev)

    def randint(lo, hi):
        return torch.randint(lo, hi, (n,), generator=gen, device=dev)

    zero = torch.zeros((n,), dtype=torch.int64, device=dev)
    out: Params = {}
    if "geom" in ops:
        out["flip"] = on()
        t_on = on()
        my, mx = max(h // 8, 1), max(w // 8, 1)
        out["ty"] = torch.where(t_on, randint(-my, my + 1), zero)
        out["tx"] = torch.where(t_on, randint(-mx, mx + 1), zero)
        if h == w:
            out["rk"] = torch.where(on(), randint(1, 4), zero)
    if "affine" in ops:
        one = torch.ones((n,), device=dev)
        out["iso"] = torch.where(on(), torch.exp2(normal() * 0.2), one)
        out["theta"] = torch.where(
            on(), torch.rand((n,), generator=gen, device=dev) * (2 * math.pi) - math.pi,
            one * 0.0)
        out["aniso"] = torch.where(on(), torch.exp2(normal() * 0.2), one)
        t_on = on()
        out["atx"] = torch.where(t_on, normal() * (0.125 * w), one * 0.0)
        out["aty"] = torch.where(t_on, normal() * (0.125 * h), one * 0.0)
    if "color" in ops:
        out["b_on"], out["b"] = on(), normal() * 0.2
        out["c_on"], out["cfac"] = on(), torch.exp2(normal() * 0.5)
        if c == 3:
            out["s_on"], out["sfac"] = on(), torch.exp2(normal())
    if "noise" in ops:
        out["n_on"] = on()
        out["sigma"] = normal().abs() * 0.1
        out["noise"] = torch.randn(tuple(shape), generator=gen, device=dev)
    if "cutout" in ops:
        out["cut_on"] = on()
        out["cy"], out["cx"] = randint(0, h), randint(0, w)
    return out


def augment(x: torch.Tensor, params: Params, ops: Sequence[str]) -> torch.Tensor:
    """The augmentation stack on an NHWC batch with given parameters, in
    the JAX package's order (geom, affine, color, noise, cutout)."""
    if "geom" in ops:
        x = _blit(x, params)
    if "affine" in ops:
        x = affine_warp(x, params["iso"], params["theta"], params["aniso"],
                        params["atx"], params["aty"])
    if "color" in ops:
        x = _color(x, params)
    if "noise" in ops:
        noise = (params["noise"] * params["sigma"][:, None, None, None]).to(x.dtype)
        x = torch.where(params["n_on"][:, None, None, None], x + noise, x)
    if "cutout" in ops:
        x = _cutout(x, params)
    return x


def _rows(n: int, device) -> torch.Tensor:
    return torch.arange(n, device=device)[:, None, None]


def _blit(x: torch.Tensor, params: Params) -> torch.Tensor:
    """Flip, integer translation (wrap-around) and rot90 as one gather."""
    n, h, w, _ = x.shape
    dev = x.device
    ty, tx = params["ty"][:, None, None], params["tx"][:, None, None]
    gy = torch.remainder(torch.arange(h, device=dev)[None, :, None] - ty, h)
    gx = torch.remainder(torch.arange(w, device=dev)[None, None, :] - tx, w)
    gx = torch.where(params["flip"][:, None, None], w - 1 - gx, gx)
    gy, gx = gy.expand(n, h, w), gx.expand(n, h, w)
    if "rk" in params:
        rk = params["rk"][:, None, None]
        sy = torch.where(rk == 1, gx, torch.where(rk == 2, h - 1 - gy,
                                                  torch.where(rk == 3, w - 1 - gx, gy)))
        sx = torch.where(rk == 1, h - 1 - gy, torch.where(rk == 2, w - 1 - gx,
                                                          torch.where(rk == 3, gy, gx)))
        gy, gx = sy, sx
    return x[_rows(n, dev), gy, gx]


def affine_warp(x, scale, theta, aniso, tx, ty) -> torch.Tensor:
    """Per-sample affine resampling about the image centre: an output pixel
    samples the inverse-mapped source point of p_out = R(theta)
    diag(scale aniso, scale / aniso) p_src + (tx, ty) bilinearly, the
    source reflect-101 padded. (1, 0, 1, 0, 0) is the identity, exactly."""
    n, h, w, _ = x.shape
    dev, dtype = x.device, x.dtype
    sx = (scale * aniso)[:, None, None]
    sy = (scale / aniso)[:, None, None]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None] - cy
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :] - cx
    px = xx - tx[:, None, None]
    py = yy - ty[:, None, None]
    cos, sin = torch.cos(theta)[:, None, None], torch.sin(theta)[:, None, None]
    src_x = (cos * px + sin * py) / sx + cx
    src_y = (-sin * px + cos * py) / sy + cy
    x0, y0 = torch.floor(src_x), torch.floor(src_y)
    fx, fy = (src_x - x0)[..., None], (src_y - y0)[..., None]
    x0, y0 = x0.to(torch.int64), y0.to(torch.int64)

    def ref(i, size):  # reflect-101: a triangle wave of period 2 size - 2
        if size == 1:
            return torch.zeros_like(i)
        m = 2 * size - 2
        i = torch.remainder(i, m)
        return torch.where(i >= size, m - i, i)

    b = _rows(n, dev)

    def g(yi, xi):
        return x[b, ref(yi, h), ref(xi, w)].float()

    out = (g(y0, x0) * (1 - fy) * (1 - fx) + g(y0, x0 + 1) * (1 - fy) * fx
           + g(y0 + 1, x0) * fy * (1 - fx) + g(y0 + 1, x0 + 1) * fy * fx)
    return out.to(dtype)


@functools.lru_cache(maxsize=None)
def _luma_weights(dtype: torch.dtype, device: str) -> torch.Tensor:
    """The RGB luma weights on `device`, made once (a captured step may
    copy nothing from the host)."""
    return torch.tensor([0.299, 0.587, 0.114], dtype=dtype, device=device)


def _color(x: torch.Tensor, params: Params) -> torch.Tensor:
    n, _, _, c = x.shape
    dtype = x.dtype

    def blend(apply, aug):
        return torch.where(apply[:, None, None, None], aug, x)

    x = blend(params["b_on"], x + params["b"].to(dtype)[:, None, None, None])
    cfac = params["cfac"].to(dtype)[:, None, None, None]
    # f32 accumulation of the mean, as the JAX package does
    mean = x.float().mean(dim=(1, 2, 3), keepdim=True).to(dtype)
    x = blend(params["c_on"], (x - mean) * cfac + mean)
    if c == 3:
        sfac = params["sfac"].to(dtype)[:, None, None, None]
        luma = (x * _luma_weights(dtype, str(x.device))).sum(-1, keepdim=True)
        x = blend(params["s_on"], (x - luma) * sfac + luma)
    return x


def _cutout(x: torch.Tensor, params: Params) -> torch.Tensor:
    n, h, w, _ = x.shape
    dev = x.device
    yy = torch.arange(h, device=dev)[None, :, None]
    xx = torch.arange(w, device=dev)[None, None, :]
    keep = ((yy - params["cy"][:, None, None]).abs() >= h // 4) | (
        (xx - params["cx"][:, None, None]).abs() >= w // 4)
    keep = keep | ~params["cut_on"][:, None, None]
    return x * keep[..., None].to(x.dtype)
