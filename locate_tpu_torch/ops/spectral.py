"""Spectral normalization of the discriminator, counterpart of
`locate_tpu/ops/spectral.py` (SN-GAN, arXiv 1802.05957).

Stateless, as the JAX package's: every D forward runs `n_iters`
power iterations from a fixed start vector with u and v detached, then
forms sigma = u^T W v, differentiable in W (d sigma / dW = u v^T), and
divides W by max(sigma, eps). No buffer joins the parameters, so the
optimizer, EMA and checkpoint layouts do not change with the option.

The start vector is JAX's `normal(PRNGKey(0), (fan_out,))`
(`utils/jax_random.py`), and a weight is viewed as JAX's (fan_in,
fan_out) matrix (conv kernels OIHW -> HWIO, then rows of kh*kw*ci), so a
JAX discriminator's normalized weights come out the same here.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

from locate_tpu_torch.utils import jax_random

_START: Dict[Tuple[int, str], torch.Tensor] = {}


def start_vector(cols: int, device) -> torch.Tensor:
    """JAX's `normal(PRNGKey(0), (cols,))` on `device`, made once a
    (cols, device) (before a CUDA graph's capture: its warm-up runs the
    forward first)."""
    key = (cols, str(device))
    v = _START.get(key)
    if v is None:
        v = torch.from_numpy(jax_random.normal(jax_random.prng_key(0), (cols,))).to(device)
        _START[key] = v
    return v


def as_matrix(w: torch.Tensor) -> torch.Tensor:
    """A weight as JAX's (fan_in, fan_out) matrix: an OIHW conv kernel as
    its HWIO reshape (kh*kw*ci, co), a dense [in, out] as it is."""
    if w.ndim == 4:
        w = w.permute(2, 3, 1, 0)
    return w.reshape(-1, w.shape[-1])


def spectral_sigma(w: torch.Tensor, n_iters: int = 9, eps: float = 1e-12) -> torch.Tensor:
    """The largest singular value of `w` by fresh-start power iteration,
    in f32; the gradient reaches `w` through sigma = u^T W v alone."""
    m = as_matrix(w).float()
    with torch.no_grad():
        v = start_vector(m.shape[1], m.device)
        v = v / torch.linalg.vector_norm(v)
        for _ in range(n_iters):
            u = m @ v
            u = u / (torch.linalg.vector_norm(u) + eps)
            v = m.T @ u
            v = v / (torch.linalg.vector_norm(v) + eps)
        u = m @ v
        u = u / (torch.linalg.vector_norm(u) + eps)
    return u @ (m @ v)


def normalized(name: str, w: torch.Tensor) -> bool:
    """Whether spectral norm divides this parameter: a leaf named `w` of
    two dimensions or more (biases, norms and `class_proj` pass)."""
    return name.rsplit(".", 1)[-1] == "w" and w.ndim >= 2


def spectral_normalize(params: Mapping[str, torch.Tensor], n_iters: int = 9,
                       eps: float = 1e-12) -> Dict[str, torch.Tensor]:
    """The `normalized` entries of a name -> tensor mapping divided by
    their spectral norms (the others are left out)."""
    out = {}
    for name, w in params.items():
        if normalized(name, w):
            sigma = spectral_sigma(w, n_iters, eps)
            out[name] = (w.float() / torch.clamp_min(sigma, eps)).to(w.dtype)
    return out
