"""Sampling, counterpart of `locate_tpu/io/sampling.py`: latents from an
explicit `torch.Generator`, images to uint8 on the device before the copy
to the host, the style family's w-space truncation, slerp interpolation
sheets, PNG grids, and the serving generator of a train state (its EMA
weights in a module of their own)."""

from __future__ import annotations

import math
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from torch import nn

W_AVG_DRAWS = 4096  # latents of a truncation centre (`style_generator.w_average`)


def sample_latents(gen: torch.Generator, n: int, latent_dim: int,
                   truncation: float = 0.0) -> torch.Tensor:
    """z ~ N(0, I) in f32 on `gen`'s device (`models/gan.py:sample_latents`;
    the generator casts it to the compute dtype). `truncation` > 0 draws
    from the normal truncated to [-truncation, truncation] by inverting
    its CDF."""
    shape = (n, latent_dim)
    if truncation > 0.0:
        lo = 0.5 * (1.0 + math.erf(-truncation / math.sqrt(2.0)))
        u = torch.rand(shape, generator=gen, device=gen.device, dtype=torch.float64)
        p = lo + u * (1.0 - 2.0 * lo)
        z = (math.sqrt(2.0) * torch.erfinv(2.0 * p - 1.0)).float()
        z = z.clamp(-truncation, truncation)
    else:
        z = torch.randn(shape, generator=gen, device=gen.device)
    return z


def to_uint8(imgs: np.ndarray) -> np.ndarray:
    """Denormalize [-1, 1] -> [0, 255] uint8."""
    return np.clip((imgs + 1.0) * 127.5 + 0.5, 0, 255).astype(np.uint8)


def to_uint8_tensor(imgs: torch.Tensor) -> torch.Tensor:
    """`to_uint8` on the device, in f32: the host copy is then one byte
    per channel."""
    return ((imgs.float() + 1.0) * 127.5 + 0.5).clamp(0, 255).to(torch.uint8)


def check_truncation_psi(model: nn.Module, truncation_psi: float) -> None:
    if truncation_psi > 0.0 and model.config.arch != "style":
        raise ValueError("truncation_psi is w-space truncation — it needs "
                         "model.arch='style' (use `truncation` for z-space)")


def truncation_centre(model: nn.Module, gen: torch.Generator) -> torch.Tensor:
    """The style family's w-space truncation centre: the mean w of
    `W_AVG_DRAWS` latents drawn from `gen`. `generate_samples` and
    `SampleGraph` both draw it before any z, so from one seed their first
    batches are the same images."""
    from locate_tpu_torch.models.style_generator import w_average

    with torch.inference_mode():
        return w_average(model, gen, W_AVG_DRAWS)


def generate_samples(model: nn.Module, gen: torch.Generator, count: int,
                     labels: Optional[torch.Tensor] = None,
                     truncation: float = 0.0, truncation_psi: float = 0.0) -> np.ndarray:
    """Run the generator on its device and return uint8 NHWC images on the
    host (device compute and the transfer both included). `truncation` >
    0 truncates the z draw (either family); `truncation_psi` in (0, 1]
    applies the style family's w-space truncation around
    `truncation_centre(model, gen)`, drawn before z."""
    cfg = model.config
    check_truncation_psi(model, truncation_psi)
    device = gen.device
    with torch.inference_mode():
        w_avg = truncation_centre(model, gen) if truncation_psi > 0.0 else None
        z = sample_latents(gen, count, cfg.latent_dim, truncation)
        if labels is None and cfg.num_classes:
            labels = torch.arange(count, device=device) % cfg.num_classes
        if w_avg is not None:
            from locate_tpu_torch.models.style_generator import apply_truncated

            imgs = apply_truncated(model, z, labels, psi=truncation_psi, w_avg=w_avg)
        else:
            imgs = model(z, labels)
        return to_uint8_tensor(imgs).cpu().numpy()


class ShardedSampler:
    """Data-parallel serving (`locate_tpu/io/sampling.py:ShardedSampler`):
    each request's batch split over the ranks of `mesh` (by default the
    process group's, `parallel/mesh.py:make_mesh`), one forward a rank.
    The latents are `generate_samples`' draw of `count` from `gen` on
    every rank (so the generators stay in step, and from one seed the
    images are `generate_samples`' images), padded with zero rows up to a
    multiple of the world; rank 0 gathers the images and trims the
    padding. `gan_or_model` is a GAN (its generator) or a generator
    module; `weights` (parameters by name, e.g. `serving_weights(state)`)
    go into a serving copy of it, else the module serves as it is."""

    def __init__(self, gan_or_model, weights: Optional[Dict[str, torch.Tensor]] = None,
                 mesh=None):
        model = getattr(gan_or_model, "generator", gan_or_model)
        if weights is not None:
            from locate_tpu_torch.models.generator import build_generator

            device = next(model.parameters()).device
            model = build_generator(model.config, model.compute_dtype, device).eval()
            model.load_state_dict(weights)
        if mesh is None:
            from locate_tpu_torch.config import ParallelConfig
            from locate_tpu_torch.parallel.mesh import make_mesh

            mesh = make_mesh(ParallelConfig(data_parallel=-1))
        self.model, self.mesh = model, mesh

    def __call__(self, gen: torch.Generator, count: int, labels: Optional[torch.Tensor] = None,
                 truncation: float = 0.0) -> Optional[np.ndarray]:
        """uint8 NHWC images of `count` samples on rank 0 (None on the
        other ranks); every rank calls it."""
        cfg, mesh = self.model.config, self.mesh
        per = -(-count // mesh.world)
        with torch.inference_mode():
            z = sample_latents(gen, count, cfg.latent_dim, truncation)
            if labels is None and cfg.num_classes:
                labels = torch.arange(count, device=gen.device) % cfg.num_classes
            pad = per * mesh.world - count
            if pad:
                z = torch.cat([z, z.new_zeros((pad, z.shape[1]))])
                if labels is not None:
                    labels = torch.cat([labels, labels.new_zeros(pad)])
            rows = slice(mesh.rank * per, (mesh.rank + 1) * per)
            imgs = to_uint8_tensor(self.model(z[rows], None if labels is None else labels[rows]))
            imgs = mesh.all_gather(imgs)
        return imgs[:count].cpu().numpy() if mesh.primary else None


def slerp(a: torch.Tensor, b: torch.Tensor, t) -> torch.Tensor:
    """Spherical interpolation between latent vectors (the way to walk a
    Gaussian latent space: a linear path leaves the shell); parallel
    vectors fall back to the linear path."""
    a_n = a / torch.linalg.vector_norm(a, dim=-1, keepdim=True)
    b_n = b / torch.linalg.vector_norm(b, dim=-1, keepdim=True)
    omega = torch.arccos(torch.clamp((a_n * b_n).sum(-1, keepdim=True), -1, 1))
    so = torch.sin(omega)
    t = torch.as_tensor(t, dtype=a.dtype, device=a.device)[..., None]
    return torch.where(so < 1e-6, (1.0 - t) * a + t * b,
                       (torch.sin((1.0 - t) * omega) * a + torch.sin(t * omega) * b) / so)


def interpolation_grid(model: nn.Module, gen: torch.Generator, rows: int = 4, cols: int = 8,
                       labels: Optional[torch.Tensor] = None,
                       latents: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> np.ndarray:
    """`rows` latent pairs (drawn from `gen` unless `latents` gives them,
    each [rows, latent_dim]), each slerp-interpolated across `cols` steps:
    uint8 (rows * cols, H, W, C) in row-major order for
    `save_image_grid(..., cols=cols)`. A class-conditional model's row r
    takes class r mod num_classes."""
    cfg = model.config
    device = gen.device
    if latents is None:
        latents = (sample_latents(gen, rows, cfg.latent_dim),
                   sample_latents(gen, rows, cfg.latent_dim))
    za, zb = (z.to(device, torch.float32) for z in latents)
    ts = torch.linspace(0.0, 1.0, cols, device=device)
    z = torch.stack([slerp(za, zb, torch.full((rows,), float(t), device=device))
                     for t in ts])                      # (cols, rows, D)
    z = z.transpose(0, 1).reshape(rows * cols, -1)
    if labels is None and cfg.num_classes:
        labels = torch.repeat_interleave(torch.arange(rows, device=device) % cfg.num_classes,
                                         cols)
    with torch.inference_mode():
        return to_uint8_tensor(model(z, labels)).cpu().numpy()


def serving_weights(state) -> Dict[str, torch.Tensor]:
    """The generator weights a train state serves, by parameter name: its
    EMA shadow's, or G's own where the run keeps no EMA (views, not
    copies)."""
    flat = state.ema_params if state.ema_params is not None else state.g_params.flat
    return state.g_params.named(flat)


def serving_generator(gan, state) -> nn.Module:
    """A second generator module holding `serving_weights(state)`, for
    sample grids and `sample --checkpoint`: the live G keeps training,
    this one only serves."""
    from locate_tpu_torch.models.generator import build_generator

    model = build_generator(gan.config, gan.compute_dtype, gan.device).eval()
    return load_weights(model, state)


def load_weights(model: nn.Module, state) -> nn.Module:
    """Copy `serving_weights(state)` into `model`."""
    model.load_state_dict(serving_weights(state))
    return model


def tile_grid(imgs: np.ndarray, cols: Optional[int] = None) -> np.ndarray:
    """Tile (N, H, W, C) uint8 images into one grid image."""
    n, h, w, c = imgs.shape
    cols = cols or int(np.ceil(np.sqrt(n)))
    rows = int(np.ceil(n / cols))
    grid = np.zeros((rows * h, cols * w, c), np.uint8)
    for i in range(n):
        r, col = divmod(i, cols)
        grid[r * h:(r + 1) * h, col * w:(col + 1) * w] = imgs[i]
    return grid


def save_image_grid(imgs: np.ndarray, path: str, cols: Optional[int] = None) -> str:
    """Write a PNG grid to `path`."""
    from PIL import Image

    grid = tile_grid(imgs, cols)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if grid.shape[-1] == 1:
        grid = grid[..., 0]
    Image.fromarray(grid).save(path)
    return path
