"""Sampling, counterpart of `locate_tpu/io/sampling.py`: latents from an
explicit `torch.Generator`, images to uint8 on the device before the copy
to the host, and PNG grids."""

from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np
import torch

from locate_tpu_torch.models.generator import Generator


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


def generate_samples(model: Generator, gen: torch.Generator, count: int,
                     labels: Optional[torch.Tensor] = None,
                     truncation: float = 0.0) -> np.ndarray:
    """Run the generator on its device and return uint8 NHWC images on the
    host (device compute and the transfer both included)."""
    cfg = model.config
    device = gen.device
    with torch.inference_mode():
        z = sample_latents(gen, count, cfg.latent_dim, truncation)
        if labels is None and cfg.num_classes:
            labels = torch.arange(count, device=device) % cfg.num_classes
        imgs = model(z, labels)
        return to_uint8_tensor(imgs).cpu().numpy()


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
