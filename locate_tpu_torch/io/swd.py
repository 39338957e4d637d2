"""Sliced Wasserstein distance over Laplacian-pyramid patches (ProGAN,
arXiv 1710.10196 §5 and appendix A), counterpart of `locate_tpu/io/swd.py`:
a multi-scale quality metric that needs no pretrained network.

Protocol: a Laplacian pyramid of both image sets down to `min_res`; at
each level `patches_per_image` random 7x7xC patches an image, each set
normalized per channel (mean / population std over all its patches);
both clouds projected onto random unit directions; the estimate is the
mean |difference| of the sorted projections (the exact 1-D W1 per
direction), averaged over `n_proj` directions x `repeats` draws, x1e3.

The draws are the JAX package's (`utils/jax_random.py`, bit for bit):
level li's key is fold_in(prng_key(seed), li), split into k_patch and
k_proj; patch positions are `randint` draws of split(k_patch), and
repeat r's directions `normal(fold_in(k_proj, r), (d, n_proj))` over the
(y, x, c) order of a patch. Both sets take the same k_patch, so
swd(x, x) == 0 exactly. The pyramid, the patch gather (index arithmetic),
the projections and the sorts run on a device, in f32 with TF32 off.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from locate_tpu_torch.device import resolve_device
from locate_tpu_torch.io.fid import exact_f32, generate_fakes, real_examples
from locate_tpu_torch.utils import jax_random as jr

PATCH = 7

# ProGAN's 5-tap binomial pyramid filter [1,4,6,4,1]/16
_K5 = np.asarray([1.0, 4.0, 6.0, 4.0, 1.0], np.float32) / 16.0
_K5_2D = np.outer(_K5, _K5)  # (5, 5), sums to 1


def _blur(x: torch.Tensor, gain: float = 1.0) -> torch.Tensor:
    """Depthwise 5x5 binomial blur, padding 2 on each side (NHWC)."""
    c = x.shape[-1]
    k = torch.as_tensor(_K5_2D * np.float32(gain), dtype=x.dtype, device=x.device)
    y = F.conv2d(x.permute(0, 3, 1, 2), k.expand(c, 1, 5, 5), padding=2, groups=c)
    return y.permute(0, 2, 3, 1)


def _pyr_down(x: torch.Tensor) -> torch.Tensor:
    return _blur(x)[:, ::2, ::2, :]


def _pyr_up(x: torch.Tensor) -> torch.Tensor:
    """Zero-stuff 2x, then blur with gain 4 (the zero-stuffed image has a
    quarter of the energy)."""
    n, h, w, c = x.shape
    up = x.new_zeros((n, 2 * h, 2 * w, c))
    up[:, ::2, ::2, :] = x
    return _blur(up, gain=4.0)


def laplacian_pyramid(x: torch.Tensor, n_levels: int) -> List[torch.Tensor]:
    """Fine-to-coarse Laplacian pyramid of NHWC `x`: n_levels - 1
    band-pass levels and the Gaussian base."""
    levels = []
    for _ in range(n_levels - 1):
        down = _pyr_down(x)
        levels.append(x - _pyr_up(down))
        x = down
    levels.append(x)
    return levels


def patch_descriptors(level: torch.Tensor, key: np.ndarray,
                      patches_per_image: int = 128) -> torch.Tensor:
    """(N, H, W, C) level -> (N * patches_per_image, PATCH, PATCH, C)
    patches at uniform positions: `randint` draws of split(key) for the
    rows and the columns."""
    n, h, w, c = level.shape
    ky, kx = jr.split(key)
    dev = level.device
    ys = torch.from_numpy(jr.randint(ky, (n, patches_per_image), 0, h - PATCH + 1)).to(dev)
    xs = torch.from_numpy(jr.randint(kx, (n, patches_per_image), 0, w - PATCH + 1)).to(dev)
    off = torch.arange(PATCH, device=dev)
    rows = (ys.long()[:, :, None] + off)[:, :, :, None]      # (N, P, 7, 1)
    cols = (xs.long()[:, :, None] + off)[:, :, None, :]      # (N, P, 1, 7)
    img = torch.arange(n, device=dev)[:, None, None, None]   # (N, 1, 1, 1)
    return level[img, rows, cols].reshape(n * patches_per_image, PATCH, PATCH, c)


def _normalize_descriptors(desc: torch.Tensor) -> torch.Tensor:
    """Per-channel mean / population std over the whole descriptor set
    (ProGAN's finalize_descriptors), flattened to (n, PATCH*PATCH*C)."""
    mu = desc.mean(dim=(0, 1, 2), keepdim=True)
    sd = desc.std(dim=(0, 1, 2), keepdim=True, correction=0) + 1e-8
    d = (desc - mu) / sd
    return d.reshape(d.shape[0], -1)


def sliced_wasserstein(a: torch.Tensor, b: torch.Tensor, key: np.ndarray,
                       n_proj: int = 512, repeats: int = 4,
                       dirs: Optional[np.ndarray] = None) -> float:
    """SWD between two equal-size descriptor clouds (n, d): the mean over
    unit directions of the exact 1-D W1. `dirs` (d, n_proj) replaces the
    random draw."""
    if a.shape != b.shape:
        raise ValueError(f"descriptor sets differ: {tuple(a.shape)} vs {tuple(b.shape)}")
    d = a.shape[1]
    total = torch.zeros((), dtype=torch.float32, device=a.device)
    n_rep = 1 if dirs is not None else repeats
    with exact_f32():
        for r in range(n_rep):
            dd = jr.normal(jr.fold_in(key, r), (d, n_proj)) if dirs is None else dirs
            dd = torch.as_tensor(np.asarray(dd, np.float32), device=a.device)
            dd = dd / (torch.linalg.vector_norm(dd, dim=0, keepdim=True) + 1e-12)
            pa = torch.sort(a.float() @ dd, dim=0).values
            pb = torch.sort(b.float() @ dd, dim=0).values
            total = total + (pa - pb).abs().mean()
    return float(total / n_rep)


def _images(images_u8, device: torch.device) -> torch.Tensor:
    x = images_u8 if isinstance(images_u8, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(images_u8))
    return x.to(device).float()


def swd(real_u8, fake_u8, *, min_res: int = 16, patches_per_image: int = 128,
        n_proj: int = 512, repeats: int = 4, seed: int = 0,
        device=None) -> Dict[str, float]:
    """Multi-scale SWD between two equal-size uint8 NHWC image sets (numpy
    or tensors), on `device` (the fake tensor's own by default, else the
    card): {"swd_<res>": x1e3 per pyramid level, "swd_avg": their mean}.
    Images enter as [0, 255] floats."""
    if tuple(real_u8.shape) != tuple(fake_u8.shape):
        raise ValueError(
            f"image sets differ: {tuple(real_u8.shape)} vs {tuple(fake_u8.shape)}"
        )
    if device is None and isinstance(fake_u8, torch.Tensor):
        device = fake_u8.device
    device = resolve_device(device)
    res = real_u8.shape[1]
    if res < min_res:
        raise ValueError(f"images ({res}px) below min_res={min_res}")
    n_levels = int(np.log2(res // min_res)) + 1
    key = jr.prng_key(seed)
    out: Dict[str, float] = {}
    vals = []
    with torch.inference_mode(), exact_f32():
        pyr_r = laplacian_pyramid(_images(real_u8, device), n_levels)
        pyr_f = laplacian_pyramid(_images(fake_u8, device), n_levels)
        for li, (lr, lf) in enumerate(zip(pyr_r, pyr_f)):
            k_patch, k_proj = jr.split(jr.fold_in(key, li))
            # the same k_patch for both sets: swd(x, x) == 0 exactly
            dr = _normalize_descriptors(patch_descriptors(lr, k_patch, patches_per_image))
            df = _normalize_descriptors(patch_descriptors(lf, k_patch, patches_per_image))
            v = sliced_wasserstein(dr, df, k_proj, n_proj, repeats) * 1e3
            out[f"swd_{lr.shape[1]}"] = v
            vals.append(v)
    out["swd_avg"] = float(np.mean(vals))
    return out


def swd_generator(model: torch.nn.Module, dataset, *, n_samples: int = 1024,
                  batch: int = 64, seed: int = 0, min_res: int = 16,
                  **swd_kw) -> Dict[str, float]:
    """SWD between `n_samples` images of `model` (a serving generator) and
    as many random dataset examples, on the model's device: the latents
    and the real draw of `io/fid.py:evaluate_generator`."""
    fake_u8 = torch.cat(list(generate_fakes(model, n_samples, batch, seed)))
    real_u8 = real_examples(dataset, n_samples, seed)
    n = min(len(real_u8), len(fake_u8))
    return swd(real_u8[:n], fake_u8[:n], min_res=min_res, seed=seed,
               device=fake_u8.device, **swd_kw)
