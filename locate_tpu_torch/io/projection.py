"""Latent-space projection (GAN inversion), counterpart of
`locate_tpu/io/projection.py`: find the latent whose image matches a
target, by `steps` Adam updates (optax's defaults: b1 0.9, b2 0.999, eps
1e-8) of a multi-scale MSE (full resolution, 2x and 4x average-pooled)
plus a prior pull (`prior_weight`).

Spaces: "z", the input latent (either family), through the generator in
its compute dtype, the prior mean(z^2); and for the style family "w" (one
intermediate latent an image) and "w+" (one a styled layer), started at
w_avg and pulled back to it, through the synthesis alone in f32.

JAX runs the whole optimization as one `lax.scan`. On the card the port
captures one step (the forward, the backward for the latent's gradient,
which runs the gate kernels' backward passes, the Adam update, the loss
history's entry) as a CUDA graph and replays it `steps` times, after one
eager warm-up from a snapshot that is put back; on the CPU it runs the
same step `steps` times.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from locate_tpu_torch.io.sampling import W_AVG_DRAWS, sample_latents, to_uint8
from locate_tpu_torch.ops.conv import downsample_avg

B1, B2, EPS = 0.9, 0.999, 1e-8


def _pyramid_mse(a: torch.Tensor, b: torch.Tensor, levels: int = 3) -> torch.Tensor:
    loss = ((a - b) ** 2).mean()
    for _ in range(levels - 1):
        if a.shape[1] <= 4:
            break
        a, b = downsample_avg(a, 2), downsample_avg(b, 2)
        loss = loss + ((a - b) ** 2).mean()
    return loss


def f32_synthesis(model):
    """The style generator's synthesis in f32 on `model`'s own parameters
    (the JAX package's `make_style_fns(config)["synthesis"]`)."""
    from locate_tpu_torch.models.gan import shared_twin

    twin = shared_twin(model, model.config, compute_dtype=None)
    return lambda w: twin.synthesis(w, dtype=torch.float32)


class Projector:
    """The optimization's tensors (the latent `v`, Adam's moments and
    count, the loss history, the step index) and one step on them, in
    place, every tensor at its address: what a CUDA graph captures."""

    def __init__(self, fwd, prior, v0: torch.Tensor, targets: torch.Tensor, steps: int,
                 lr: float, prior_weight: float):
        self.fwd, self.prior, self.targets = fwd, prior, targets
        self.lr, self.prior_weight = lr, prior_weight
        self.v = v0.detach().clone()
        self.mu = torch.zeros_like(self.v)
        self.nu = torch.zeros_like(self.v)
        self.count = torch.zeros((), device=v0.device)
        self.hist = torch.zeros(steps, device=v0.device)
        self.idx = torch.zeros(1, dtype=torch.long, device=v0.device)

    def tensors(self):
        return (self.v, self.mu, self.nu, self.count, self.hist, self.idx)

    def step(self) -> None:
        v = self.v.detach().requires_grad_(True)
        img = self.fwd(v).float()
        total = _pyramid_mse(img, self.targets) + self.prior_weight * self.prior(v)
        (g,) = torch.autograd.grad(total, [v])
        with torch.no_grad():
            self.mu.copy_((1 - B1) * g + B1 * self.mu)
            self.nu.copy_((1 - B2) * g.square() + B2 * self.nu)
            self.count.add_(1)
            mu_hat = self.mu / (1 - torch.pow(B1, self.count)).to(self.mu.dtype)
            nu_hat = self.nu / (1 - torch.pow(B2, self.count)).to(self.nu.dtype)
            self.v.add_(-self.lr * (mu_hat / (torch.sqrt(nu_hat) + EPS)))
            self.hist.index_copy_(0, self.idx, total.detach().float().reshape(1))
            self.idx.add_(1)

    def run(self, steps: int) -> None:
        if self.v.device.type != "cuda":
            for _ in range(steps):
                self.step()
            return
        from locate_tpu_torch.train.graph import _on_side_stream

        saved = [t.clone() for t in self.tensors()]
        _on_side_stream(self.step)  # warm-up: plans, kernel libraries, caches
        for t, s in zip(self.tensors(), saved):
            t.copy_(s)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self.step()
        for _ in range(steps):
            graph.replay()


def projector(model, targets, *, labels=None, steps: int = 400, lr: float = 0.05,
              prior_weight: float = 1e-3, init: str = "random", space: str = "z",
              gen: Optional[torch.Generator] = None, z0: Optional[torch.Tensor] = None,
              w_avg: Optional[torch.Tensor] = None) -> Projector:
    """The `Projector` of `project`'s arguments, before its first step."""
    if space not in ("z", "w", "w+"):
        raise ValueError(f"space must be z/w/w+, got {space!r}")
    cfg = model.config
    device = next(model.parameters()).device
    x = torch.as_tensor(np.asarray(targets, np.float32), device=device)
    n = x.shape[0]
    if labels is not None:
        labels = torch.as_tensor(np.asarray(labels), device=device)
    if gen is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
    if space == "z":
        if z0 is None:
            z0 = (torch.zeros((n, cfg.latent_dim), device=device) if init == "zero"
                  else sample_latents(gen, n, cfg.latent_dim).to(model.compute_dtype
                                                                  or torch.float32))

        def fwd(v):
            return model(v, labels)

        def prior(v):
            return (v * v).mean()
    else:
        if cfg.arch != "style":
            raise ValueError(f"space={space!r} projection needs model.arch='style' "
                             f"(got {cfg.arch!r})")
        from locate_tpu_torch.models.style_generator import w_average

        if w_avg is None:
            with torch.no_grad():
                w_avg = w_average(model, gen, W_AVG_DRAWS)
        w_avg = torch.as_tensor(w_avg, device=device).float()
        shape = (n, w_avg.shape[0]) if space == "w" else (n, model.num_ws, w_avg.shape[0])
        z0 = w_avg.expand(shape) if z0 is None else z0
        fwd = f32_synthesis(model)

        def prior(v):
            return ((v - w_avg) ** 2).mean()
    return Projector(fwd, prior, torch.as_tensor(z0, device=device), x, steps, lr,
                     prior_weight)


def project(model, targets, *, steps: int = 400, **kw) -> Tuple[np.ndarray, np.ndarray]:
    """Invert `targets` (f32 NHWC in [-1, 1]) through the generator
    `model` on its device: (latents, loss history) as host arrays.
    `space` "z" starts at a draw from `gen` in the compute dtype (or 0
    with init="zero", or at `z0`); "w" / "w+" (style family) start at
    w_avg, the mean w of `W_AVG_DRAWS` latents from `gen` unless given.
    Labels condition a class-conditional model; they are not optimized.
    Keywords as `projector`'s."""
    proj = projector(model, targets, steps=steps, **kw)
    proj.run(steps)
    return proj.v.float().cpu().numpy(), proj.hist.cpu().numpy()


def reconstruction_grid(model, targets, z, labels=None, space: str = "z") -> np.ndarray:
    """Interleaved [target | reconstruction] rows as uint8 NHWC, for the
    CLI's --recon output; `space` as the `project` call that made `z`."""
    device = next(model.parameters()).device
    v = torch.as_tensor(np.asarray(z), device=device)
    with torch.no_grad():
        if space == "z":
            lab = None if labels is None else torch.as_tensor(np.asarray(labels), device=device)
            rec = model(v, lab)
        else:
            rec = f32_synthesis(model)(v.float())
    rec = rec.float().cpu().numpy()
    pairs = np.stack([np.asarray(targets, np.float32), rec], axis=1)
    return to_uint8(pairs.reshape((-1,) + rec.shape[1:]))
