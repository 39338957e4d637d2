"""GAN losses and penalties, counterpart of `locate_tpu/objectives/losses.py`:
seven loss families (nonsat, hinge, wgan, lsgan and the relativistic
ragan, rahinge, rpgan), the per-sample G losses of top-k training, and the
regularizers R1, WGAN-GP, path lengths, LeCam and orthogonal
regularization, all in f32 whatever the compute dtype.

The penalties that differentiate a gradient (R1, GP, path lengths) keep
their input gradient's graph (`create_graph=True`): the model they are
given must be twice differentiable, which the kernels' first-order
Functions are not, so the train step hands them the plain twins
(`train/step.py:plain_twin`).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F


def _f(t: torch.Tensor) -> torch.Tensor:
    return t.float().reshape(-1)


def g_nonsat_loss(fake_logits: torch.Tensor) -> torch.Tensor:
    """Generator non-saturating loss: -log sigmoid(D(fake))."""
    return F.softplus(-fake_logits.float()).mean()


def d_nonsat_loss(real_logits: torch.Tensor, fake_logits: torch.Tensor) -> torch.Tensor:
    """Discriminator loss: -log sigmoid(D(real)) - log(1 - sigmoid(D(fake)))."""
    return F.softplus(-real_logits.float()).mean() + F.softplus(fake_logits.float()).mean()


def g_hinge_loss(fake_logits: torch.Tensor) -> torch.Tensor:
    """-E[D(fake)], the generator's hinge loss (and wgan's)."""
    return -fake_logits.float().mean()


def d_hinge_loss(real_logits: torch.Tensor, fake_logits: torch.Tensor) -> torch.Tensor:
    """E[relu(1 - D(real))] + E[relu(1 + D(fake))]."""
    return F.relu(1.0 - real_logits.float()).mean() + F.relu(1.0 + fake_logits.float()).mean()


def d_wgan_loss(real_logits: torch.Tensor, fake_logits: torch.Tensor) -> torch.Tensor:
    """The Wasserstein critic loss E[D(fake)] - E[D(real)]."""
    return fake_logits.float().mean() - real_logits.float().mean()


def g_lsgan_loss(fake_logits: torch.Tensor) -> torch.Tensor:
    """0.5 E[(D(fake) - 1)^2]."""
    return 0.5 * (fake_logits.float() - 1.0).square().mean()


def d_lsgan_loss(real_logits: torch.Tensor, fake_logits: torch.Tensor) -> torch.Tensor:
    """0.5 E[(D(real) - 1)^2] + 0.5 E[D(fake)^2]."""
    return (0.5 * (real_logits.float() - 1.0).square().mean()
            + 0.5 * fake_logits.float().square().mean())


def g_ragan_loss(fake_logits, real_logits, mean_fn=torch.mean):
    """Relativistic average G loss: E[softplus(-(D(fake) - E[D(real)]))] +
    E[softplus(D(real) - E[D(fake)])]."""
    f, r = fake_logits.float(), real_logits.float()
    mr, mf = mean_fn(r), mean_fn(f)
    return F.softplus(-(f - mr)).mean() + F.softplus(r - mf).mean()


def d_ragan_loss(real_logits, fake_logits, mean_fn=torch.mean):
    """E[softplus(-(D(real) - E[D(fake)]))] + E[softplus(D(fake) - E[D(real)])]."""
    r, f = real_logits.float(), fake_logits.float()
    mr, mf = mean_fn(r), mean_fn(f)
    return F.softplus(-(r - mf)).mean() + F.softplus(f - mr).mean()


def g_rahinge_loss(fake_logits, real_logits, mean_fn=torch.mean):
    """E[relu(1 - (D(fake) - E[D(real)]))] + E[relu(1 + (D(real) - E[D(fake)]))]."""
    f, r = fake_logits.float(), real_logits.float()
    mr, mf = mean_fn(r), mean_fn(f)
    return F.relu(1.0 - (f - mr)).mean() + F.relu(1.0 + (r - mf)).mean()


def d_rahinge_loss(real_logits, fake_logits, mean_fn=torch.mean):
    """E[relu(1 - (D(real) - E[D(fake)]))] + E[relu(1 + (D(fake) - E[D(real)]))]."""
    r, f = real_logits.float(), fake_logits.float()
    mr, mf = mean_fn(r), mean_fn(f)
    return F.relu(1.0 - (r - mf)).mean() + F.relu(1.0 + (f - mr)).mean()


def g_rpgan_loss(fake_logits, real_logits, mean_fn=torch.mean):
    """Relativistic pairing: E_i[softplus(-(D(fake_i) - D(real_i)))]."""
    del mean_fn
    return F.softplus(-(_f(fake_logits) - _f(real_logits))).mean()


def d_rpgan_loss(real_logits, fake_logits, mean_fn=torch.mean):
    """E_i[softplus(-(D(real_i) - D(fake_i)))]."""
    del mean_fn
    return F.softplus(-(_f(real_logits) - _f(fake_logits))).mean()


# Families whose G loss needs the real logits: both loss functions take
# (logits..., mean_fn)
RELATIVISTIC = frozenset({"ragan", "rahinge", "rpgan"})

_FAMILIES = {
    "nonsat": (g_nonsat_loss, d_nonsat_loss),
    "hinge": (g_hinge_loss, d_hinge_loss),
    "wgan": (g_hinge_loss, d_wgan_loss),
    "lsgan": (g_lsgan_loss, d_lsgan_loss),
    "ragan": (g_ragan_loss, d_ragan_loss),
    "rahinge": (g_rahinge_loss, d_rahinge_loss),
    "rpgan": (g_rpgan_loss, d_rpgan_loss),
}


def get_losses(kind: str):
    """(g_loss_fn, d_loss_fn) of a loss family; the relativistic ones take
    g(fake, real, mean_fn) and d(real, fake, mean_fn)."""
    if kind not in _FAMILIES:
        raise ValueError(f"unknown GAN loss {kind!r}")
    return _FAMILIES[kind]


def g_per_sample(kind: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """The per-sample G loss (N,) -> (N,) of a family that decomposes so
    (what top-k training masks); its mean is the family's G loss."""
    if kind == "nonsat":
        return lambda f: F.softplus(-f.float())
    if kind in ("hinge", "wgan"):
        return lambda f: -f.float()
    if kind == "lsgan":
        return lambda f: 0.5 * (f.float() - 1.0).square()
    raise ValueError(f"loss {kind!r} has no per-sample generator decomposition "
                     "(relativistic losses couple samples through batch means)")


# Parameters left out of orthogonal regularization by name (the JAX
# package's ORTHO_EXCLUDE: learned const inputs and class embeddings)
ORTHO_EXCLUDE = frozenset({"const", "class_embed"})


def ortho_weights(names: Sequence[str], params: Sequence[torch.Tensor]):
    """The parameters orthogonal regularization reads: every one of two or
    more dimensions whose dotted name has no part in ORTHO_EXCLUDE."""
    return [p for n, p in zip(names, params)
            if p.dim() >= 2 and not ORTHO_EXCLUDE & set(n.split("."))]


def orthogonal_penalty(weights: Sequence[torch.Tensor]) -> torch.Tensor:
    """BigGAN's off-diagonal orthogonal regularization, sum over `weights`
    of ||W^T W o (1 - I)||_F^2 with W [fan_in, fan_out]: a conv kernel
    (OIHW here, HWIO in JAX) as [I*H*W, O], a dense [in, out] as it is.
    The Gram matrix does not depend on the order of the fan-in."""
    tot = torch.zeros((), dtype=torch.float32, device=weights[0].device)
    for p in weights:
        w = p.float()
        w = w.reshape(w.shape[0], -1).t() if w.dim() == 4 else w.reshape(-1, w.shape[-1])
        gram = w.t() @ w
        gram = gram - torch.diag(torch.diagonal(gram))
        tot = tot + gram.square().sum()
    return tot


def lecam_penalty(real_logits: torch.Tensor, fake_logits: torch.Tensor,
                  ema_real: torch.Tensor, ema_fake: torch.Tensor) -> torch.Tensor:
    """LeCam: E[relu(D(real) - ema_fake)^2] + E[relu(ema_real - D(fake))^2],
    the trackers from the state (no gradient reaches them)."""
    return (F.relu(_f(real_logits) - ema_fake).square().mean()
            + F.relu(ema_real - _f(fake_logits)).square().mean())


def r1_penalty(d_apply: Callable, real_images: torch.Tensor,
               labels: Optional[torch.Tensor] = None) -> torch.Tensor:
    """R1 = 0.5 * E[ ||grad_x D(x)||^2 ] on real images, in f32. The input
    gradient keeps its graph (`create_graph=True`), so the penalty's own
    gradient reaches D's parameters: `d_apply` must be twice
    differentiable, which the kernels' first-order Function is not."""
    x = real_images.detach().float().requires_grad_(True)
    (grads,) = torch.autograd.grad(d_apply(x, labels).sum(), x, create_graph=True)
    return 0.5 * grads.float().square().sum(dim=(1, 2, 3)).mean()


def gradient_penalty(d_apply: Callable, real: torch.Tensor, fake: torch.Tensor,
                     eps: torch.Tensor, labels: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """WGAN-GP: E[(||grad_x D(x_hat)||_2 - 1)^2] at x_hat = eps real +
    (1 - eps) fake, `eps` (N, 1, 1, 1) in [0, 1], scored under `labels`."""
    x_hat = (eps * real.detach().float() + (1.0 - eps) * fake.detach().float())
    x_hat.requires_grad_(True)
    (grads,) = torch.autograd.grad(d_apply(x_hat, labels).sum(), x_hat, create_graph=True)
    norms = (grads.float().square().sum(dim=(1, 2, 3)) + 1e-12).sqrt()
    return (norms - 1.0).square().mean()


def path_lengths(g_apply: Callable, z: torch.Tensor, labels: Optional[torch.Tensor],
                 y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample path lengths ||J_z^T y||_2 of the generator at z, with y
    image-shaped noise already scaled by 1/sqrt(H*W) (`path_noise`). The
    vector-Jacobian product keeps its graph, so the lengths differentiate
    into G's parameters (a gradient of a gradient)."""
    zz = z.detach().float().requires_grad_(True)
    imgs = g_apply(zz, labels).float()
    (jt_y,) = torch.autograd.grad(imgs, zz, grad_outputs=y, create_graph=True)
    return (jt_y.float().square().sum(dim=-1) + 1e-12).sqrt()


def path_noise(gen: torch.Generator, shape: Sequence[int]) -> torch.Tensor:
    """y ~ N(0, I / (H*W)) of an NHWC image shape, from `gen`."""
    n, h, w, _ = shape
    y = torch.randn(tuple(shape), generator=gen, device=gen.device)
    return y / math.sqrt(h * w)
