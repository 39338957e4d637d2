"""GAN losses, counterpart of `locate_tpu/objectives/losses.py`: the
non-saturating pair and the R1 penalty, all in f32 whatever the compute
dtype. The other loss families and penalties are not ported yet
(ROADMAP.md Queue 1 item 11)."""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F


def g_nonsat_loss(fake_logits: torch.Tensor) -> torch.Tensor:
    """Generator non-saturating loss: -log sigmoid(D(fake))."""
    return F.softplus(-fake_logits.float()).mean()


def d_nonsat_loss(real_logits: torch.Tensor, fake_logits: torch.Tensor) -> torch.Tensor:
    """Discriminator loss: -log sigmoid(D(real)) - log(1 - sigmoid(D(fake)))."""
    return F.softplus(-real_logits.float()).mean() + F.softplus(fake_logits.float()).mean()


def get_losses(kind: str):
    """(g_loss_fn, d_loss_fn) of a loss family."""
    if kind == "nonsat":
        return g_nonsat_loss, d_nonsat_loss
    if kind in ("hinge", "wgan", "lsgan", "ragan", "rahinge", "rpgan"):
        raise NotImplementedError(
            f"train.loss={kind!r} is not ported yet (ROADMAP.md Queue 1 item 11)")
    raise ValueError(f"unknown GAN loss {kind!r}")


def r1_penalty(d_apply: Callable, real_images: torch.Tensor,
               labels: Optional[torch.Tensor] = None) -> torch.Tensor:
    """R1 = 0.5 * E[ ||grad_x D(x)||^2 ] on real images, in f32. The input
    gradient keeps its graph (`create_graph=True`), so the penalty's own
    gradient reaches D's parameters: `d_apply` must be twice
    differentiable, which the kernels' first-order Function is not."""
    x = real_images.detach().float().requires_grad_(True)
    (grads,) = torch.autograd.grad(d_apply(x, labels).sum(), x, create_graph=True)
    return 0.5 * grads.float().square().sum(dim=(1, 2, 3)).mean()
