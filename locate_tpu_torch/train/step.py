"""The GAN train step, counterpart of `locate_tpu/train/step.py`, in its
alternating flavor (the reference's):

    1. D update on (real, G(z_d)), G's forward under no_grad;
    2. G update through the *updated* D on G(z_g);
    3. EMA update of G's parameters.

Lazy R1 fires when `step % r1_interval == 0`. Its gradient of a gradient
cannot go through the gate kernels' first-order Function, so with
use_pallas it runs through a kernel-free twin of D that shares D's
parameter tensors and runs the plain composition (`d_apply_r1` in JAX);
`r1_remat` recomputes that twin's forward in the backward pass
(`torch.utils.checkpoint`, non-reentrant).

The step updates the state in place (the parameter buffers, the
optimizer and EMA tensors, the step count) and returns it with its
metrics, 0-d tensors on the device under the JAX metric names; nothing in
the step waits for the host. Latents and labels come from the state's
generator unless the caller passes them (`z_d`, `z_g`, `labels_d`,
`labels_g`), which is how tests feed JAX's threefry draws.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from locate_tpu_torch.config import Config, TrainConfig
from locate_tpu_torch.models.discriminator import Discriminator
from locate_tpu_torch.models.gan import GAN
from locate_tpu_torch.objectives.ema import ema_update
from locate_tpu_torch.objectives.losses import get_losses, r1_penalty
from locate_tpu_torch.objectives.optim import (guard_stats, make_optimizers,
                                               safe_global_norm)
from locate_tpu_torch.train.state import TrainState

Batch = Dict[str, torch.Tensor]
Metrics = Dict[str, torch.Tensor]

# (option is on, what it is): the train-step options not ported yet
_UNPORTED = (
    (lambda t: t.d_steps > 1, "train.d_steps > 1 (the multi-critic step)"),
    (lambda t: t.fused_step, "train.fused_step (the fused simultaneous step)"),
    (lambda t: t.augment_p > 0.0 or t.ada_target > 0.0,
     "train.augment_p / ada_target (ADA, ops/augment.py)"),
    (lambda t: t.bcr_gamma > 0.0, "train.bcr_gamma (bCR)"),
    (lambda t: t.lecam_gamma > 0.0, "train.lecam_gamma (LeCam)"),
    (lambda t: t.gp_gamma > 0.0, "train.gp_gamma (WGAN-GP)"),
    (lambda t: t.r2_gamma > 0.0, "train.r2_gamma (R2)"),
    (lambda t: t.pl_gamma > 0.0, "train.pl_gamma (path-length regularization)"),
    (lambda t: t.ortho_gamma > 0.0, "train.ortho_gamma (orthogonal regularization)"),
    (lambda t: t.feature_matching > 0.0, "train.feature_matching"),
    (lambda t: t.topk_fraction < 1.0, "train.topk_fraction < 1 (top-k training)"),
    (lambda t: t.logit_penalty > 0.0, "train.logit_penalty (the drift penalty)"),
    (lambda t: t.share_latents, "train.share_latents"),
    (lambda t: t.ema_rampup > 0.0, "train.ema_rampup"),
    (lambda t: t.r1_batch_fraction < 1.0, "train.r1_batch_fraction < 1"),
)


def refuse_unported(tcfg: TrainConfig) -> None:
    for on, what in _UNPORTED:
        if on(tcfg):
            raise NotImplementedError(
                f"{what} is not ported yet (ROADMAP.md Queue 1 item 11)")


def plain_twin(disc: Discriminator) -> Discriminator:
    """A discriminator that runs the plain composition (use_pallas=False)
    on `disc`'s own parameter tensors: gradients through it reach the
    same leaves, and an update of `disc` is an update of the twin."""
    device = disc.head.w.device
    gen = torch.Generator(device=device)
    twin = Discriminator(dataclasses.replace(disc.config, use_pallas=False),
                         disc.compute_dtype, gen)
    for name, p in disc.named_parameters():
        owner, _, attr = name.rpartition(".")
        twin.get_submodule(owner)._parameters[attr] = p
    return twin


class TrainStep:
    """`step(state, batch, *, z_d=None, z_g=None, labels_d=None,
    labels_g=None) -> (state, metrics)`: the alternating flavor. Its two
    halves are methods too (`d_loss_and_grads`, `g_loss_and_grads`), so
    one step's gradients can be taken on several paths from one state."""

    def __init__(self, cfg: Config, gan: GAN):
        tcfg = cfg.train
        refuse_unported(tcfg)
        self.tcfg = tcfg
        self.gan = gan
        self.g_opt, self.d_opt = make_optimizers(tcfg)
        self.g_loss_of, self.d_loss_of = get_losses(tcfg.loss)
        twin = gan.discriminator
        if tcfg.r1_gamma > 0.0 and gan.config.use_pallas:
            twin = plain_twin(gan.discriminator)
        self._r1_twin = twin

    def d_apply_r1(self, x: torch.Tensor, labels: Optional[torch.Tensor]) -> torch.Tensor:
        """D for the R1 penalty: the plain twin under use_pallas, its
        forward recomputed in the backward pass under train.r1_remat."""
        if self.tcfg.r1_remat:
            return torch.utils.checkpoint.checkpoint(self._r1_twin, x, labels,
                                                     use_reentrant=False)
        return self._r1_twin(x, labels)

    def d_loss_and_grads(self, state: TrainState, real, labels, z_d, labels_d):
        """(D loss, its aux metrics, flat D gradient) on (real, G(z_d)),
        G's forward under no_grad; R1 joins the loss at its steps."""
        tcfg, D = self.tcfg, self.gan.discriminator
        with torch.no_grad():
            fake = self.gan.generator(z_d, labels_d)
        real_logits = D(real, labels)
        fake_logits = D(fake, labels_d)
        loss = self.d_loss_of(real_logits, fake_logits)
        aux = {"real_logits": real_logits.float().mean(),
               "fake_logits": fake_logits.float().mean()}
        if tcfg.r1_gamma > 0.0:
            if state.step % tcfg.r1_interval == 0:
                pen = r1_penalty(self.d_apply_r1, real, labels)
                pen = pen * (tcfg.r1_gamma * tcfg.r1_interval)
            else:
                pen = torch.zeros((), device=real.device)
            aux["r1"] = pen
            loss = loss + pen
        grads = torch.autograd.grad(loss, state.d_params.params)
        return (loss.detach(), {k: v.detach() for k, v in aux.items()},
                state.d_params.flatten(grads))

    def g_loss_and_grads(self, state: TrainState, z_g, labels_g):
        """(G loss, flat G gradient) of G(z_g) scored by D as it stands."""
        gan = self.gan
        loss = self.g_loss_of(gan.discriminator(gan.generator(z_g, labels_g), labels_g))
        grads = torch.autograd.grad(loss, state.g_params.params)
        return loss.detach(), state.g_params.flatten(grads)

    def prepare(self, state: TrainState, batch: Batch, z_d=None, z_g=None,
                labels_d=None, labels_g=None):
        """(real, labels, z_d, labels_d, z_g, labels_g): the batch on the
        device in the compute dtype, and the draws not passed in."""
        gan = self.gan
        real = batch["image"].to(gan.device)
        if real.dtype == torch.uint8:
            # uint8 crosses to the device; normalize to [-1, 1] there
            real = real.float() / 127.5 - 1.0
        real = real.to(gan.compute_dtype)
        labels = batch["label"].to(gan.device) if gan.config.num_classes else None
        n = real.shape[0]
        if z_d is None:
            z_d = gan.sample_latents(state.rng, n)
        if labels_d is None:
            labels_d = gan.sample_labels(state.rng, n)
        if z_g is None:
            z_g = gan.sample_latents(state.rng, n)
        if labels_g is None:
            labels_g = gan.sample_labels(state.rng, n)
        return real, labels, z_d, labels_d, z_g, labels_g

    def __call__(self, state: TrainState, batch: Batch, *,
                 z_d: Optional[torch.Tensor] = None, z_g: Optional[torch.Tensor] = None,
                 labels_d: Optional[torch.Tensor] = None,
                 labels_g: Optional[torch.Tensor] = None) -> Tuple[TrainState, Metrics]:
        tcfg = self.tcfg
        real, labels, z_d, labels_d, z_g, labels_g = self.prepare(
            state, batch, z_d, z_g, labels_d, labels_g)
        # 1. D on (real, detached fake)
        d_loss, d_aux, d_grads = self.d_loss_and_grads(state, real, labels, z_d, labels_d)
        state.d_opt_state = _apply(self.d_opt, state.d_params, state.d_opt_state, d_grads)
        # 2. G through the updated D
        g_loss, g_grads = self.g_loss_and_grads(state, z_g, labels_g)
        state.g_opt_state = _apply(self.g_opt, state.g_params, state.g_opt_state, g_grads)
        # 3. EMA of G
        if state.ema_params is not None:
            state.ema_params = ema_update(state.ema_params, state.g_params.flat,
                                          tcfg.ema_decay)
        metrics = {"d_loss": d_loss, "g_loss": g_loss,
                   "d_grad_norm": safe_global_norm(d_grads),
                   "g_grad_norm": safe_global_norm(g_grads), **d_aux}
        for prefix, s in (("d_", state.d_opt_state), ("g_", state.g_opt_state)):
            for k, v in guard_stats(s, tcfg).items():
                if k != "grad_norm_guard":
                    metrics[prefix + k] = v
        state.step += 1
        return state, metrics


def _apply(opt, params, opt_state, grads):
    """One optimizer update of a flat parameter buffer, in place."""
    updates, opt_state = opt.update(grads, opt_state)
    with torch.no_grad():
        params.flat.add_(updates)
    return opt_state


def make_train_step(cfg: Config, gan: GAN) -> TrainStep:
    """The alternating train step of `gan` (`TrainStep`); every option of
    the other flavors and every unported regularizer raises
    NotImplementedError."""
    return TrainStep(cfg, gan)
