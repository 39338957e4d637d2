"""The GAN train step, counterpart of `locate_tpu/train/step.py`, in its
three flavors (`train.fused_step`, `train.d_steps`):

* alternating (the reference's):
    1. D update on (real, G(z_d)), G's forward under no_grad;
    2. G update through the *updated* D on G(z_g);
    3. EMA update of G's parameters;
* multi-critic (`d_steps` = c > 1): c D updates, each on a fresh real
  batch (the batch's leaves carry a leading [c] axis) and fresh latents,
  then one G update through the updated D;
* fused simultaneous: one forward of G(z) and D(aug(G(z))), both
  gradients taken from it at the current parameters (two backward passes
  through one graph, `retain_graph`), both updates applied.

Every option of the JAX step runs: the seven loss families, top-k G training, ADA (augmentation of what D sees, G's
gradient going through it, and the controller of p), bCR, LeCam, the
drift penalty, R1 (with `r1_batch_fraction`'s leading rows), R2, WGAN-GP,
path-length and orthogonal regularization, feature matching,
`share_latents`, `grad_accum`, the LR schedules, the bf16 EMA and
`ema_rampup`, and the style family's training forward (`g_forward`, the
JAX step's `g_apply_train`): style mixing and random noise. Lazy R1 and R2 fire when `step % r1_interval == 0`, lazy PL
when `step % pl_interval == 0`: host flags (`lazy_flags`), one graph
variant each in `train/graph.py`; everything else decides on the card.

Second-order terms (R1, R2, GP through D; PL through G) cannot go through
the kernels' first-order Functions, so with use_pallas they run through
kernel-free twins that share the networks' parameter tensors and run the
plain composition (`plain_twin`, the JAX package's `d_apply_r1` and
`g_apply_pl`); `r1_remat` recomputes D's twin's forward in the backward
pass (`torch.utils.checkpoint`, non-reentrant).

The step updates the state in place (the parameter buffers, the
optimizer, EMA and option tensors, written with `copy_` so that every
tensor keeps its address, and the step count) and returns it with its
metrics, 0-d tensors on the device under the JAX metric names; nothing in
the step waits for the host or copies from it, so a CUDA graph can
capture it. Every random draw comes from the state's generator unless the
caller passes it, which is how tests feed JAX's threefry draws
(`prepare`'s names: `z_d`, `labels_d`, `z_g`, `labels_g`; `aug_real.*`,
`aug_fake.*`, `aug_g.*` and `bcr_real.*`, `bcr_fake.*`, each an
`ops/augment.py` parameter set; `gp_eps`; `pl_noise`; `ema_bits`; the
style family's `mix_z2_d`, `mix_cut_d`, `g_noise_d.<stage>.<conv>` for the
G forward of D's update and `mix_z2_g`, `mix_cut_g`, `g_noise_g.*` for
G's; under d_steps the critics' draws carry a leading [c] axis; the fused
flavor's one latent batch is `z_d`, `labels_d`, its augmentation of fakes
`aug_fake.*`, its one G forward's style draws the `_d` ones, which
`share_latents` also gives G's forward, as JAX reuses the forward's key).

On a mesh (`parallel/mesh.py`, built by `parallel/sharding.py:
make_step_for`) the step runs on its data row's rows of the global batch
(the model ranks of a row see the same rows) with the JAX step's
collectives over the data axis: the gradients' mean before each update
(so every guard decides on the reduced gradient, on every rank alike),
the metrics' mean, ADA's r and LeCam's logit means before they move the
state, the relativistic losses' and feature matching's global means
(differentiable, `Mesh.gmean`), top-k's gathered fake logits and its
summed mask. Latents, labels, GP's eps and the style mixing's draws are
made for the global batch on every rank, which takes its rows; the
augmentation, bCR and style-noise draws are the global batch's rows too
under "gspmd" and a replica's own under "shard_map" (`per_replica`).
Under a model axis the state is the rank's model-axis layout
(`parallel/tp.py`): the networks' split layers gather their channels over
the model group, the gradients are the rank's slices, and the norms
gather their sums. Without a mesh, or on one of one rank with no group,
nothing differs from the one-process step.

`make_multi_step(step, k)` is the counterpart of the JAX package's: k
steps a call over batches with a leading [k] axis, the metrics reduced as
`_LAST_METRICS` says; on the card the k steps are replays of a captured
graph of one step.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from locate_tpu_torch.config import Config
from locate_tpu_torch.models.gan import GAN, shared_twin
from locate_tpu_torch.objectives.ema import ema_bits, ema_update, rampup_decay
from locate_tpu_torch.objectives.losses import (RELATIVISTIC, g_per_sample, get_losses,
                                                gradient_penalty, lecam_penalty,
                                                orthogonal_penalty, ortho_weights,
                                                path_lengths, path_noise, r1_penalty)
from locate_tpu_torch.objectives.optim import guard_stats, make_optimizers, safe_global_norm
from locate_tpu_torch.ops.augment import augment, draw_params, parse_ops
from locate_tpu_torch.parallel.mesh import Mesh
from locate_tpu_torch.train.state import TrainState

Batch = Dict[str, torch.Tensor]
Metrics = Dict[str, torch.Tensor]
Draws = Dict[str, torch.Tensor]


def plain_twin(module: torch.nn.Module) -> torch.nn.Module:
    """A generator or discriminator that runs the plain composition
    (use_pallas=False) on `module`'s own parameter tensors: gradients
    through it reach the same leaves, and an update of `module` is an
    update of the twin."""
    return shared_twin(module, dataclasses.replace(module.config, use_pallas=False),
                       module.compute_dtype)


def _group(draws: Draws, prefix: str) -> Dict[str, torch.Tensor]:
    """The entries `prefix.<name>` of a flat draw dict, as {name: tensor}."""
    start = prefix + "."
    return {k[len(start):]: v for k, v in draws.items() if k.startswith(start)}


def _flat(prefix: str, params: Dict[str, torch.Tensor]) -> Draws:
    return {f"{prefix}.{k}": v for k, v in params.items()}


def _row(draws: Draws, i: int) -> Draws:
    return {k: v[i] for k, v in draws.items()}


def _rows(x, lo: int, hi: int):
    """Rows [lo, hi) of a draw (a tensor, a dict of them, or None)."""
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: v[lo:hi] for k, v in x.items()}
    return x[lo:hi]


# metrics that are the same on every rank before the metrics' mean (made
# from reduced or replicated values), left out of it
_REPLICATED = ("pl_len", "pl_mean", "ortho", "fm")


def _critic_draw(name: str) -> bool:
    """Whether a draw is one critic update's (stacked [c] under d_steps)."""
    return name in ("z_d", "labels_d", "gp_eps", "mix_z2_d", "mix_cut_d") or name.startswith(
        ("aug_real.", "aug_fake.", "bcr_real.", "bcr_fake.", "g_noise_d."))


class TrainStep:
    """`step(state, batch, **draws) -> (state, metrics)`, the flavor the
    config names. Its parts are methods (`prepare`, `d_loss_and_grads`,
    `g_loss_and_grads`, `update`), so one step's gradients can be taken on
    several paths from one state."""

    def __init__(self, cfg: Config, gan: GAN, mesh: Optional[Mesh] = None,
                 per_replica: bool = False):
        tcfg = cfg.train
        self.tcfg, self.gan = tcfg, gan
        self.mesh = mesh or Mesh()
        if self.mesh.world > 1 and self.mesh.group is None:
            raise ValueError(f"a mesh of {self.mesh.world} ranks needs a process group")
        self.per_replica = per_replica
        self.g_opt, self.d_opt = make_optimizers(tcfg)
        self.g_loss_of, self.d_loss_of = get_losses(tcfg.loss)
        self.relativistic = tcfg.loss in RELATIVISTIC
        self.per_sample = g_per_sample(tcfg.loss) if tcfg.topk_fraction < 1.0 else None
        self.flavor = ("fused" if tcfg.fused_step
                       else "multi_critic" if tcfg.d_steps > 1 else "alternating")
        self.aug_on = tcfg.augment_p > 0.0 or tcfg.ada_target > 0.0
        self.ada_ops = parse_ops(tcfg.augment_ops)
        self.bcr_ops = parse_ops(tcfg.bcr_ops)
        self.bf16_ema = tcfg.ema_decay > 0 and tcfg.ema_dtype == "bfloat16"
        style = gan.config.arch == "style"
        self.style_mixing = style and gan.config.style.mixing_prob > 0.0
        self.style_noise = style and gan.config.style.noise == "random"
        # the style draws of G's own forward: JAX folds them off the
        # forward's latent key, which share_latents makes D's
        self.g_side = "d" if self.flavor == "alternating" and tcfg.share_latents else "g"
        use_pallas = gan.config.use_pallas
        any_gp = tcfg.r1_gamma > 0.0 or tcfg.gp_gamma > 0.0 or tcfg.r2_gamma > 0.0
        self._d_twin = (plain_twin(gan.discriminator) if any_gp and use_pallas
                        else gan.discriminator)
        self._g_twin = (plain_twin(gan.generator) if tcfg.pl_gamma > 0.0 and use_pallas
                        else gan.generator)
        named = list(gan.generator.named_parameters())
        self._ortho = ortho_weights([n for n, _ in named], [p for _, p in named])

    # ------------------------------------------------------------- schedule
    def r1_due(self, step: int) -> bool:
        """Whether lazy R1 (and R2, on its cadence) fires at optimizer step
        `step` (host integer)."""
        t = self.tcfg
        return (t.r1_gamma > 0.0 or t.r2_gamma > 0.0) and step % t.r1_interval == 0

    def pl_due(self, step: int) -> bool:
        t = self.tcfg
        return t.pl_gamma > 0.0 and step % t.pl_interval == 0

    def lazy_flags(self, step: int) -> Tuple[bool, bool]:
        """(R1/R2 fire, PL fire) at step `step`: what a step's graph
        variant is keyed on."""
        return self.r1_due(step), self.pl_due(step)

    def d_apply_r1(self, x: torch.Tensor, labels: Optional[torch.Tensor]) -> torch.Tensor:
        """D for R1, R2 and GP: the plain twin under use_pallas, its forward
        recomputed in the backward pass under train.r1_remat (it draws no
        random numbers, so no generator state is stashed)."""
        if self.tcfg.r1_remat:
            return torch.utils.checkpoint.checkpoint(self._d_twin, x, labels,
                                                     use_reentrant=False,
                                                     preserve_rng_state=False)
        return self._d_twin(x, labels)

    # ---------------------------------------------------------------- draws
    def _global(self, draw, n: int):
        """`draw(m)` made for the global batch (n rows a data rank), this
        rank's rows (the same on the model ranks of a data row)."""
        m = self.mesh
        if m.dp == 1:
            return draw(n)
        return _rows(draw(n * m.dp), m.data_index * n, (m.data_index + 1) * n)

    def _replica(self, draw, n: int):
        """A draw of n rows that is each replica's own under "shard_map"
        (every rank draws the world's sets in turn and keeps its own, so
        the generators stay in step), else the global batch's rows."""
        m = self.mesh
        if not self.per_replica or m.dp == 1:
            return self._global(draw, n)
        return [draw(n) for _ in range(m.dp)][m.data_index]

    def _style_draws(self, rng: torch.Generator, n: int, side: str, given: Draws) -> Draws:
        """The style family's draws of one G forward (`side` "d" or "g"):
        style mixing's second latent `mix_z2_<side>` and per-sample
        crossover `mix_cut_<side>` (with probability mixing_prob uniform in
        [1, num_ws - 1], else num_ws: no mixing), random noise's
        `g_noise_<side>.<stage>.<conv>` planes; those in `given` as given."""
        gan, out = self.gan, {}

        def take(name, draw):
            out[name] = given[name] if name in given else draw()

        if self.style_mixing:
            num_ws = gan.num_ws

            def cut(m):
                mix = torch.rand((m,), generator=rng, device=rng.device) < \
                    gan.config.style.mixing_prob
                layer = torch.randint(1, num_ws, (m,), generator=rng, device=rng.device)
                return torch.where(mix, layer, num_ws).to(torch.int32)

            take(f"mix_z2_{side}",
                 lambda: self._global(lambda m: gan.sample_latents(rng, m), n))
            take(f"mix_cut_{side}", lambda: self._global(cut, n))
        if self.style_noise:
            for i, shapes in enumerate(gan.generator.noise_shapes(n)):
                for j, shape in enumerate(shapes):
                    take(f"g_noise_{side}.{i}.{j}", lambda shape=shape: self._replica(
                        lambda m: torch.randn((m,) + tuple(shape[1:]), generator=rng,
                                              device=rng.device), n))
        return out

    def g_forward(self, z: torch.Tensor, labels: Optional[torch.Tensor], draws: Draws,
                  side: str) -> torch.Tensor:
        """G's training forward (`g_apply_train`): the style family's mixing
        and random noise on the `side` draws where configured, else the
        plain forward."""
        G = self.gan.generator
        if not (self.style_mixing or self.style_noise):
            return G(z, labels)
        noise = None
        if self.style_noise:
            noise = [[draws[f"g_noise_{side}.{i}.{j}"] for j in range(len(shapes))]
                     for i, shapes in enumerate(G.noise_shapes(z.shape[0]))]
        if self.style_mixing:
            return G.apply_mixed(z, draws[f"mix_z2_{side}"], draws[f"mix_cut_{side}"], labels,
                                 noise=noise)
        return G(z, labels, noise=noise)

    def _critic_draws(self, state: TrainState, shape, given: Draws) -> Draws:
        """One D update's draws for real images of NHWC `shape`: latents and
        labels (and, in the alternating flavor, G's right after them),
        ADA's augmentation of reals and fakes, bCR's, GP's eps; those in
        `given` taken as they are."""
        gan, t, rng = self.gan, self.tcfg, state.rng
        n = shape[0]
        out = {}

        def take(name, draw):
            out[name] = given[name] if name in given else draw()

        def take_aug(prefix, p, ops):
            out.update(_flat(prefix, _group(given, prefix) or self._replica(
                lambda m: draw_params(rng, (m,) + tuple(shape[1:]), p, ops), n)))

        def latents():
            return self._global(lambda m: gan.sample_latents(rng, m), n)

        def labels():
            return self._global(lambda m: gan.sample_labels(rng, m), n)

        take("z_d", latents)
        take("labels_d", labels)
        out.update(self._style_draws(rng, n, "d", given))
        if self.flavor == "alternating":
            if t.share_latents:
                out["z_g"], out["labels_g"] = out["z_d"], out["labels_d"]
            else:
                take("z_g", latents)
                take("labels_g", labels)
                out.update(self._style_draws(rng, n, "g", given))
        if self.aug_on:
            take_aug("aug_real", state.ada_p, self.ada_ops)
            take_aug("aug_fake", state.ada_p, self.ada_ops)
        if t.bcr_gamma > 0.0:
            take_aug("bcr_real", t.bcr_p, self.bcr_ops)
            take_aug("bcr_fake", t.bcr_p, self.bcr_ops)
        if t.gp_gamma > 0.0:
            take("gp_eps", lambda: self._global(
                lambda m: torch.rand((m, 1, 1, 1), generator=rng, device=rng.device), n))
        return {k: v for k, v in out.items() if v is not None}

    def _g_draws(self, state: TrainState, n: int, pl: bool, given: Draws) -> Draws:
        """The draws of G's update and the EMA after the critics': G's
        latents under d_steps, ADA's augmentation of G's fakes (but in the
        fused flavor, whose fakes D saw), PL's noise where PL fires, the
        bf16 EMA's bits."""
        gan, rng = self.gan, state.rng
        cfg = gan.config
        gshape = (n, cfg.resolution, cfg.resolution, cfg.img_channels)
        out = {}

        def take(name, draw):
            out[name] = given[name] if name in given else draw()

        if self.flavor == "multi_critic":
            take("z_g", lambda: self._global(lambda m: gan.sample_latents(rng, m), n))
            take("labels_g", lambda: self._global(lambda m: gan.sample_labels(rng, m), n))
            out.update(self._style_draws(rng, n, "g", given))
        if self.aug_on and self.flavor != "fused":
            out.update(_flat("aug_g", _group(given, "aug_g") or self._replica(
                lambda m: draw_params(rng, (m,) + gshape[1:], state.ada_p, self.ada_ops), n)))
        if pl:
            # the JAX shard_map step draws PL's noise with the replicated
            # key at the replica's shape: the same rows on every replica
            take("pl_noise", lambda: path_noise(rng, gshape) if self.per_replica else
                 self._global(lambda m: path_noise(rng, (m,) + gshape[1:]), n))
        if self.bf16_ema:
            take("ema_bits", lambda: ema_bits(rng, state.g_params.full_numel))
        return {k: v for k, v in out.items() if v is not None}

    def draw(self, state: TrainState, shape, flags, given: Draws) -> Draws:
        """Every draw of one step for real images of NHWC `shape` (one
        critic's under d_steps, whose draws are stacked on a leading [c]
        axis), from the state's generator in a fixed order unless in
        `given`: the latents and labels first, as the alternating step has
        always drawn them."""
        if self.flavor == "multi_critic":
            per = [self._critic_draws(state, shape, {k: v[i] for k, v in given.items()
                                                     if _critic_draw(k)})
                   for i in range(self.tcfg.d_steps)]
            out = {k: torch.stack([d[k] for d in per]) for k in per[0]}
            given = {k: v for k, v in given.items() if not _critic_draw(k)}
        else:
            out = self._critic_draws(state, shape, given)
        out.update(self._g_draws(state, shape[0], flags[1], given))
        return out

    def prepare(self, state: TrainState, batch: Batch, flags=None, **given):
        """(real, labels, draws): the batch on the device in the compute
        dtype, and the step's draws (`draw`) with those passed in."""
        gan = self.gan
        real = batch["image"].to(gan.device)
        if real.dtype == torch.uint8:
            # uint8 crosses to the device; normalize to [-1, 1] there
            real = real.float() / 127.5 - 1.0
        real = real.to(gan.compute_dtype)
        labels = batch["label"].to(gan.device) if gan.config.num_classes else None
        flags = self.lazy_flags(state.step) if flags is None else flags
        shape = real.shape[1:] if self.flavor == "multi_critic" else real.shape
        draws = self.draw(state, tuple(shape), flags,
                          {k: v.to(gan.device) for k, v in given.items() if v is not None})
        return real, labels, draws

    # ------------------------------------------------------------------- D
    def d_loss_and_grads(self, state: TrainState, real_in, labels, fake_in, fake_labels,
                         draws: Draws, r1: bool, keep_graph: bool = False):
        """(D loss, its aux metrics, flat D gradient, fake logits) on D's
        inputs as given (augmented where ADA is on); the regularizers each
        join where their option is on, R1 and R2 where `r1` says. With
        `keep_graph` the fake logits keep their graph for a second
        backward pass (the fused flavor's G gradient)."""
        t, D = self.tcfg, self.gan.discriminator
        fake_feats = None
        if t.feature_matching > 0.0 and keep_graph:
            fake_logits, fake_feats = D(fake_in, fake_labels, return_features=True)
        else:
            fake_logits = D(fake_in, fake_labels)
        real_logits = D(real_in, labels)
        if self.relativistic:
            loss = self.d_loss_of(real_logits, fake_logits, self.gmean)
        else:
            loss = self.d_loss_of(real_logits, fake_logits)
        aux = {"real_logits": real_logits.float().mean(),
               "fake_logits": fake_logits.float().mean()}
        fake_d = fake_in.detach()
        if t.ada_target > 0.0:
            # ADA's overfitting heuristic r_t = E[sign(D(real))]
            aux["ada_r"] = torch.sign(real_logits.float()).mean()
        if t.bcr_gamma > 0.0:
            rl_t = D(augment(real_in, _group(draws, "bcr_real"), self.bcr_ops), labels)
            fl_t = D(augment(fake_d, _group(draws, "bcr_fake"), self.bcr_ops), fake_labels)
            bcr = ((real_logits.float() - rl_t.float()).square().mean()
                   + (fake_logits.float() - fl_t.float()).square().mean())
            aux["bcr"] = bcr
            loss = loss + t.bcr_gamma * bcr
        if t.lecam_gamma > 0.0:
            lc = lecam_penalty(real_logits, fake_logits, state.lecam[0], state.lecam[1])
            aux["lecam"] = lc
            loss = loss + t.lecam_gamma * lc
        if t.logit_penalty > 0.0:
            drift = t.logit_penalty * real_logits.float().square().mean()
            aux["drift"] = drift
            loss = loss + drift
        for gamma, name, x, lab in ((t.r1_gamma, "r1", real_in, labels),
                                    (t.r2_gamma, "r2", fake_d, fake_labels)):
            if gamma <= 0.0:
                continue
            k, scale = self.r1_rows(x.shape[0])
            if r1 and k:
                # the leading rows: an unbiased sample of i.i.d. rows
                sub = lab[:k] if lab is not None else None
                pen = r1_penalty(self.d_apply_r1, x[:k], sub) * (gamma * t.r1_interval)
                if scale != 1.0:
                    pen = pen * scale
            else:
                pen = torch.zeros((), device=x.device)
            aux[name] = pen
            loss = loss + pen
        if t.gp_gamma > 0.0:
            gp = gradient_penalty(self.d_apply_r1, real_in, fake_d, draws["gp_eps"], labels)
            aux["gp"] = gp
            loss = loss + t.gp_gamma * gp
        grads = torch.autograd.grad(loss, state.d_params.params, retain_graph=keep_graph)
        detached = {k: v.detach() for k, v in aux.items()}
        logits = (fake_logits, fake_feats, real_logits.detach())
        return loss.detach(), detached, state.d_params.flatten(grads), logits

    def r1_rows(self, n: int) -> Tuple[int, float]:
        """(k, scale): R1's and R2's leading rows of a rank's n, and the
        factor that makes the rank's penalty, averaged over ranks, the
        penalty of its batch. `r1_batch_fraction` takes the leading rows
        of the batch the step sees: each replica's own under "shard_map";
        the global batch's under "gspmd", of which a rank may hold some,
        all or none (k = 0: the rank adds no penalty)."""
        m, frac = self.mesh, self.tcfg.r1_batch_fraction
        if self.per_replica or m.dp == 1:
            return max(1, int(round(n * frac))), 1.0
        k_glob = max(1, int(round(n * m.dp * frac)))
        k = min(max(k_glob - m.data_index * n, 0), n)
        return k, k * m.dp / k_glob

    def gmean(self, x: torch.Tensor) -> torch.Tensor:
        """The global batch's mean of a per-sample tensor (the relativistic
        losses' mean), differentiable across ranks (`Mesh.gmean`)."""
        return self.mesh.gmean(torch.mean(x))

    # ------------------------------------------------------------------- G
    def g_adv(self, fake_logits, real_logits):
        """The adversarial G term: the family's loss, relativistic ones
        against `real_logits()`, top-k training's masked mean (the global
        top-k fake logits, gathered from every rank, ties at the threshold
        included; a rank's masked sum over the global mask count, times
        the world, whose gradients' mean is the global masked mean's)."""
        if self.relativistic:
            return self.g_loss_of(fake_logits, real_logits(), self.gmean)
        if self.per_sample is None:
            return self.g_loss_of(fake_logits)
        per = self.per_sample(fake_logits).reshape(-1)
        fl = fake_logits.float().reshape(-1)
        glob = self.mesh.all_gather(fl.detach())
        k = max(1, int(round(glob.shape[0] * self.tcfg.topk_fraction)))
        thresh = torch.topk(glob, k).values[-1]
        mask = (fl >= thresh).float()
        loss = (per * mask).sum() / self.mesh.sum_(mask.sum())
        return loss * self.mesh.dp if self.mesh.dp > 1 else loss

    def g_reg(self, state: TrainState, z, labels, draws: Draws, pl: bool):
        """(term, aux) of G's parameter and Jacobian regularizers:
        orthogonal regularization every step, lazy path-length where `pl`
        says, the penalty mean((len - b)^2) as m2 - 2 b m1 + b^2 with b the
        updated running mean (no gradient), as the JAX package does."""
        t = self.tcfg
        ortho = torch.zeros((), device=z.device)
        aux = {}
        if t.ortho_gamma > 0.0:
            tot = orthogonal_penalty(self._ortho)
            ortho = t.ortho_gamma * tot
            aux["ortho"] = tot
        if t.pl_gamma <= 0.0:
            return ortho, aux
        pl_mean = state.pl_mean
        if pl:
            lengths = path_lengths(self._g_twin, z, labels, draws["pl_noise"])
            m1, m2 = lengths.mean(), lengths.square().mean()
            fired = torch.ones((), device=z.device)
            m1g = self.mesh.mean_(m1.detach().clone())  # the same on every rank
            base = (pl_mean + t.pl_decay * (m1g - pl_mean)).detach()
        else:
            m1 = m2 = m1g = fired = torch.zeros((), device=z.device)
            base = pl_mean.clone()
        pen = m2 - 2.0 * base * m1 + base * base * fired
        term = pen * (t.pl_gamma * t.pl_interval)
        return term + ortho, {"pl": term, "pl_len": m1g, "pl_mean": base, **aux}

    def g_loss_and_grads(self, state: TrainState, z, labels_g, real_in, labels,
                         aug_params, draws: Draws, pl: bool, fake_logits=None):
        """(G loss, its aux metrics, flat G gradient) of G(z) scored by D
        as it stands, through the augmentation where ADA is on; the fused
        flavor passes the (fake, features, real) logits of its shared
        forward instead, whose graph reaches G through the same D."""
        t, gan = self.tcfg, self.gan
        D = gan.discriminator
        fm = torch.zeros((), device=z.device)
        fm_aux = {}
        if fake_logits is None:
            fake = self.g_forward(z, labels_g, draws, self.g_side)
            if self.aug_on:
                fake = augment(fake, aug_params, self.ada_ops)
            if t.feature_matching > 0.0:
                logits, feats = D(fake, labels_g, return_features=True)
            else:
                logits, feats = D(fake, labels_g), None
            real_logits = None
        else:
            logits, feats, real_logits = fake_logits

        def real():
            if real_logits is not None:
                return real_logits
            with torch.no_grad():
                return D(real_in, labels)

        loss = self.g_adv(logits, real)
        reg, g_aux = self.g_reg(state, z, labels_g, draws, pl)
        if t.feature_matching > 0.0:
            with torch.no_grad():
                f_real = D(real_in, labels, return_features=True)[1]
            m_fake = self.mesh.gmean(feats.float().mean(dim=0))
            m_real = self.mesh.mean_(f_real.float().mean(dim=0))
            fm_val = (m_real - m_fake).square().mean()
            # the JAX shard_map step scales the term by the axis size
            fm = fm_val * (t.feature_matching * (self.mesh.dp if self.per_replica else 1))
            fm_aux = {"fm": fm_val.detach()}
        total = loss + reg + fm
        grads = torch.autograd.grad(total, state.g_params.params)
        aux = {k: v.detach() for k, v in {**g_aux, **fm_aux}.items()}
        return total.detach(), aux, state.g_params.flatten(grads)

    # ----------------------------------------------------------------- step
    def _augmented(self, x, draws, prefix):
        return augment(x, _group(draws, prefix), self.ada_ops) if self.aug_on else x

    def update(self, state: TrainState, real, labels, draws: Draws, r1: bool,
               pl: bool = False) -> Metrics:
        """One step's device work on prepared inputs, R1 and R2 where `r1`
        says, PL where `pl` says: the updates, the EMA, ADA's p, LeCam's
        trackers and the path-length mean, all in the state's own tensors;
        the metrics. The step count is the caller's."""
        t, gan = self.tcfg, self.gan
        d_norm = None
        if self.flavor == "fused":
            z, lab = draws["z_d"], draws.get("labels_d")
            fake = self._augmented(self.g_forward(z, lab, draws, "d"), draws, "aug_fake")
            real_in = self._augmented(real, draws, "aug_real")
            d_loss, d_aux, d_grads, logits = self.d_loss_and_grads(
                state, real_in, labels, fake, lab, draws, r1, keep_graph=True)
            g_loss, g_aux, g_grads = self.g_loss_and_grads(
                state, z, lab, real_in, labels, None, draws, pl, fake_logits=logits)
            d_grads = self._apply(self.d_opt, state.d_params, state.d_opt_state, d_grads)
            n_images = real.shape[0]
        elif self.flavor == "multi_critic":
            losses, auxes, norms = [], [], []
            for i in range(t.d_steps):
                cd = _row({k: v for k, v in draws.items() if _critic_draw(k)}, i)
                lab_i = labels[i] if labels is not None else None
                d_loss, d_aux, d_grads, real_g = self._d_update(state, real[i], lab_i, cd, r1)
                losses.append(d_loss)
                auxes.append(d_aux)
                norms.append(safe_global_norm(d_grads, state.d_params.layout))
            d_loss = torch.stack(losses).mean()
            d_aux = {k: torch.stack([a[k] for a in auxes]).mean() for k in auxes[0]}
            d_norm = torch.stack(norms).mean()
            # FM's and the relativistic G loss's real side: the last critic
            # batch under the augmentation D saw
            lab_g = labels[-1] if labels is not None else None
            g_loss, g_aux, g_grads = self.g_loss_and_grads(
                state, draws["z_g"], draws.get("labels_g"), real_g, lab_g,
                _group(draws, "aug_g"), draws, pl)
            n_images = real.shape[0] * real.shape[1]
        else:
            d_loss, d_aux, d_grads, real_in = self._d_update(state, real, labels, draws, r1)
            g_loss, g_aux, g_grads = self.g_loss_and_grads(
                state, draws["z_g"], draws.get("labels_g"), real_in, labels,
                _group(draws, "aug_g"), draws, pl)
            n_images = real.shape[0]
        return self.finish(state, d_loss, d_aux, d_grads, d_norm, g_loss, g_aux, g_grads,
                           n_images, draws)

    def _d_update(self, state, real, labels, draws, r1):
        """One D update on (real, G(z_d)) with G's forward under no_grad;
        returns D's loss, aux metrics, gradient and input reals."""
        with torch.no_grad():
            fake = self.g_forward(draws["z_d"], draws.get("labels_d"), draws, "d")
            fake_in = self._augmented(fake, draws, "aug_fake")
            real_in = self._augmented(real, draws, "aug_real")
        d_loss, d_aux, d_grads, _ = self.d_loss_and_grads(
            state, real_in, labels, fake_in, draws.get("labels_d"), draws, r1)
        d_grads = self._apply(self.d_opt, state.d_params, state.d_opt_state, d_grads)
        return d_loss, d_aux, d_grads, real_in

    def _apply(self, opt, params, opt_state, grads):
        """One optimizer update of a flat parameter buffer from the ranks'
        mean gradient (returned): the parameters and the optimizer state
        change in place, every tensor at its address."""
        grads = self.mesh.mean_(grads)
        updates, new = opt.update(grads, opt_state)
        with torch.no_grad():
            params.apply_update(updates)
            opt_state.copy_(new)
        return grads

    def _mean_metrics(self, metrics: Metrics) -> Metrics:
        """The ranks' mean of every metric, in one all-reduce."""
        if self.mesh.group is None or not metrics:
            return metrics
        names = list(metrics)
        packed = self.mesh.mean_(torch.stack([metrics[k].float().reshape(()) for k in names]))
        return dict(zip(names, packed.unbind(0)))

    def finish(self, state, d_loss, d_aux, d_grads, d_norm, g_loss, g_aux, g_grads,
               n_images, draws) -> Metrics:
        """The shared tail of the flavors: G's update, the EMA, ADA's
        controller, LeCam's trackers, the path-length mean, the metrics."""
        t = self.tcfg
        g_grads = self._apply(self.g_opt, state.g_params, state.g_opt_state, g_grads)
        # the metrics that differ between ranks, reduced before ADA and
        # LeCam read them
        local = self._mean_metrics({"d_loss": d_loss, "g_loss": g_loss, **d_aux, **{
            k: v for k, v in g_aux.items() if k not in _REPLICATED}})
        d_loss, g_loss = local.pop("d_loss"), local.pop("g_loss")
        d_aux = {k: local[k] for k in d_aux}
        g_aux = {k: local.get(k, v) for k, v in g_aux.items()}
        with torch.no_grad():
            if state.ema_params is not None:
                decay = t.ema_decay
                if t.ema_rampup > 0.0:
                    decay = rampup_decay(state.step_tensor, t.ema_decay, t.ema_rampup)
                bits = draws.get("ema_bits")
                g = state.g_params
                new = ema_update(state.ema_params, g.local(g.flat), decay,
                                 None if bits is None else g.local(g.model_slice(bits)))
                emitted = self.g_opt.emitted(state.g_opt_state)
                if emitted is not None:  # the EMA moves on optimizer emits only
                    new = torch.where(emitted, new, state.ema_params)
                state.ema_params.copy_(new)
            if t.ada_target > 0.0:
                step = n_images * self.mesh.dp / (t.ada_speed_kimg * 1000.0)
                state.ada_p.copy_(torch.clamp(
                    state.ada_p + torch.sign(d_aux["ada_r"] - t.ada_target) * step, 0.0, 1.0))
            if "pl_mean" in g_aux:
                state.pl_mean.copy_(g_aux["pl_mean"])
            if t.lecam_gamma > 0.0:
                m = torch.stack([d_aux["real_logits"], d_aux["fake_logits"]]).float()
                new = t.lecam_decay * state.lecam + (1.0 - t.lecam_decay) * m
                state.lecam.copy_(torch.where(torch.isfinite(m).all(), new, state.lecam))
            if state.step_tensor is not None:
                state.step_tensor.add_(1)
        metrics = {**g_aux, "d_loss": d_loss, "g_loss": g_loss,
                   "d_grad_norm": (safe_global_norm(d_grads, state.d_params.layout)
                                   if d_norm is None else d_norm),
                   "g_grad_norm": safe_global_norm(g_grads, state.g_params.layout), **d_aux}
        if self.aug_on:
            metrics["augment_p"] = state.ada_p.clone()
        for prefix, s in (("d_", state.d_opt_state), ("g_", state.g_opt_state)):
            for k, v in guard_stats(s, t).items():
                if k != "grad_norm_guard":
                    # a copy: the state's tensor moves on at the next step
                    metrics[prefix + k] = v.clone()
        return metrics

    def __call__(self, state: TrainState, batch: Batch, **draws) -> Tuple[TrainState, Metrics]:
        flags = self.lazy_flags(state.step)
        real, labels, prepared = self.prepare(state, batch, flags, **draws)
        metrics = self.update(state, real, labels, prepared, *flags)
        state.step += 1
        return state, metrics


def make_train_step(cfg: Config, gan: GAN) -> TrainStep:
    """The one-process train step of `gan` in the flavor `cfg.train` names
    (`TrainStep`); on a mesh, `parallel/sharding.py:make_step_for`."""
    return TrainStep(cfg, gan)


# Metric keys whose reduction over a call's steps is the last step's, not
# the mean: running state (the guards' skip streaks and counts, ADA's p, the
# path-length mean), whose value at the end of the call is the current one
# (`locate_tpu/train/step.py`).
_LAST_METRICS = ("d_nonfinite_streak", "g_nonfinite_streak",
                 "d_grad_limit_count", "g_grad_limit_count",
                 "d_grad_limit_streak", "g_grad_limit_streak",
                 "augment_p", "pl_mean")


def reduce_metrics(per_step: Dict[str, torch.Tensor]) -> Metrics:
    """A call's metrics from each metric's [k] values, one a step: the last
    step's for `_LAST_METRICS`, the mean for the rest."""
    return {k: (v[-1].clone() if k in _LAST_METRICS else v.mean())
            for k, v in per_step.items()}


class MultiStep:
    """`multi(state, batches, **draws) -> (state, metrics)`: `k` optimizer
    steps a call, the counterpart of the JAX package's `make_multi_step`.
    Every leaf of `batches` (and each draw passed) has a leading [k] axis,
    step i takes row i. On the CPU the steps run one by one; on the card
    they are replays of a CUDA graph of one step (`train/graph.py`), one
    graph for each set of lazy flags, with nothing between the replays
    that waits for the host. A capture or replay that fails raises."""

    def __init__(self, step: TrainStep, k: int):
        self.step, self.k = step, k
        self.graphs = None

    def __call__(self, state: TrainState, batches: Batch, **draws) -> Tuple[TrainState,
                                                                          Metrics]:
        draws = {name: t for name, t in draws.items() if t is not None}
        if state.g_params.flat.device.type == "cuda":
            from locate_tpu_torch.train.graph import StepGraphs

            if self.graphs is None:
                self.graphs = StepGraphs(self.step, self.k, state, batches, draws)
            return self.graphs(state, batches, draws)
        history = []
        for i in range(self.k):
            state, metrics = self.step(state, {n: t[i] for n, t in batches.items()},
                                       **{n: t[i] for n, t in draws.items()})
            history.append(metrics)
        return state, reduce_metrics({k: torch.stack([m[k] for m in history])
                                      for k in history[0]})


def make_multi_step(step: TrainStep, steps_per_call: int):
    """`step` itself for one step a call, else a `MultiStep` of
    `steps_per_call` steps (`train.steps_per_call`)."""
    if steps_per_call <= 1:
        return step
    return MultiStep(step, steps_per_call)
