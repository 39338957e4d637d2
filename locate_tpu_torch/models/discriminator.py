"""Discriminator, counterpart of `locate_tpu/models/discriminator.py`.

Image (+ optional class) -> from-RGB 1x1 conv -> stages of [conv blocks +
location attention + 2x average-pool], the generator's mirror -> norm +
act + global average pool -> dense logit, plus a projection term
<class_proj[y], features> when class-conditional. With
`model.spectral_norm` every forward runs on spectrally normalized weights
(`ops/spectral.py`).

The module tree mirrors the JAX params pytree, so `state_dict()` keys are
the JAX dotted paths (`stem.w`, `trunk.0.0.main.2.row.w`, `neck.0.scale`,
`head.w`, `class_proj`) and `io/export.py:params_from_jax` carries a JAX
discriminator across unchanged.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from locate_tpu_torch.config import ModelConfig
from locate_tpu_torch.device import resolve_device
from locate_tpu_torch.models.generator import as_dtype
from locate_tpu_torch.nn.blocks import discriminator_stage, from_rgb, run_stages
from locate_tpu_torch.ops import initializers
from locate_tpu_torch.ops.activations import Act
from locate_tpu_torch.ops.conv import Dense, GlobalAvgPool
from locate_tpu_torch.ops.norm import make_norm, minibatch_stddev
from locate_tpu_torch.ops.spectral import spectral_normalize


class Discriminator(nn.Module):
    """`forward(images, labels=None, return_features=False) -> logits (N,)`
    in f32 (and the pooled (N, C) features with `return_features`)."""

    def __init__(self, cfg: ModelConfig, compute_dtype: Optional[torch.dtype] = None,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.config = cfg
        self._normalizing = False
        self.compute_dtype = compute_dtype
        chans = cfg.stage_channels()
        resolutions = cfg.stage_resolutions()
        n = len(chans)
        self.stem = from_rgb(cfg.img_channels, chans[n - 1], compute_dtype, gen)
        # high-res -> low-res; the stage at resolutions[i] maps
        # chans[i] -> chans[max(i-1, 0)] and halves the resolution, except
        # the last (4x4) one
        self.trunk = nn.Sequential(*[
            discriminator_stage(chans[i], chans[max(i - 1, 0)], resolutions[i], cfg,
                                last=(i == 0), compute_dtype=compute_dtype, gen=gen)
            for i in range(n - 1, -1, -1)
        ])
        self.neck = nn.Sequential(
            make_norm(cfg.norm, chans[0], cfg.group_norm_groups,
                      compute_dtype=compute_dtype, device=initializers.device_of(gen)),
            Act(cfg.act, cfg.leaky_slope),
            GlobalAvgPool(),
        )
        # the minibatch-stddev scalar joins the pooled features at the head only
        self.head = Dense(chans[0] + (1 if cfg.mbstd_group else 0), 1,
                          compute_dtype=compute_dtype, gen=gen)
        if cfg.num_classes:
            # zero-init projection: conditioning starts neutral
            self.class_proj = nn.Parameter(
                initializers.zeros(gen, (cfg.num_classes, chans[0])))

    def forward(self, x: torch.Tensor, labels: Optional[torch.Tensor] = None,
                return_features: bool = False):
        cfg = self.config
        if cfg.spectral_norm and not self._normalizing:
            # the same forward on spectrally normalized weights: the
            # parameters stay what they are (the optimizer's, the EMA's and
            # the checkpoint's), gradients reach them through sigma
            sn = spectral_normalize(dict(self.named_parameters()), cfg.sn_iters)
            self._normalizing = True
            try:
                return torch.func.functional_call(self, sn, (x, labels, return_features))
            finally:
                self._normalizing = False
        cd = self.compute_dtype or x.dtype
        h = run_stages(self.trunk, self.stem(x.to(cd)), cfg.remat)
        feats = self.neck(h)                                   # (N, chans[0])
        head_in = feats
        if cfg.mbstd_group:
            mb = minibatch_stddev(h, cfg.mbstd_group)
            head_in = torch.cat([feats, mb.to(feats.dtype)], dim=-1)
        logit = self.head(head_in)[:, 0].float()
        if cfg.num_classes:
            if labels is None:
                raise ValueError("class-conditional discriminator needs labels")
            proj = self.class_proj.float()[labels]
            logit = logit + (proj * feats.float()).sum(dim=-1)
        if return_features:
            return logit, feats
        return logit


def build_discriminator(cfg: ModelConfig, compute_dtype=None, device=None,
                        seed: int = 0) -> Discriminator:
    """A discriminator with weights drawn from `torch.Generator(device)`
    seeded with `seed`, on the card unless `device="cpu"` is asked for."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return Discriminator(cfg, as_dtype(compute_dtype), gen)
