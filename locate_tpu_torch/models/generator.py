"""Generator, counterpart of `locate_tpu/models/generator.py`.

Locate family: latent z (+ optional class embedding) -> dense to a 4x4xC
seed -> stages of [upsample + conv blocks + location attention] -> norm +
act + to-RGB conv + tanh -> NHWC image in [-1, 1]. With
`model.g_rgb="skip"` each stage has its own linear [norm, act, 1x1 conv]
head instead, summed in f32 with the 2x-upsampled running image, and one
tanh on the sum. `generator_of` dispatches on `model.arch`: "style" is
`models/style_generator.py`.

The module tree mirrors the JAX params pytree, so `state_dict()` keys are
the JAX dotted paths (`seed.w`, `trunk.0.1.main.2.row.w`, `head.2.b` or
`rgb.3.2.w`, `class_embed`) and weights carry across through
`io/export.py`.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from locate_tpu_torch.config import ModelConfig
from locate_tpu_torch.device import resolve_device
from locate_tpu_torch.nn.blocks import ToRGB, generator_stage, run_stage, run_stages
from locate_tpu_torch.ops import initializers
from locate_tpu_torch.ops.activations import Act
from locate_tpu_torch.ops.conv import Conv2d, Dense, upsample_nearest
from locate_tpu_torch.ops.norm import make_norm
from locate_tpu_torch.parallel.tp import whole


def as_dtype(dtype: Union[None, str, torch.dtype]) -> Optional[torch.dtype]:
    """`train.compute_dtype` strings ("bfloat16", "float32") to torch."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, dtype)


class Generator(nn.Module):
    """`forward(z, labels=None) -> images` (NHWC, compute dtype, in [-1, 1])."""

    def __init__(self, cfg: ModelConfig, compute_dtype: Optional[torch.dtype] = None,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.arch != "locate":
            raise ValueError(f"model.arch={cfg.arch!r}: build it with generator_of")
        self.config = cfg
        self.num_ws = 0  # the style family's crossover index space
        self.compute_dtype = compute_dtype
        chans = cfg.stage_channels()
        resolutions = cfg.stage_resolutions()
        self.chans = chans
        in_dim = cfg.latent_dim + (cfg.class_embed_dim if cfg.num_classes else 0)
        self.seed = Dense(in_dim, 4 * 4 * chans[0], compute_dtype=compute_dtype, gen=gen)
        self.trunk = nn.Sequential(*[
            generator_stage(chans[max(i - 1, 0)], chans[i], resolutions[i], cfg,
                            first=(i == 0), compute_dtype=compute_dtype, gen=gen)
            for i in range(len(chans))
        ])
        dev = initializers.device_of(gen)
        if cfg.g_rgb == "skip":
            self.rgb = nn.ModuleList([nn.Sequential(
                make_norm(cfg.norm, c, cfg.group_norm_groups, compute_dtype=compute_dtype,
                          device=dev),
                Act(cfg.act, cfg.leaky_slope),
                Conv2d(c, cfg.img_channels, (1, 1),
                       weight_init=lambda g, s: initializers.normal(g, s, stddev=0.02),
                       compute_dtype=compute_dtype, gen=gen),
            ) for c in chans])
        else:
            self.head = nn.Sequential(
                make_norm(cfg.norm, chans[-1], cfg.group_norm_groups,
                          compute_dtype=compute_dtype, device=dev),
                Act(cfg.act, cfg.leaky_slope),
                ToRGB(chans[-1], cfg.img_channels, compute_dtype=compute_dtype, gen=gen),
            )
        if cfg.num_classes:
            self.class_embed = nn.Parameter(initializers.normal(
                gen, (cfg.num_classes, cfg.class_embed_dim), stddev=0.02))

    def forward(self, z: torch.Tensor, labels: Optional[torch.Tensor] = None) -> torch.Tensor:
        cd = self.compute_dtype or z.dtype
        z = z.to(cd)
        if self.config.num_classes:
            if labels is None:
                raise ValueError("class-conditional generator needs labels")
            z = torch.cat([z, whole(self.class_embed).to(cd)[labels]], dim=-1)
        x = self.seed(z).reshape(z.shape[0], 4, 4, self.chans[0])
        if self.config.g_rgb != "skip":
            return self.head(run_stages(self.trunk, x, self.config.remat))
        # the running image: each stage adds its linear RGB view to the
        # 2x-upsampled sum so far, in f32
        rgb = None
        for stage, head in zip(self.trunk, self.rgb):
            x = run_stage(stage, x, self.config.remat)
            y = head(x).float()
            rgb = y if rgb is None else upsample_nearest(rgb, 2) + y
        return torch.tanh(rgb).to(cd)


def generator_of(cfg: ModelConfig, compute_dtype: Optional[torch.dtype] = None,
                 gen: Optional[torch.Generator] = None) -> nn.Module:
    """The generator of the family `model.arch` names, weights drawn from
    `gen` (`locate_tpu/models/generator.py:build_generator`'s dispatch)."""
    if cfg.arch == "style":
        from locate_tpu_torch.models.style_generator import StyleGenerator

        return StyleGenerator(cfg, compute_dtype, gen)
    return Generator(cfg, compute_dtype, gen)


def build_generator(cfg: ModelConfig, compute_dtype=None, device=None,
                    seed: int = 0) -> nn.Module:
    """A generator of either family with weights drawn from
    `torch.Generator(device)` seeded with `seed`, on the card unless
    `device="cpu"` is asked for."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return generator_of(cfg, as_dtype(compute_dtype), gen)
