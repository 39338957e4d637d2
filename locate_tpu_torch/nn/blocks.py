"""Generator and discriminator blocks, counterpart of `locate_tpu/nn/blocks.py`.

Module and attribute names follow the JAX params pytree, so a block's
`state_dict()` keys are the JAX dotted paths (`main.0.scale`,
`main.2.row.w`, `skip.w`, ...). The JAX package's fused-stage dispatch
(`_maybe_fused_stage`, kernels 7-11 of ROADMAP.md Queue 2) is not ported:
where its profile would fuse a stage, the port raises rather than run the
stage unfused.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.utils.checkpoint
from torch import nn

from locate_tpu_torch.config import ModelConfig
from locate_tpu_torch.ops import initializers
from locate_tpu_torch.ops.activations import Act
from locate_tpu_torch.ops.attention import LocateAttention
from locate_tpu_torch.ops.conv import (Conv2d, DownsampleAvg, FactorizedConv2d,
                                       UpsampleNearest)
from locate_tpu_torch.ops.norm import make_norm

# `gate_profile.json` `min_locations` of every fused-stage flavor in the
# JAX package: at or above it the JAX stage runs the fused-stage kernels.
FUSE_MIN_LOCATIONS = 262144


def _conv(in_ch, out_ch, cfg: ModelConfig, compute_dtype, gen):
    if cfg.factorized and cfg.kernel_size > 1:
        return FactorizedConv2d(in_ch, out_ch, cfg.kernel_size,
                                compute_dtype=compute_dtype, gen=gen)
    return Conv2d(in_ch, out_ch, (cfg.kernel_size, cfg.kernel_size),
                  compute_dtype=compute_dtype, gen=gen)


class ConvBlock(nn.Module):
    """Pre-activation residual conv block, y = conv(act(norm(x))) + skip(x),
    scaled by 1/sqrt(2), with a 1x1 skip projection when channels differ."""

    def __init__(self, in_ch: int, out_ch: int, cfg: ModelConfig,
                 compute_dtype: Optional[torch.dtype] = None,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.main = nn.Sequential(
            make_norm(cfg.norm, in_ch, cfg.group_norm_groups,
                      compute_dtype=compute_dtype, device=initializers.device_of(gen)),
            Act(cfg.act, cfg.leaky_slope),
            _conv(in_ch, out_ch, cfg, compute_dtype, gen),
        )
        self.skip = (
            None if in_ch == out_ch
            else Conv2d(in_ch, out_ch, (1, 1), use_bias=False,
                        compute_dtype=compute_dtype, gen=gen)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.main(x)
        s = x if self.skip is None else self.skip(x)
        return (y + s) * _inv_sqrt2(y.dtype)


def _inv_sqrt2(dtype: torch.dtype) -> float:
    """1/sqrt(2) rounded to `dtype`, as `jnp.asarray(0.7071..., y.dtype)`."""
    return float(torch.tensor(0.7071067811865476, dtype=dtype))


def stage_fusable(cfg: ModelConfig) -> bool:
    """Whether the JAX package's fused-stage kernel implements this
    config's conv block (`locate_tpu/nn/blocks.py:stage_fusable`)."""
    return (
        cfg.use_pallas
        and cfg.factorized
        and cfg.kernel_size == 3
        and cfg.norm == "group"
        and cfg.act in ("leaky_relu", "relu", "silu", "gelu")
    )


def _refuse_fused_stage(cfg: ModelConfig, resolution: int) -> None:
    if stage_fusable(cfg) and resolution * resolution >= FUSE_MIN_LOCATIONS:
        raise NotImplementedError(
            f"a {resolution}x{resolution} stage with use_pallas runs the fused "
            "stage kernels (ops/pallas/fused_stage.py) in the JAX package; they "
            "are not ported yet (ROADMAP.md, Queue 2)")


def _attention_layer(cfg: ModelConfig, out_ch: int, compute_dtype, gen):
    if cfg.attention.kind == "self":
        raise NotImplementedError(
            "attention.kind='self' (ops/self_attention.py and its flash "
            "kernels) is not ported yet (ROADMAP.md)")
    return LocateAttention(out_ch, cfg.attention, cfg.act, cfg.leaky_slope,
                           compute_dtype, use_pallas=cfg.use_pallas, gen=gen)


def generator_stage(in_ch: int, out_ch: int, resolution: int, cfg: ModelConfig,
                    first: bool, compute_dtype: Optional[torch.dtype] = None,
                    gen: Optional[torch.Generator] = None) -> nn.Sequential:
    """One generator stage: [upsample] + conv blocks + attention.
    `resolution` is the stage's output resolution."""
    _refuse_fused_stage(cfg, resolution)
    layers = [] if first else [UpsampleNearest(2)]
    layers.append(ConvBlock(in_ch, out_ch, cfg, compute_dtype, gen))
    for _ in range(cfg.blocks_per_stage - 1):
        layers.append(ConvBlock(out_ch, out_ch, cfg, compute_dtype, gen))
    if cfg.attention_at(resolution):
        layers.append(_attention_layer(cfg, out_ch, compute_dtype, gen))
    return nn.Sequential(*layers)


def run_stages(stages: nn.Sequential, x: torch.Tensor, remat: bool) -> torch.Tensor:
    """Run `stages` in turn. With `remat` (model.remat, `nn/core.py:maybe_remat`)
    each stage's activations are recomputed in the backward pass instead of
    stored, through non-reentrant `torch.utils.checkpoint`."""
    for stage in stages:
        if remat and torch.is_grad_enabled():
            x = torch.utils.checkpoint.checkpoint(stage, x, use_reentrant=False)
        else:
            x = stage(x)
    return x


def discriminator_stage(in_ch: int, out_ch: int, resolution: int, cfg: ModelConfig,
                        last: bool, compute_dtype: Optional[torch.dtype] = None,
                        gen: Optional[torch.Generator] = None) -> nn.Sequential:
    """One discriminator stage, the generator's mirror: conv blocks +
    attention + [2x average-pool downsample unless `last`]. `resolution`
    is the stage's input resolution."""
    _refuse_fused_stage(cfg, resolution)
    layers = [ConvBlock(in_ch, out_ch, cfg, compute_dtype, gen)]
    for _ in range(cfg.blocks_per_stage - 1):
        layers.append(ConvBlock(out_ch, out_ch, cfg, compute_dtype, gen))
    if cfg.attention_at(resolution):
        layers.append(_attention_layer(cfg, out_ch, compute_dtype, gen))
    if not last:
        layers.append(DownsampleAvg(2))
    return nn.Sequential(*layers)


class ToRGB(Conv2d):
    """Feature map -> image in [-1, 1]: a 1x1 conv (params `w`, `b`, as
    the JAX layer's) then tanh in f32, cast back to the compute dtype."""

    def __init__(self, in_ch: int, img_channels: int,
                 compute_dtype: Optional[torch.dtype] = None,
                 gen: Optional[torch.Generator] = None):
        super().__init__(in_ch, img_channels, (1, 1),
                         weight_init=lambda g, s: initializers.normal(g, s, stddev=0.02),
                         compute_dtype=compute_dtype, gen=gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(super().forward(x).float()).to(self.compute_dtype or x.dtype)


def from_rgb(img_channels: int, out_ch: int, compute_dtype: Optional[torch.dtype] = None,
             gen: Optional[torch.Generator] = None) -> Conv2d:
    """Image -> feature map: a 1x1 conv (params `w`, `b`)."""
    return Conv2d(img_channels, out_ch, (1, 1), compute_dtype=compute_dtype, gen=gen)
