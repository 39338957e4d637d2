"""Generator and discriminator blocks, counterpart of `locate_tpu/nn/blocks.py`.

Module and attribute names follow the JAX params pytree, so a block's
`state_dict()` keys are the JAX dotted paths (`main.0.scale`,
`main.2.row.w`, `skip.w`, ...). A stage is a `FusableStage`: an
`nn.Sequential` of the same children whatever `use_pallas` says, whose
forward is the port of `_maybe_fused_stage`. Where the config's conv block
is fusable and a stage flavor reaches its threshold of locations, it runs
that conv block (with the attention after it, the upsample before it or
the pool after it) through `ops/fused_stage.py`; elsewhere it runs the
layers one by one. A self-attention layer (`attention.kind="self"`) is
never part of a fused pair.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.utils.checkpoint
from torch import nn

from locate_tpu_torch.config import ModelConfig
from locate_tpu_torch.ops import gate_profile, initializers
from locate_tpu_torch.ops.activations import Act
from locate_tpu_torch.ops.attention import LocateAttention
from locate_tpu_torch.ops.conv import (Conv2d, DownsampleAvg, FactorizedConv2d,
                                       UpsampleNearest)
from locate_tpu_torch.ops.fused_stage import fused_stage
from locate_tpu_torch.ops.norm import make_norm
from locate_tpu_torch.ops.self_attention import SelfAttention
from locate_tpu_torch.parallel.tp import whole

# An int here overrides the profile's threshold for every flavor (tests and
# chip_smoke.py force fusion with it), as the JAX package's
# `FUSE_MIN_LOCATIONS` does.
FUSE_MIN_LOCATIONS: Optional[int] = None


def fuse_threshold(flavor: str) -> int:
    """The count of (fine) locations at or above which a stage flavor runs
    fused: `FUSE_MIN_LOCATIONS`, else the card's profile
    (`ops/gate_profile.json`)."""
    if FUSE_MIN_LOCATIONS is not None:
        return FUSE_MIN_LOCATIONS
    return gate_profile.min_locations(flavor)


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


def _apply_fused_stage(cfg: ModelConfig, block: ConvBlock,
                       attn: Optional[LocateAttention], x: torch.Tensor,
                       compute_dtype, upsample: bool, downsample: bool) -> torch.Tensor:
    """`block` (and the gate `attn` after it, if given) through
    `fused_stage`, on the layers' own parameters. With `upsample`, x is
    the coarse input of the stage's upsample; with `downsample`, the
    stage's pool is fused in."""
    norm, _, conv = block.main
    # the kernels read whole weights: a model-split one is gathered
    w_row, w_col = whole(conv.row.w), whole(conv.col.w)
    skip = None if block.skip is None else whole(block.skip.w)
    kw = dict(groups=norm.groups, eps=norm.eps, act=cfg.act, leaky_slope=cfg.leaky_slope,
              upsample=upsample, downsample=downsample)
    if attn is not None:
        _, h, w, _ = x.shape
        if upsample:
            h, w = 2 * h, 2 * w  # the gate's position features are fine
        pos_proj, w1x, b1, w2, b2 = attn.gate_operands(h, w, w_col.shape[0], x.device)
        kw.update(mode=cfg.attention.mode, pos_proj=pos_proj, w1x=w1x, b1=b1, w2=w2, b2=b2,
                  gate_max=cfg.attention.gate_max)
    return fused_stage(x.to(compute_dtype or x.dtype), norm.scale, norm.bias, w_row, w_col,
                       conv.col.b, skip, **kw)


class FusableStage(nn.Sequential):
    """One resolution stage: the layers of an `nn.Sequential` (so its
    state_dict keys do not depend on `use_pallas`), and the forward of
    `_maybe_fused_stage`. With a fusable config, each conv block whose
    flavor reaches its threshold runs fused: with the attention after it
    (a pair), with the upsample before it (`up_`), with the pool after it
    or after its attention (`down_`); the other layers run one by one."""

    def __init__(self, layers, cfg: ModelConfig, compute_dtype: Optional[torch.dtype]):
        super().__init__(*layers)
        self.cfg = cfg
        self.compute_dtype = compute_dtype

    def plan(self, height: int, width: int) -> List[Tuple[Optional[str], int, int, int, int]]:
        """The calls `forward` makes on an input of height x width (coarse
        under an upsample), in order: (flavor, first layer, layer count,
        height, width of that call's input), where a flavor runs those
        layers as one fused stage and None runs the one layer alone."""
        layers = list(self)
        if not stage_fusable(self.cfg):
            calls = []
            for i, layer in enumerate(layers):
                calls.append((None, i, 1, height, width))
                height, width = _resampled(layer, height, width)
            return calls
        calls, i = [], 0
        while i < len(layers):
            up = (isinstance(layers[i], UpsampleNearest) and i + 1 < len(layers)
                  and isinstance(layers[i + 1], ConvBlock))
            j = i + up  # the candidate conv block
            locs = height * width * (4 if up else 1)
            conv = isinstance(layers[j], ConvBlock)
            nxt = layers[j + 1] if j + 1 < len(layers) else None
            taken = None
            if conv and isinstance(nxt, LocateAttention) and self.cfg.attention.residual:
                dn = (not up and j + 2 < len(layers)
                      and isinstance(layers[j + 2], DownsampleAvg))
                flavor = "up_pair" if up else ("down_pair" if dn else "pair")
                if locs >= fuse_threshold(flavor):
                    taken = (flavor, 2 + dn)
            if taken is None and conv:
                dn = not up and isinstance(nxt, DownsampleAvg)
                flavor = "up_conv" if up else ("down_conv" if dn else "conv")
                if locs >= fuse_threshold(flavor):
                    taken = (flavor, 1 + dn)
            if taken is None:  # layer i alone (an unfused upsample too)
                calls.append((None, i, 1, height, width))
                height, width = _resampled(layers[i], height, width)
                i += 1
                continue
            flavor, count = taken
            calls.append((flavor, i, up + count, height, width))
            for layer in layers[i:j + count]:
                height, width = _resampled(layer, height, width)
            i = j + count
        return calls

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        layers = list(self)
        for flavor, i, _, _, _ in self.plan(x.shape[1], x.shape[2]):
            if flavor is None:
                x = layers[i](x)
                continue
            up, dn = flavor.startswith("up_"), flavor.startswith("down_")
            attn = layers[i + up + 1] if flavor.endswith("pair") else None
            x = _apply_fused_stage(self.cfg, layers[i + up], attn, x, self.compute_dtype,
                                   up, dn)
        return x


def _resampled(layer: nn.Module, height: int, width: int) -> Tuple[int, int]:
    """The spatial size after `layer`: scaled up by an upsample, down by a
    pool, else kept."""
    if isinstance(layer, UpsampleNearest):
        return layer.factor * height, layer.factor * width
    if isinstance(layer, DownsampleAvg):
        return height // layer.factor, width // layer.factor
    return height, width


def _attention_layer(cfg: ModelConfig, out_ch: int, compute_dtype, gen):
    if cfg.attention.kind == "self":
        return SelfAttention(out_ch, cfg.attention, compute_dtype,
                             use_pallas=cfg.use_pallas, gen=gen)
    return LocateAttention(out_ch, cfg.attention, cfg.act, cfg.leaky_slope,
                           compute_dtype, use_pallas=cfg.use_pallas, gen=gen)


def generator_stage(in_ch: int, out_ch: int, resolution: int, cfg: ModelConfig,
                    first: bool, compute_dtype: Optional[torch.dtype] = None,
                    gen: Optional[torch.Generator] = None) -> FusableStage:
    """One generator stage: [upsample] + conv blocks + attention.
    `resolution` is the stage's output resolution."""
    layers = [] if first else [UpsampleNearest(2)]
    layers.append(ConvBlock(in_ch, out_ch, cfg, compute_dtype, gen))
    for _ in range(cfg.blocks_per_stage - 1):
        layers.append(ConvBlock(out_ch, out_ch, cfg, compute_dtype, gen))
    if cfg.attention_at(resolution):
        layers.append(_attention_layer(cfg, out_ch, compute_dtype, gen))
    return FusableStage(layers, cfg, compute_dtype)


def run_stage(stage: nn.Module, x: torch.Tensor, remat: bool) -> torch.Tensor:
    """Run one stage. With `remat` (model.remat, `nn/core.py:maybe_remat`)
    its activations are recomputed in the backward pass instead of stored,
    through non-reentrant `torch.utils.checkpoint`; a stage draws no random
    numbers, so no generator state is stashed for the recompute."""
    if remat and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(stage, x, use_reentrant=False,
                                                 preserve_rng_state=False)
    return stage(x)


def run_stages(stages: nn.Sequential, x: torch.Tensor, remat: bool) -> torch.Tensor:
    """Run `stages` in turn, each through `run_stage`."""
    for stage in stages:
        x = run_stage(stage, x, remat)
    return x


def discriminator_stage(in_ch: int, out_ch: int, resolution: int, cfg: ModelConfig,
                        last: bool, compute_dtype: Optional[torch.dtype] = None,
                        gen: Optional[torch.Generator] = None) -> FusableStage:
    """One discriminator stage, the generator's mirror: conv blocks +
    attention + [2x average-pool downsample unless `last`]. `resolution`
    is the stage's input resolution."""
    layers = [ConvBlock(in_ch, out_ch, cfg, compute_dtype, gen)]
    for _ in range(cfg.blocks_per_stage - 1):
        layers.append(ConvBlock(out_ch, out_ch, cfg, compute_dtype, gen))
    if cfg.attention_at(resolution):
        layers.append(_attention_layer(cfg, out_ch, compute_dtype, gen))
    if not last:
        layers.append(DownsampleAvg(2))
    return FusableStage(layers, cfg, compute_dtype)


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
