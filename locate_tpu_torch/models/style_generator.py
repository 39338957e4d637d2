"""Style-based generator family (`model.arch="style"`), counterpart of
`locate_tpu/models/style_generator.py`.

A mapping network z -> w (f32, pixel-norm, equalized-LR dense layers, an
optional class embedding), a learned 4x4 constant, and stages of
weight-modulated 3x3 convolutions (an upsample first from the second
stage on), each stage ending in the configured attention layer, then a
styled 1x1 to-RGB and tanh. With `model.g_rgb="skip"` every stage has its
own styled to-RGB, summed in f32 with the 2x-upsampled running image.

The modulated conv is the JAX package's input-scale / output-demodulate
form: one ordinary convolution with the shared weight on x * s, then the
output scaled by demod = rsqrt(sum (W s)^2 + eps) a sample and output
channel; s and demod in f32, the conv in the compute dtype, the bias cast.

Styles are indexed by layer (`num_ws` of them: stage-major conv order and
one to-RGB last, or with "skip" each stage's convs then its to-RGB);
`synthesis` takes w as (N, D), one style for all, or (N, num_ws, D), the
style-mixing form. Noise (`style.noise`): "const" adds JAX's fixed
per-layer plane (`utils/jax_random.py`), "random" a per-sample plane the
caller passes (the train step draws them) and the const plane without
one. `w_average` and `apply_truncated` give w-space truncation.

The module tree mirrors the JAX params pytree, so `state_dict()` keys are
its dotted paths (`mapping.layers.0.w`, `const`,
`stages.1.convs.0.affine.b`, `stages.1.attn.to_hidden.w`, `rgb.w` or
`rgb.2.w`) and `io/export.py:params_from_jax` carries weights across.
Under tensor parallelism (`parallel/tp.py`) the mapping's, the modulated
convs' and the constant's split leaves are gathered whole at use.
"""

from __future__ import annotations

import functools
import math
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.utils.checkpoint
from torch import nn

from locate_tpu_torch.config import ModelConfig
from locate_tpu_torch.nn.blocks import _attention_layer
from locate_tpu_torch.ops import initializers
from locate_tpu_torch.ops.activations import act_fn
from locate_tpu_torch.ops.conv import conv_nhwc, upsample_nearest
from locate_tpu_torch.parallel.tp import whole
from locate_tpu_torch.utils import jax_random

NOISE_SEED = 0x4E4F4953  # the const planes' PRNGKey


def const_noise_plane(li: int, h: int, w: int) -> np.ndarray:
    """The fixed noise plane of styled layer `li`: JAX's
    `normal(fold_in(PRNGKey(0x4E4F4953), li), (h, w, 1))`."""
    return jax_random.normal(jax_random.fold_in(jax_random.prng_key(NOISE_SEED), li),
                             (h, w, 1))


class EqDense(nn.Module):
    """Equalized-LR dense layer: `w` drawn N(0, 1) / lr_mul, scaled by
    lr_mul / sqrt(in) at run time; x @ (w scale) + b lr_mul in x's dtype."""

    def __init__(self, in_dim: int, out_dim: int, lr_mul: float = 1.0,
                 bias_init: float = 0.0, gen: Optional[torch.Generator] = None):
        super().__init__()
        self.lr_mul = lr_mul
        self.w = nn.Parameter(initializers.normal(gen, (in_dim, out_dim), stddev=1.0) / lr_mul)
        self.b = nn.Parameter(initializers.zeros(gen, (out_dim,)) + bias_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.lr_mul / float(np.sqrt(self.w.shape[0]))
        return x @ (whole(self.w) * scale).to(x.dtype) + (self.b * self.lr_mul).to(x.dtype)


class ModulatedConv2d(nn.Module):
    """One styled conv: `affine` maps w to the per-sample input scales s
    (bias 1: styles start at identity), `w` (OIHW, N(0, w_std^2)) and `b`;
    with `noise_plane` = (layer index, resolution) a learned
    `noise_strength` (0 at init) and the layer's const plane (a buffer
    outside the state_dict)."""

    def __init__(self, w_dim: int, cin: int, cout: int, kernel: int, w_std: float = 1.0,
                 noise_plane: Optional[Sequence[int]] = None,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.affine = EqDense(w_dim, cin, bias_init=1.0, gen=gen)
        w = initializers.normal(gen, (kernel, kernel, cin, cout), stddev=1.0) * w_std
        self.w = nn.Parameter(w.permute(3, 2, 0, 1).contiguous())
        self.b = nn.Parameter(initializers.zeros(gen, (cout,)))
        if noise_plane is not None:
            self.noise_strength = nn.Parameter(initializers.zeros(gen, ()))
            li, res = noise_plane
            plane = torch.as_tensor(const_noise_plane(li, res, res),
                                    device=initializers.device_of(gen))
            self.register_buffer("noise_const", plane, persistent=False)

    def forward(self, x: torch.Tensor, wlat: torch.Tensor, demodulate: bool = True,
                eps: float = 1e-8) -> torch.Tensor:
        cd = x.dtype
        w = whole(self.w)
        _, cin, kh, kw = w.shape
        he = 1.0 / float(np.sqrt(kh * kw * cin))
        s = self.affine(wlat.float())                                   # (N, Cin)
        y = conv_nhwc(x * s.to(cd)[:, None, None, :], (w * he).to(cd))
        if demodulate:
            wsq = ((w.float() * he) ** 2).sum(dim=(2, 3)).T             # (Cin, Cout)
            d = torch.rsqrt((s ** 2) @ wsq + eps)                       # (N, Cout)
            y = y * d.to(cd)[:, None, None, :]
        return y + self.b.to(cd)


class Mapping(nn.Module):
    """`layers` of EqDense at `mapping_lr_mul`, and `class_embed` when
    class-conditional (the JAX params' `mapping` subtree)."""

    def __init__(self, cfg: ModelConfig, w_dim: int, gen: Optional[torch.Generator]):
        super().__init__()
        scfg = cfg.style
        map_in = cfg.latent_dim + (cfg.class_embed_dim if cfg.num_classes else 0)
        dims = [map_in] + [w_dim] * scfg.mapping_layers
        self.layers = nn.ModuleList([EqDense(dims[i], dims[i + 1], lr_mul=scfg.mapping_lr_mul,
                                             gen=gen)
                                     for i in range(scfg.mapping_layers)])
        if cfg.num_classes:
            self.class_embed = nn.Parameter(initializers.normal(
                gen, (cfg.num_classes, cfg.class_embed_dim), stddev=0.02))


class StyleStage(nn.Module):
    """A synthesis stage's parameters: `convs` and, where the config puts
    attention at its resolution, `attn`."""

    def __init__(self, convs: List[ModulatedConv2d], attn: Optional[nn.Module]):
        super().__init__()
        self.convs = nn.ModuleList(convs)
        self.attn = attn


@functools.lru_cache(maxsize=None)
def _gain(dtype: torch.dtype) -> float:
    """The variance-preserving gain sqrt(2) after an activation, rounded to
    `dtype` as `jnp.asarray(gain, x.dtype)`."""
    return float(torch.tensor(math.sqrt(2.0), dtype=dtype))


def _pixel_norm(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x ** 2).mean(dim=-1, keepdim=True) + 1e-8)


class StyleGenerator(nn.Module):
    """`forward(z, labels=None, noise=None) -> images` (NHWC, compute
    dtype, in [-1, 1]); `apply_mixed` is the style-mixing forward;
    `mapping` and `synthesis` are the two halves. `noise`, for
    style.noise="random", is a list over stages of lists over convs of
    (N, H, W, 1) f32 planes (`noise_shapes`)."""

    def __init__(self, cfg: ModelConfig, compute_dtype: Optional[torch.dtype] = None,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        scfg = cfg.style
        self.config = cfg
        self.compute_dtype = compute_dtype
        chans = cfg.stage_channels()
        resolutions = cfg.stage_resolutions()
        self.chans, self.resolutions = chans, resolutions
        w_dim = scfg.w_dim or cfg.latent_dim
        bps = cfg.blocks_per_stage
        self.skip_rgb = cfg.g_rgb == "skip"
        self.noise_on = scfg.noise != "none"
        self.num_ws = len(chans) * (bps + 1) if self.skip_rgb else len(chans) * bps + 1
        self.act = act_fn(cfg.act, cfg.leaky_slope)
        self.mapping = Mapping(cfg, w_dim, gen)
        self.const = nn.Parameter(initializers.normal(gen, (4, 4, chans[0]), stddev=1.0))
        stages = []
        for i in range(len(chans)):
            cin, cout = chans[max(i - 1, 0)], chans[i]
            convs = [ModulatedConv2d(
                w_dim, cin if j == 0 else cout, cout, cfg.kernel_size,
                noise_plane=(self.li_conv(i, j), resolutions[i]) if self.noise_on else None,
                gen=gen) for j in range(bps)]
            attn = (_attention_layer(cfg, cout, compute_dtype, gen)
                    if cfg.attention_at(resolutions[i]) else None)
            stages.append(StyleStage(convs, attn))
        self.stages = nn.ModuleList(stages)
        if self.skip_rgb:
            self.rgb = nn.ModuleList([ModulatedConv2d(w_dim, c, cfg.img_channels, 1, w_std=0.05,
                                                      gen=gen) for c in chans])
        else:
            self.rgb = ModulatedConv2d(w_dim, chans[-1], cfg.img_channels, 1, w_std=0.05,
                                       gen=gen)

    # ------------------------------------------------------ the style index
    def li_conv(self, i: int, j: int) -> int:
        """The style index of stage i's conv j."""
        bps = self.config.blocks_per_stage
        return i * (bps + 1) + j if self.skip_rgb else i * bps + j

    def li_rgb(self, i: int) -> int:
        """The style index of stage i's to-RGB (the last one without skip)."""
        bps = self.config.blocks_per_stage
        return i * (bps + 1) + bps if self.skip_rgb else self.num_ws - 1

    @staticmethod
    def w_at(wlat: torch.Tensor, li: int) -> torch.Tensor:
        return wlat if wlat.ndim == 2 else wlat[:, li]

    def noise_shapes(self, n: int) -> List[List[tuple]]:
        """The shapes of one forward's random noise planes, by stage and conv."""
        return [[(n, r, r, 1)] * len(stage.convs)
                for r, stage in zip(self.resolutions, self.stages)]

    # -------------------------------------------------------------- forward
    def _act(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(x) * _gain(x.dtype)

    def mapping_forward(self, z: torch.Tensor, labels: Optional[torch.Tensor] = None):
        """z (and labels) -> w (N, w_dim), in f32 throughout."""
        x = _pixel_norm(z.float())
        if self.config.num_classes:
            if labels is None:
                raise ValueError("class-conditional generator needs labels")
            embed = whole(self.mapping.class_embed)
            x = torch.cat([x, _pixel_norm(embed[labels].float())], dim=-1)
        for layer in self.mapping.layers:
            x = self._act(layer(x))
        return x

    def _stage(self, i: int, x: torch.Tensor, wlat: torch.Tensor,
               noise: Optional[List[torch.Tensor]]) -> torch.Tensor:
        stage = self.stages[i]
        if i > 0:
            x = upsample_nearest(x, 2)
        for j, conv in enumerate(stage.convs):
            y = conv(x, self.w_at(wlat, self.li_conv(i, j)), self.config.style.demodulate)
            if self.noise_on:
                nz = noise[j] if noise is not None else conv.noise_const[None]
                y = y + (conv.noise_strength * nz).to(y.dtype)
            x = self._act(y)
        if stage.attn is not None:
            x = stage.attn(x)
        return x

    def synthesis(self, wlat: torch.Tensor, noise=None, dtype=None) -> torch.Tensor:
        """w (N, D) or per-layer w (N, num_ws, D) -> images. `noise` is used
        under style.noise="random" only (else the const planes)."""
        cfg = self.config
        cd = self.compute_dtype or dtype or torch.float32
        if cfg.style.noise != "random":
            noise = None
        n = wlat.shape[0]
        x = whole(self.const).to(cd)[None].expand(n, 4, 4, self.chans[0])
        rgb = None
        for i in range(len(self.stages)):
            nz = noise[i] if noise is not None else None
            if cfg.remat and torch.is_grad_enabled():
                x = torch.utils.checkpoint.checkpoint(self._stage, i, x, wlat, nz,
                                                      use_reentrant=False,
                                                      preserve_rng_state=False)
            else:
                x = self._stage(i, x, wlat, nz)
            if self.skip_rgb:
                # accumulate in f32: many small bf16 adds would lose the low bits
                y = self.rgb[i](x, self.w_at(wlat, self.li_rgb(i)), demodulate=False).float()
                rgb = y if rgb is None else upsample_nearest(rgb, 2) + y
        if self.skip_rgb:
            return torch.tanh(rgb).to(cd)
        y = self.rgb(x, self.w_at(wlat, self.num_ws - 1), demodulate=False)
        return torch.tanh(y.float()).to(cd)

    def forward(self, z: torch.Tensor, labels: Optional[torch.Tensor] = None,
                noise=None) -> torch.Tensor:
        return self.synthesis(self.mapping_forward(z, labels), noise, dtype=z.dtype)

    def apply_mixed(self, z1: torch.Tensor, z2: torch.Tensor, cut: torch.Tensor,
                    labels: Optional[torch.Tensor] = None, noise=None) -> torch.Tensor:
        """The style-mixing forward: layer l takes w(z1) where l < cut (a
        sample), else w(z2); cut == num_ws is z1 alone."""
        w1 = self.mapping_forward(z1, labels)
        w2 = self.mapping_forward(z2, labels)
        take1 = (torch.arange(self.num_ws, device=cut.device)[None, :] < cut[:, None])[..., None]
        ws = torch.where(take1, w1[:, None, :], w2[:, None, :])
        return self.synthesis(ws, noise, dtype=z1.dtype)


def w_average(model: StyleGenerator, gen: Optional[torch.Generator] = None, n: int = 4096,
              z: Optional[torch.Tensor] = None,
              labels: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The mapping's mean w over `n` latents drawn from `gen` (or over `z`
    and `labels` as given), the truncation centre (f32, (w_dim,))."""
    cfg = model.config
    if z is None:
        z = torch.randn((n, cfg.latent_dim), generator=gen, device=gen.device)
        if cfg.num_classes:
            labels = torch.randint(0, cfg.num_classes, (n,), generator=gen, device=gen.device)
    return model.mapping_forward(z, labels).mean(dim=0)


def apply_truncated(model: StyleGenerator, z: torch.Tensor,
                    labels: Optional[torch.Tensor] = None, *, psi: float = 0.7,
                    w_avg: Optional[torch.Tensor] = None,
                    gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """W-space truncation: w' = w_avg + psi (w - w_avg) through synthesis.
    `w_avg` as given, else estimated from `gen`'s draws (`w_average`)."""
    if w_avg is None:
        if gen is None:
            raise ValueError("apply_truncated needs w_avg or a generator")
        w_avg = w_average(model, gen)
    wlat = model.mapping_forward(z, labels)
    return model.synthesis(w_avg + psi * (wlat - w_avg), dtype=z.dtype)
