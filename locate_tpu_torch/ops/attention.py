"""LocAtE location-based attention, counterpart of `locate_tpu/ops/attention.py`.

    pos   = sinusoidal coordinate features, shape (H, W, P)   [static]
    h     = act(W1 @ concat(x, pos))            # bottleneck 1x1 conv
    a     = W2 @ h                              # gate logits, zero-init
    gate  = softmax_{H,W}(a) * H*W | sigmoid(a) * 2
    y     = x * min(gate, gate_max)

`LocateAttention` keeps both apply paths of the JAX layer and its
dispatch between them. The composed path concatenates the position
features in the compute dtype and runs two 1x1 convs; the fused path
precomputes `pos_proj` in f32 from the W1[C:] slice and calls
`ops/fused_attention.py`, whose CUDA kernels serve CUDA tensors. In bf16
the two round differently, so each is held against its own JAX
counterpart.
"""

from __future__ import annotations

import functools
import warnings
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from locate_tpu_torch.config import AttentionConfig
from locate_tpu_torch.ops import gate_profile, initializers
from locate_tpu_torch.ops.activations import act_fn
from locate_tpu_torch.ops.conv import Conv2d
from locate_tpu_torch.ops.fused_attention import fused_locate_attention
from locate_tpu_torch.parallel.tp import whole

@functools.lru_cache(maxsize=64)
def _coord_features_np(height: int, width: int, features: int) -> np.ndarray:
    """Sinusoidal coordinate embedding, shape (H, W, features): half the
    channels encode y, half x; within each half, sin/cos pairs at octave
    frequencies of the normalized coordinate in [-1, 1]."""
    assert features % 4 == 0, "pos_features must be a multiple of 4"
    per_axis = features // 2
    n_freq = per_axis // 2
    ys = np.linspace(-1.0, 1.0, height, dtype=np.float32)
    xs = np.linspace(-1.0, 1.0, width, dtype=np.float32)
    freqs = (np.pi * 2.0 ** np.arange(n_freq, dtype=np.float32))[None, :]
    y_feat = np.concatenate(
        [np.sin(ys[:, None] * freqs), np.cos(ys[:, None] * freqs)], axis=-1
    )  # (H, per_axis)
    x_feat = np.concatenate(
        [np.sin(xs[:, None] * freqs), np.cos(xs[:, None] * freqs)], axis=-1
    )  # (W, per_axis)
    out = np.concatenate(
        [
            np.broadcast_to(y_feat[:, None, :], (height, width, per_axis)),
            np.broadcast_to(x_feat[None, :, :], (height, width, per_axis)),
        ],
        axis=-1,
    )
    return np.ascontiguousarray(out)


def coord_features(height: int, width: int, features: int,
                   dtype: torch.dtype = torch.float32,
                   device: Optional[torch.device] = None) -> torch.Tensor:
    return torch.from_numpy(_coord_features_np(height, width, features)).to(
        device=device, dtype=dtype)


def locate_gate(x: torch.Tensor, logits: torch.Tensor, mode: str, residual: bool,
                gate_max: float = 0.0) -> torch.Tensor:
    """Modulate `x` (N,H,W,C) by the gate computed from `logits`
    (N,H,W,C or N,H,W,1); softmax and gate in f32."""
    n, h, w, _ = logits.shape
    lf = logits.float()
    if mode == "softmax":
        gate = torch.softmax(lf.reshape(n, h * w, lf.shape[-1]), dim=1).reshape(lf.shape)
        if residual:
            gate = gate * (h * w)
    elif mode == "sigmoid":
        gate = torch.sigmoid(lf)
        if residual:
            gate = gate * 2.0
    else:
        raise ValueError(f"unknown attention mode {mode!r}")
    if gate_max > 0.0:
        gate = gate.clamp(max=gate_max)
    return (x.float() * gate).to(x.dtype)


class LocateAttention(nn.Module):
    """Location-based attention block for NHWC feature maps of `channels`.
    Params `to_hidden.{w,b}` and `to_logits.{w,b}` (1x1 convs, OIHW)."""

    def __init__(self, channels: int, cfg: AttentionConfig, act: str = "leaky_relu",
                 leaky_slope: float = 0.2, compute_dtype: Optional[torch.dtype] = None,
                 use_pallas: bool = False, gen: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.act = act
        self.leaky_slope = leaky_slope
        self.compute_dtype = compute_dtype
        hidden = max(8, channels // cfg.bottleneck)
        out_ch = channels if cfg.per_channel else 1
        self.to_hidden = Conv2d(channels + cfg.pos_features, hidden, (1, 1),
                                compute_dtype=compute_dtype, gen=gen)
        # zero-init logits: the block is the identity at init
        self.to_logits = Conv2d(hidden, out_ch, (1, 1), weight_init=initializers.zeros,
                                compute_dtype=compute_dtype, gen=gen)
        self.activation = act_fn(act, leaky_slope)
        self.use_fused = use_pallas and cfg.residual
        if use_pallas and not cfg.residual:
            warnings.warn(
                "use_pallas requested but attention.residual=False: the fused "
                "kernels only implement the residual form; running the "
                "composed path", stacklevel=2)
        self._pos: Dict[Tuple, torch.Tensor] = {}

    def _coords(self, h: int, w: int, dtype: torch.dtype, device) -> torch.Tensor:
        """Coordinate features, cached per shape so a forward uploads none
        (made outside inference mode, so autograd may use them later).
        While `torch.export` traces, they are made anew and the trace keeps
        them as constants: the tracer's tensors never enter the cache."""
        if torch.compiler.is_compiling():
            return coord_features(h, w, self.cfg.pos_features, dtype, device)
        key = (h, w, dtype, str(device))
        if key not in self._pos:
            with torch.inference_mode(False):
                self._pos[key] = coord_features(h, w, self.cfg.pos_features, dtype, device)
        return self._pos[key]

    def fused_profitable(self, hw: int) -> bool:
        """The JAX layer's dispatch (`fused_profitable`) on the card's
        profile: the softmax gate always runs fused, the sigmoid gate where
        one of `gate_profile.sigmoid_ranges()` holds H*W."""
        return self.cfg.mode == "softmax" or gate_profile.sigmoid_fused(hw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, h, w, _ = x.shape
        if self.use_fused and self.fused_profitable(h * w):
            return self.forward_fused(x)
        return self.forward_composed(x)

    def forward_composed(self, x: torch.Tensor) -> torch.Tensor:
        """Counterpart of the JAX layer's `apply_xla`."""
        n, h, w, _ = x.shape
        cd = self.compute_dtype or x.dtype
        feats = x.to(cd)
        p = self.cfg.pos_features
        if p:
            pos = self._coords(h, w, cd, x.device)
            feats = torch.cat([feats, pos[None].expand(n, h, w, p)], dim=-1)
        hdn = self.activation(self.to_hidden(feats))
        logits = self.to_logits(hdn)
        return locate_gate(x, logits, self.cfg.mode, self.cfg.residual,
                           self.cfg.gate_max)

    def gate_operands(self, h: int, w: int, channels: int, device):
        """(pos_proj, w1x, b1, w2, b2) of the fused gate on an h x w map of
        `channels`: pos_proj precomputed in f32 from the W1[C:] slice, or
        None without position features."""
        # the kernels read whole weights: a model-split one is gathered
        w1 = whole(self.to_hidden.w)[:, :, 0, 0].t()   # (C+P, Hd)
        w1x, w1p = w1[:channels], w1[channels:]
        w2 = whole(self.to_logits.w)[:, :, 0, 0].t()   # (Hd, Cout)
        p = self.cfg.pos_features
        pos_proj = None
        if p:
            pos = self._coords(h, w, torch.float32, device)
            pos_proj = pos.reshape(h * w, p) @ w1p.float()
        return pos_proj, w1x, self.to_hidden.b, w2, self.to_logits.b

    def fused_operands(self, x: torch.Tensor):
        """(x in the compute dtype, pos_proj, w1x, b1, w2, b2): the fused
        gate's operands (`gate_operands`, zeros for a missing pos_proj)."""
        n, h, w, c = x.shape
        cd = self.compute_dtype or x.dtype
        pos_proj, w1x, b1, w2, b2 = self.gate_operands(h, w, c, x.device)
        if pos_proj is None:
            pos_proj = torch.zeros((h * w, w1x.shape[1]), dtype=torch.float32,
                                   device=x.device)
        return x.to(cd), pos_proj, w1x, b1, w2, b2

    def forward_fused(self, x: torch.Tensor) -> torch.Tensor:
        """Counterpart of the JAX layer's `apply_pallas`."""
        return fused_locate_attention(
            *self.fused_operands(x), mode=self.cfg.mode, act=self.act,
            leaky_slope=self.leaky_slope, gate_max=self.cfg.gate_max)
