"""InceptionV3's pool3 graph, the standard FID extractor, counterpart of
`locate_tpu/io/inception.py`.

The graph is torchvision's `inception_v3` up to its 2048-d global average
pool, inference only, as an `nn.Module` of plain convolutions and pools
(no kernel of the JAX package's Pallas family lies on it). It reads the
`.npz` that `scripts/convert_inception.py` writes (`FORMAT`): for every
BasicConv2d path P in torchvision's naming, `{P}.w`, an HWIO kernel with
BatchNorm's scale folded into its output channels, and `{P}.b`, the
folded bias; `input_mean` / `input_std`, applied after uint8 -> [0, 1];
`variant`; and optionally the classifier head `fc.w` (2048, n_classes) /
`fc.b`, for the Inception Score.

Variants: "torchvision" pools as torchvision does; "fid" is
pytorch-fid's patched graph (the pt_inception weights): its branch
average pools leave the padding out of the count, and Mixed_7c's branch
pool is a 3x3 / 1 max pool.

The FID protocol (pytorch-fid's): uint8 RGB -> [0, 1] -> bilinear resize
to 299x299 with half-pixel centres and no antialias -> normalize -> the
graph -> pool3. `InceptionExtractor` runs it in f32 with TF32 off.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from locate_tpu_torch.device import resolve_device

FORMAT = "locate-tpu-inception-v3/v1"


# ---------------------------------------------------------------------------
# architecture spec: every BasicConv2d as (path, cin, cout, (kh, kw),
# (sh, sw), (ph, pw)) in torchvision's module naming and order
# ---------------------------------------------------------------------------


def _spec_a(prefix: str, cin: int, pool: int) -> List[tuple]:
    return [
        (f"{prefix}.branch1x1", cin, 64, (1, 1), (1, 1), (0, 0)),
        (f"{prefix}.branch5x5_1", cin, 48, (1, 1), (1, 1), (0, 0)),
        (f"{prefix}.branch5x5_2", 48, 64, (5, 5), (1, 1), (2, 2)),
        (f"{prefix}.branch3x3dbl_1", cin, 64, (1, 1), (1, 1), (0, 0)),
        (f"{prefix}.branch3x3dbl_2", 64, 96, (3, 3), (1, 1), (1, 1)),
        (f"{prefix}.branch3x3dbl_3", 96, 96, (3, 3), (1, 1), (1, 1)),
        (f"{prefix}.branch_pool", cin, pool, (1, 1), (1, 1), (0, 0)),
    ]


def _spec_b(prefix: str, cin: int) -> List[tuple]:
    return [
        (f"{prefix}.branch3x3", cin, 384, (3, 3), (2, 2), (0, 0)),
        (f"{prefix}.branch3x3dbl_1", cin, 64, (1, 1), (1, 1), (0, 0)),
        (f"{prefix}.branch3x3dbl_2", 64, 96, (3, 3), (1, 1), (1, 1)),
        (f"{prefix}.branch3x3dbl_3", 96, 96, (3, 3), (2, 2), (0, 0)),
    ]


def _spec_c(prefix: str, cin: int, c7: int) -> List[tuple]:
    return [
        (f"{prefix}.branch1x1", cin, 192, (1, 1), (1, 1), (0, 0)),
        (f"{prefix}.branch7x7_1", cin, c7, (1, 1), (1, 1), (0, 0)),
        (f"{prefix}.branch7x7_2", c7, c7, (1, 7), (1, 1), (0, 3)),
        (f"{prefix}.branch7x7_3", c7, 192, (7, 1), (1, 1), (3, 0)),
        (f"{prefix}.branch7x7dbl_1", cin, c7, (1, 1), (1, 1), (0, 0)),
        (f"{prefix}.branch7x7dbl_2", c7, c7, (7, 1), (1, 1), (3, 0)),
        (f"{prefix}.branch7x7dbl_3", c7, c7, (1, 7), (1, 1), (0, 3)),
        (f"{prefix}.branch7x7dbl_4", c7, c7, (7, 1), (1, 1), (3, 0)),
        (f"{prefix}.branch7x7dbl_5", c7, 192, (1, 7), (1, 1), (0, 3)),
        (f"{prefix}.branch_pool", cin, 192, (1, 1), (1, 1), (0, 0)),
    ]


def _spec_d(prefix: str, cin: int) -> List[tuple]:
    return [
        (f"{prefix}.branch3x3_1", cin, 192, (1, 1), (1, 1), (0, 0)),
        (f"{prefix}.branch3x3_2", 192, 320, (3, 3), (2, 2), (0, 0)),
        (f"{prefix}.branch7x7x3_1", cin, 192, (1, 1), (1, 1), (0, 0)),
        (f"{prefix}.branch7x7x3_2", 192, 192, (1, 7), (1, 1), (0, 3)),
        (f"{prefix}.branch7x7x3_3", 192, 192, (7, 1), (1, 1), (3, 0)),
        (f"{prefix}.branch7x7x3_4", 192, 192, (3, 3), (2, 2), (0, 0)),
    ]


def _spec_e(prefix: str, cin: int) -> List[tuple]:
    return [
        (f"{prefix}.branch1x1", cin, 320, (1, 1), (1, 1), (0, 0)),
        (f"{prefix}.branch3x3_1", cin, 384, (1, 1), (1, 1), (0, 0)),
        (f"{prefix}.branch3x3_2a", 384, 384, (1, 3), (1, 1), (0, 1)),
        (f"{prefix}.branch3x3_2b", 384, 384, (3, 1), (1, 1), (1, 0)),
        (f"{prefix}.branch3x3dbl_1", cin, 448, (1, 1), (1, 1), (0, 0)),
        (f"{prefix}.branch3x3dbl_2", 448, 384, (3, 3), (1, 1), (1, 1)),
        (f"{prefix}.branch3x3dbl_3a", 384, 384, (1, 3), (1, 1), (0, 1)),
        (f"{prefix}.branch3x3dbl_3b", 384, 384, (3, 1), (1, 1), (1, 0)),
        (f"{prefix}.branch_pool", cin, 192, (1, 1), (1, 1), (0, 0)),
    ]


def conv_specs() -> List[tuple]:
    """All BasicConv2d layers: (path, cin, cout, kernel, stride, padding)."""
    specs = [
        ("Conv2d_1a_3x3", 3, 32, (3, 3), (2, 2), (0, 0)),
        ("Conv2d_2a_3x3", 32, 32, (3, 3), (1, 1), (0, 0)),
        ("Conv2d_2b_3x3", 32, 64, (3, 3), (1, 1), (1, 1)),
        ("Conv2d_3b_1x1", 64, 80, (1, 1), (1, 1), (0, 0)),
        ("Conv2d_4a_3x3", 80, 192, (3, 3), (1, 1), (0, 0)),
    ]
    specs += _spec_a("Mixed_5b", 192, 32)
    specs += _spec_a("Mixed_5c", 256, 64)
    specs += _spec_a("Mixed_5d", 288, 64)
    specs += _spec_b("Mixed_6a", 288)
    specs += _spec_c("Mixed_6b", 768, 128)
    specs += _spec_c("Mixed_6c", 768, 160)
    specs += _spec_c("Mixed_6d", 768, 160)
    specs += _spec_c("Mixed_6e", 768, 192)
    specs += _spec_d("Mixed_7a", 768)
    specs += _spec_e("Mixed_7b", 1280)
    specs += _spec_e("Mixed_7c", 2048)
    return specs


# ---------------------------------------------------------------------------
# the graph
# ---------------------------------------------------------------------------


class FoldedConv(nn.Conv2d):
    """BasicConv2d with its BatchNorm folded into (weight, bias): conv +
    bias + relu."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(super().forward(x))


class InceptionV3(nn.Module):
    """The pool3 graph's convolutions, as submodules named by their
    torchvision paths (`Mixed_5b.branch1x1`, ...); `pool3_features` runs
    them. `forward` is the graph of this module's `variant`."""

    def __init__(self, variant: str = "torchvision"):
        super().__init__()
        if variant not in ("torchvision", "fid"):
            raise ValueError(f"unknown inception variant {variant!r}")
        self.variant = variant
        for path, cin, cout, k, s, p in conv_specs():
            parent, _, name = path.rpartition(".")
            if parent and not hasattr(self, parent):
                self.add_module(parent, nn.Module())
            owner = self.get_submodule(parent) if parent else self
            owner.add_module(name, FoldedConv(cin, cout, k, stride=s, padding=p))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return pool3_features(self, x, self.variant)


def _avg_pool3(x: torch.Tensor, include_pad: bool = True) -> torch.Tensor:
    """3x3 / 1 average pool, padding 1; torchvision counts the padding,
    pytorch-fid's patched blocks do not."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=include_pad)


def _max_pool3s1p1(x: torch.Tensor) -> torch.Tensor:
    """pytorch-fid's Mixed_7c branch pool."""
    return F.max_pool2d(x, 3, stride=1, padding=1)


def _max_pool3s2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, stride=2)


def _mixed_a(block: nn.Module, x: torch.Tensor, pool_fn) -> torch.Tensor:
    b1 = block.branch1x1(x)
    b5 = block.branch5x5_2(block.branch5x5_1(x))
    b3 = block.branch3x3dbl_3(block.branch3x3dbl_2(block.branch3x3dbl_1(x)))
    return torch.cat([b1, b5, b3, block.branch_pool(pool_fn(x))], dim=1)


def _mixed_b(block: nn.Module, x: torch.Tensor) -> torch.Tensor:
    d = block.branch3x3dbl_3(block.branch3x3dbl_2(block.branch3x3dbl_1(x)))
    return torch.cat([block.branch3x3(x), d, _max_pool3s2(x)], dim=1)


def _mixed_c(block: nn.Module, x: torch.Tensor, pool_fn) -> torch.Tensor:
    b1 = block.branch1x1(x)
    b7 = block.branch7x7_3(block.branch7x7_2(block.branch7x7_1(x)))
    d = block.branch7x7dbl_1(x)
    for name in ("branch7x7dbl_2", "branch7x7dbl_3", "branch7x7dbl_4", "branch7x7dbl_5"):
        d = getattr(block, name)(d)
    return torch.cat([b1, b7, d, block.branch_pool(pool_fn(x))], dim=1)


def _mixed_d(block: nn.Module, x: torch.Tensor) -> torch.Tensor:
    b3 = block.branch3x3_2(block.branch3x3_1(x))
    d = block.branch7x7x3_1(x)
    for name in ("branch7x7x3_2", "branch7x7x3_3", "branch7x7x3_4"):
        d = getattr(block, name)(d)
    return torch.cat([b3, d, _max_pool3s2(x)], dim=1)


def _mixed_e(block: nn.Module, x: torch.Tensor, pool_fn) -> torch.Tensor:
    b1 = block.branch1x1(x)
    b3 = block.branch3x3_1(x)
    b3 = torch.cat([block.branch3x3_2a(b3), block.branch3x3_2b(b3)], dim=1)
    d = block.branch3x3dbl_2(block.branch3x3dbl_1(x))
    d = torch.cat([block.branch3x3dbl_3a(d), block.branch3x3dbl_3b(d)], dim=1)
    return torch.cat([b1, b3, d, block.branch_pool(pool_fn(x))], dim=1)


def pool3_features(net: InceptionV3, x: torch.Tensor,
                   variant: str = "torchvision") -> torch.Tensor:
    """NCHW float input (normalized, 299x299x3) -> (N, 2048) pool3, with
    `variant`'s pooling ("torchvision" or "fid")."""
    if variant not in ("torchvision", "fid"):
        raise ValueError(f"unknown inception variant {variant!r}")
    fid = variant == "fid"
    avg = (lambda v: _avg_pool3(v, include_pad=False)) if fid else _avg_pool3
    pool_7c = _max_pool3s1p1 if fid else avg
    x = net.Conv2d_1a_3x3(x)
    x = net.Conv2d_2a_3x3(x)
    x = net.Conv2d_2b_3x3(x)
    x = _max_pool3s2(x)
    x = net.Conv2d_3b_1x1(x)
    x = net.Conv2d_4a_3x3(x)
    x = _max_pool3s2(x)
    for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d"):
        x = _mixed_a(getattr(net, name), x, avg)
    x = _mixed_b(net.Mixed_6a, x)
    for name in ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
        x = _mixed_c(getattr(net, name), x, avg)
    x = _mixed_d(net.Mixed_7a, x)
    x = _mixed_e(net.Mixed_7b, x, avg)
    x = _mixed_e(net.Mixed_7c, x, pool_7c)
    return x.mean(dim=(2, 3))  # adaptive average pool -> 2048


def logits_from_pool3(fc: Tuple, feats) -> torch.Tensor:
    """pool3 features (N, 2048) -> class logits (N, n_classes) through the
    archive's classifier head `fc` = (w (2048, n_classes), b)."""
    w, b = (torch.as_tensor(np.asarray(a, np.float32)) for a in fc)
    feats = torch.as_tensor(feats, dtype=torch.float32)
    return feats @ w.to(feats.device) + b.to(feats.device)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def load_npz(path: str, device=None):
    """A converted .npz -> (net on `device`, input_mean, input_std,
    variant, fc or None); the HWIO kernels become OIHW."""
    device = resolve_device(device)
    data = np.load(path)
    fmt = str(data["format"]) if "format" in data.files else ""
    if fmt != FORMAT:
        raise ValueError(
            f"{path!r} is not a {FORMAT} archive (format={fmt!r}); "
            f"produce one with scripts/convert_inception.py"
        )
    variant = str(data["variant"]) if "variant" in data.files else "torchvision"
    net = InceptionV3(variant)
    state = {}
    for p, *_ in conv_specs():
        state[f"{p}.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.asarray(data[f"{p}.w"], np.float32).transpose(3, 2, 0, 1)))
        state[f"{p}.bias"] = torch.from_numpy(np.asarray(data[f"{p}.b"], np.float32))
    net.load_state_dict(state)
    fc = ((np.asarray(data["fc.w"], np.float32), np.asarray(data["fc.b"], np.float32))
          if "fc.w" in data.files else None)
    mean = np.asarray(data["input_mean"], np.float32)
    std = np.asarray(data["input_std"], np.float32)
    return net.to(device).eval(), mean, std, variant, fc


def random_archive(path: str, seed: int = 0, variant: str = "fid",
                   fc_classes: int = 0) -> str:
    """An archive of `FORMAT` with random folded weights from numpy's
    `default_rng(seed)` at the graph's exact shapes (the real weights are
    converted elsewhere by scripts/convert_inception.py): kernels
    N(0, 1) * sqrt(2 / fan_in) (He's scale, so activations stay of order
    one through the graph), biases N(0, 1) * 0.1, pytorch-fid's input
    normalization; `fc_classes` > 0 adds a classifier head."""
    rng = np.random.default_rng(seed)
    arrays = {"format": np.asarray(FORMAT), "variant": np.asarray(variant),
              "input_mean": np.full(3, 0.5, np.float32),
              "input_std": np.full(3, 0.5, np.float32)}
    for p, cin, cout, k, _, _ in conv_specs():
        fan_in = k[0] * k[1] * cin
        arrays[f"{p}.w"] = (rng.standard_normal((k[0], k[1], cin, cout), np.float32)
                            * np.float32(np.sqrt(2.0 / fan_in)))
        arrays[f"{p}.b"] = rng.standard_normal(cout, np.float32) * np.float32(0.1)
    if fc_classes:
        arrays["fc.w"] = rng.standard_normal((2048, fc_classes), np.float32) / np.float32(45)
        arrays["fc.b"] = rng.standard_normal(fc_classes, np.float32) * np.float32(0.1)
    np.savez(path, **arrays)
    return path


# ---------------------------------------------------------------------------
# the FID-protocol extractor
# ---------------------------------------------------------------------------


def preprocess(images_u8, mean: np.ndarray, std: np.ndarray, size: int = 299,
               device=None) -> torch.Tensor:
    """uint8 NHWC -> [0, 1] -> bilinear resize to size^2 (half-pixel
    centres, no antialias: pytorch-fid's F.interpolate) -> (x - mean) /
    std, as NCHW f32 on `device` (the images' own if they are a tensor)."""
    from locate_tpu_torch.io.fid import images_nchw

    if device is None:
        device = images_u8.device if isinstance(images_u8, torch.Tensor) else "cpu"
    x = images_nchw(images_u8, torch.device(device)) / 255.0
    if tuple(x.shape[2:]) != (size, size):
        x = F.interpolate(x, size=(size, size), mode="bilinear", align_corners=False,
                          antialias=False)
    m = torch.as_tensor(np.asarray(mean, np.float32), device=x.device).reshape(1, 3, 1, 1)
    s = torch.as_tensor(np.asarray(std, np.float32), device=x.device).reshape(1, 3, 1, 1)
    return (x - m) / s


class InceptionExtractor:
    """FID features: uint8 NHWC -> (N, 2048) pool3, f32 numpy, on
    `device` in f32 with TF32 off. Grayscale images are repeated to RGB.
    `fc` is the archive's classifier head as numpy (w, b), or None."""

    def __init__(self, path: str, device=None):
        self.path = path
        self.device = resolve_device(device)
        self.net, self.mean, self.std, self.variant, self.fc = load_npz(path, self.device)

    @property
    def cache_token(self) -> str:
        return f"inception_v3:{self.path}"

    def __call__(self, images_u8) -> np.ndarray:
        from locate_tpu_torch.io.fid import exact_f32

        if images_u8.shape[-1] == 1:
            images_u8 = (images_u8.repeat(1, 1, 1, 3) if isinstance(images_u8, torch.Tensor)
                         else np.repeat(images_u8, 3, axis=-1))
        with torch.inference_mode(), exact_f32():
            x = preprocess(images_u8, self.mean, self.std, device=self.device)
            return self.net(x).cpu().numpy().astype(np.float32, copy=False)

