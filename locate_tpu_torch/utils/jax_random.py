"""JAX's `PRNGKey`, `fold_in`, `split`, `normal` (f32) and `randint`
(int32) in numpy.

The JAX package bakes two fixed random constants into the model's
function: the style family's const noise planes
(`locate_tpu/models/style_generator.py:_const_noise_plane`) and spectral
norm's start vector (`locate_tpu/ops/spectral.py:spectral_sigma`). A JAX
checkpoint computes the same images and logits in the port only if the
port reproduces those draws, so this module reimplements JAX's default
PRNG: threefry2x32 (20 rounds) with the counters of a 64-bit iota split
into (hi, lo) words, the "partitionable" layout that is JAX's default
(`jax_threefry_partitionable=True`), the uniform from the mantissa bits,
and XLA's single-precision erfinv (Giles' polynomial). The keys, bits and
uniforms are JAX's bit for bit; the normals too at the model's shapes,
and within 2 f32 ulps at a million draws, where about 2 in 100,000
differ (XLA CPU's f32 log rounds 0.04 % of its inputs one ulp apart from
`_log_f32`). It is used for those constants and for the evaluation's
draws (`io/fid.py`: the random-conv extractor's weights and the fake
latents; `io/swd.py`: patch positions and projection directions), so a
checkpoint scores the same in both packages; the port's training draws
come from `torch.Generator`s.

A key is a numpy uint32 array of shape (2,).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray):
    """The threefry2x32 block cipher of `key` on the counter words
    (x0, x1), elementwise; returns the two output words."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def prng_key(seed: int) -> np.ndarray:
    """`jax.random.PRNGKey(seed)`: the seed's high and low 32-bit words."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.array([seed >> 32, seed & 0xFFFFFFFF], np.uint32)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """`jax.random.fold_in(key, data)`: threefry of the counter (0, data)."""
    y0, y1 = threefry2x32(key, np.zeros(1, np.uint32),
                          np.array([int(data) & 0xFFFFFFFF], np.uint32))
    return np.array([y0[0], y1[0]], np.uint32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """`jax.random.split(key, num)`: (num, 2) keys, row i the threefry of
    the counter (hi(i), lo(i)), which is `fold_in(key, i)` for i < 2**32."""
    iota = np.arange(int(num), dtype=np.uint64)
    y0, y1 = threefry2x32(key, (iota >> np.uint64(32)).astype(np.uint32),
                          (iota & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    return np.stack([y0, y1], axis=1)


def random_bits(key: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """`jax.random.bits(key, shape, uint32)`: threefry of the iota's (hi,
    lo) words, the two output words xor'ed."""
    count = int(np.prod(shape, dtype=np.int64))
    iota = np.arange(count, dtype=np.uint64)
    hi = (iota >> np.uint64(32)).astype(np.uint32)
    lo = (iota & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    b0, b1 = threefry2x32(key, hi, lo)
    return (b0 ^ b1).reshape(tuple(shape))


def uniform(key: np.ndarray, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> np.ndarray:
    """`jax.random.uniform(key, shape, float32, minval, maxval)`."""
    bits = random_bits(key, shape)
    one = np.float32(1.0)
    floats = ((bits >> np.uint32(32 - 23)) | one.view(np.uint32)).view(np.float32) - one
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, floats * (hi - lo) + lo)


_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                 0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                 0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)
# XLA's log1p for |x| < sqrt(2) - 1: the Cephes rational, numerator and
# denominator highest power first
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)
# XLA CPU's f32 log (Cephes' polynomial as Eigen's plog evaluates it)
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
          1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
          3.3333331174e-1)

_F32 = np.float32


def _fma(a, b, c) -> np.ndarray:
    """a * b + c rounded once to f32 (the product of two f32 is exact in
    f64), as the compiled kernels' fused multiply-adds."""
    f64 = np.float64
    return (np.asarray(a, _F32).astype(f64) * np.asarray(b, _F32).astype(f64)
            + np.asarray(c, _F32).astype(f64)).astype(_F32)


def _horner(coeffs, x: np.ndarray) -> np.ndarray:
    r = np.full_like(x, _F32(coeffs[0]))
    for c in coeffs[1:]:
        r = _fma(r, x, _F32(c))
    return r


def _log_f32(v: np.ndarray) -> np.ndarray:
    """XLA CPU's f32 log of positive `v`."""
    m, e = np.frexp(np.maximum(v, _F32(1.17549435e-38)))
    m, e = m.astype(_F32), e.astype(_F32)
    low = m < _F32(0.707106781186547524)
    x = (m - _F32(1)) + np.where(low, m, _F32(0))
    e = e - np.where(low, _F32(1), _F32(0))
    x2 = x * x
    x3 = x2 * x
    p = _LOG_P
    y = _fma(_fma(p[0], x, p[1]), x, p[2])
    y1 = _fma(_fma(p[3], x, p[4]), x, p[5])
    y2 = _fma(_fma(p[6], x, p[7]), x, p[8])
    y = _fma(_fma(y, x3, y1), x3, y2) * x3
    y = y + e * _F32(-2.12194440e-4)
    x = (x - x2 * _F32(0.5)) + y
    return (x + e * _F32(0.693359375)).astype(_F32)


def _log1p_f32(x: np.ndarray) -> np.ndarray:
    """XLA's f32 log1p: a rational for |x| < sqrt(2) - 1, log(1 + x) above."""
    x2 = x * x
    small = x + (_F32(-0.5) * x2 + (x * x2) * (_horner(_LOG1P_NUM, x) / _horner(_LOG1P_DEN, x)))
    large = _log_f32((_F32(1) + x).astype(_F32))
    return np.where(np.abs(x) < _F32(0.41421356237309504880), small, large).astype(_F32)


def erfinv_f32(x: np.ndarray) -> np.ndarray:
    """XLA's f32 erfinv (`ErfInv32`, Giles' single-precision polynomial),
    evaluated in f32 in XLA's order, with its fused multiply-adds."""
    x = np.asarray(x, _F32)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        w = -_log1p_f32(-x * x)
        small = w < _F32(5.0)
        w = np.where(small, w - _F32(2.5), np.sqrt(w) - _F32(3.0))
        p = np.where(small, _F32(_ERFINV_SMALL[0]), _F32(_ERFINV_LARGE[0]))
        for a, b in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
            p = _fma(p, w, np.where(small, _F32(a), _F32(b)))
        out = p * x
    return np.where(np.abs(x) == 1, x * np.finfo(_F32).max, out).astype(_F32)


def normal(key: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """`jax.random.normal(key, shape, float32)`: sqrt(2) erfinv(u), u
    uniform over (-1, 1)."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(key, shape, lo, 1.0)
    return (np.float32(np.sqrt(2)) * erfinv_f32(u)).astype(np.float32)


def randint(key: np.ndarray, shape: Sequence[int], minval: int, maxval: int) -> np.ndarray:
    """`jax.random.randint(key, shape, minval, maxval)` (int32, scalar
    bounds inside int32's range): two sets of bits from `split(key)`,
    combined modulo the span as (hi mod span) * (2**32 mod span) + lo
    mod span, in uint32 arithmetic; minval where maxval <= minval."""
    lo_i, hi_i = int(minval), int(maxval)
    if not (-2**31 <= lo_i < 2**31 and -2**31 <= hi_i < 2**31):
        raise ValueError(f"randint bounds ({minval}, {maxval}) outside int32")
    k1, k2 = split(key)
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    span = np.uint32(1 if hi_i <= lo_i else (hi_i - lo_i) & 0xFFFFFFFF)
    with np.errstate(over="ignore"):
        mult = np.uint32(2 ** 16) % span
        mult = (mult * mult) % span
        offset = ((higher % span) * mult + lower % span) % span
        return (np.int32(lo_i) + offset.astype(np.int32)).astype(np.int32)
