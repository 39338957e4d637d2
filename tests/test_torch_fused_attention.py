"""The port's plain location-attention gate (what a CPU tensor runs, and
what the CUDA kernels are held against on the card) against the JAX
package: its Pallas kernels in interpret mode and its XLA composition.
float32, tolerance 2e-5 as in tests/test_pallas_attention.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from locate_tpu.ops.pallas import fused_attention as jfa
from locate_tpu_torch.ops import fused_attention as tfa

TOL = dict(rtol=2e-5, atol=2e-5)


def make_inputs(n=2, h=8, w=8, c=16, hd=8, cout=16, pos=True, seed=0):
    """Gate weights large enough that the mean-1 softmax gate passes 16."""
    rng = np.random.default_rng(seed)

    def r(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    x = r(n, h, w, c)
    pos_proj = r(h * w, hd, scale=0.5) if pos else np.zeros((h * w, hd), np.float32)
    return x, pos_proj, r(c, hd, scale=0.5), r(hd, scale=0.1), r(hd, cout, scale=1.5), r(cout, scale=0.1)


def to_torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


def clamp_hit(x, pos_proj, w1x, b1, w2, b2, act):
    n, h, w, c = x.shape
    l = tfa.gate_logits_reference(*to_torch((x.reshape(n, h * w, c), pos_proj, w1x, b1, w2, b2)),
                                  act=act, leaky_slope=0.2)
    return bool((torch.softmax(l, dim=1) * (h * w) > 16.0).any())


@pytest.mark.parametrize("pos_features", [0, 4])
@pytest.mark.parametrize("per_channel", [True, False])
@pytest.mark.parametrize("gate_max", [0.0, 16.0])
@pytest.mark.parametrize("act", ["leaky_relu", "relu", "silu", "gelu"])
def test_plain_matches_jax(act, gate_max, per_channel, pos_features):
    arrays = make_inputs(cout=16 if per_channel else 1, pos=bool(pos_features))
    x, pos_proj, w1x, b1, w2, b2 = arrays
    assert clamp_hit(*arrays, act)
    n, h, w, c = x.shape
    kw = dict(act=act, leaky_slope=0.2, gate_max=gate_max)
    got = tfa.fused_locate_attention(*to_torch(arrays), mode="softmax", **kw).numpy()
    xla = jfa.locate_attention_xla_core(
        jnp.asarray(x.reshape(n, h * w, c)), *map(jnp.asarray, arrays[1:]),
        mode="softmax", hw_scale=float(h * w), **kw)
    np.testing.assert_allclose(got, np.asarray(xla).reshape(x.shape), **TOL)
    if gate_max:
        # the Pallas kernels themselves (interpret mode), with the clamp on:
        # each interpret run costs about a second on the CPU
        pallas = jfa.fused_locate_attention(*map(jnp.asarray, arrays), mode="softmax",
                                            interpret=True, **kw)
        np.testing.assert_allclose(got, np.asarray(pallas), **TOL)


@pytest.mark.parametrize("hw_side", [4, 32])
def test_stats_and_apply_match_pallas(hw_side):
    """The two passes one by one against `softmax_gate_stats` and the
    forward's apply pass, with several spatial tiles at 32x32."""
    arrays = make_inputs(h=hw_side, w=hw_side, c=8, hd=8, cout=8, seed=3)
    x, pos_proj, w1x, b1, w2, b2 = arrays
    n, h, w, c = x.shape
    x2d = x.reshape(n, h * w, c)
    jm, jse = jfa.softmax_gate_stats(jnp.asarray(x2d), *map(jnp.asarray, arrays[1:]),
                                     act="leaky_relu", leaky_slope=0.2, interpret=True)
    ops = to_torch((x2d, pos_proj, w1x, b1, w2, b2))
    m, se = tfa.softmax_gate_stats(*ops, act="leaky_relu", leaky_slope=0.2)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), **TOL)
    np.testing.assert_allclose(se.numpy(), np.asarray(jse), rtol=1e-4)
    y = tfa.softmax_gate_apply(*ops, m, se, act="leaky_relu", leaky_slope=0.2,
                               hw_scale=float(h * w), gate_max=16.0)
    jy = jfa.fused_locate_attention(*map(jnp.asarray, arrays), mode="softmax",
                                    gate_max=16.0, interpret=True)
    np.testing.assert_allclose(y.numpy().reshape(x.shape), np.asarray(jy), **TOL)


def test_sigmoid_plain_matches_jax():
    arrays = make_inputs(seed=5)
    x = arrays[0]
    n, h, w, c = x.shape
    got = tfa.locate_attention_core_reference(
        torch.from_numpy(x.reshape(n, h * w, c)), *to_torch(arrays[1:]),
        mode="sigmoid", act="leaky_relu", leaky_slope=0.2, hw_scale=float(h * w),
        gate_max=1.5).numpy()
    want = jfa.locate_attention_xla_core(
        jnp.asarray(x.reshape(n, h * w, c)), *map(jnp.asarray, arrays[1:]),
        mode="sigmoid", act="leaky_relu", leaky_slope=0.2, hw_scale=float(h * w),
        gate_max=1.5)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_bf16_plain_matches_jax_composition():
    """bf16 on the CPU: both round h and y to bf16 at the same places;
    their f32 sums differ in order, so a few elements may round to the
    neighbouring bf16 value (2^-7 relative)."""
    arrays = make_inputs(seed=7)
    x = arrays[0]
    n, h, w, c = x.shape
    x2d = x.reshape(n, h * w, c)
    got = tfa.fused_locate_attention(
        torch.from_numpy(x).to(torch.bfloat16), *to_torch(arrays[1:]),
        gate_max=16.0).float().numpy().reshape(n, h * w, c)
    want = jfa.locate_attention_xla_core(
        jnp.asarray(x2d, jnp.bfloat16), *map(jnp.asarray, arrays[1:]), mode="softmax",
        act="leaky_relu", leaky_slope=0.2, hw_scale=float(h * w), gate_max=16.0)
    want = np.asarray(want.astype(jnp.float32))
    close = np.isclose(got, want, rtol=1e-2, atol=1e-2)
    assert close.mean() > 0.99, close.mean()


def test_cpu_wrappers_do_not_count_launches():
    arrays = to_torch(make_inputs(seed=9))
    before = (tfa.softmax_gate_stats.launches, tfa.softmax_gate_apply.launches)
    tfa.fused_locate_attention(*arrays, gate_max=16.0)
    n, h, w, c = arrays[0].shape
    tfa.softmax_gate_stats(arrays[0].reshape(n, h * w, c), *arrays[1:],
                           act="leaky_relu", leaky_slope=0.2)
    assert (tfa.softmax_gate_stats.launches, tfa.softmax_gate_apply.launches) == before
