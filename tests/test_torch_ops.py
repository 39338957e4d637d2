"""The port's ops against the JAX package's, in float32 on the CPU: the
same inputs (numpy, seeded) and the same weights (carried across by
`params_from_jax`). Tolerance 1e-5 absolute and relative, f32 rounding
of differently ordered sums."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from locate_tpu.config import AttentionConfig as JaxAttentionConfig
from locate_tpu.io.export import _flatten
from locate_tpu.ops import activations as jact
from locate_tpu.ops import attention as jatt
from locate_tpu.ops import conv as jconv
from locate_tpu.ops import norm as jnorm
from locate_tpu_torch.config import AttentionConfig
from locate_tpu_torch.io.export import params_from_jax
from locate_tpu_torch.ops import activations as tact
from locate_tpu_torch.ops import attention as tatt
from locate_tpu_torch.ops import conv as tconv
from locate_tpu_torch.ops import norm as tnorm

TOL = dict(rtol=1e-5, atol=1e-5)
CPU_GEN = torch.Generator(device="cpu")


def rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def load(module, jax_params):
    """Load JAX params (a pytree) into a port module, as an export does."""
    module.load_state_dict(params_from_jax(_flatten(jax.device_get(jax_params))))
    return module


def run_torch(module, x):
    with torch.no_grad():
        return module(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("kernel", [(3, 3), (1, 3), (3, 1), (1, 1)])
def test_conv2d(kernel):
    layer = jconv.conv2d(5, 7, kernel)
    params = layer.init(jax.random.PRNGKey(0))
    params["b"] = jnp.asarray(rand(7, seed=1))
    x = rand(2, 6, 5, 5, seed=2)
    want = np.asarray(layer.apply(params, jnp.asarray(x)))
    got = run_torch(load(tconv.Conv2d(5, 7, kernel, gen=CPU_GEN), params), x)
    np.testing.assert_allclose(got, want, **TOL)


def test_factorized_conv2d():
    layer = jconv.factorized_conv2d(6, 4, 3)
    params = layer.init(jax.random.PRNGKey(1))
    params["col"]["b"] = jnp.asarray(rand(4, seed=3))
    x = rand(2, 5, 7, 6, seed=4)
    want = np.asarray(layer.apply(params, jnp.asarray(x)))
    got = run_torch(load(tconv.FactorizedConv2d(6, 4, 3, gen=CPU_GEN), params), x)
    np.testing.assert_allclose(got, want, **TOL)


def test_dense():
    layer = jconv.dense(9, 5)
    params = layer.init(jax.random.PRNGKey(2))
    params["b"] = jnp.asarray(rand(5, seed=5))
    x = rand(3, 9, seed=6)
    want = np.asarray(layer.apply(params, jnp.asarray(x)))
    got = run_torch(load(tconv.Dense(9, 5, gen=CPU_GEN), params), x)
    np.testing.assert_allclose(got, want, **TOL)


def test_upsample_nearest():
    x = rand(2, 3, 4, 5, seed=7)
    want = np.asarray(jconv.upsample_nearest(2).apply((), jnp.asarray(x)))
    got = tconv.upsample_nearest(torch.from_numpy(x), 2).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("channels,groups", [(16, 8), (12, 8), (6, 8)])
def test_group_norm(channels, groups):
    assert tnorm.effective_groups(channels, groups) == jnorm.effective_groups(channels, groups)
    layer = jnorm.group_norm(channels, groups)
    params = {"scale": jnp.asarray(rand(channels, seed=8) + 1.0),
              "bias": jnp.asarray(rand(channels, seed=9))}
    x = rand(2, 4, 5, channels, seed=10, scale=3.0) + 2.0
    want = np.asarray(layer.apply(params, jnp.asarray(x)))
    got = run_torch(load(tnorm.GroupNorm(channels, groups), params), x)
    np.testing.assert_allclose(got, want, **TOL)


def test_pixel_norm():
    x = rand(2, 3, 3, 8, seed=11)
    want = np.asarray(jnorm.pixel_norm().apply((), jnp.asarray(x)))
    got = run_torch(tnorm.PixelNorm(), x)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("kind", ["leaky_relu", "relu", "silu", "gelu", "tanh", "none"])
def test_activations(kind):
    x = rand(4, 33, seed=12, scale=3.0)
    x[0, :3] = 0.0  # the subgradient edge of leaky_relu/relu
    want = np.asarray(jact.act_fn(kind, 0.2)(jnp.asarray(x)))
    got = tact.act_fn(kind, 0.2)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("h,w,features", [(4, 4, 4), (8, 16, 8), (5, 3, 12)])
def test_coord_features(h, w, features):
    want = np.asarray(jatt.coord_features(h, w, features))
    got = tatt.coord_features(h, w, features).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["softmax", "sigmoid"])
@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("gate_max", [0.0, 4.0])
@pytest.mark.parametrize("cout", [6, 1])
def test_locate_gate(mode, residual, gate_max, cout):
    x = rand(2, 4, 4, 6, seed=13)
    logits = rand(2, 4, 4, cout, seed=14, scale=2.0)
    want = np.asarray(jatt.locate_gate(jnp.asarray(x), jnp.asarray(logits), mode,
                                       residual, gate_max))
    got = tatt.locate_gate(torch.from_numpy(x), torch.from_numpy(logits), mode,
                           residual, gate_max).numpy()
    if gate_max and residual and mode == "softmax":  # the clamp is hit
        lf = logits.reshape(2, 16, cout)
        g = np.exp(lf - lf.max(1, keepdims=True))
        assert (g / g.sum(1, keepdims=True) * 16 > gate_max).any()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_locate_attention_layer(use_pallas):
    """The whole layer, composed path (`apply_xla`) and fused path
    (`apply_pallas`, Pallas in interpret mode on the JAX side)."""
    kw = dict(pos_features=4, bottleneck=2, gate_max=16.0)
    layer = jatt.locate_attention(8, JaxAttentionConfig(**kw), use_pallas=use_pallas)
    params = layer.init(jax.random.PRNGKey(3))
    params["to_logits"]["w"] = jnp.asarray(rand(1, 1, 8, 8, seed=15, scale=3.0))
    x = rand(2, 8, 8, 8, seed=16)
    want = np.asarray(layer.apply(params, jnp.asarray(x)))
    port = tatt.LocateAttention(8, AttentionConfig(**kw), use_pallas=use_pallas,
                                gen=CPU_GEN)
    got = run_torch(load(port, params), x)
    np.testing.assert_allclose(got, want, **TOL)


def test_attention_autograd_after_inference():
    """The cached coordinate features made under inference_mode stay
    usable by a later forward that autograd tracks (CPU plain version)."""
    port = tatt.LocateAttention(8, AttentionConfig(pos_features=4), use_pallas=True,
                                gen=CPU_GEN)
    x = torch.from_numpy(rand(2, 4, 4, 8, seed=17))
    with torch.inference_mode():
        port(x)
    x.requires_grad_(True)
    port(x).sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
