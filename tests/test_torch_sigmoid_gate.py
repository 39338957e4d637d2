"""The port's sigmoid location gate (`SigmoidGate`, `sigmoid_gate`,
`sigmoid_gate_backward` and `LocateAttention`'s dispatch) against the JAX
package on the CPU, where the port's wrappers run their kernels' plain
versions and the JAX side runs its Pallas kernels in interpret mode.

Inputs are numpy draws from a seed. The gate weights make the logits vary
by a few units, so that `gate_max` 1.5 (below the gate's ceiling of 2)
clamps a part of the locations and leaves the rest: the clamp's mask
path is exercised, as with `gate_max` 0 (off) its absence is. Tolerances,
float32: the output to 2e-5 of its largest magnitude, each gradient to
5e-5 of its own (tests/test_torch_fused_stage.py's). In bf16 the plain
version rounds h, y, dl, du and dx where the Pallas kernels do, so the two
are at most one bf16 rounding step apart: 2^-7 of each tensor's scale."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from locate_tpu.config import AttentionConfig as JaxAttentionConfig
from locate_tpu.io.export import _flatten
from locate_tpu.ops import attention as jatt
from locate_tpu.ops.pallas import fused_attention as jfa
from locate_tpu_torch.config import AttentionConfig
from locate_tpu_torch.io.export import params_from_jax
from locate_tpu_torch.ops import attention as tatt
from locate_tpu_torch.ops import fused_attention as tfa
from locate_tpu_torch.ops import gate_profile
from torch_port_parity import use_jax_sigmoid_bound

NAMES = ("x", "pos_proj", "w1x", "b1", "w2", "b2")
BF16_STEP = 2.0 ** -7


def make_inputs(n=2, h=8, w=8, c=16, hd=8, cout=16, seed=0):
    """The gate's operands (x NHWC) and a cotangent dy like x."""
    rng = np.random.default_rng(seed)

    def r(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    arrays = (r(n, h, w, c), r(h * w, hd, scale=0.5), r(c, hd, scale=0.5), r(hd, scale=0.1),
              r(hd, cout, scale=1.5), r(cout, scale=0.1))
    return arrays, r(n, h, w, c)


def gates(arrays, act):
    """2 sigmoid(l) of the inputs, unclamped (f32)."""
    x = arrays[0]
    n, h, w, c = x.shape
    ops = [torch.from_numpy(a) for a in (x.reshape(n, h * w, c), *arrays[1:])]
    return 2.0 * torch.sigmoid(tfa.gate_logits_reference(*ops, act=act, leaky_slope=0.2))


def assert_close(got, want, rtol, names=NAMES):
    for name, a, b in zip(names, got, want):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * max(np.abs(b).max(), 1e-6),
                                   err_msg=name)


def port_run(arrays, dy, dtype=torch.float32, **kw):
    """(y, gradients of every input) through the port's fused_locate_attention."""
    inputs = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    y = tfa.fused_locate_attention(inputs[0].to(dtype), *inputs[1:], mode="sigmoid", **kw)
    grads = torch.autograd.grad(y, inputs, torch.from_numpy(dy).to(dtype))
    return y.detach().float().numpy(), [g.float().numpy() for g in grads]


def jax_run(arrays, dy, dtype=jnp.float32, **kw):
    """(y, vjp of every input) through JAX fused_locate_attention, interpret."""
    def f(x, *rest):
        return jfa.fused_locate_attention(x.astype(dtype), *rest, mode="sigmoid",
                                          interpret=True, **kw)

    y, vjp = jax.vjp(f, *map(jnp.asarray, arrays))
    grads = vjp(jnp.asarray(dy, dtype))
    return np.asarray(y.astype(jnp.float32)), [np.asarray(g, np.float32) for g in grads]


@pytest.mark.parametrize("gate_max", [0.0, 1.5])
@pytest.mark.parametrize("per_channel", [True, False])
@pytest.mark.parametrize("act", ["leaky_relu", "relu", "silu"])
def test_gate_matches_jax_interpret(act, per_channel, gate_max):
    """Forward and first-order gradients: leaky_relu and relu take the
    backward kernel's plain version, silu the vjp of the plain composition,
    as `_make_fused_core` does."""
    arrays, dy = make_inputs(cout=16 if per_channel else 1)
    g = gates(arrays, act)
    assert 0.1 < float((g > 1.5).float().mean()) < 0.9
    kw = dict(act=act, leaky_slope=0.2, gate_max=gate_max)
    py, pg = port_run(arrays, dy, **kw)
    jy, jg = jax_run(arrays, dy, **kw)
    assert_close([py], [jy], 2e-5, ("y",))
    assert_close(pg, jg, 5e-5)


@pytest.mark.parametrize("gate_max", [0.0, 1.5])
@pytest.mark.parametrize("per_channel", [True, False])
@pytest.mark.parametrize("act", ["leaky_relu", "relu"])
def test_backward_reference_matches_pallas_backward(act, per_channel, gate_max):
    """`sigmoid_gate_backward_reference` against `_pallas_backward`
    (`_bwd_kernel_sigmoid`) called directly."""
    arrays, dy = make_inputs(cout=16 if per_channel else 1, seed=1)
    n, h, w, c = arrays[0].shape
    x2d, dy2d = arrays[0].reshape(n, h * w, c), dy.reshape(n, h * w, c)
    kw = dict(act=act, leaky_slope=0.2, gate_max=gate_max)
    want = jfa._pallas_backward(jnp.asarray(x2d), jnp.asarray(dy2d),
                                *map(jnp.asarray, arrays[1:]), None, None, mode="sigmoid",
                                hw_scale=1.0, interpret=True, **kw)
    got = tfa.sigmoid_gate_backward(torch.from_numpy(x2d), torch.from_numpy(dy2d),
                                    *map(torch.from_numpy, arrays[1:]), **kw)
    assert_close([t.numpy() for t in got], [np.asarray(t) for t in want], 5e-5)


def test_backward_several_tiles_and_rows():
    """64x32 locations at C=8 make two spatial tiles in the Pallas kernel,
    with three batch rows accumulating dpos_proj and the weight grads."""
    arrays, dy = make_inputs(n=3, h=64, w=32, c=8, hd=8, cout=8, seed=2)
    kw = dict(act="leaky_relu", leaky_slope=0.2, gate_max=1.5)
    py, pg = port_run(arrays, dy, **kw)
    jy, jg = jax_run(arrays, dy, **kw)
    assert_close([py], [jy], 2e-5, ("y",))
    assert_close(pg, jg, 5e-5)


def test_bf16_rounds_like_the_pallas_kernels():
    """bf16 x: forward and gradients at most one bf16 step from JAX's."""
    arrays, dy = make_inputs(seed=3)
    kw = dict(act="leaky_relu", leaky_slope=0.2, gate_max=1.5)
    py, pg = port_run(arrays, dy, torch.bfloat16, **kw)
    jy, jg = jax_run(arrays, dy, jnp.bfloat16, **kw)
    np.testing.assert_allclose(py, jy, rtol=0, atol=BF16_STEP * np.abs(jy).max())
    assert np.mean(py == jy) > 0.95
    for name, a, b in zip(NAMES, pg, jg):
        np.testing.assert_allclose(a, b, rtol=0, atol=BF16_STEP * np.abs(b).max(),
                                   err_msg=name)


def layer_params(layer, seed):
    """JAX init of the layer with its zero-init logit conv filled."""
    params = layer.init(jax.random.PRNGKey(seed))
    w = params["to_logits"]["w"]
    params["to_logits"]["w"] = jnp.asarray(
        np.random.default_rng(seed).standard_normal(w.shape).astype(np.float32) * 1.5)
    return params


@pytest.mark.parametrize("side,fused", [(16, True), (32, False)])
def test_layer_dispatch_matches_jax(monkeypatch, tmp_path, side, fused):
    """LocateAttention with use_pallas, mode="sigmoid", on a profile holding
    the JAX layer's bound: at H*W <= 256 the fused gate, above it the
    composed path, as the JAX layer's `apply_dispatch`; output and
    gradients of x and the params."""
    use_jax_sigmoid_bound(monkeypatch, tmp_path)
    kw = dict(mode="sigmoid", pos_features=4, bottleneck=2, gate_max=1.5)
    layer = jatt.locate_attention(16, JaxAttentionConfig(**kw), use_pallas=True)
    params = layer_params(layer, seed=4)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, side, side, 16)).astype(np.float32)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    jy = layer.apply(params, jnp.asarray(x))
    jgp, jgx = jax.grad(lambda p, xx: jnp.sum(layer.apply(p, xx) * dy), argnums=(0, 1))(
        params, jnp.asarray(x))

    port = tatt.LocateAttention(16, AttentionConfig(**kw), use_pallas=True,
                                gen=torch.Generator(device="cpu"))
    port.load_state_dict(params_from_jax(_flatten(jax.device_get(params))))
    paths = []
    for name in ("forward_fused", "forward_composed"):
        original = getattr(port, name)
        monkeypatch.setattr(port, name, lambda t, n=name, f=original: paths.append(n) or f(t))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = port(xt)
    (y * torch.from_numpy(dy)).sum().backward()
    assert paths == ["forward_fused" if fused else "forward_composed"]
    assert_close([y.detach().numpy()], [np.asarray(jy)], 2e-5, ("y",))
    assert_close([xt.grad.numpy()], [np.asarray(jgx)], 5e-5, ("x",))
    want = params_from_jax(_flatten(jax.device_get(jgp)))
    got = {n: p.grad for n, p in port.named_parameters()}
    assert set(got) == set(want)
    assert_close([got[n].numpy() for n in sorted(got)], [want[n].numpy() for n in sorted(got)],
                 5e-5, sorted(got))


def test_threshold_is_the_jax_layers():
    """The JAX layer's dispatch (`fused_profitable`) on the card's profile:
    the sigmoid gate runs its kernels inside each of the profile's ranges
    and not just outside them; the softmax gate everywhere."""
    port = tatt.LocateAttention(8, AttentionConfig(mode="sigmoid"), use_pallas=True,
                                gen=torch.Generator(device="cpu"))
    ranges = gate_profile.sigmoid_ranges()
    assert ranges
    for lo, hi in ranges:
        assert port.fused_profitable(lo) and port.fused_profitable(hi)
        assert not port.fused_profitable(hi + 1) or any(a <= hi + 1 <= b for a, b in ranges)
        assert lo == 0 or not port.fused_profitable(lo - 1) or any(
            a <= lo - 1 <= b for a, b in ranges)
    softmax = tatt.LocateAttention(8, AttentionConfig(), use_pallas=True,
                                   gen=torch.Generator(device="cpu"))
    assert softmax.fused_profitable(1 << 20)


def test_cpu_calls_count_no_launches():
    arrays, dy = make_inputs(seed=6)
    counters = (tfa.sigmoid_gate, tfa.sigmoid_gate_backward)
    before = [f.launches for f in counters]
    port_run(arrays, dy, act="leaky_relu", leaky_slope=0.2, gate_max=1.5)
    assert [f.launches for f in counters] == before


def test_double_backward_raises():
    """Differentiating the gate's backward again raises: second-order
    terms such as R1 take the plain composition."""
    arrays, _ = make_inputs(seed=7)
    inputs = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    y = tfa.fused_locate_attention(*inputs, mode="sigmoid", gate_max=1.5)
    (gx,) = torch.autograd.grad((y * y).sum(), inputs[0], create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        gx.square().sum().backward()


def test_unknown_mode_raises():
    arrays, _ = make_inputs(seed=8)
    with pytest.raises(ValueError, match="unknown attention mode"):
        tfa.fused_locate_attention(*map(torch.from_numpy, arrays), mode="tanh")
