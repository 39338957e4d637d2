"""The backward of the port's location-attention gate on the CPU: the plain
backward (what a CPU tensor runs, and what the backward kernels are held
against on the card) against `jax.grad` of the JAX package's fused gate,
its Pallas kernels in interpret mode, and of its XLA composition.

float32. Tolerance: 2e-5 relative, plus 2e-5 of the leaf's largest
magnitude absolute (the sums of the two frameworks run in other orders).
db2 of a softmax gate is a near-cancelling sum, analytically zero without
the clamp, so its noise scales with the terms it adds: its absolute
tolerance takes dW2's magnitude, which sums the same dl terms weighted
by h."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from locate_tpu.ops.pallas import fused_attention as jfa
from locate_tpu_torch.ops import fused_attention as tfa

NAMES = ("x", "pos_proj", "w1x", "b1", "w2", "b2")


def make_inputs(n=2, h=8, w=8, c=16, hd=8, cout=16, pos=True, seed=0):
    """Gate weights large enough that the mean-1 softmax gate passes 16,
    and a cotangent dy of the output's shape."""
    rng = np.random.default_rng(seed)

    def r(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    x = r(n, h, w, c)
    pos_proj = r(h * w, hd, scale=0.5) if pos else np.zeros((h * w, hd), np.float32)
    arrays = (x, pos_proj, r(c, hd, scale=0.5), r(hd, scale=0.1), r(hd, cout, scale=1.5),
              r(cout, scale=0.1))
    return arrays, r(n, h, w, c)


def port_grads(arrays, dy, **kw):
    inputs = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    y = tfa.fused_locate_attention(*inputs, mode="softmax", **kw)
    return [g.numpy() for g in torch.autograd.grad(y, inputs, torch.from_numpy(dy))]


def jax_grads(arrays, dy, pallas, **kw):
    n, h, w, c = arrays[0].shape
    if pallas:
        def f(*a):
            return jfa.fused_locate_attention(*a, mode="softmax", interpret=True, **kw)
    else:
        def f(x, *rest):
            y = jfa.locate_attention_xla_core(x.reshape(n, h * w, c), *rest, mode="softmax",
                                              hw_scale=float(h * w), **kw)
            return y.reshape(x.shape)
    _, vjp = jax.vjp(f, *map(jnp.asarray, arrays))
    return [np.asarray(g) for g in vjp(jnp.asarray(dy))]


def assert_grads_close(got, want):
    scale = {name: max(1.0, float(np.abs(b).max())) for name, b in zip(NAMES, want)}
    scale["b2"] = max(scale["b2"], scale["w2"])  # the same dl terms, weighted by h
    for name, a, b in zip(NAMES, got, want):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-5 * scale[name], err_msg=name)


def clamp_hit(arrays, act):
    x = arrays[0]
    n, h, w, c = x.shape
    ops = [torch.from_numpy(a) for a in (x.reshape(n, h * w, c), *arrays[1:])]
    l = tfa.gate_logits_reference(*ops, act=act, leaky_slope=0.2)
    return bool((torch.softmax(l, dim=1) * (h * w) > 16.0).any())


@pytest.mark.parametrize("pos_features", [0, 4])
@pytest.mark.parametrize("per_channel", [True, False])
@pytest.mark.parametrize("gate_max", [0.0, 16.0])
@pytest.mark.parametrize("act", ["leaky_relu", "relu", "silu"])
def test_backward_matches_jax(act, gate_max, per_channel, pos_features):
    """leaky_relu and relu run the plain backward (the kernels' arithmetic),
    silu the vjp of the plain composition, as JAX does."""
    arrays, dy = make_inputs(cout=16 if per_channel else 1, pos=bool(pos_features))
    assert clamp_hit(arrays, act)
    kw = dict(act=act, leaky_slope=0.2, gate_max=gate_max)
    got = port_grads(arrays, dy, **kw)
    assert_grads_close(got, jax_grads(arrays, dy, pallas=False, **kw))
    if gate_max and pos_features:
        # the Pallas backward kernels themselves, in interpret mode
        assert_grads_close(got, jax_grads(arrays, dy, pallas=True, **kw))


@pytest.mark.parametrize("act", ["leaky_relu", "relu"])
def test_backward_several_tiles_and_rows(act):
    """64x32 locations at C=8 make two spatial tiles in the Pallas kernels,
    with three batch rows accumulating dpos_proj and the weight grads."""
    arrays, dy = make_inputs(n=3, h=64, w=32, c=8, hd=8, cout=8, seed=11)
    kw = dict(act=act, leaky_slope=0.2, gate_max=16.0)
    got = port_grads(arrays, dy, **kw)
    assert_grads_close(got, jax_grads(arrays, dy, pallas=True, **kw))


def test_relu_subgradient_at_zero():
    """u == 0 everywhere: relu's backward must use grad 0 there, as
    jax.nn.relu does (tests/test_pallas_attention.py:122)."""
    c, hd = 8, 8
    arrays = (np.zeros((1, 4, 4, c), np.float32), np.zeros((16, hd), np.float32),
              np.full((c, hd), 0.1, np.float32), np.zeros(hd, np.float32),
              np.full((hd, c), 0.1, np.float32), np.zeros(c, np.float32))
    dy = np.random.default_rng(3).standard_normal((1, 4, 4, c)).astype(np.float32)
    kw = dict(act="relu", leaky_slope=0.2, gate_max=0.0)
    got = port_grads(arrays, dy, **kw)
    assert_grads_close(got, jax_grads(arrays, dy, pallas=True, **kw))
    np.testing.assert_array_equal(got[3], 0.0)  # db1: every u sits at 0


@pytest.mark.parametrize("act", ["leaky_relu", "silu"])
def test_function_matches_autograd_of_plain_forward(act):
    """The Function's gradients equal torch.autograd through the plain
    composition (locate_attention_core_reference)."""
    arrays, dy = make_inputs(seed=4)
    kw = dict(act=act, leaky_slope=0.2, gate_max=16.0)
    got = port_grads(arrays, dy, **kw)
    inputs = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    n, h, w, c = arrays[0].shape
    y = tfa.locate_attention_core_reference(inputs[0].reshape(n, h * w, c), *inputs[1:],
                                            mode="softmax", hw_scale=float(h * w), **kw)
    want = torch.autograd.grad(y.reshape(n, h, w, c), inputs, torch.from_numpy(dy))
    assert_grads_close(got, [g.numpy() for g in want])


def test_bf16_backward_rounds_like_jax():
    """bf16 on the CPU: the plain backward against the JAX XLA composition's
    vjp in bf16. Both round h, dl, du and dx at the same places; their f32
    sums run in other orders, so a few elements land one bf16 step apart."""
    arrays, dy = make_inputs(seed=8)
    n, h, w, c = arrays[0].shape
    inputs = [torch.from_numpy(arrays[0]).to(torch.bfloat16).requires_grad_(True)]
    inputs += [torch.from_numpy(a).requires_grad_(True) for a in arrays[1:]]
    y = tfa.fused_locate_attention(*inputs, gate_max=16.0)
    got = torch.autograd.grad(y, inputs, torch.from_numpy(dy).to(torch.bfloat16))
    jx = [jnp.asarray(arrays[0].reshape(n, h * w, c), jnp.bfloat16)]
    jx += [jnp.asarray(a) for a in arrays[1:]]
    _, vjp = jax.vjp(lambda *a: jfa.locate_attention_xla_core(
        *a, mode="softmax", act="leaky_relu", leaky_slope=0.2, hw_scale=float(h * w),
        gate_max=16.0), *jx)
    want = vjp(jnp.asarray(dy.reshape(n, h * w, c), jnp.bfloat16))
    dx = got[0].float().numpy().reshape(n, h * w, c)
    close = np.isclose(dx, np.asarray(want[0].astype(jnp.float32)), rtol=2e-2, atol=2e-2)
    assert close.mean() > 0.99, close.mean()
    scale = {name: np.linalg.norm(np.asarray(b)) for name, b in zip(NAMES[1:], want[1:])}
    scale["b2"] = max(scale["b2"], scale["w2"])  # near-cancelling: see module docstring
    for name, a, b in zip(NAMES[1:], got[1:], want[1:]):
        err = np.linalg.norm(a.numpy() - np.asarray(b)) / scale[name]
        assert err < 2e-2, (name, err)


def test_double_backward_raises():
    """Differentiating the gate's backward again (what R1 would do through
    the kernels) raises: second-order terms take the plain composition."""
    arrays, _ = make_inputs(seed=6)
    inputs = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    y = tfa.fused_locate_attention(*inputs, gate_max=16.0)
    (gx,) = torch.autograd.grad((y * y).sum(), inputs[0], create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        gx.square().sum().backward()


def test_cpu_backward_counts_no_launches():
    arrays, dy = make_inputs(seed=9)
    counters = (tfa.softmax_gate_csum, tfa.softmax_gate_backward)
    before = [f.launches for f in counters]
    port_grads(arrays, dy, act="leaky_relu", leaky_slope=0.2, gate_max=16.0)
    assert [f.launches for f in counters] == before


def test_wrappers_refuse_activations_without_a_backward_kernel():
    arrays, dy = make_inputs(seed=10)
    x = arrays[0]
    n, h, w, c = x.shape
    ops = [torch.from_numpy(a) for a in (x.reshape(n, h * w, c), *arrays[1:])]
    with pytest.raises(ValueError, match="backward kernel"):
        tfa._bwd_operands(ops[0], torch.from_numpy(dy).reshape(n, h * w, c), *ops[1:],
                          torch.zeros(n, 1, c), torch.ones(n, 1, c), "silu")


@pytest.mark.parametrize("n,hw,c", [(64, 16, 512), (64, 16384, 64), (128, 1024, 64),
                                    (3, 200, 48)])
def test_bwd_grid(n, hw, c):
    """The backward kernel's tiling: tile rows a multiple of 4, and more
    blocks than the H100's 132 SMs wherever the shape allows it."""
    t, rows = tfa.bwd_grid(n, hw, c)
    assert t % 4 == 0 and 4 <= t <= tfa.tile_rows(c) and 1 <= rows <= n
    blocks = -(-hw // t) * -(-n // rows)
    assert blocks > 132 or blocks == -(-hw // 4) * n
