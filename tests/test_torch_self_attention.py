"""The port's self-attention block (`attention.kind="self"`) against the JAX
package's, on the CPU in float32: `_head_dims` at every stage width of
every preset, and `SelfAttention` against
`locate_tpu.ops.self_attention.self_attention` on the same weights (JAX
init with `gamma` set to 0.7 and q/k scaled up so the softmax is not flat,
carried across by `params_from_jax`) and the same input (numpy, seeded):
output, input gradient and all nine parameter gradients to 2e-4, the
tolerance of tests/test_model_parity_torch.py. With use_pallas the JAX
layer runs its flash kernels in interpret mode and the port
`FlashAttention` on the kernels' plain versions."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from locate_tpu import config as jconfig
from locate_tpu.ops import self_attention as jsa
from locate_tpu_torch import config as tconfig
from locate_tpu_torch.io.export import flatten_tree, params_from_jax
from locate_tpu_torch.ops import flash_attention as tfa
from locate_tpu_torch.ops import self_attention as tsa
from torch_port_parity import as_state_dict, port_config

TOL = 2e-4
C = 32


@pytest.mark.parametrize("preset", sorted(jconfig.PRESETS))
def test_head_dims_match_jax(preset):
    widths = set(jconfig.get_config(preset).model.stage_channels()) | {8, 24, 1024}
    for heads in (1, 2, 4):
        for qk, vb in ((8, 2), (4, 1), (3, 5)):
            kw = dict(kind="self", heads=heads, sa_qk_bottleneck=qk, sa_v_bottleneck=vb)
            for c in widths:
                want = jsa._head_dims(c, jconfig.AttentionConfig(**kw))
                assert tsa._head_dims(c, tconfig.AttentionConfig(**kw)) == want
                assert want[0] % (8 * heads) == 0 and want[1] % (8 * heads) == 0


def test_lsun_bedroom_128_head_dims():
    """The six layers the card runs: (dk, dv) per stage width, heads 1."""
    cfg = tconfig.get_config("lsun_bedroom_128", {"model.attention.kind": "self"})
    dims = [tsa._head_dims(c, cfg.model.attention) for c in cfg.model.stage_channels()]
    assert dims == [(64, 256), (32, 128), (16, 64), (8, 32), (8, 32), (8, 32)]


def jax_layer(heads, sa_scale, use_pallas, gamma=0.7, seed=0):
    """(JAX attention config, layer, params with gamma set and q/k weights
    tripled)."""
    acfg = jconfig.AttentionConfig(kind="self", heads=heads, sa_qk_bottleneck=4,
                                   sa_scale=sa_scale)
    layer = jsa.self_attention(C, acfg, use_pallas=use_pallas)
    params = layer.init(jax.random.PRNGKey(seed))
    params["gamma"] = jnp.asarray(gamma, jnp.float32)
    keys = jax.random.split(jax.random.PRNGKey(seed + 1), 4)
    for name, key in zip("qkvo", keys):
        w = params[name]["w"] * (3.0 if name in "qk" and sa_scale else 1.0)
        params[name] = {"w": w, "b": jax.random.normal(key, params[name]["b"].shape) * 0.2}
    return acfg, layer, params


def port_layer(acfg, params, use_pallas):
    layer = tsa.SelfAttention(C, port_config(acfg), torch.float32, use_pallas=use_pallas)
    layer.load_state_dict({k: torch.from_numpy(v) for k, v in as_state_dict(params).items()})
    return layer


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("sa_scale", [True, False])
@pytest.mark.parametrize("heads", [1, 2])
def test_layer_matches_jax(heads, sa_scale, use_pallas):
    acfg, jl, params = jax_layer(heads, sa_scale, use_pallas)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, 8, C)).astype(np.float32)
    dy = rng.standard_normal((2, 8, 8, C)).astype(np.float32)
    want = np.asarray(jl.apply(params, jnp.asarray(x)))
    gp, gx = jax.grad(lambda p, xx: jnp.sum(jl.apply(p, xx) * dy), argnums=(0, 1))(
        params, jnp.asarray(x))

    ran = []
    original = tfa.FlashAttention.apply
    layer = port_layer(acfg, params, use_pallas)
    xt = torch.from_numpy(x).requires_grad_(True)
    try:
        tfa.FlashAttention.apply = lambda *a: ran.append(1) or original(*a)
        y = layer(xt)
    finally:
        tfa.FlashAttention.apply = original
    assert len(ran) == int(use_pallas)
    (y * torch.from_numpy(dy)).sum().backward()
    assert np.abs(want - x).max() > 0.05  # the attention branch is not a rounding error
    np.testing.assert_allclose(y.detach().numpy(), want, rtol=TOL, atol=TOL)
    gx = np.asarray(gx)
    np.testing.assert_allclose(xt.grad.numpy(), gx, rtol=TOL, atol=TOL * np.abs(gx).max())
    grads = {n: p.grad.numpy() for n, p in layer.named_parameters()}
    want_grads = as_state_dict(gp)
    assert set(grads) == set(want_grads) and len(grads) == 9
    for name, w in want_grads.items():
        assert grads[name].shape == w.shape, name
        assert np.abs(w).max() > 0, name
        scale = np.abs(w).max()
        if name == "k.b":
            # a bias on every key shifts a query's scores alike, which the
            # softmax ignores: this gradient is rounding noise around 0, on
            # the scale of the key weights' gradient, which sums the same terms
            scale = np.abs(want_grads["k.w"]).max()
        np.testing.assert_allclose(grads[name], w, rtol=TOL, atol=TOL * max(1e-3, scale),
                                   err_msg=name)


def test_softmax_is_not_flat():
    """The inputs of `test_layer_matches_jax` give attention rows far from
    uniform, so a wrong score would show."""
    acfg, _, params = jax_layer(1, True, False)
    layer = port_layer(acfg, params, False)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 8, 8, C))
                         .astype(np.float32))
    with torch.no_grad():
        q = layer.q(x).reshape(2, 64, layer.dk)
        k = layer.k(x).reshape(2, 64, layer.dk)
        p = torch.softmax(q @ k.transpose(1, 2) * layer.scale, dim=-1)
    assert float(p.amax(dim=-1).mean()) > 4.0 / 64


@pytest.mark.parametrize("use_pallas", [False, True])
def test_identity_at_init(use_pallas):
    layer = tsa.SelfAttention(C, tconfig.AttentionConfig(kind="self"), torch.float32,
                              use_pallas=use_pallas)
    assert layer.gamma.shape == () and layer.gamma.dtype == torch.float32
    assert float(layer.gamma.detach()) == 0.0
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 4, 4, C))
                         .astype(np.float32))
    with torch.no_grad():
        np.testing.assert_array_equal(layer(x).numpy(), x.numpy())


def test_params_from_jax_round_trip():
    """HWIO (1, 1, C, d) kernels arrive OIHW, the 0-d gamma as a 0-d tensor."""
    acfg, _, params = jax_layer(2, True, False, gamma=0.3)
    sd = params_from_jax(flatten_tree(jax.device_get(params)))
    layer = tsa.SelfAttention(C, port_config(acfg), torch.float32)
    assert set(sd) == set(layer.state_dict())
    assert sd["gamma"].shape == () and float(sd["gamma"]) == pytest.approx(0.3)
    for name in "qkvo":
        hwio = np.asarray(params[name]["w"])
        assert hwio.shape[:2] == (1, 1)
        assert tuple(sd[f"{name}.w"].shape) == (hwio.shape[3], hwio.shape[2], 1, 1)
        np.testing.assert_array_equal(sd[f"{name}.w"][:, :, 0, 0].numpy(), hwio[0, 0].T)
    layer.load_state_dict(sd)
    back = {k: v.numpy() for k, v in layer.state_dict().items()}
    for k, v in as_state_dict(params).items():
        np.testing.assert_array_equal(back[k], v)


def test_use_pallas_changes_no_state_dict_key():
    cfg = tconfig.AttentionConfig(kind="self", heads=2)
    keys = [list(tsa.SelfAttention(C, cfg, torch.float32, use_pallas=flag).state_dict())
            for flag in (False, True)]
    assert keys[0] == keys[1]
    assert keys[0] == ["gamma", "q.w", "q.b", "k.w", "k.b", "v.w", "v.b", "o.w", "o.b"]


def test_split_and_merge_heads_match_jax():
    x = np.random.default_rng(4).standard_normal((3, 10, 24)).astype(np.float32)
    for heads in (1, 2, 4):
        want = np.asarray(jsa._split_heads(jnp.asarray(x), heads))
        got = tsa._split_heads(torch.from_numpy(x), heads)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(tsa._merge_heads(got, heads).numpy(), x)


def test_layer_bf16_matches_jax_within_bf16_steps():
    """bf16 compute over f32 params, use_pallas on both sides: the block's
    output within two bf16 steps (2^-6) of the JAX layer's at the output's
    scale. The projections round in bf16 in both, and XLA may keep a cast
    of the interpreted kernel in f32."""
    acfg = jconfig.AttentionConfig(kind="self", sa_qk_bottleneck=4)
    _, _, params = jax_layer(1, True, True)
    jl = jsa.self_attention(C, acfg, compute_dtype=jnp.bfloat16, use_pallas=True)
    x = np.random.default_rng(5).standard_normal((2, 8, 8, C)).astype(np.float32)
    want = np.asarray(jl.apply(params, jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    layer = tsa.SelfAttention(C, port_config(acfg), torch.bfloat16, use_pallas=True)
    layer.load_state_dict({k: torch.from_numpy(v) for k, v in as_state_dict(params).items()})
    with torch.no_grad():
        got = layer(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    assert np.abs(got.float().numpy() - want).max() <= 2.0 ** -6 * np.abs(want).max()
