"""The port's fused stage (`locate_tpu_torch/ops/fused_stage.py`) against
the JAX package's (`locate_tpu/ops/pallas/fused_stage.py`), on the CPU.

On CPU tensors the port's wrappers run their kernels' plain versions, and
its `FusedStage` backward chains them (conv recompute, the gate's three
backward passes, the conv-block backward, the GroupNorm epilogue); the JAX
side runs its Pallas kernels in interpret mode under `jax.grad`. Inputs are
numpy draws from a seed, at the sizes of tests/test_fused_stage.py (16x16
fine maps, 32 channels, 16 -> 32 for the 1x1 skip). Tolerances, float32:
outputs to 2e-5 of their largest magnitude, gradients to 5e-5 of theirs
(tests/test_fused_stage.py's own); a softmax gate's logit-bias gradient is
zero in exact arithmetic (the softmax is shift invariant), so it is held
to the logit weights' gradient scale. In bf16 the plain versions repeat
the kernel bodies' cast placement, so the port and JAX round alike: at
most one bf16 rounding step apart (2^-7 of the output's scale)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from locate_tpu.ops.pallas import fused_stage as jfs
from locate_tpu_torch.ops import fused_stage as fs

GATE = ("pos_proj", "w1x", "b1", "w2", "b2")
# (mode, C, Co, upsample, downsample, act)
VARIANTS = {
    "conv": (None, 32, 32, False, False, "leaky_relu"),
    "conv_skip": (None, 16, 32, False, False, "leaky_relu"),
    "conv_up": (None, 32, 32, True, False, "leaky_relu"),
    "conv_skip_up": (None, 16, 32, True, False, "relu"),
    "conv_skip_down": (None, 16, 32, False, True, "leaky_relu"),
    "softmax": ("softmax", 32, 32, False, False, "leaky_relu"),
    "softmax_skip": ("softmax", 16, 32, False, False, "relu"),
    "softmax_up": ("softmax", 32, 32, True, False, "leaky_relu"),
    "softmax_skip_up": ("softmax", 16, 32, True, False, "leaky_relu"),
    "softmax_down": ("softmax", 32, 32, False, True, "leaky_relu"),
    "softmax_skip_down": ("softmax", 16, 32, False, True, "leaky_relu"),
    "sigmoid_down": ("sigmoid", 32, 32, False, True, "leaky_relu"),
    "softmax_silu_oracle_bwd": ("softmax", 32, 32, False, False, "silu"),
}
H = 16  # the fine side


def operands(mode, c, co, upsample, seed=0, hd=8):
    """numpy operands in the JAX layout (HWIO weights)."""
    rng = np.random.default_rng(seed)

    def f(*shape, scale=0.1):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    hin = H // 2 if upsample else H
    ops = dict(x=f(2, hin, hin, c, scale=1.0), gn_scale=1.0 + f(c), gn_bias=f(c),
               w_row=f(1, 3, c, co, scale=0.2), w_col=f(3, 1, co, co, scale=0.2),
               b_col=f(co))
    if c != co:
        ops["w_skip"] = f(1, 1, c, co, scale=0.2)
    if mode is not None:
        ops.update(pos_proj=f(H * H, hd, scale=0.5), w1x=f(co, hd, scale=0.3), b1=f(hd),
                   w2=f(hd, co, scale=1.0), b2=f(co))
    return ops


def port_tensor(name, v):
    t = torch.from_numpy(np.array(v, copy=True))
    return t.permute(3, 2, 0, 1).contiguous() if name.startswith("w_") else t


def jax_layout(name, v):
    v = np.asarray(v, np.float32)
    return np.transpose(v, (2, 3, 1, 0)) if name.startswith("w_") else v


def cotangent(kw, co):
    """A fixed cotangent of the stage's output (numpy, seeded)."""
    side = H // 2 if kw["downsample"] else H
    return np.random.default_rng(7).standard_normal((2, side, side, co)).astype(np.float32)


def jax_run(ops, kw, dtype=jnp.float32):
    """(y, the vjp of y with `cotangent`) through JAX fused_stage in
    interpret mode."""
    jops = {k: jnp.asarray(v) for k, v in ops.items()}
    jops["x"] = jops["x"].astype(dtype)
    dy = jnp.asarray(cotangent(kw, ops["w_col"].shape[-1]))

    def f(o):
        gate = {k: o[k] for k in GATE if k in o}
        return jfs.fused_stage(o["x"], o["gn_scale"], o["gn_bias"], o["w_row"], o["w_col"],
                               o["b_col"], o.get("w_skip"), interpret=True, **gate, **kw)

    y = f(jops)
    grads = jax.grad(lambda o: jnp.sum(f(o).astype(jnp.float32) * dy))(jops)
    return np.asarray(y.astype(jnp.float32)), {k: np.asarray(v, np.float32)
                                               for k, v in grads.items()}


def port_run(ops, kw, dtype=torch.float32):
    leaves = {k: port_tensor(k, v).requires_grad_(True) for k, v in ops.items()}
    gate = {k: leaves[k] for k in GATE if k in leaves}
    y = fs.fused_stage(leaves["x"].to(dtype), leaves["gn_scale"], leaves["gn_bias"],
                       leaves["w_row"], leaves["w_col"], leaves["b_col"], leaves.get("w_skip"),
                       **gate, **kw)
    dy = torch.from_numpy(cotangent(kw, ops["w_col"].shape[-1]))
    (y.float() * dy).sum().backward()
    return y.detach().float().numpy(), {k: jax_layout(k, t.grad.numpy())
                                        for k, t in leaves.items()}


def stage_kw(mode, upsample, downsample, act):
    return dict(groups=4, act=act, mode=mode, upsample=upsample, downsample=downsample,
                gate_max=16.0 if mode else 0.0)


def assert_grads_close(got, want, mode, rtol):
    assert set(got) == set(want)
    for k, w in want.items():
        scale = np.abs(w).max()
        if mode == "softmax" and k == "b2":
            scale = max(scale, np.abs(want["w2"]).max())
        np.testing.assert_allclose(got[k], w, rtol=rtol, atol=rtol * max(scale, 1e-6),
                                   err_msg=k)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_fused_stage_matches_jax_interpret(variant):
    """Forward and first-order gradients of every input, f32."""
    mode, c, co, up, dn, act = VARIANTS[variant]
    ops = operands(mode, c, co, up)
    kw = stage_kw(mode, up, dn, act)
    jy, jg = jax_run(ops, kw)
    py, pg = port_run(ops, kw)
    side = H // 2 if dn else H
    assert py.shape == jy.shape == (2, side, side, co)
    np.testing.assert_allclose(py, jy, rtol=2e-5, atol=2e-5 * np.abs(jy).max())
    assert_grads_close(pg, jg, mode, rtol=5e-5)


@pytest.mark.parametrize("resample", ["upsample", "downsample"])
def test_bf16_cast_placement_matches_jax_interpret(resample):
    """The bf16 kernel bodies' cast placement (tests/test_fused_stage.py
    :416): the port's plain versions and JAX's interpreted kernels round
    at the same places, so they agree to one bf16 rounding step."""
    up = resample == "upsample"
    ops = operands("softmax", 32, 32, up, seed=3)
    kw = stage_kw("softmax", up, not up, "leaky_relu")
    jy, _ = jax_run(ops, kw, jnp.bfloat16)
    py, _ = port_run(ops, kw, torch.bfloat16)
    scale = np.abs(jy).max()
    np.testing.assert_allclose(py, jy, rtol=0, atol=2.0 ** -7 * scale)
    assert np.mean(py == jy) > 0.95


@pytest.mark.parametrize("variant", ["conv_skip_up", "conv_skip_down", "softmax_up",
                                     "softmax_skip_down", "sigmoid_down"])
def test_stage_oracle_matches_jax(variant):
    """The port's exact composition against JAX's, forward and gradients."""
    mode, c, co, up, dn, act = VARIANTS[variant]
    ops = operands(mode, c, co, up, seed=1)
    kw = dict(h=H, w=H, groups=4, eps=1e-5, act=act, leaky_slope=0.2, mode=mode,
              gate_max=16.0 if mode else 0.0, upsample=up, downsample=dn)
    dy = cotangent(kw, co)
    jops = {k: jnp.asarray(v) for k, v in ops.items()}
    jy = jfs.stage_oracle(jops, **kw)
    jg = jax.grad(lambda o: jnp.sum(jfs.stage_oracle(o, **kw) * dy))(jops)
    leaves = {k: port_tensor(k, v).requires_grad_(True) for k, v in ops.items()}
    py = fs.stage_oracle(leaves, **kw)
    (py * torch.from_numpy(dy)).sum().backward()
    np.testing.assert_allclose(py.detach().numpy(), np.asarray(jy), rtol=2e-5,
                               atol=2e-5 * np.abs(np.asarray(jy)).max())
    assert_grads_close({k: jax_layout(k, t.grad.numpy()) for k, t in leaves.items()},
                       {k: np.asarray(v) for k, v in jg.items()}, mode, rtol=5e-5)


def test_fold_groupnorm_matches_jax():
    ops = operands(None, 32, 32, False, seed=2)
    ja, jb = jfs._fold_groupnorm(jnp.asarray(ops["x"]), jnp.asarray(ops["gn_scale"]),
                                 jnp.asarray(ops["gn_bias"]), 4, 1e-5)
    a, b = fs.fold_groupnorm(torch.from_numpy(ops["x"]), torch.from_numpy(ops["gn_scale"]),
                             torch.from_numpy(ops["gn_bias"]), 4, 1e-5)
    np.testing.assert_allclose(a.numpy(), np.asarray(ja)[:, 0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(b.numpy(), np.asarray(jb)[:, 0], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("c,co,up", [(32, 32, False), (16, 32, False), (32, 32, True),
                                     (16, 32, True)])
def test_conv_backward_matches_jax_interpret(c, co, up):
    """`stage_conv_bwd`'s plain version and the epilogue against
    `_pallas_conv_backward` (the `_kernel_conv_bwd` call and its XLA
    epilogue) on one cotangent."""
    ops = operands(None, c, co, up, seed=4)
    dw = np.random.default_rng(5).standard_normal((2, H * H, co)).astype(np.float32)
    want = jfs._pallas_conv_backward({k: jnp.asarray(v) for k, v in ops.items()},
                                     jnp.asarray(dw), h=H, w=H, groups=4, eps=1e-5,
                                     act="leaky_relu", leaky_slope=0.2, interpret=True,
                                     upsample=up)
    t = {k: port_tensor(k, v) for k, v in ops.items()}
    a, b = fs.fold_groupnorm(t["x"], t["gn_scale"], t["gn_bias"], 4, 1e-5)
    wr, wc, ws = fs.kernel_weights(t["w_row"], t["w_col"], t.get("w_skip"), torch.float32)
    du, dxs, dwr, dwc, dbc, dws = fs.stage_conv_bwd(
        t["x"], torch.from_numpy(dw).reshape(2, H, H, co), a, b, wr, wc, ws,
        act="leaky_relu", leaky_slope=0.2, upsample=up)
    dx, dscale, dbias = fs.groupnorm_act_backward(t["x"], du, dxs, t["gn_scale"], t["gn_bias"],
                                                  groups=4, eps=1e-5, act="leaky_relu",
                                                  leaky_slope=0.2)
    got = {"x": dx, "gn_scale": dscale, "gn_bias": dbias, "b_col": dbc,
           "w_row": dwr.reshape(1, 3, c, co), "w_col": dwc.reshape(3, 1, co, co)}
    if dws is not None:
        got["w_skip"] = dws.reshape(1, 1, c, co)
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(got[k].numpy(), w, rtol=5e-5, atol=5e-5 * np.abs(w).max(),
                                   err_msg=k)


def test_oracle_backward_matches_the_hand_written_one():
    """`oracle_bwd=True` takes the vjp of `stage_oracle`; in f32 it agrees
    with the kernel chain's plain versions (the escape hatch of
    tests/test_fused_stage.py:267)."""
    ops = operands("softmax", 16, 32, False, seed=6)
    kw = stage_kw("softmax", False, True, "leaky_relu")
    _, hand = port_run(ops, kw)
    _, oracle = port_run(ops, dict(kw, oracle_bwd=True))
    assert_grads_close(hand, oracle, "softmax", rtol=5e-5)


def test_shapes_and_options_the_kernels_refuse():
    x = torch.zeros(1, 8, 8, 16)
    w = torch.zeros(16, 16, 1, 3), torch.zeros(16, 16, 3, 1), torch.zeros(16)
    with pytest.raises(ValueError, match="mutually exclusive"):
        fs.fused_stage(x, torch.ones(16), torch.zeros(16), *w, None, groups=4,
                       upsample=True, downsample=True)
    with pytest.raises(ValueError, match="unknown gate mode"):
        fs.fused_stage(x, torch.ones(16), torch.zeros(16), *w, None, groups=4, mode="tanh")
    assert fs.bwd_blocks(16, 512, 512, 4, 16) == fs._BWD_TARGET_BLOCKS
    assert fs.bwd_blocks(1, 8, 8, 4, 8) == 2
