"""The port's fused stage with the sigmoid gate (`fused_stage(mode="sigmoid")`:
the `stage_sigmoid` pass, and in the backward the recomputed w, the
sigmoid gate's one-pass backward and the conv-block backward) against the
JAX package's `fused_stage(mode="sigmoid", interpret=True)`, on the CPU.

The inputs and tolerances are tests/test_torch_fused_stage.py's: 16x16
fine maps, 32 channels (16 -> 32 for the 1x1 skip), numpy draws from a
seed; float32 outputs to 2e-5 of their largest magnitude, gradients to
5e-5 of theirs; bf16 outputs at most one rounding step (2^-7 of the scale)
apart. `gate_max` 1.5, below the sigmoid gate's ceiling of 2, clamps a
part of the pixels (the preset's 16 never binds), so the clamp's mask is
exercised in the forward and the backward."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from locate_tpu_torch.ops import fused_attention as fa
from locate_tpu_torch.ops import fused_stage as fs
from test_torch_fused_stage import (H, assert_grads_close, jax_run, operands, port_run,
                                    port_tensor, stage_kw)

# (C, Co, upsample, downsample, act, gate_max)
VARIANTS = {
    "plain": (32, 32, False, False, "leaky_relu", 1.5),
    "plain_unclamped": (32, 32, False, False, "leaky_relu", 0.0),
    "skip": (16, 32, False, False, "leaky_relu", 1.5),
    "up": (32, 32, True, False, "leaky_relu", 1.5),
    "skip_up": (16, 32, True, False, "relu", 1.5),
    "down": (32, 32, False, True, "leaky_relu", 1.5),
    "skip_down": (16, 32, False, True, "leaky_relu", 1.5),
    "skip_down_unclamped": (16, 32, False, True, "relu", 0.0),
    "silu_oracle_bwd": (32, 32, False, False, "silu", 1.5),
}


def sigmoid_kw(up, dn, act, gate_max):
    return dict(stage_kw("sigmoid", up, dn, act), gate_max=gate_max)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_sigmoid_stage_matches_jax_interpret(variant):
    """Forward and first-order gradients of every input, f32."""
    c, co, up, dn, act, gate_max = VARIANTS[variant]
    ops = operands("sigmoid", c, co, up, seed=10)
    kw = sigmoid_kw(up, dn, act, gate_max)
    jy, jg = jax_run(ops, kw)
    py, pg = port_run(ops, kw)
    side = H // 2 if dn else H
    assert py.shape == jy.shape == (2, side, side, co)
    np.testing.assert_allclose(py, jy, rtol=2e-5, atol=2e-5 * np.abs(jy).max())
    assert_grads_close(pg, jg, "sigmoid", rtol=5e-5)


def test_the_clamp_binds():
    """With these operands gate_max 1.5 clamps some pixels and not others."""
    ops = operands("sigmoid", 32, 32, False, seed=10)
    t = {k: port_tensor(k, v) for k, v in ops.items()}
    a, b = fs.fold_groupnorm(t["x"], t["gn_scale"], t["gn_bias"], 4, 1e-5)
    wr, wc, ws = fs.kernel_weights(t["w_row"], t["w_col"], None, torch.float32)
    w = fs.stage_conv(t["x"], a, b, wr, wc, t["b_col"], ws, act="leaky_relu", leaky_slope=0.2)
    gate = [t[k] for k in ("pos_proj", "w1x", "b1", "w2", "b2")]
    l = fa.gate_logits_reference(w.reshape(2, H * H, 32), *gate, act="leaky_relu",
                                 leaky_slope=0.2)
    share = float((2 * torch.sigmoid(l) > 1.5).float().mean())
    assert 0.05 < share < 0.95, share


@pytest.mark.parametrize("resample", ["upsample", "downsample"])
def test_bf16_cast_placement_matches_jax_interpret(resample):
    """`stage_sigmoid_reference` rounds where `_kernel_sigmoid` does: w in
    bf16, the gated values cast to bf16, and under downsample those cast
    values pooled in f32. The port and JAX agree to one bf16 step. (Not
    bitwise: interpreted on the CPU, XLA's default excess precision keeps
    the kernel's in-register w in f32 for its gate; with
    --xla_allow_excess_precision=false the two are bitwise equal.)"""
    up = resample == "upsample"
    ops = operands("sigmoid", 32, 32, up, seed=11)
    kw = sigmoid_kw(up, not up, "leaky_relu", 1.5)
    jy, _ = jax_run(ops, kw, jnp.bfloat16)
    py, _ = port_run(ops, kw, torch.bfloat16)
    np.testing.assert_allclose(py, jy, rtol=0, atol=2.0 ** -7 * np.abs(jy).max())


def test_sigmoid_stage_wrapper_runs_its_plain_version_on_the_cpu():
    """`stage_sigmoid` on CPU tensors is `stage_sigmoid_reference` and
    counts no launch; under downsample it is the fine version pooled."""
    ops = operands("sigmoid", 16, 32, False, seed=12)
    t = {k: port_tensor(k, v) for k, v in ops.items()}
    a, b = fs.fold_groupnorm(t["x"], t["gn_scale"], t["gn_bias"], 4, 1e-5)
    wr, wc, ws = fs.kernel_weights(t["w_row"], t["w_col"], t["w_skip"], torch.float32)
    args = (t["x"], a, b, wr, wc, t["b_col"], ws, *(t[k] for k in ("pos_proj", "w1x", "b1",
                                                                   "w2", "b2")))
    kw = dict(act="leaky_relu", leaky_slope=0.2, gate_max=1.5)
    before = fs.stage_sigmoid.launches
    fine = fs.stage_sigmoid(*args, **kw)
    pooled = fs.stage_sigmoid(*args, downsample=True, **kw)
    assert fs.stage_sigmoid.launches == before
    assert torch.equal(fine, fs.stage_sigmoid_reference(*args, **kw))
    assert torch.equal(pooled, fs.down2x(fine))
    with pytest.raises(ValueError, match="mutually exclusive"):
        fs.stage_sigmoid(*args, upsample=True, downsample=True, **kw)


def test_oracle_backward_matches_the_hand_written_one():
    """`oracle_bwd=True` takes the vjp of `stage_oracle`; in f32 it agrees
    with the kernel chain's plain versions."""
    ops = operands("sigmoid", 16, 32, False, seed=13)
    kw = sigmoid_kw(False, True, "leaky_relu", 1.5)
    _, hand = port_run(ops, kw)
    _, oracle = port_run(ops, dict(kw, oracle_bwd=True))
    assert_grads_close(hand, oracle, "sigmoid", rtol=5e-5)
