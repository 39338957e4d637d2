"""The gate backward's mma route at the wide gates, (C, Hd, Cout) = (512,
128, 512), on the CPU: which calls `gate_bwd_route` sends there (bf16 with
HW a multiple of 16) and which stay on simt, what the wrappers refuse, the
grid and workspace of `bwd_wide_grid`, what chip_smoke.py expects of the
train steps and names of the kernels, and the plain backward of both gates
at that width against the JAX package's backward (its Pallas kernels in
interpret mode, as tests/test_torch_fused_attention_bwd.py runs them).

Tolerance of the parity cases, float32: 2e-5 relative, plus 2e-5 of each
leaf's largest magnitude absolute (tests/test_torch_fused_attention_bwd.py's;
the sums of the two frameworks run in other orders); a softmax gate's db2,
a near-cancelling sum, takes dW2's magnitude. The kernels themselves run on
the card only (tests/test_torch_kernels_gpu.py, `-k wide`)."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from locate_tpu.ops.pallas import fused_attention as jfa
from locate_tpu_torch.ops import fused_attention as fa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDE = (512, 128, 512)
NAMES = ("x", "pos_proj", "w1x", "b1", "w2", "b2")
# (N, HW) of the C = 512 gate calls of the main paths: lsun_bedroom_128 at
# batch 64, ffhq_512 (either gate) at batch 16
PATH_SHAPES = [(64, 16), (64, 64), (16, 16), (16, 64)]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("hw", [16, 64, 256])
def test_bf16_at_the_wide_template_takes_the_mma_route(hw):
    assert fa.GATE_WIDE == WIDE and fa.GATE_MMA_WIDTHS[WIDE] == 16
    assert fa.gate_bwd_route(torch.bfloat16, hw, *WIDE) == fa.MMA


@pytest.mark.parametrize("dtype,hw,c,hd,cout", [
    (torch.float32, 64, 512, 128, 512),    # f32 keeps f32 products
    (torch.bfloat16, 24, 512, 128, 512),   # 16 does not divide HW
    (torch.bfloat16, 100, 512, 128, 512),
    (torch.bfloat16, 64, 512, 128, 1),     # a gate broadcast over the channels
    (torch.bfloat16, 64, 512, 64, 512),    # Hd != 128
    (torch.bfloat16, 64, 256, 64, 256),    # the widths K1d and K1e take later
    (torch.bfloat16, 256, 128, 32, 128),
])
def test_other_wide_calls_take_the_simt_route(dtype, hw, c, hd, cout):
    assert fa.gate_bwd_route(dtype, hw, c, hd, cout) == fa.SIMT


def _gate(dtype, n=1, hw=16, c=512, hd=128, cout=512, seed=0):
    """(x, dy, pos_proj, w1x, b1, w2, b2, m, se, c) made with numpy, the
    weights scaled so that the logits vary by a few units."""
    rng = np.random.default_rng(seed)

    def r(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))

    x, dy = r(n, hw, c).to(dtype), r(n, hw, c).to(dtype)
    pp, w1, b1 = r(hw, hd, scale=0.5), r(c, hd, scale=c ** -0.5), r(hd, scale=0.1)
    w2, b2 = r(hd, cout, scale=3 * hd ** -0.5), r(cout, scale=0.1)
    kw = dict(act="leaky_relu", leaky_slope=0.2)
    m, se = fa.softmax_gate_stats_reference(x, pp, w1, b1, w2, b2, **kw)
    cs = fa.softmax_gate_csum_reference(x, dy, pp, w1, b1, w2, b2, m, se, hw_scale=float(hw),
                                        gate_max=16.0, **kw)
    return x, dy, pp, w1, b1, w2, b2, m, se, cs


def _backward(gate, ops, hw, **kw):
    opts = dict(act="leaky_relu", leaky_slope=0.2, gate_max=16.0, **kw)
    if gate == "softmax":
        return fa.softmax_gate_backward(*ops, hw_scale=float(hw), **opts)
    return fa.sigmoid_gate_backward(*ops[:7], **opts)


@pytest.mark.parametrize("gate", ["softmax", "sigmoid"])
def test_cpu_call_on_the_wide_mma_route_runs_the_plain_version(gate):
    """A CPU tensor runs the plain version on the mma route too, bitwise as
    on simt, and no launch is counted; the route it names is still
    checked."""
    wrapper = fa.softmax_gate_backward if gate == "softmax" else fa.sigmoid_gate_backward
    ops = _gate(torch.bfloat16)
    before = (wrapper.launches, wrapper.launches_mma, wrapper.launches_simt)
    got = _backward(gate, ops, 16, route=fa.MMA)
    for a, b in zip(got, _backward(gate, ops, 16, route=fa.SIMT)):
        assert torch.equal(a, b)
    assert (wrapper.launches, wrapper.launches_mma, wrapper.launches_simt) == before
    assert got[0].dtype == torch.bfloat16 and got[0].shape == (1, 16, 512)
    with pytest.raises(ValueError, match="mma route"):
        _backward(gate, _gate(torch.float32), 16, route=fa.MMA)


@pytest.mark.parametrize("n,hw", PATH_SHAPES)
def test_wide_grid_keeps_the_workspace_at_a_few_mb(n, hw):
    """The weight-gradient pass fills the grid with at most one split a
    stage of 64 locations, and the workspace is a few MB where the simt
    kernel's per-block slices take up to 135 MB."""
    splits, w_floats, pp_floats = fa.bwd_wide_grid(n, hw, *WIDE)
    rows, stages = n * hw, -(-n * hw // fa.GATE_WIDE_STAGE)
    assert 1 <= splits <= stages and splits * 32 <= fa._BWD_TARGET_BLOCKS
    assert w_floats == splits * 2 * 512 * 128 + rows // 16 * 512
    assert pp_floats == rows * 128 + rows * (2 * 128 + 512) // 2
    wide_bytes = 4 * (w_floats + pp_floats)
    t, per_block = fa.bwd_grid(n, hw, 512)
    blocks = -(-hw // t) * -(-n // per_block)
    simt_bytes = 4 * blocks * (2 * 512 * 128 + 128 + 512)
    assert wide_bytes < 16e6 and wide_bytes * 10 < simt_bytes


def test_wide_grid_at_the_largest_shape():
    assert fa.bwd_wide_grid(64, 64, *WIDE) == (8, 8 * 131072 + 256 * 512, 4096 * 512)
    assert fa.bwd_wide_grid(16, 16, *WIDE)[0] == 4  # four stages, a split each
    assert fa.bwd_wide_grid(1, 16, *WIDE)[0] == 1


@pytest.mark.parametrize("per_step,wide", [("BWD_PER_STEP", 7), ("FFHQ_BWD_PER_STEP", 7),
                                            ("SIGMOID_BWD_PER_STEP", 0)])
def test_seven_calls_a_step_take_the_wide_template(smoke, per_step, wide):
    """Each softmax train step runs the gate backward 7 times at C = 512
    (G's 4^2 once, D's 4^2 and 8^2 three times each), all of them on the
    mma route: 16 / 8 and 24 / 8 launches a step by route; the sigmoid
    step none (the card's profile runs the sigmoid gates up to 16^2 plain):
    17 / 3."""
    shapes = getattr(smoke, per_step)
    assert sum(k for (hw, c, hd), k in shapes.items() if (c, hd, c) == WIDE) == wide
    want = {"BWD_PER_STEP": {"mma": 16, "simt": 8}, "FFHQ_BWD_PER_STEP": {"mma": 24, "simt": 8},
            "SIGMOID_BWD_PER_STEP": {"mma": 17, "simt": 3}}[per_step]
    assert smoke.gate_routes_per_step(fa, shapes) == want


def test_chip_smoke_names_and_sizes_the_wide_kernels(smoke):
    """Phase 2 checks the wide template's three kernels by the names ptxas
    gives their instances; phases 4 and 15 record their grid and
    workspace."""
    inst = smoke.gate_mma_instances(fa)
    assert {k: v for k, v in inst.items() if "wide" in k} == {
        "softmax_bwd_wide_mma<512,128,512>": (0, WIDE),
        "sigmoid_bwd_wide_mma<512,128,512>": (1, WIDE),
        "gate_wgrad_wide_mma<512,128,512>": (2, WIDE)}
    mma = smoke.bwd_grid_of(fa, "mma", 64, 64, 512, 128)
    simt = smoke.bwd_grid_of(fa, "simt", 64, 64, 512, 128)
    assert mma["splits"] == 8 and mma["workspace_bytes"] < 16e6
    assert simt["workspace_bytes"] > 130e6  # 256 slices of 131,712 floats


def _parity_inputs(seed):
    """(x NHWC, pos_proj, w1x, b1, w2, b2) and dy at (2, 16, 512, 128, 512)."""
    rng = np.random.default_rng(seed)

    def r(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    c, hd = 512, 128
    arrays = (r(2, 4, 4, c), r(16, hd, scale=0.5), r(c, hd, scale=c ** -0.5),
              r(hd, scale=0.1), r(hd, c, scale=3 * hd ** -0.5), r(c, scale=0.1))
    return arrays, r(2, 4, 4, c)


def _assert_grads_close(got, want, mode):
    scale = {name: max(1.0, float(np.abs(b).max())) for name, b in zip(NAMES, want)}
    if mode == "softmax":
        scale["b2"] = max(scale["b2"], scale["w2"])  # the same dl terms, weighted by h
    for name, a, b in zip(NAMES, got, want):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-5 * scale[name], err_msg=name)


@pytest.mark.parametrize("mode,gate_max", [("softmax", 16.0), ("sigmoid", 1.5)])
def test_wide_backward_matches_jax_interpret(mode, gate_max):
    """f32 at (N, HW, C, Hd, Cout) = (2, 16, 512, 128, 512): the port's
    plain backward (what the card's kernels are held to) through
    `fused_locate_attention`, against the vjp of the JAX package's, whose
    backward runs its Pallas kernel (`_bwd_kernel_softmax` or
    `_bwd_kernel_sigmoid`) in interpret mode."""
    arrays, dy = _parity_inputs(seed=31 if mode == "softmax" else 32)
    kw = dict(mode=mode, act="leaky_relu", leaky_slope=0.2, gate_max=gate_max)
    inputs = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    y = fa.fused_locate_attention(*inputs, **kw)
    got = [g.numpy() for g in torch.autograd.grad(y, inputs, torch.from_numpy(dy))]
    _, vjp = jax.vjp(lambda *a: jfa.fused_locate_attention(*a, interpret=True, **kw),
                     *map(jnp.asarray, arrays))
    want = [np.asarray(g) for g in vjp(jnp.asarray(dy))]
    _assert_grads_close(got, want, mode)
    if mode == "sigmoid":  # the clamp binds at a part of the locations
        x = torch.from_numpy(arrays[0]).reshape(2, 16, 512)
        ops = [torch.from_numpy(a) for a in arrays[1:]]
        g = 2 * torch.sigmoid(fa.gate_logits_reference(x, *ops, act="leaky_relu",
                                                       leaky_slope=0.2))
        assert 0.05 < float((g > gate_max).float().mean()) < 0.95
