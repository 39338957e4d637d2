"""The port's CUDA location-attention kernels, forward and backward, against
their plain PyTorch versions, on the card (marker `gpu`; each test skips
without a card).

Run on a machine with an H100: `python -m pytest -m gpu tests/`.

Tolerances: in f32 the kernel and the plain version differ only in the
order of their f32 sums, so every output agrees to 1e-4 in norm-relative
error. In bf16 both round h and y to bf16 and may round a different way
where their f32 sums differ, so each is held against an f32 plain version
of the same inputs: the kernel's error may be at most twice the bf16
plain version's (the rule of scripts/bf16_kernel_sweep.py).
"""

import importlib.util
import math
import os

import pytest
import torch

from locate_tpu_torch.ops import fused_attention as fa

F32_TOL = 1e-4
BF16_FACTOR = 2.0

# (HW, C, Hd) of the six lsun_bedroom_128 generator stages
MAIN_SHAPES = [(16, 512, 128), (64, 256, 64), (256, 128, 32),
               (1024, 64, 16), (4096, 64, 16), (16384, 64, 16)]
# and the discriminator's stages that the generator does not have
D_SHAPES = [(1024, 128, 32), (256, 256, 64), (64, 512, 128)]
GRAD_NAMES = ("c", "dx", "dpos_proj", "dW1x", "db1", "dW2", "db2")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def make_inputs(n, hw, c, hd, cout, dtype, device, pos=True, seed=0):
    """Gate weights scaled so the gate varies and passes 16 where HW > 16."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(n, hw, c, generator=g)
    pp = torch.randn(hw, hd, generator=g) * 0.5 if pos else torch.zeros(hw, hd)
    w1 = torch.randn(c, hd, generator=g) / math.sqrt(c)
    b1 = torch.randn(hd, generator=g) * 0.1
    w2 = torch.randn(hd, cout, generator=g) * 3.0 / math.sqrt(hd)
    b2 = torch.randn(cout, generator=g) * 0.1
    return [t.to(device) for t in (x.to(dtype), pp, w1, b1, w2, b2)]


def rel_err(got, truth):
    got, truth = got.double(), truth.double()
    return float((got - truth).norm() / truth.norm().clamp_min(1e-12))


def run_both(ops, act, gate_max, hw, route=None):
    """(kernel (m, se, y), plain (m, se, y)) on the same inputs, the
    kernels on `route` (the wrappers' choice where None)."""
    kw = dict(act=act, leaky_slope=0.2)
    with torch.inference_mode():
        km, ks = fa.softmax_gate_stats(*ops, route=route, **kw)
        ky = fa.softmax_gate_apply(*ops, km, ks, hw_scale=float(hw),
                                   gate_max=gate_max, route=route, **kw)
        pm, ps = fa.softmax_gate_stats_reference(*ops, **kw)
        py = fa.softmax_gate_apply_reference(*ops, pm, ps, hw_scale=float(hw),
                                             gate_max=gate_max, **kw)
        torch.cuda.synchronize()
    return (km, ks, ky), (pm, ps, py)


def check_bf16(ops, act, gate_max, hw, route=None):
    kern, plain = run_both(ops, act, gate_max, hw, route)
    f32_ops = [ops[0].float()] + ops[1:]
    _, truth = run_both(f32_ops, act, gate_max, hw)
    for name, k, p, t in zip(("m", "se", "y"), kern, plain, truth):
        ek, ep = rel_err(k, t), rel_err(p, t)
        assert ek <= max(BF16_FACTOR * ep, 1e-6), (name, ek, ep)
    return kern, truth


@pytest.mark.gpu
@pytest.mark.parametrize("hw,c,hd", MAIN_SHAPES + D_SHAPES)
def test_main_path_shapes_bf16(cuda, hw, c, hd):
    ops = make_inputs(4, hw, c, hd, c, torch.bfloat16, cuda)
    _, truth = check_bf16(ops, "leaky_relu", 16.0, hw)
    if hw > 16:  # the clamp is reachable only when HW > gate_max
        pm, ps = fa.softmax_gate_stats_reference(
            ops[0].float(), *ops[1:], act="leaky_relu", leaky_slope=0.2)
        l = fa.gate_logits_reference(ops[0].float(), *ops[1:], act="leaky_relu",
                                     leaky_slope=0.2)
        assert (torch.exp(l - pm) / ps * hw > 16.0).any()


@pytest.mark.gpu
@pytest.mark.parametrize("act", ["leaky_relu", "relu", "silu", "gelu"])
@pytest.mark.parametrize("gate_max", [0.0, 16.0])
@pytest.mark.parametrize("per_channel", [True, False])
@pytest.mark.parametrize("pos", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_options(cuda, act, gate_max, per_channel, pos, dtype):
    hw, c, hd = 200, 48, 12  # a ragged last tile, C and Hd off the main path
    ops = make_inputs(3, hw, c, hd, c if per_channel else 1, dtype, cuda, pos=pos)
    if dtype == torch.bfloat16:
        check_bf16(ops, act, gate_max, hw)
        return
    kern, plain = run_both(ops, act, gate_max, hw)
    for name, k, p in zip(("m", "se", "y"), kern, plain):
        assert rel_err(k, p) <= F32_TOL, (name, rel_err(k, p))


@pytest.mark.gpu
@pytest.mark.parametrize("hw,c,hd", [(1, 8, 8), (7, 16, 8), (4096, 64, 16)])
def test_f32_shapes(cuda, hw, c, hd):
    ops = make_inputs(2, hw, c, hd, c, torch.float32, cuda, seed=3)
    kern, plain = run_both(ops, "leaky_relu", 16.0, hw)
    for name, k, p in zip(("m", "se", "y"), kern, plain):
        assert rel_err(k, p) <= F32_TOL, (name, rel_err(k, p))


@pytest.mark.gpu
def test_launch_counters_and_forward_only(cuda):
    """One forward launches stats and apply once; its backward, through the
    first-order Function, csum and backward once."""
    ops = make_inputs(2, 64, 32, 8, 32, torch.bfloat16, cuda)
    counters = (fa.softmax_gate_stats, fa.softmax_gate_apply, fa.softmax_gate_csum,
                fa.softmax_gate_backward)
    before = [f.launches for f in counters]
    with torch.inference_mode():
        fa.fused_locate_attention(ops[0].reshape(2, 8, 8, 32), *ops[1:], gate_max=16.0)
    assert [f.launches - b for f, b in zip(counters, before)] == [1, 1, 0, 0]
    w1 = ops[2].clone().requires_grad_(True)
    y = fa.fused_locate_attention(ops[0].reshape(2, 8, 8, 32), ops[1], w1, *ops[3:],
                                  gate_max=16.0)
    y.float().sum().backward()
    assert [f.launches - b for f, b in zip(counters, before)] == [2, 2, 1, 1]
    assert w1.grad is not None and bool(torch.isfinite(w1.grad).all())


def run_backward(ops, dy, act, gate_max, hw, kernel, route=None):
    """(c, dx, dpos_proj, dW1x, db1, dW2, db2): stats, csum and backward,
    all kernels (the backward on `route`, the wrapper's choice where None)
    or all plain versions."""
    kw = dict(act=act, leaky_slope=0.2)
    opts = dict(hw_scale=float(hw), gate_max=gate_max, **kw)
    if kernel:
        stats, csum = fa.softmax_gate_stats, fa.softmax_gate_csum

        def bwd(*args, **kw):
            return fa.softmax_gate_backward(*args, route=route, **kw)
    else:
        stats = fa.softmax_gate_stats_reference
        csum = fa.softmax_gate_csum_reference
        bwd = fa.softmax_gate_backward_reference
    with torch.no_grad():
        m, se = stats(*ops, **kw)
        c = csum(ops[0], dy, *ops[1:], m, se, **opts)
        out = (c, *bwd(ops[0], dy, *ops[1:], m, se, c, **opts))
        torch.cuda.synchronize()
    return out


def grad_errors(got, truth):
    """Norm-relative error of each gradient; db2 against dW2's norm."""
    errs = {}
    for name, g, t in zip(GRAD_NAMES, got, truth):
        scale = truth[5] if name == "db2" else t
        errs[name] = float((g.double() - t.double()).norm()
                           / scale.double().norm().clamp_min(1e-12))
    return errs


def check_backward(ops, dy, act, gate_max, hw, route=None):
    kern = run_backward(ops, dy, act, gate_max, hw, kernel=True, route=route)
    if ops[0].dtype == torch.float32:
        plain = run_backward(ops, dy, act, gate_max, hw, kernel=False)
        for name, e in grad_errors(kern, plain).items():
            assert e <= F32_TOL, (name, e)
        return kern
    plain = run_backward(ops, dy, act, gate_max, hw, kernel=False)
    truth = run_backward([ops[0].float()] + ops[1:], dy.float(), act, gate_max, hw,
                         kernel=False)
    ek, ep = grad_errors(kern, truth), grad_errors(plain, truth)
    for name in GRAD_NAMES:
        floor = 1e-3 if name == "db2" else 1e-6
        assert ek[name] <= max(BF16_FACTOR * ep[name], floor), (name, ek[name], ep[name])
    return kern


def make_dy(n, hw, c, dtype, device, seed=1):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randn(n, hw, c, generator=g).to(device=device, dtype=dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("hw,c,hd", MAIN_SHAPES + D_SHAPES)
def test_backward_main_path_shapes_bf16(cuda, hw, c, hd):
    ops = make_inputs(4, hw, c, hd, c, torch.bfloat16, cuda)
    check_backward(ops, make_dy(4, hw, c, torch.bfloat16, cuda), "leaky_relu", 16.0, hw)


@pytest.mark.gpu
@pytest.mark.parametrize("act", ["leaky_relu", "relu"])
@pytest.mark.parametrize("gate_max", [0.0, 16.0])
@pytest.mark.parametrize("per_channel", [True, False])
@pytest.mark.parametrize("pos", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_options(cuda, act, gate_max, per_channel, pos, dtype):
    hw, c, hd = 200, 48, 12  # a ragged last tile, C and Hd off the main path
    ops = make_inputs(3, hw, c, hd, c if per_channel else 1, dtype, cuda, pos=pos)
    check_backward(ops, make_dy(3, hw, c, dtype, cuda), act, gate_max, hw)


@pytest.mark.gpu
@pytest.mark.parametrize("n,hw,c,hd", [(64, 4096, 64, 16), (5, 16384, 64, 16),
                                       (64, 16, 512, 128)])
def test_backward_many_rows_per_block_f32(cuda, n, hw, c, hd):
    """Blocks that loop over several batch rows, a ragged last block of rows,
    and the largest weight-gradient workspace."""
    ops = make_inputs(n, hw, c, hd, c, torch.float32, cuda, seed=5)
    check_backward(ops, make_dy(n, hw, c, torch.float32, cuda), "leaky_relu", 16.0, hw)


@pytest.mark.gpu
def test_backward_is_bitwise_repeatable(cuda):
    ops = make_inputs(8, 1024, 64, 16, 64, torch.bfloat16, cuda)
    dy = make_dy(8, 1024, 64, torch.bfloat16, cuda)
    first = run_backward(ops, dy, "leaky_relu", 16.0, 1024, kernel=True)
    second = run_backward(ops, dy, "leaky_relu", 16.0, 1024, kernel=True)
    for name, a, b in zip(GRAD_NAMES, first, second):
        assert torch.equal(a, b), name


@pytest.mark.gpu
def test_relu_subgradient_at_zero_on_the_card(cuda):
    """u == 0 everywhere: the relu backward kernel uses grad 0 there."""
    n, hw, c, hd = 1, 16, 8, 8
    ops = [torch.zeros(n, hw, c, device=cuda), torch.zeros(hw, hd, device=cuda),
           torch.full((c, hd), 0.1, device=cuda), torch.zeros(hd, device=cuda),
           torch.full((hd, c), 0.1, device=cuda), torch.zeros(c, device=cuda)]
    grads = run_backward(ops, make_dy(n, hw, c, torch.float32, cuda), "relu", 0.0, hw,
                         kernel=True)
    assert torch.equal(grads[4], torch.zeros(hd, device=cuda))  # db1


@pytest.mark.gpu
def test_function_gradients_on_the_card(cuda):
    """Gradients of fused_locate_attention (kernels) against autograd of the
    plain composition, f32."""
    ops = make_inputs(2, 256, 32, 8, 32, torch.float32, cuda, seed=7)
    ops[0] = ops[0].reshape(2, 16, 16, 32)
    dy = make_dy(2, 256, 32, torch.float32, cuda).reshape(2, 16, 16, 32)
    inputs = [t.clone().requires_grad_(True) for t in ops]
    y = fa.fused_locate_attention(*inputs, gate_max=16.0)
    got = torch.autograd.grad(y, inputs, dy)
    ref = [t.clone().requires_grad_(True) for t in ops]
    y = fa.locate_attention_core_reference(
        ref[0].reshape(2, 256, 32), *ref[1:], mode="softmax", act="leaky_relu",
        leaky_slope=0.2, hw_scale=256.0, gate_max=16.0)
    want = torch.autograd.grad(y, ref, dy.reshape(2, 256, 32))
    for i, (g, w) in enumerate(zip(got, want)):
        scale = want[4] if i == 5 else w  # db2 against dW2, as above
        err = float((g.reshape(w.shape) - w).norm() / scale.norm().clamp_min(1e-12))
        assert err <= F32_TOL, (i, err)


def gate_route_counts():
    f = fa.softmax_gate_backward
    return f.launches, f.launches_mma, f.launches_simt


@pytest.mark.gpu
@pytest.mark.parametrize("gate_max", [16.0, 1.5])
@pytest.mark.parametrize("n,hw", [(2, 1024), (4, 4096)])
def test_gate_bwd_mma_route_against_plain(cuda, n, hw, gate_max):
    """softmax_bwd_mma (the wrapper's choice at bf16, C = 64, Hd = 16) and the
    simt kernel on the same inputs, each under the bf16 rule; at gate_max
    1.5 the clamp binds at a part of the locations."""
    ops = make_inputs(n, hw, 64, 16, 64, torch.bfloat16, cuda, seed=11)
    dy = make_dy(n, hw, 64, torch.bfloat16, cuda, seed=12)
    assert fa.gate_bwd_route(torch.bfloat16, hw, 64, 16, 64) == fa.MMA
    before = gate_route_counts()
    check_backward(ops, dy, "leaky_relu", gate_max, hw)
    after = gate_route_counts()
    assert (after[0] - before[0], after[1] - before[1], after[2] - before[2]) == (1, 1, 0)
    check_backward(ops, dy, "leaky_relu", gate_max, hw, route=fa.SIMT)
    assert gate_route_counts()[2] == after[2] + 1
    if gate_max < 16.0:
        with torch.no_grad():
            pm, ps = fa.softmax_gate_stats_reference(ops[0].float(), *ops[1:],
                                                     act="leaky_relu", leaky_slope=0.2)
            l = fa.gate_logits_reference(ops[0].float(), *ops[1:], act="leaky_relu",
                                         leaky_slope=0.2)
            share = float((torch.exp(l - pm) / ps * hw > gate_max).float().mean())
        assert 0.01 < share < 0.99, share


@pytest.mark.gpu
def test_gate_bwd_mma_relu_against_plain(cuda):
    ops = make_inputs(3, 2048, 64, 16, 64, torch.bfloat16, cuda, seed=13)
    check_backward(ops, make_dy(3, 2048, 64, torch.bfloat16, cuda), "relu", 0.0, 2048,
                   route=fa.MMA)


@pytest.mark.gpu
def test_gate_bwd_mma_is_bitwise_repeatable(cuda):
    ops = make_inputs(8, 4096, 64, 16, 64, torch.bfloat16, cuda, seed=14)
    dy = make_dy(8, 4096, 64, torch.bfloat16, cuda)
    first = run_backward(ops, dy, "leaky_relu", 16.0, 4096, kernel=True, route=fa.MMA)
    second = run_backward(ops, dy, "leaky_relu", 16.0, 4096, kernel=True, route=fa.MMA)
    for name, a, b in zip(GRAD_NAMES, first, second):
        assert torch.equal(a, b), name


@pytest.mark.gpu
def test_gate_bwd_mma_route_counters_after_one_gate(cuda):
    """One SoftmaxGate forward and backward at the template's widths: stats
    and apply once, csum once, the backward once on the mma route."""
    ops = make_inputs(2, 1024, 64, 16, 64, torch.bfloat16, cuda, seed=15)
    w1 = ops[2].clone().requires_grad_(True)
    before = gate_route_counts()
    y = fa.fused_locate_attention(ops[0].reshape(2, 32, 32, 64), ops[1], w1, *ops[3:],
                                  gate_max=16.0)
    y.float().sum().backward()
    after = gate_route_counts()
    assert tuple(a - b for a, b in zip(after, before)) == (1, 1, 0)
    assert w1.grad is not None and bool(torch.isfinite(w1.grad).all())


@pytest.mark.gpu
def test_gate_bwd_mma_refuses_a_wider_gate(cuda):
    """route="mma" at C = 128 raises in the wrapper; the C interface itself
    refuses a call the template cannot take (cudaErrorInvalidValue) before
    it reads an operand."""
    ops = make_inputs(2, 1024, 128, 32, 128, torch.bfloat16, cuda)
    dy = make_dy(2, 1024, 128, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="mma route"):
        run_backward(ops, dy, "leaky_relu", 16.0, 1024, kernel=True, route=fa.MMA)
    lib = fa._library()
    for bf16, hw, c, hd, cout, t in [(1, 1024, 128, 32, 128, 128), (0, 1024, 64, 16, 64, 128),
                                     (1, 1000, 64, 16, 64, 128), (1, 1024, 64, 16, 64, 64)]:
        err = lib.locate_softmax_bwd(1, bf16, *([None] * 15), 2, hw, c, hd, cout, t, 1, 0,
                                     0.2, float(hw), 16.0, None)
        assert err == 1, (bf16, hw, c, hd, cout, t, err)  # cudaErrorInvalidValue
    assert lib.locate_softmax_bwd_mma_smem_bytes(128, 32, 128) == 0
    assert lib.locate_softmax_bwd_mma_smem_bytes(64, 16, 64) <= fa._MAX_SMEM
    assert lib.locate_softmax_bwd_mma_blocks_per_sm(0, 64, 16, 64) >= 1
    assert lib.locate_softmax_bwd_mma_blocks_per_sm(1, 64, 16, 64) >= 1
    assert lib.locate_softmax_bwd_mma_blocks_per_sm(0, 128, 32, 128) == 0


# the forward pair's tensor-core route, bf16 at (C, Hd, Cout) = (64, 16, 64)

def fwd_route_counts():
    return tuple((f.launches, f.launches_mma, f.launches_simt)
                 for f in (fa.softmax_gate_stats, fa.softmax_gate_apply))


@pytest.mark.gpu
@pytest.mark.parametrize("gate_max", [0.0, 16.0, 1.5])
@pytest.mark.parametrize("n,hw", [(2, 1024), (64, 4096), (3, 16384)])
def test_gate_fwd_mma_route_against_plain(cuda, n, hw, gate_max):
    """softmax_stats_mma and softmax_apply_mma (the wrappers' choice at bf16,
    (64, 16, 64)) and the simt kernels on the same inputs, each under the
    bf16 rule; at batch 64 a block walks several tiles of a row (and the
    last block fewer); at gate_max 1.5 the clamp binds at a part of the
    locations."""
    ops = make_inputs(n, hw, 64, 16, 64, torch.bfloat16, cuda, seed=21)
    assert fa.gate_fwd_route(torch.bfloat16, hw, 64, 16, 64) == fa.MMA
    before = fwd_route_counts()
    check_bf16(ops, "leaky_relu", gate_max, hw)
    after = fwd_route_counts()
    # the bf16 call on the mma route, its f32 truth's on the simt route
    assert [tuple(a - b for a, b in zip(x, y)) for x, y in zip(after, before)] == [(2, 1, 1)] * 2
    check_bf16(ops, "leaky_relu", gate_max, hw, route=fa.SIMT)
    assert [c[2] for c in fwd_route_counts()] == [c[2] + 2 for c in after]


@pytest.mark.gpu
def test_gate_fwd_mma_relu_and_broadcast_pos(cuda):
    ops = make_inputs(3, 2048, 64, 16, 64, torch.bfloat16, cuda, pos=False, seed=22)
    check_bf16(ops, "relu", 16.0, 2048, route=fa.MMA)


@pytest.mark.gpu
def test_gate_fwd_mma_is_bitwise_repeatable(cuda):
    ops = make_inputs(16, 8192, 64, 16, 64, torch.bfloat16, cuda, seed=23)
    first, _ = run_both(ops, "leaky_relu", 16.0, 8192, fa.MMA)
    second, _ = run_both(ops, "leaky_relu", 16.0, 8192, fa.MMA)
    for name, a, b in zip(("m", "se", "y"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.gpu
def test_gate_fwd_mma_route_counters_after_one_gate(cuda):
    """One SoftmaxGate forward and backward at the template's widths: stats
    and apply once each on the mma route, the backward's mma route once."""
    ops = make_inputs(2, 1024, 64, 16, 64, torch.bfloat16, cuda, seed=25)
    w1 = ops[2].clone().requires_grad_(True)
    before, bwd = fwd_route_counts(), gate_route_counts()
    y = fa.fused_locate_attention(ops[0].reshape(2, 32, 32, 64), ops[1], w1, *ops[3:],
                                  gate_max=16.0)
    y.float().sum().backward()
    after = fwd_route_counts()
    assert [tuple(a - b for a, b in zip(x, y)) for x, y in zip(after, before)] == [(1, 1, 0)] * 2
    assert tuple(a - b for a, b in zip(gate_route_counts(), bwd)) == (1, 1, 0)


@pytest.mark.gpu
def test_gate_fwd_mma_refuses_an_unfit_call(cuda):
    """route="mma" where the template cannot take the call raises in the
    wrappers; the C interface itself refuses it (cudaErrorInvalidValue)
    before it reads an operand, and refuses an unknown route."""
    ops = make_inputs(2, 1024, 128, 32, 128, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="mma route"):
        run_both(ops, "leaky_relu", 16.0, 1024, fa.MMA)
    lib = fa._library()
    for route, bf16, hw, c, hd, cout, t in [
            (1, 1, 1024, 128, 32, 128, 128), (1, 0, 1024, 64, 16, 64, 128),
            (1, 1, 1000, 64, 16, 64, 128), (1, 1, 1024, 64, 16, 64, 64),
            (1, 1, 1024, 64, 16, 64, 0), (2, 1, 1024, 64, 16, 64, 128)]:
        err = lib.locate_softmax_stats(route, bf16, *([None] * 10), 2, hw, c, hd, cout, t, 0,
                                       0.2, None)
        assert err == 1, ("stats", route, bf16, hw, c, hd, cout, t, err)
        err = lib.locate_softmax_apply(route, bf16, *([None] * 9), 2, hw, c, hd, cout, t, 0,
                                       0.2, float(hw), 16.0, None)
        assert err == 1, ("apply", route, bf16, hw, c, hd, cout, t, err)
    for apply in (0, 1):
        assert lib.locate_softmax_fwd_mma_smem_bytes(apply, 128, 32, 128) == 0
        assert 0 < lib.locate_softmax_fwd_mma_smem_bytes(apply, 64, 16, 64) <= fa._MAX_SMEM
        assert lib.locate_softmax_fwd_mma_blocks_per_sm(apply, 64, 16, 64) >= 1
        assert lib.locate_softmax_fwd_mma_blocks_per_sm(apply, 512, 128, 512) == 0


# the csum pass on the forward body's tensor-core route, bf16 at (64, 16, 64)

def csum_route_counts():
    f = fa.softmax_gate_csum
    return f.launches, f.launches_mma, f.launches_simt


def run_csum(ops, dy, gate_max, hw, route=None, plain=False):
    """c from the plain statistics: the kernel on `route` (the wrapper's
    choice where None) or the plain version."""
    kw = dict(act="leaky_relu", leaky_slope=0.2)
    opts = dict(hw_scale=float(hw), gate_max=gate_max, **kw)
    with torch.no_grad():
        m, se = fa.softmax_gate_stats_reference(ops[0].float(), *ops[1:], **kw)
        if plain:
            c = fa.softmax_gate_csum_reference(ops[0], dy, *ops[1:], m, se, **opts)
        else:
            c = fa.softmax_gate_csum(ops[0], dy, *ops[1:], m, se, route=route, **opts)
        torch.cuda.synchronize()
    return c, m, se


def check_csum(ops, dy, gate_max, hw, route=None):
    """c on `route` under the bf16 rule, each error against the norm of c's
    absolute terms (c cancels over the locations)."""
    kern, m, se = run_csum(ops, dy, gate_max, hw, route)
    plain, _, _ = run_csum(ops, dy, gate_max, hw, plain=True)
    truth, _, _ = run_csum([ops[0].float()] + ops[1:], dy.float(), gate_max, hw, plain=True)
    with torch.no_grad():
        l = fa.gate_logits_reference(ops[0].float(), *ops[1:], act="leaky_relu",
                                     leaky_slope=0.2)
        scale = (torch.exp(l - m) / se * hw * (ops[0].float() * dy.float()).abs()).sum(1)
    err = [float((c.double() - truth.double()).norm() / scale.double().norm())
           for c in (kern, plain)]
    assert err[0] <= max(BF16_FACTOR * err[1], 1e-6), (route, err)
    return kern


@pytest.mark.gpu
@pytest.mark.parametrize("gate_max", [0.0, 16.0, 1.5])
@pytest.mark.parametrize("n,hw", [(2, 1024), (64, 4096), (3, 16384)])
def test_gate_csum_mma_route_against_plain(cuda, n, hw, gate_max):
    """softmax_csum_mma (the wrapper's choice at bf16, (64, 16, 64)) and the
    simt kernel on the same inputs, each under the bf16 rule; at batch 64 a
    block walks several tiles of a row; at gate_max 1.5 the clamp binds."""
    ops = make_inputs(n, hw, 64, 16, 64, torch.bfloat16, cuda, seed=51)
    dy = make_dy(n, hw, 64, torch.bfloat16, cuda, seed=52)
    assert fa.gate_fwd_route(torch.bfloat16, hw, 64, 16, 64) == fa.MMA
    before = csum_route_counts()
    check_csum(ops, dy, gate_max, hw)
    after = csum_route_counts()
    assert tuple(a - b for a, b in zip(after, before)) == (1, 1, 0)
    check_csum(ops, dy, gate_max, hw, route=fa.SIMT)
    assert tuple(a - b for a, b in zip(csum_route_counts(), after)) == (1, 0, 1)


@pytest.mark.gpu
def test_gate_csum_mma_is_bitwise_repeatable_and_faster(cuda):
    """Two runs bitwise equal; the mma route faster than the simt route in
    device time (CUDA graphs of the launches, chip_smoke's graph_ms: a
    wrapper's host time would hide the kernels') at ffhq_512's 256^2 gate."""
    ops = make_inputs(16, 65536, 64, 16, 64, torch.bfloat16, cuda, seed=53)
    dy = make_dy(16, 65536, 64, torch.bfloat16, cuda, seed=54)
    first, m, se = run_csum(ops, dy, 16.0, 65536, fa.MMA)
    assert torch.equal(first, run_csum(ops, dy, 16.0, 65536, fa.MMA)[0])
    kw = dict(act="leaky_relu", leaky_slope=0.2, hw_scale=65536.0, gate_max=16.0)
    with torch.no_grad():
        ms = {r: chip_smoke().graph_ms(lambda: fa.softmax_gate_csum(
            ops[0], dy, *ops[1:], m, se, route=r, **kw)) for r in (fa.MMA, fa.SIMT)}
    assert ms[fa.MMA] < ms[fa.SIMT], ms


@pytest.mark.gpu
def test_gate_csum_mma_counters_after_one_gate(cuda):
    """One SoftmaxGate forward and backward at the template's widths: stats,
    apply, csum and the backward each once on the mma route."""
    ops = make_inputs(2, 1024, 64, 16, 64, torch.bfloat16, cuda, seed=55)
    w1 = ops[2].clone().requires_grad_(True)
    before = (fwd_route_counts(), csum_route_counts(), gate_route_counts())
    y = fa.fused_locate_attention(ops[0].reshape(2, 32, 32, 64), ops[1], w1, *ops[3:],
                                  gate_max=16.0)
    y.float().sum().backward()
    after = (fwd_route_counts(), csum_route_counts(), gate_route_counts())
    assert [tuple(a - b for a, b in zip(x, y)) for x, y in zip(after[0], before[0])] == \
        [(1, 1, 0)] * 2
    for x, y in zip(after[1:], before[1:]):
        assert tuple(a - b for a, b in zip(x, y)) == (1, 1, 0)


@pytest.mark.gpu
def test_gate_csum_mma_refuses_an_unfit_call(cuda):
    """route="mma" where the template cannot take the call raises in the
    wrapper; the C interface refuses it (cudaErrorInvalidValue) before it
    reads an operand, and an unknown route; its occupancy and shared memory
    answer for the csum pass (x and dy staged: more than the pair's)."""
    ops = make_inputs(2, 1024, 128, 32, 128, torch.bfloat16, cuda)
    dy = make_dy(2, 1024, 128, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="mma route"):
        run_csum(ops, dy, 16.0, 1024, fa.MMA)
    lib = fa._library()
    for route, bf16, hw, c, hd, cout, t in [
            (1, 1, 1024, 128, 32, 128, 128), (1, 0, 1024, 64, 16, 64, 128),
            (1, 1, 1000, 64, 16, 64, 128), (1, 1, 1024, 64, 16, 64, 64),
            (1, 1, 1024, 64, 16, 64, 0), (2, 1, 1024, 64, 16, 64, 128)]:
        err = lib.locate_softmax_csum(route, bf16, *([None] * 11), 2, hw, c, hd, cout, t, 0,
                                      0.2, float(hw), 16.0, None)
        assert err == 1, (route, bf16, hw, c, hd, cout, t, err)
    pair = lib.locate_softmax_fwd_mma_smem_bytes(0, 64, 16, 64)
    assert pair < lib.locate_softmax_fwd_mma_smem_bytes(2, 64, 16, 64) <= fa._MAX_SMEM
    assert lib.locate_softmax_fwd_mma_smem_bytes(3, 64, 16, 64) == 0
    assert lib.locate_softmax_fwd_mma_blocks_per_sm(2, 64, 16, 64) >= 1
    assert lib.locate_softmax_fwd_mma_blocks_per_sm(2, 128, 32, 128) == 0


# the sigmoid gate's forward on the tensor cores at (512, 128, 512)

def sigmoid_gate_route_counts():
    f = fa.sigmoid_gate
    return f.launches, f.launches_mma, f.launches_simt


def check_sigmoid_gate(ops, gate_max, route=None):
    """y on `route` in bf16 under the rule of check_bf16."""
    kw = dict(act="leaky_relu", leaky_slope=0.2, gate_max=gate_max)
    with torch.no_grad():
        kern = fa.sigmoid_gate(*ops, route=route, **kw)
        plain = fa.sigmoid_gate_reference(*ops, **kw)
        truth = fa.sigmoid_gate_reference(ops[0].float(), *ops[1:], **kw)
        torch.cuda.synchronize()
    ek, ep = rel_err(kern, truth), rel_err(plain, truth)
    assert ek <= max(BF16_FACTOR * ep, 1e-6), (route, ek, ep)
    return kern


@pytest.mark.gpu
@pytest.mark.parametrize("gate_max", [0.0, 1.5])
@pytest.mark.parametrize("n,hw", [(16, 16), (16, 64), (3, 16)])
def test_sigmoid_gate_mma_route_against_plain(cuda, monkeypatch, n, hw, gate_max):
    """sigmoid_gate_wide_mma (the wrapper's choice at bf16, C = 512, Hd =
    128) at every split of Cout over blocks, and the simt kernel on the same
    inputs, each under the bf16 rule, each twice bitwise equal and every
    split bitwise equal to the others (one l, whatever the grid); 3 x 16
    rows leave the last location block one m-tile; at gate_max 1.5 the
    clamp binds."""
    ops = sigmoid_inputs(n, hw, 512, 128, 512, torch.bfloat16, cuda, seed=61)
    assert fa.sigmoid_gate_route(torch.bfloat16, hw, 512, 128, 512) == fa.MMA
    before = sigmoid_gate_route_counts()
    first = check_sigmoid_gate(ops, gate_max)
    assert tuple(a - b for a, b in zip(sigmoid_gate_route_counts(), before)) == (1, 1, 0)
    for k in (1, 2, 4, 8):
        monkeypatch.setattr(fa, "sigmoid_wide_splits", lambda n, hw, sms, k=k: k)
        assert torch.equal(check_sigmoid_gate(ops, gate_max), first), k
    monkeypatch.undo()
    simt = check_sigmoid_gate(ops, gate_max, route=fa.SIMT)
    assert torch.equal(simt, check_sigmoid_gate(ops, gate_max, route=fa.SIMT))


@pytest.mark.gpu
@pytest.mark.parametrize("hw", [16, 64])
def test_sigmoid_gate_mma_is_faster(cuda, hw):
    """The mma route faster than the simt route in device time (CUDA
    graphs, as above) at ffhq_512's two C = 512 shapes."""
    ops = sigmoid_inputs(16, hw, 512, 128, 512, torch.bfloat16, cuda, seed=62)
    kw = dict(act="leaky_relu", leaky_slope=0.2, gate_max=1.5)
    with torch.no_grad():
        ms = {r: chip_smoke().graph_ms(lambda: fa.sigmoid_gate(*ops, route=r, **kw))
              for r in (fa.MMA, fa.SIMT)}
    assert ms[fa.MMA] < ms[fa.SIMT], ms


@pytest.mark.gpu
def test_sigmoid_gate_mma_counters_after_one_gate(cuda):
    """One SigmoidGate forward and backward at the wide widths: the forward
    and the backward each once on the mma route."""
    ops = sigmoid_inputs(3, 16, 512, 128, 512, torch.bfloat16, cuda, seed=63)
    w1 = ops[2].clone().requires_grad_(True)
    before = (sigmoid_gate_route_counts(), sigmoid_route_counts())
    y = fa.fused_locate_attention(ops[0].reshape(3, 4, 4, 512), ops[1], w1, *ops[3:],
                                  mode="sigmoid", gate_max=1.5)
    y.float().sum().backward()
    for x, y in zip((sigmoid_gate_route_counts(), sigmoid_route_counts()), before):
        assert tuple(a - b for a, b in zip(x, y)) == (1, 1, 0)


@pytest.mark.gpu
def test_sigmoid_gate_mma_refuses_an_unfit_call(cuda):
    """The C interface takes the wide forward only for bf16 at (512, 128,
    512) with its 32-row block, HW a multiple of 16 and splits that divide
    Cout's 8 chunks; its occupancy and shared memory answer at that width
    only."""
    ops = sigmoid_inputs(2, 24, 512, 128, 512, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="mma route"):
        fa.sigmoid_gate(*ops, act="leaky_relu", leaky_slope=0.2, gate_max=1.5, route=fa.MMA)
    lib = fa._library()
    for route, bf16, hw, c, hd, cout, t, r in [
            (1, 0, 64, 512, 128, 512, 32, 8), (1, 1, 24, 512, 128, 512, 32, 8),
            (1, 1, 64, 512, 128, 512, 16, 8), (1, 1, 64, 512, 64, 512, 32, 8),
            (1, 1, 64, 512, 128, 512, 32, 0), (1, 1, 64, 512, 128, 512, 32, 3),
            (1, 1, 64, 512, 128, 512, 32, 16), (2, 1, 64, 512, 128, 512, 32, 8)]:
        err = lib.locate_sigmoid_gate(route, bf16, *([None] * 7), 2, hw, c, hd, cout, t, r, 0,
                                      0.2, 1.5, None)
        assert err == 1, (route, bf16, hw, c, hd, cout, t, r, err)
    assert 0 < lib.locate_sigmoid_gate_mma_smem_bytes(512, 128, 512) <= fa._MAX_SMEM
    assert lib.locate_sigmoid_gate_mma_smem_bytes(256, 64, 256) == 0
    assert lib.locate_sigmoid_gate_mma_blocks_per_sm(512, 128, 512) >= 1
    assert lib.locate_sigmoid_gate_mma_blocks_per_sm(64, 16, 64) == 0


# the wide template, (C, Hd, Cout) = (512, 128, 512): each gate at its
# path's batch (softmax: lsun_bedroom_128's 64; sigmoid: ffhq_512's 16) at
# the two C = 512 shapes, HW 16 and 64
WIDE_CASES = [("softmax", 64, 16), ("softmax", 64, 64), ("sigmoid", 16, 16),
              ("sigmoid", 16, 64)]


def wide_backward(gate, ops, dy, route):
    if gate == "softmax":
        return run_backward(ops, dy, "leaky_relu", 16.0, ops[0].shape[1], kernel=True,
                            route=route)
    return run_sigmoid_bwd(ops, dy, 1.5, True, route)


def event_ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@pytest.mark.gpu
@pytest.mark.parametrize("gate,n,hw", WIDE_CASES)
def test_gate_bwd_wide_mma_route_against_plain(cuda, gate, n, hw):
    """softmax_bwd_wide_mma / sigmoid_bwd_wide_mma with their weight-gradient
    pass (the wrapper's choice at bf16, C = 512, Hd = 128) and the simt
    kernel on the same inputs: each under the bf16 rule on every output,
    each twice bitwise equal; the mma route the faster."""
    ops = make_inputs(n, hw, 512, 128, 512, torch.bfloat16, cuda, seed=41)
    dy = make_dy(n, hw, 512, torch.bfloat16, cuda, seed=42)
    assert fa.gate_bwd_route(torch.bfloat16, hw, 512, 128, 512) == fa.MMA
    counts = gate_route_counts if gate == "softmax" else sigmoid_route_counts
    for route in (None, fa.SIMT):
        before = counts()
        if gate == "softmax":
            check_backward(ops, dy, "leaky_relu", 16.0, hw, route=route)
        else:
            check_sigmoid_bwd(ops, dy, 1.5, route=route)
        step = [b - a for a, b in zip(before, counts())]
        assert step == ([1, 1, 0] if route is None else [1, 0, 1]), (route, step)
        first, second = (wide_backward(gate, ops, dy, route) for _ in range(2))
        for a, b in zip(first, second):
            assert torch.equal(a, b), route
    with torch.no_grad():
        ms = {r: event_ms(lambda: wide_backward(gate, ops, dy, r)) for r in (fa.MMA, fa.SIMT)}
    assert ms[fa.MMA] < ms[fa.SIMT], ms


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["softmax", "sigmoid"])
def test_gate_bwd_wide_mma_route_counters_after_one_gate(cuda, mode):
    """One gate forward and backward at the wide widths (4 x 4 locations, a
    last block of one m-tile): the backward once on the mma route."""
    ops = make_inputs(3, 16, 512, 128, 512, torch.bfloat16, cuda, seed=43)
    w1 = ops[2].clone().requires_grad_(True)
    counts = gate_route_counts if mode == "softmax" else sigmoid_route_counts
    before = counts()
    y = fa.fused_locate_attention(ops[0].reshape(3, 4, 4, 512), ops[1], w1, *ops[3:],
                                  mode=mode, gate_max=1.5)
    y.float().sum().backward()
    assert tuple(a - b for a, b in zip(counts(), before)) == (1, 1, 0)
    assert w1.grad is not None and bool(torch.isfinite(w1.grad).all())


@pytest.mark.gpu
def test_gate_bwd_wide_mma_refuses_an_unfit_call(cuda):
    """The C interface takes the wide template only for bf16 at (512, 128,
    512) with its 32-row block and HW a multiple of 16, and at least one
    split; its occupancy and shared memory answer for its three kernels."""
    lib = fa._library()
    for bf16, hw, c, hd, cout, t, r in [(0, 64, 512, 128, 512, 32, 8),
                                        (1, 24, 512, 128, 512, 32, 8),
                                        (1, 64, 512, 128, 512, 16, 8),
                                        (1, 64, 512, 64, 512, 32, 8),
                                        (1, 64, 512, 128, 512, 32, 0)]:
        for fn, nptr in ((lib.locate_softmax_bwd, 15), (lib.locate_sigmoid_bwd, 12)):
            floats = (0.2, float(hw), 16.0) if nptr == 15 else (0.2, 16.0)
            err = fn(1, bf16, *([None] * nptr), 2, hw, c, hd, cout, t, r, 0, *floats, None)
            assert err == 1, (fn, bf16, hw, c, hd, cout, t, r, err)
    assert 0 < lib.locate_softmax_bwd_mma_smem_bytes(512, 128, 512) <= fa._MAX_SMEM
    for kind in (0, 1, 2):
        assert lib.locate_softmax_bwd_mma_blocks_per_sm(kind, 512, 128, 512) >= 1


# ---------------------------------------------------------------------------
# the fused-stage kernels (csrc/fused_stage.cu) against their plain versions
# ---------------------------------------------------------------------------

from locate_tpu_torch.ops import fused_stage as fs  # noqa: E402

STAGE_KW = dict(act="leaky_relu", leaky_slope=0.2)
# (C, Co, upsample, downsample)
STAGE_VARIANTS = [(32, 32, False, False), (16, 32, False, False), (32, 32, True, False),
                  (16, 32, True, False), (32, 32, False, True), (16, 32, False, True)]
BWD_NAMES = ("du", "dxs", "dWr", "dWc", "db_col", "dWskip")


def stage_inputs(n, hin, c, co, dtype, device, seed=0):
    """(x, a, b, wr, wc, b_col, ws) as the kernels take them, weights
    scaled to keep every stage output of order one."""
    g = torch.Generator(device="cpu").manual_seed(seed)

    def r(*shape, scale=0.1):
        return torch.randn(*shape, generator=g) * scale

    ws = r(c, co, scale=1 / math.sqrt(c)).to(dtype) if c != co else None
    out = [r(n, hin, hin, c, scale=1.0).to(dtype), 1 + r(n, c), r(n, c),
           r(3, c, co, scale=1 / math.sqrt(3 * c)).to(dtype),
           r(3, co, co, scale=1 / math.sqrt(3 * co)).to(dtype), r(co), ws]
    return [None if t is None else t.to(device) for t in out]


def stage_gate(hw, co, dtype, device, seed=1):
    """(pos_proj, w1x, b1, w2, b2) making the gate vary and reach 16."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    hd = max(8, co // 4)
    r = lambda *shape, scale=0.1: torch.randn(*shape, generator=g) * scale  # noqa: E731
    return [t.to(device) for t in (r(hw, hd, scale=0.5), r(co, hd, scale=1 / math.sqrt(co))
                                   .to(dtype), r(hd), r(hd, co, scale=3 / math.sqrt(hd))
                                   .to(dtype), r(co))]


def as_f32(ops):
    return [None if t is None else t.float() for t in ops]


def hold(name, kern, plain, truth, scale=None):
    """f32: within F32_TOL of the plain version; bf16: the kernel's error
    against an f32 plain computation at most twice the plain version's."""
    scale = truth if scale is None else scale
    if truth is None:
        diff = (kern.double() - plain.double()).norm()
        err = float(diff / plain.double().norm().clamp_min(1e-12))
        assert err <= F32_TOL, (name, err)
        return
    s = scale.double().norm().clamp_min(1e-12)
    ek = float((kern.double() - truth.double()).norm() / s)
    ep = float((plain.double() - truth.double()).norm() / s)
    assert ek <= max(BF16_FACTOR * ep, 1e-5), (name, ek, ep)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,co,up,dn", STAGE_VARIANTS)
def test_stage_forward_kernels(cuda, c, co, up, dn, dtype):
    n, hin = 2, (8 if up else 16)
    ops = stage_inputs(n, hin, c, co, dtype, cuda)
    f32 = dtype == torch.float32
    kw = dict(upsample=up, downsample=dn, **STAGE_KW)
    with torch.no_grad():
        hold("stage_conv", fs.stage_conv(*ops, **kw), fs.stage_conv_reference(*ops, **kw),
             None if f32 else fs.stage_conv_reference(*as_f32(ops), **kw))
        h = 2 * hin if up else hin
        gate = stage_gate(h * h, co, dtype, cuda)
        if not dn:
            kern = fs.stage_softmax_stats(*ops, *gate, upsample=up, **STAGE_KW)
            plain = fs.stage_softmax_stats_reference(*ops, *gate, upsample=up, **STAGE_KW)
            truth = (None,) * 3 if f32 else fs.stage_softmax_stats_reference(
                *as_f32(ops), *as_f32(gate), upsample=up, **STAGE_KW)
            for name, k, p, t in zip(("w_pre", "m", "se"), kern, plain, truth):
                hold(name, k, p, t)
        if not up:
            w_pre = fs.stage_conv_reference(*ops, **STAGE_KW)
            m, se = fa.softmax_gate_stats_reference(w_pre.reshape(n, h * h, co), *gate,
                                                    **STAGE_KW)
            opts = dict(hw_scale=float(h * h), gate_max=16.0, **STAGE_KW)
            hold("apply_pool", fs.stage_softmax_apply_pool(w_pre, *gate, m, se, **opts),
                 fs.stage_softmax_apply_pool_reference(w_pre, *gate, m, se, **opts),
                 None if f32 else fs.stage_softmax_apply_pool_reference(
                     w_pre.float(), *as_f32(gate), m, se, **opts))


def stage_bwd(ops, dw, up, plain, route=None):
    fn = fs.stage_conv_bwd_reference if plain else fs.stage_conv_bwd
    kw = {} if plain else dict(route=route)
    with torch.no_grad():
        out = fn(ops[0], dw, ops[1], ops[2], ops[3], ops[4], ops[6], upsample=up, **STAGE_KW,
                 **kw)
        torch.cuda.synchronize()
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,co,up", [(32, 32, False), (16, 32, False), (32, 32, True),
                                     (16, 32, True), (64, 64, False)])
def test_stage_conv_bwd_kernel(cuda, c, co, up, dtype):
    """du, dxs and the weight gradients against the plain backward; two
    runs bitwise equal."""
    n, hin = 3, (8 if up else 32)
    ops = stage_inputs(n, hin, c, co, dtype, cuda, seed=2)
    h = 2 * hin if up else hin
    g = torch.Generator(device="cpu").manual_seed(3)
    dw = torch.randn(n, h, h, co, generator=g).to(device=cuda, dtype=dtype)
    kern, again = stage_bwd(ops, dw, up, False), stage_bwd(ops, dw, up, False)
    plain = stage_bwd(ops, dw, up, True)
    truth = ((None,) * 6 if dtype == torch.float32
             else stage_bwd(as_f32(ops), dw.float(), up, True))
    for name, k, a, p, t in zip(BWD_NAMES, kern, again, plain, truth):
        if k is None:
            assert p is None and name == "dWskip"
            continue
        assert torch.equal(k, a), name
        hold(name, k, p, t)


@pytest.mark.gpu
@pytest.mark.parametrize("up", [True, False])
def test_stage_kernels_at_ffhq_512_shapes(cuda, up):
    """G's 512^2 stage (coarse 256^2 x 64 in) and D's (512^2 x 64 in), batch
    2, bf16: every kernel of the stage's forward and backward."""
    n = 2
    ops = stage_inputs(n, 256 if up else 512, 64, 64, torch.bfloat16, cuda, seed=4)
    gate = stage_gate(512 * 512, 64, torch.bfloat16, cuda, seed=5)
    with torch.no_grad():
        kern = fs.stage_softmax_stats(*ops, *gate, upsample=up, **STAGE_KW)
        plain = fs.stage_softmax_stats_reference(*ops, *gate, upsample=up, **STAGE_KW)
        truth = fs.stage_softmax_stats_reference(*as_f32(ops), *as_f32(gate), upsample=up,
                                                 **STAGE_KW)
        for name, k, p, t in zip(("w_pre", "m", "se"), kern, plain, truth):
            hold(name, k, p, t)
        if not up:
            opts = dict(hw_scale=512.0 * 512, gate_max=16.0, **STAGE_KW)
            w_pre, m, se = plain
            hold("apply_pool", fs.stage_softmax_apply_pool(w_pre, *gate, m, se, **opts),
                 fs.stage_softmax_apply_pool_reference(w_pre, *gate, m, se, **opts),
                 fs.stage_softmax_apply_pool_reference(w_pre.float(), *as_f32(gate), m, se,
                                                       **opts))
    dw = torch.randn(n, 512, 512, 64, device=cuda).to(torch.bfloat16)
    for name, k, p, t in zip(BWD_NAMES, stage_bwd(ops, dw, up, False),
                             stage_bwd(ops, dw, up, True),
                             stage_bwd(as_f32(ops), dw.float(), up, True)):
        if k is not None:
            hold(name, k, p, t)


def chip_smoke():
    """chip_smoke.py as a module, for its helpers (no phase runs)."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# the tensor-core (mma) route of stage_softmax_stats and stage_conv_bwd:
# (C, Co, upsample) of each template in both forms
MMA_STAGE_FORMS = [(64, 64, False), (64, 64, True), (32, 64, False), (32, 64, True)]


def route_counts(fn):
    return fn.launches_mma, fn.launches_simt


@pytest.mark.gpu
@pytest.mark.parametrize("c,co,up", MMA_STAGE_FORMS)
def test_stage_softmax_stats_mma_route(cuda, c, co, up):
    """bf16 on the mma route (the route's own choice) and on the simt route
    on the same inputs, each under the bf16 rule against the f32 plain
    version; the mma route twice, bitwise equal."""
    n, hin = 2, (16 if up else 32)
    h = 2 * hin if up else hin
    ops = stage_inputs(n, hin, c, co, torch.bfloat16, cuda, seed=9)
    gate = stage_gate(h * h, co, torch.bfloat16, cuda, seed=10)
    assert fs.stage_route(torch.bfloat16, c, co, skip=ops[6] is not None, h=h, w=h,
                          hd=gate[1].shape[1], cout=co) == fs.MMA
    kw = dict(upsample=up, **STAGE_KW)
    before = route_counts(fs.stage_softmax_stats)
    with torch.no_grad():
        kern = fs.stage_softmax_stats(*ops, *gate, **kw)
        again = fs.stage_softmax_stats(*ops, *gate, **kw)
        simt = fs.stage_softmax_stats(*ops, *gate, route="simt", **kw)
        plain = fs.stage_softmax_stats_reference(*ops, *gate, **kw)
        truth = fs.stage_softmax_stats_reference(*as_f32(ops), *as_f32(gate), **kw)
        torch.cuda.synchronize()
    after = route_counts(fs.stage_softmax_stats)
    assert (after[0] - before[0], after[1] - before[1]) == (2, 1)
    for name, k, a, sm, p, t in zip(("w_pre", "m", "se"), kern, again, simt, plain, truth):
        assert torch.equal(k, a), name
        hold(name, k, p, t)
        hold(name + " (simt)", sm, p, t)


@pytest.mark.gpu
@pytest.mark.parametrize("up", [False, True])
def test_stage_stats_and_gate_stats_share_one_l(cuda, up):
    """The fused stage's statistics (stage_softmax_stats_mma) against
    softmax_stats_mma on the pre-gate w the stage stores, with the same
    gate weights: both compute l by gate_mlp_mma from the same bf16 w, so
    m is bitwise equal and se equal up to the order of its f32 merges (at
    most one f32 step a tile and 128 more, chip_smoke's SE_ORDER_TOL)."""
    n, hin = 2, (32 if up else 64)
    h = 2 * hin if up else hin
    ops = stage_inputs(n, hin, 64, 64, torch.bfloat16, cuda, seed=26)
    gate = stage_gate(h * h, 64, torch.bfloat16, cuda, seed=27)
    with torch.no_grad():
        w_pre, m, se = fs.stage_softmax_stats(*ops, *gate, upsample=up, **STAGE_KW)
        m2, se2 = fa.softmax_gate_stats(w_pre.reshape(n, h * h, 64), *gate, route=fa.MMA,
                                        **STAGE_KW)
        torch.cuda.synchronize()
    assert torch.equal(m, m2)
    assert float(((se2 - se).abs() / se).max()) <= (h * h // 128 + 128) * 2.0 ** -24


@pytest.mark.gpu
@pytest.mark.parametrize("c,co,up", MMA_STAGE_FORMS)
def test_stage_conv_bwd_mma_route(cuda, c, co, up):
    """du, dxs and the weight gradients of the mma route and the simt route
    on the same bf16 inputs, under the bf16 rule against the f32 plain
    backward (each output on the scale of its absolute terms, as the sums
    cancel); the mma route twice, bitwise equal. Batch 3 at 64^2 gives
    the persistent blocks several tiles each and a ragged last share."""
    n, hin = 3, (32 if up else 64)
    h = 2 * hin if up else hin
    ops = stage_inputs(n, hin, c, co, torch.bfloat16, cuda, seed=11)
    g = torch.Generator(device="cpu").manual_seed(12)
    dw = torch.randn(n, h, h, co, generator=g).to(device=cuda, dtype=torch.bfloat16)
    before = route_counts(fs.stage_conv_bwd)
    kern, again = stage_bwd(ops, dw, up, False), stage_bwd(ops, dw, up, False)
    simt = stage_bwd(ops, dw, up, False, route="simt")
    after = route_counts(fs.stage_conv_bwd)
    assert (after[0] - before[0], after[1] - before[1]) == (2, 1)
    plain = stage_bwd(ops, dw, up, True)
    truth = stage_bwd(as_f32(ops), dw.float(), up, True)
    scales = chip_smoke().conv_bwd_scales(fs, ops, dw, up)
    for name, k, a, sm, p, t, sc in zip(BWD_NAMES, kern, again, simt, plain, truth, scales):
        if k is None:
            assert sm is None and p is None and name == "dWskip"
            continue
        assert torch.equal(k, a), name
        hold(name, k, p, t, sc)
        hold(name + " (simt)", sm, p, t, sc)


# the mma route of the two forward passes (stage_conv_mma,
# stage_sigmoid_mma): (C, Co, upsample, downsample) of each template's forms
MMA_FORWARD_FORMS = [(64, 64, False, False), (64, 64, True, False), (64, 64, False, True),
                     (32, 64, False, False), (32, 64, True, False), (32, 64, False, True)]


def apply_pool(w_pre, gate, stats, gate_max, plain=False, route=None):
    n, h, w, co = w_pre.shape
    kw = dict(hw_scale=float(h * w), gate_max=gate_max, **STAGE_KW)
    with torch.no_grad():
        if plain:
            return fs.stage_softmax_apply_pool_reference(w_pre, *gate, *stats, **kw)
        return fs.stage_softmax_apply_pool(w_pre, *gate, *stats, route=route, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("gate_max", [0.0, 16.0])
@pytest.mark.parametrize("n,h,w", [(2, 32, 32), (3, 64, 128), (1, 16, 48)])
def test_stage_apply_pool_mma_route(cuda, n, h, w, gate_max):
    """The pooled apply pass at (Co, Hd, Cout) = (64, 16, 64) in bf16 on the
    mma route (the wrapper's choice) and on the simt route on the same
    inputs, each under the bf16 rule against the f32 plain version (each
    path with the statistics of its own w_pre); the mma route twice,
    bitwise equal. Batch 3 at 64 x 128 leaves the persistent blocks a
    ragged last share and several images a block."""
    g = torch.Generator(device="cpu").manual_seed(25)
    w_pre = torch.randn(n, h, w, 64, generator=g).to(device=cuda, dtype=torch.bfloat16)
    gate = stage_gate(h * w, 64, torch.bfloat16, cuda, seed=26)
    assert fs.stage_route(torch.bfloat16, 64, 64, h=h, w=w, hd=16, cout=64) == fs.MMA
    stats, truth_stats = (fa.softmax_gate_stats_reference(t.reshape(n, h * w, 64), *gate,
                                                          **STAGE_KW)
                          for t in (w_pre, w_pre.float()))
    before = route_counts(fs.stage_softmax_apply_pool)
    kern = apply_pool(w_pre, gate, stats, gate_max)
    again = apply_pool(w_pre, gate, stats, gate_max, route=fs.MMA)
    simt = apply_pool(w_pre, gate, stats, gate_max, route=fs.SIMT)
    plain = apply_pool(w_pre, gate, stats, gate_max, plain=True)
    truth = apply_pool(w_pre.float(), as_f32(gate), truth_stats, gate_max, plain=True)
    torch.cuda.synchronize()
    after = route_counts(fs.stage_softmax_apply_pool)
    assert (after[0] - before[0], after[1] - before[1]) == (2, 1)
    assert kern.shape == (n, h // 2, w // 2, 64) and kern.dtype == torch.bfloat16
    assert torch.equal(kern, again)
    hold("stage_softmax_apply_pool", kern, plain, truth)
    hold("stage_softmax_apply_pool (simt)", simt, plain, truth)


@pytest.mark.gpu
def test_stage_apply_pool_mma_refuses_an_unfit_call(cuda):
    """route="mma" for f32 or Co = 32 raises in the wrapper; the C interface
    refuses what the template cannot take (cudaErrorInvalidValue) before it
    reads an operand; the library reports the block's bytes and blocks an
    SM on both routes."""
    w_pre = torch.zeros(2, 16, 32, 64, device=cuda)
    gate = stage_gate(16 * 32, 64, torch.float32, cuda)
    stats = fa.softmax_gate_stats_reference(w_pre.reshape(2, 512, 64), *gate, **STAGE_KW)
    with pytest.raises(ValueError, match="mma route"):
        apply_pool(w_pre, gate, stats, 16.0, route=fs.MMA)
    lib = fs._library()
    for route, bf16, h, w, co, hd, cout, th, tw in [(1, 0, 16, 32, 64, 16, 64, 8, 16),
                                                    (1, 1, 16, 32, 32, 8, 32, 8, 16),
                                                    (1, 1, 16, 32, 64, 32, 64, 8, 16),
                                                    (1, 1, 16, 32, 64, 16, 1, 8, 16),
                                                    (1, 1, 12, 32, 64, 16, 64, 8, 16),
                                                    (1, 1, 16, 32, 64, 16, 64, 4, 16),
                                                    (2, 1, 16, 32, 64, 16, 64, 8, 16)]:
        err = lib.locate_stage_softmax_apply_pool(route, bf16, *([None] * 9), 2, h, w, co, hd,
                                                  cout, th, tw, 0, 0.2, 512.0, 16.0, None)
        assert err == 1, (route, bf16, h, w, co, hd, cout, th, tw, err)
    nbytes = lib.locate_stage_smem_bytes(1, fs._APPLY_POOL, 64, 64, 16, 64, 8, 16)
    assert 0 < nbytes <= fa._MAX_SMEM
    assert lib.locate_stage_smem_bytes(1, fs._APPLY_POOL, 64, 64, 32, 64, 8, 16) == 0
    assert lib.locate_stage_blocks_per_sm(1, fs._APPLY_POOL, 64, 64, 16, 64, 8, 16) >= 2
    th, tw = fs.pick_tile(fs._APPLY_POOL, 512, 512, 64, 64, 16, 64, lib=lib)
    assert lib.locate_stage_blocks_per_sm(0, fs._APPLY_POOL, 64, 64, 16, 64, th, tw) >= 1


def stage_forward(kind, ops, gate, up, dn, plain=False, route=None):
    """stage_conv or stage_sigmoid (gate_max 1.5), or its plain version."""
    kw = dict(upsample=up, downsample=dn, **STAGE_KW)
    if not plain:
        kw["route"] = route
    with torch.no_grad():
        if kind == "conv":
            out = (fs.stage_conv_reference if plain else fs.stage_conv)(*ops, **kw)
        else:
            fn = fs.stage_sigmoid_reference if plain else fs.stage_sigmoid
            out = fn(*ops, *gate, gate_max=1.5, **kw)
        torch.cuda.synchronize()
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["conv", "sigmoid"])
@pytest.mark.parametrize("c,co,up,dn", MMA_FORWARD_FORMS)
def test_stage_forward_mma_route(cuda, kind, c, co, up, dn):
    """stage_conv and stage_sigmoid in bf16 on the mma route (the route's
    own choice) and on the simt route on the same inputs, each under the
    bf16 rule against the f32 plain version; the mma route twice, bitwise
    equal; one mma launch a call. Batch 3 at 128^2 fine gives 384 tiles:
    more than the persistent blocks, so a block takes several, and some
    one more than others."""
    n, h = 3, 128
    hin = h // 2 if up else h
    ops = stage_inputs(n, hin, c, co, torch.bfloat16, cuda, seed=16)
    gate = stage_gate(h * h, co, torch.bfloat16, cuda, seed=17)
    gate[3] = gate[3] / 3.0  # logits over a few units: gate_max 1.5 clamps a part
    fn = fs.stage_conv if kind == "conv" else fs.stage_sigmoid
    before = route_counts(fn)
    kern = stage_forward(kind, ops, gate, up, dn)
    again = stage_forward(kind, ops, gate, up, dn)
    simt = stage_forward(kind, ops, gate, up, dn, route="simt")
    after = route_counts(fn)
    assert (after[0] - before[0], after[1] - before[1]) == (2, 1)
    side = h // 2 if dn else h
    assert kern.shape == (n, side, side, co) and kern.dtype == torch.bfloat16
    assert torch.equal(kern, again)
    plain = stage_forward(kind, ops, gate, up, dn, plain=True)
    truth = stage_forward(kind, as_f32(ops), as_f32(gate), up, dn, plain=True)
    hold(kind, kern, plain, truth)
    hold(kind + " (simt)", simt, plain, truth)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["softmax", "sigmoid"])
@pytest.mark.parametrize("up,dn", [(True, False), (False, True)])
def test_fused_stage_routes_on_the_card(cuda, mode, up, dn):
    """One bf16 `fused_stage` forward plus backward at (C, Co) = (64, 64):
    the gated pass (stage_softmax_stats or stage_sigmoid), the backward's
    recompute of w (stage_conv) and the conv backward each launch once,
    all on the mma route; the outputs and gradients are finite."""
    n, c, h = 2, 64, 32
    ops = stage_inputs(n, h // 2 if up else h, c, c, torch.bfloat16, cuda, seed=18)
    gate = stage_gate(h * h, c, torch.float32, cuda, seed=19)
    g = torch.Generator(device="cpu").manual_seed(20)
    leaves = dict(x=ops[0], gn_scale=1 + torch.randn(c, generator=g).to(cuda) * 0.1,
                  gn_bias=torch.randn(c, generator=g).to(cuda) * 0.1,
                  w_row=ops[3].float().permute(2, 1, 0)[:, :, None, :].contiguous(),
                  w_col=ops[4].float().permute(2, 1, 0)[:, :, :, None].contiguous(),
                  b_col=ops[5])
    inputs = {k: v.clone().requires_grad_(True) for k, v in leaves.items()}
    routed = (fs.stage_conv, fs.stage_sigmoid, fs.stage_softmax_stats, fs.stage_conv_bwd)
    before = [route_counts(f) for f in routed]
    y = fs.fused_stage(*inputs.values(), None, groups=4, mode=mode, pos_proj=gate[0],
                       w1x=gate[1], b1=gate[2], w2=gate[3], b2=gate[4], gate_max=1.5,
                       upsample=up, downsample=dn, **STAGE_KW)
    dy = torch.randn(y.shape, generator=g).to(device=cuda, dtype=y.dtype)
    grads = torch.autograd.grad(y, list(inputs.values()), dy)
    moved = [(a[0] - b[0], a[1] - b[1]) for a, b in zip((route_counts(f) for f in routed),
                                                          before)]
    gated = (1, 0)
    assert moved == [(1, 0), gated if mode == "sigmoid" else (0, 0),
                     gated if mode == "softmax" else (0, 0), (1, 0)], moved
    assert torch.isfinite(y.float()).all()
    for name, gr in zip(inputs, grads):
        assert torch.isfinite(gr.float()).all(), name


@pytest.mark.gpu
def test_stage_forward_mma_launch_refuses_an_unfit_call(cuda):
    """The C interface's mma route refuses, before any launch, f32, widths
    no template takes, a missing 1x1 skip where C != Co and (sigmoid) a
    gate with Cout 1; its two forward kernels fit two blocks an SM at each
    template."""
    lib = fs._library()
    stream = torch.cuda.current_stream().cuda_stream
    buf = torch.zeros(1 << 20, device=cuda)
    p = buf.data_ptr()

    def conv(is_bf16, c, co, ws):
        return lib.locate_stage_conv(1, is_bf16, p, p, p, p, p, p, ws, p, 2, 16, 16, c, co, 8,
                                     16, 0, 0.2, 0, 0, stream)

    def sigmoid(c, co, hd, cout):
        return lib.locate_stage_sigmoid(1, 1, p, p, p, p, p, p, None, p, p, p, p, p, p, 2, 16,
                                        16, c, co, hd, cout, 8, 16, 0, 0.2, 1.5, 0, 0, stream)

    assert conv(0, 64, 64, None) != 0        # f32
    assert conv(1, 48, 64, p) != 0           # no template
    assert conv(1, 32, 64, None) != 0        # C != Co without its skip
    assert conv(1, 64, 64, p) != 0           # a skip where C == Co
    assert sigmoid(64, 64, 16, 1) != 0       # a gate shared by the channels
    assert sigmoid(64, 64, 8, 64) != 0       # Hd 8
    assert lib.locate_stage_conv(2, 1, p, p, p, p, p, p, None, p, 2, 16, 16, 64, 64, 8, 16, 0,
                                 0.2, 0, 0, stream) != 0  # no such route
    torch.cuda.synchronize()
    for c, co in fs.STAGE_MMA_WIDTHS:
        for kind, hd, cout in ((fs._CONV, 0, 0), (fs._SIGMOID, 16, co)):
            assert lib.locate_stage_blocks_per_sm(1, kind, c, co, hd, cout, 8, 16) >= 2


@pytest.mark.gpu
def test_stage_routes_refuse_and_f32_keeps_simt(cuda):
    """f32 takes the simt kernels; an explicit mma route that the call
    cannot take raises before any launch; the C interface refuses a call
    the mma templates do not hold."""
    ops = stage_inputs(2, 16, 64, 64, torch.float32, cuda, seed=13)
    dw = torch.randn(2, 16, 16, 64, device=cuda)
    before = route_counts(fs.stage_conv_bwd)
    stage_bwd(ops, dw, False, False)
    after = route_counts(fs.stage_conv_bwd)
    assert (after[0] - before[0], after[1] - before[1]) == (0, 1)
    with pytest.raises(ValueError, match="mma route"):
        stage_bwd(ops, dw, False, False, route="mma")
    lib = fs._library()
    assert lib.locate_stage_smem_bytes(1, fs._BWD, 48, 64, 0, 0, 8, 16) == 0
    assert lib.locate_stage_smem_bytes(1, fs._STATS, 64, 64, 32, 64, 8, 16) == 0
    assert lib.locate_stage_smem_bytes(1, fs._CONV, 48, 64, 0, 0, 8, 16) == 0
    assert lib.locate_stage_smem_bytes(1, fs._SIGMOID, 64, 64, 16, 1, 8, 16) == 0
    assert lib.locate_stage_smem_bytes(1, fs._APPLY_POOL, 64, 64, 32, 64, 8, 16) == 0
    assert lib.locate_stage_smem_bytes(1, fs._APPLY_POOL, 32, 32, 8, 32, 8, 16) == 0
    assert lib.locate_stage_smem_bytes(1, fs._APPLY_POOL, 64, 64, 16, 64, 8, 16) > 0
    assert lib.locate_stage_blocks_per_sm(1, fs._BWD, 64, 64, 0, 0, 8, 16) >= 1
    assert lib.locate_stage_blocks_per_sm(1, fs._STATS, 32, 64, 16, 64, 8, 16) >= 1
    # f32 x on the mma route: refused by the library itself (cudaErrorInvalidValue)
    x = ops[0].contiguous()
    err = lib.locate_stage_conv_bwd(1, 0, *[x.data_ptr()] * 14, 2, 16, 16, 64, 64, 8, 16, 1,
                                    0, 0.2, 0, torch.cuda.current_stream().cuda_stream)
    assert err != 0


@pytest.mark.gpu
@pytest.mark.parametrize("up,dn", [(True, False), (False, True)])
def test_fused_stage_function_on_the_card(cuda, up, dn):
    """Gradients of `fused_stage` (the kernels and the gate's kernels) on
    the card against autograd of `stage_oracle` on the card, f32, each
    gradient to F32_TOL of its own scale; and the launches of one forward
    and one backward."""
    n, c, co, h = 2, 16, 32, 16
    ops = stage_inputs(n, h // 2 if up else h, c, co, torch.float32, cuda, seed=6)
    gate = stage_gate(h * h, co, torch.float32, cuda, seed=7)
    g = torch.Generator(device="cpu").manual_seed(8)
    leaves = dict(x=ops[0], gn_scale=1 + torch.randn(c, generator=g).to(cuda) * 0.1,
                  gn_bias=torch.randn(c, generator=g).to(cuda) * 0.1,
                  w_row=ops[3].permute(2, 1, 0)[:, :, None, :].contiguous(),
                  w_col=ops[4].permute(2, 1, 0)[:, :, :, None].contiguous(), b_col=ops[5],
                  w_skip=ops[6].t()[:, :, None, None].contiguous(),
                  pos_proj=gate[0], w1x=gate[1], b1=gate[2], w2=gate[3], b2=gate[4])
    kw = dict(groups=4, mode="softmax", gate_max=16.0, upsample=up, downsample=dn,
              **STAGE_KW)
    side = h // 2 if dn else h
    dy = torch.randn(n, side, side, co, generator=g).to(cuda)
    counters = (fs.stage_conv, fs.stage_softmax_stats, fs.stage_softmax_apply_pool,
                fs.stage_conv_bwd, fa.softmax_gate_apply, fa.softmax_gate_stats,
                fa.softmax_gate_csum, fa.softmax_gate_backward)
    before = [f.launches for f in counters]
    inputs = {k: v.clone().requires_grad_(True) for k, v in leaves.items()}
    y = fs.fused_stage(inputs["x"], *(inputs[k] for k in fs._NAMES[1:7]),
                       **{k: inputs[k] for k in fs._NAMES[7:]}, **kw)
    got = torch.autograd.grad(y, list(inputs.values()), dy)
    launched = [f.launches - b for f, b in zip(counters, before)]
    # forward: stats, then apply (G) or apply-pool (D); backward: conv
    # recompute, the gate's stats, csum and backward, then conv backward
    assert launched == [1, 1, int(dn), 1, int(up), 1, 1, 1], launched
    ref = {k: v.clone().requires_grad_(True) for k, v in leaves.items()}
    y_ref = fs.stage_oracle(ref, h=h, w=h, groups=4, eps=1e-5, act="leaky_relu",
                            leaky_slope=0.2, mode="softmax", gate_max=16.0, upsample=up,
                            downsample=dn)
    want = torch.autograd.grad(y_ref, list(ref.values()), dy)
    assert float((y - y_ref).detach().norm() / y_ref.detach().norm()) <= F32_TOL
    for name, gk, gw in zip(leaves, got, want):
        scale = want[-2] if name == "b2" else gw  # db2 against dW2, as above
        err = float((gk - gw).norm() / scale.norm().clamp_min(1e-12))
        assert err <= F32_TOL, (name, err)


# ---------------------------------------------------------------------------
# the sigmoid gate's kernels (sigmoid_gate, sigmoid_bwd, stage_sigmoid)
# ---------------------------------------------------------------------------

SIGMOID_NAMES = ("dx", "dpos_proj", "dW1x", "db1", "dW2", "db2")


def sigmoid_inputs(n, hw, c, hd, cout, dtype, device, seed=0):
    """Gate weights whose logits spread over a few units, so that gate_max
    1.5 clamps a part of the locations."""
    ops = make_inputs(n, hw, c, hd, cout, dtype, device, seed=seed)
    ops[4] = ops[4] / 3.0
    return ops


def run_sigmoid(ops, dy, act, gate_max, kernel):
    """(y, dx, dpos_proj, dW1x, db1, dW2, db2): the forward and the
    backward, kernels or plain versions."""
    kw = dict(act=act, leaky_slope=0.2, gate_max=gate_max)
    if kernel:
        fwd, bwd = fa.sigmoid_gate, fa.sigmoid_gate_backward
    else:
        fwd, bwd = fa.sigmoid_gate_reference, fa.sigmoid_gate_backward_reference
    with torch.no_grad():
        out = (fwd(*ops, **kw), *bwd(ops[0], dy, *ops[1:], **kw))
        torch.cuda.synchronize()
    return out


def check_sigmoid(ops, dy, act, gate_max):
    kern = run_sigmoid(ops, dy, act, gate_max, kernel=True)
    plain = run_sigmoid(ops, dy, act, gate_max, kernel=False)
    names = ("y",) + SIGMOID_NAMES
    if ops[0].dtype == torch.float32:
        for name, k, p in zip(names, kern, plain):
            assert rel_err(k, p) <= F32_TOL, (name, rel_err(k, p))
        return kern
    truth = run_sigmoid([ops[0].float()] + ops[1:], dy.float(), act, gate_max, kernel=False)
    for name, k, p, t in zip(names, kern, plain, truth):
        ek, ep = rel_err(k, t), rel_err(p, t)
        assert ek <= max(BF16_FACTOR * ep, 1e-6), (name, ek, ep)
    return kern


@pytest.mark.gpu
@pytest.mark.parametrize("hw,c,hd", [(16, 512, 128), (64, 256, 64), (256, 128, 32),
                                     (4096, 64, 16)])
def test_sigmoid_kernels_at_ffhq_512_shapes_bf16(cuda, hw, c, hd):
    """The three standalone-gate shapes of ffhq_512 (its stages up to 16^2)
    and the 512^2 stage's backward shape (Hd 16), cut to 4096 locations."""
    ops = sigmoid_inputs(4, hw, c, hd, c, torch.bfloat16, cuda)
    check_sigmoid(ops, make_dy(4, hw, c, torch.bfloat16, cuda), "leaky_relu", 1.5)
    l = fa.gate_logits_reference(ops[0].float(), *ops[1:], act="leaky_relu", leaky_slope=0.2)
    share = float((2 * torch.sigmoid(l) > 1.5).float().mean())
    assert 0.05 < share < 0.95, share


@pytest.mark.gpu
@pytest.mark.parametrize("act", ["leaky_relu", "relu"])
@pytest.mark.parametrize("gate_max", [0.0, 1.5])
@pytest.mark.parametrize("per_channel", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sigmoid_kernel_options(cuda, act, gate_max, per_channel, dtype):
    hw, c, hd = 200, 48, 12  # a ragged last tile, C and Hd off the main path
    ops = sigmoid_inputs(3, hw, c, hd, c if per_channel else 1, dtype, cuda, seed=2)
    check_sigmoid(ops, make_dy(3, hw, c, dtype, cuda), act, gate_max)


@pytest.mark.gpu
def test_sigmoid_backward_is_bitwise_repeatable(cuda):
    ops = sigmoid_inputs(16, 1024, 64, 16, 64, torch.bfloat16, cuda, seed=3)
    dy = make_dy(16, 1024, 64, torch.bfloat16, cuda)
    first = run_sigmoid(ops, dy, "leaky_relu", 1.5, kernel=True)
    second = run_sigmoid(ops, dy, "leaky_relu", 1.5, kernel=True)
    for name, a, b in zip(("y",) + SIGMOID_NAMES, first, second):
        assert torch.equal(a, b), name


@pytest.mark.gpu
def test_sigmoid_function_on_the_card(cuda):
    """Gradients of fused_locate_attention(mode="sigmoid") (the kernels)
    against autograd of the plain composition, f32, and its launches."""
    ops = sigmoid_inputs(2, 256, 32, 8, 32, torch.float32, cuda, seed=7)
    ops[0] = ops[0].reshape(2, 16, 16, 32)
    dy = make_dy(2, 256, 32, torch.float32, cuda).reshape(2, 16, 16, 32)
    counters = (fa.sigmoid_gate, fa.sigmoid_gate_backward, fa.softmax_gate_stats)
    before = [f.launches for f in counters]
    inputs = [t.clone().requires_grad_(True) for t in ops]
    y = fa.fused_locate_attention(*inputs, mode="sigmoid", gate_max=1.5)
    got = torch.autograd.grad(y, inputs, dy)
    assert [f.launches - b for f, b in zip(counters, before)] == [1, 1, 0]
    ref = [t.clone().requires_grad_(True) for t in ops]
    y_ref = fa.locate_attention_core_reference(
        ref[0].reshape(2, 256, 32), *ref[1:], mode="sigmoid", act="leaky_relu",
        leaky_slope=0.2, hw_scale=1.0, gate_max=1.5)
    want = torch.autograd.grad(y_ref, ref, dy.reshape(2, 256, 32))
    assert rel_err(y.detach().reshape(y_ref.shape), y_ref.detach()) <= F32_TOL
    for i, (g, w) in enumerate(zip(got, want)):
        assert rel_err(g.reshape(w.shape), w) <= F32_TOL, i


def sigmoid_route_counts():
    f = fa.sigmoid_gate_backward
    return f.launches, f.launches_mma, f.launches_simt


def run_sigmoid_bwd(ops, dy, gate_max, kernel, route=None):
    """(dx, dpos_proj, dW1x, db1, dW2, db2) of the sigmoid gate: the kernel
    on `route` (the wrapper's choice where None) or the plain version."""
    kw = dict(act="leaky_relu", leaky_slope=0.2, gate_max=gate_max)
    with torch.no_grad():
        if kernel:
            out = fa.sigmoid_gate_backward(ops[0], dy, *ops[1:], route=route, **kw)
        else:
            out = fa.sigmoid_gate_backward_reference(ops[0], dy, *ops[1:], **kw)
        torch.cuda.synchronize()
    return out


def check_sigmoid_bwd(ops, dy, gate_max, route=None):
    """The backward on `route` in bf16 under the rule of check_sigmoid."""
    kern = run_sigmoid_bwd(ops, dy, gate_max, True, route)
    plain = run_sigmoid_bwd(ops, dy, gate_max, False)
    truth = run_sigmoid_bwd([ops[0].float()] + ops[1:], dy.float(), gate_max, False)
    for name, k, p, t in zip(SIGMOID_NAMES, kern, plain, truth):
        ek, ep = rel_err(k, t), rel_err(p, t)
        assert ek <= max(BF16_FACTOR * ep, 1e-6), (name, route, ek, ep)
    return kern


@pytest.mark.gpu
@pytest.mark.parametrize("gate_max", [0.0, 1.5])
@pytest.mark.parametrize("n,hw", [(2, 1024), (4, 4096)])
def test_sigmoid_bwd_mma_route_against_plain(cuda, n, hw, gate_max):
    """sigmoid_bwd_mma (the wrapper's choice at bf16, C = 64, Hd = 16) and
    the simt kernel on the same inputs, each under the bf16 rule; at
    gate_max 1.5 the clamp binds at a part of the locations."""
    ops = sigmoid_inputs(n, hw, 64, 16, 64, torch.bfloat16, cuda, seed=21)
    dy = make_dy(n, hw, 64, torch.bfloat16, cuda, seed=22)
    assert fa.gate_bwd_route(torch.bfloat16, hw, 64, 16, 64) == fa.MMA
    before = sigmoid_route_counts()
    check_sigmoid_bwd(ops, dy, gate_max)
    after = sigmoid_route_counts()
    assert tuple(a - b for a, b in zip(after, before)) == (1, 1, 0)
    check_sigmoid_bwd(ops, dy, gate_max, route=fa.SIMT)
    assert sigmoid_route_counts()[2] == after[2] + 1
    if gate_max:
        l = fa.gate_logits_reference(ops[0].float(), *ops[1:], act="leaky_relu",
                                     leaky_slope=0.2)
        share = float((2 * torch.sigmoid(l) > gate_max).float().mean())
        assert 0.05 < share < 0.95, share


@pytest.mark.gpu
def test_sigmoid_bwd_mma_is_bitwise_repeatable(cuda):
    ops = sigmoid_inputs(8, 4096, 64, 16, 64, torch.bfloat16, cuda, seed=23)
    dy = make_dy(8, 4096, 64, torch.bfloat16, cuda)
    first = run_sigmoid_bwd(ops, dy, 1.5, True, fa.MMA)
    second = run_sigmoid_bwd(ops, dy, 1.5, True, fa.MMA)
    for name, a, b in zip(SIGMOID_NAMES, first, second):
        assert torch.equal(a, b), name


@pytest.mark.gpu
def test_sigmoid_bwd_mma_route_counters_after_one_gate(cuda):
    """One SigmoidGate forward and backward at the template's widths: the
    backward once on the mma route."""
    ops = sigmoid_inputs(2, 1024, 64, 16, 64, torch.bfloat16, cuda, seed=24)
    w1 = ops[2].clone().requires_grad_(True)
    before = sigmoid_route_counts()
    y = fa.fused_locate_attention(ops[0].reshape(2, 32, 32, 64), ops[1], w1, *ops[3:],
                                  mode="sigmoid", gate_max=1.5)
    y.float().sum().backward()
    assert tuple(a - b for a, b in zip(sigmoid_route_counts(), before)) == (1, 1, 0)
    assert w1.grad is not None and bool(torch.isfinite(w1.grad).all())


@pytest.mark.gpu
def test_sigmoid_bwd_mma_refuses_an_unfit_call(cuda):
    """route="mma" at C = 128 raises in the wrapper; the C interface refuses
    a call the template cannot take (cudaErrorInvalidValue) before it reads
    an operand, and route codes other than 0 and 1."""
    ops = sigmoid_inputs(2, 1024, 128, 32, 128, torch.bfloat16, cuda)
    dy = make_dy(2, 1024, 128, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="mma route"):
        run_sigmoid_bwd(ops, dy, 1.5, True, fa.MMA)
    lib = fa._library()
    for route, bf16, hw, c, hd, cout, t in [(1, 1, 1024, 128, 32, 128, 128),
                                            (1, 0, 1024, 64, 16, 64, 128),
                                            (1, 1, 1000, 64, 16, 64, 128),
                                            (1, 1, 1024, 64, 16, 64, 64),
                                            (2, 1, 1024, 64, 16, 64, 128)]:
        err = lib.locate_sigmoid_bwd(route, bf16, *([None] * 12), 2, hw, c, hd, cout, t, 1, 0,
                                     0.2, 1.5, None)
        assert err == 1, (route, bf16, hw, c, hd, cout, t, err)


def sigmoid_stage(ops, gate, up, dn, plain, gate_max=1.5):
    fn = fs.stage_sigmoid_reference if plain else fs.stage_sigmoid
    with torch.no_grad():
        return fn(*ops, *gate, upsample=up, downsample=dn, gate_max=gate_max, **STAGE_KW)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,co,up,dn", STAGE_VARIANTS)
@pytest.mark.parametrize("per_channel", [True, False])
def test_stage_sigmoid_kernel(cuda, c, co, up, dn, dtype, per_channel):
    n, hin = 2, (8 if up else 16)
    ops = stage_inputs(n, hin, c, co, dtype, cuda, seed=9)
    h = 2 * hin if up else hin
    gate = stage_gate(h * h, co, dtype, cuda, seed=10)
    gate[3] = gate[3] / 3.0  # logits over a few units: gate_max 1.5 clamps a part
    if not per_channel:
        gate[3], gate[4] = gate[3][:, :1].contiguous(), gate[4][:1].contiguous()
    kern = sigmoid_stage(ops, gate, up, dn, plain=False)
    plain = sigmoid_stage(ops, gate, up, dn, plain=True)
    truth = None if dtype == torch.float32 else sigmoid_stage(as_f32(ops), as_f32(gate), up,
                                                              dn, plain=True)
    hold("stage_sigmoid", kern, plain, truth)


@pytest.mark.gpu
@pytest.mark.parametrize("up", [True, False])
def test_stage_sigmoid_at_ffhq_512_shapes(cuda, up):
    """G's 512^2 stage (`up`, coarse 256^2 x 64 in) and D's (`down`), batch
    2, bf16, gate_max 1.5 and the preset's 16."""
    n = 2
    ops = stage_inputs(n, 256 if up else 512, 64, 64, torch.bfloat16, cuda, seed=11)
    gate = stage_gate(512 * 512, 64, torch.bfloat16, cuda, seed=12)
    for gate_max in (1.5, 16.0):
        hold("stage_sigmoid", sigmoid_stage(ops, gate, up, not up, False, gate_max),
             sigmoid_stage(ops, gate, up, not up, True, gate_max),
             sigmoid_stage(as_f32(ops), as_f32(gate), up, not up, True, gate_max))


@pytest.mark.gpu
@pytest.mark.parametrize("up,dn", [(True, False), (False, True)])
def test_sigmoid_fused_stage_function_on_the_card(cuda, up, dn):
    """Gradients of `fused_stage(mode="sigmoid")` on the card against
    autograd of `stage_oracle`, f32, and the launches of one forward and
    one backward: the stage's one pass, then the conv recompute, the
    gate's one-pass backward and the conv backward."""
    n, c, co, h = 2, 16, 32, 16
    ops = stage_inputs(n, h // 2 if up else h, c, co, torch.float32, cuda, seed=13)
    gate = stage_gate(h * h, co, torch.float32, cuda, seed=14)
    gate[3] = gate[3] / 3.0
    g = torch.Generator(device="cpu").manual_seed(15)
    leaves = dict(x=ops[0], gn_scale=1 + torch.randn(c, generator=g).to(cuda) * 0.1,
                  gn_bias=torch.randn(c, generator=g).to(cuda) * 0.1,
                  w_row=ops[3].permute(2, 1, 0)[:, :, None, :].contiguous(),
                  w_col=ops[4].permute(2, 1, 0)[:, :, :, None].contiguous(), b_col=ops[5],
                  w_skip=ops[6].t()[:, :, None, None].contiguous(),
                  pos_proj=gate[0], w1x=gate[1], b1=gate[2], w2=gate[3], b2=gate[4])
    kw = dict(groups=4, mode="sigmoid", gate_max=1.5, upsample=up, downsample=dn, **STAGE_KW)
    side = h // 2 if dn else h
    dy = torch.randn(n, side, side, co, generator=g).to(cuda)
    counters = (fs.stage_sigmoid, fs.stage_conv, fs.stage_conv_bwd, fa.sigmoid_gate_backward,
                fs.stage_softmax_stats, fa.softmax_gate_backward)
    before = [f.launches for f in counters]
    inputs = {k: v.clone().requires_grad_(True) for k, v in leaves.items()}
    y = fs.fused_stage(inputs["x"], *(inputs[k] for k in fs._NAMES[1:7]),
                       **{k: inputs[k] for k in fs._NAMES[7:]}, **kw)
    got = torch.autograd.grad(y, list(inputs.values()), dy)
    assert [f.launches - b for f, b in zip(counters, before)] == [1, 1, 1, 1, 0, 0]
    ref = {k: v.clone().requires_grad_(True) for k, v in leaves.items()}
    y_ref = fs.stage_oracle(ref, h=h, w=h, groups=4, eps=1e-5, act="leaky_relu",
                            leaky_slope=0.2, mode="sigmoid", gate_max=1.5, upsample=up,
                            downsample=dn)
    want = torch.autograd.grad(y_ref, list(ref.values()), dy)
    assert float((y - y_ref).detach().norm() / y_ref.detach().norm()) <= F32_TOL
    for name, gk, gw in zip(leaves, got, want):
        err = float((gk - gw).norm() / gw.norm().clamp_min(1e-12))
        assert err <= F32_TOL, (name, err)


# ---------------------------------------------------------------------------
# flash attention (csrc/flash_attention.cu)
# ---------------------------------------------------------------------------

from locate_tpu_torch.ops import flash_attention as fl  # noqa: E402

# (T, dh, dv) of lsun_bedroom_128's six self-attention layers (heads 1)
FLASH_SHAPES = [(16, 64, 256), (64, 32, 128), (256, 16, 64), (1024, 8, 32), (4096, 8, 32),
                (16384, 8, 32)]


def flash_inputs(b, t, s, dh, dv, dtype, device, seed=0):
    """(q, k, v, do): q and k of unit variance, so the scaled scores have
    unit variance and the softmax is far from flat."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    shapes = ((b, t, dh), (b, s, dh), (b, s, dv), (b, t, dv))
    return [torch.randn(sh, generator=g).to(dtype).to(device) for sh in shapes]


def flash_run(q, k, v, do, scale, kernel):
    """(o, ell, dq, dk, dv) through the kernels or the plain versions."""
    with torch.no_grad():
        if not kernel:
            o, ell = fl.flash_forward_reference(q, k, v, scale)
            return (o, ell, *fl.flash_backward_reference(q, k, v, o, ell, do, scale))
        o, ell = fl.flash_fwd(q, k, v, scale)
        delta = fl.row_delta(o, do)
        dq = fl.flash_dq(q, k, v, do, ell, delta, scale)
        out = (o, ell, dq, *fl.flash_dkv(q, k, v, do, ell, delta, scale))
        torch.cuda.synchronize()
    return out


def flash_scales(q, k, v, do, scale):
    """(dq, dk, dv) computed on the absolute values of their terms (f32):
    the scale each sum's rounding error grows with."""
    q, k, v, do = (t.float() for t in (q, k, v, do))
    o, ell = fl.flash_forward_reference(q, k, v, scale)
    p = torch.exp(torch.matmul(q, k.transpose(1, 2)) * scale - ell.unsqueeze(-1))
    ds = p * (torch.matmul(do.abs(), v.abs().transpose(1, 2))
              + (do.abs() * o.abs()).sum(-1, keepdim=True))
    return (torch.matmul(ds, k.abs()) * scale, torch.matmul(ds.transpose(1, 2), q.abs()) * scale,
            torch.matmul(p.transpose(1, 2), do.abs()))


def check_flash(b, t, s, dh, dv, dtype, device, seed=0):
    q, k, v, do = flash_inputs(b, t, s, dh, dv, dtype, device, seed)
    scale = dh ** -0.5
    kern = flash_run(q, k, v, do, scale, kernel=True)
    plain = flash_run(q, k, v, do, scale, kernel=False)
    truth = (None,) * 5
    if dtype != torch.float32:
        truth = flash_run(*(x.float() for x in (q, k, v, do)), scale, kernel=False)
    scales = (None, None, *flash_scales(q, k, v, do, scale))
    for name, kk, pp, tt, sc in zip(("o", "ell", "dq", "dk", "dv"), kern, plain, truth, scales):
        assert kk.shape == pp.shape and kk.dtype == pp.dtype, name
        assert bool(torch.isfinite(kk).all()), name
        if tt is None:
            sc = pp if sc is None else sc
            err = float((kk.double() - pp.double()).norm() / sc.double().norm().clamp_min(1e-12))
            assert err <= F32_TOL, (name, err)
        else:
            hold(name, kk, pp, tt, scale=sc)
    return kern


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,dh,dv", FLASH_SHAPES)
def test_flash_kernels_at_lsun_shapes(cuda, t, dh, dv, dtype):
    """Batch 4 (1 at 128^2, where the plain version's (T, T) f32 matrices
    take a gigabyte each): both q tiles, 16 rows at the small stages."""
    check_flash(1 if t == 16384 else 4, t, t, dh, dv, dtype, cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,s,dh,dv", [
    (3, 200, 200, 12, 20),     # ragged q and kv tiles, widths off the main path
    (2, 100, 333, 8, 32),      # S != T
    (2, 333, 100, 16, 8),
    (5, 7, 5, 5, 7),           # odd widths, one short tile
    (40, 300, 300, 32, 64),    # enough blocks for the 64-row q tile, ragged
    (2, 64, 64, 64, 256),      # the widest heads of the path, on the 16-row tile
])
def test_flash_kernel_options(cuda, b, t, s, dh, dv, dtype):
    check_flash(b, t, s, dh, dv, dtype, cuda, seed=1)


@pytest.mark.gpu
def test_flash_tiles_and_too_wide_heads(cuda):
    """The q tile is 64 rows where that fills the card, else 16; heads too
    wide for a block's shared memory raise."""
    assert fl.pick_tile(fl._FWD, 64, 16384, 8, 32) == 64
    assert fl.pick_tile(fl._FWD, 1, 4096, 8, 32) == 16
    assert fl.pick_tile(fl._DKV, 64, 16, 64, 256) == 16
    assert fl.pick_tile(fl._DKV, 64, 4096, 8, 32) == 64
    q, k, v, _ = flash_inputs(1, 16, 16, 512, 512, torch.float32, cuda)
    with pytest.raises(ValueError, match="shared memory"):
        fl.flash_fwd(q, k, v, 1.0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_is_bitwise_repeatable(cuda, dtype):
    q, k, v, do = flash_inputs(3, 1000, 1000, 8, 32, dtype, cuda, seed=2)
    first = flash_run(q, k, v, do, 8 ** -0.5, kernel=True)
    again = flash_run(q, k, v, do, 8 ** -0.5, kernel=True)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_flash_function_on_the_card(cuda):
    """Gradients of `flash_attention` against autograd of the plain
    composition, f32, non-contiguous operands; one launch of each kernel; a
    second derivative raises."""
    q, k, v, do = flash_inputs(4, 96, 96, 16, 24, torch.float32, cuda, seed=3)
    q = q.transpose(0, 1).contiguous().transpose(0, 1)  # same values, other strides
    counters = (fl.flash_fwd, fl.flash_dq, fl.flash_dkv)
    before = [f.launches for f in counters]
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    o = fl.flash_attention(*leaves, scale=0.25)
    got = torch.autograd.grad(o, leaves, do)
    assert [f.launches - b for f, b in zip(counters, before)] == [1, 1, 1]
    ref = [x.clone().requires_grad_(True) for x in (q, k, v)]
    o_ref = fl.attention_reference(*ref, scale=0.25)
    want = torch.autograd.grad(o_ref, ref, do)
    assert rel_err(o.detach(), o_ref.detach()) <= F32_TOL
    for name, g, w in zip("qkv", got, want):
        assert rel_err(g, w) <= F32_TOL, name
    o = fl.flash_attention(*leaves, scale=0.25)
    (gq,) = torch.autograd.grad((o * o).sum(), leaves[:1], create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        gq.sum().backward()
    with pytest.raises(ValueError, match="do not match"):
        fl.flash_fwd(q, k[:, :-1], v, 0.25)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fl.flash_fwd(q.half(), k.half(), v.half(), 0.25)


@pytest.mark.gpu
@pytest.mark.parametrize("heads", [1, 2])
def test_self_attention_layer_on_the_card(cuda, heads):
    """`SelfAttention` with use_pallas on a CUDA tensor runs the kernels
    (never the plain composition) and agrees with the layer without them."""
    from locate_tpu_torch.config import AttentionConfig
    from locate_tpu_torch.ops import self_attention as sa

    gen = torch.Generator(device=cuda).manual_seed(4)
    cfg = AttentionConfig(kind="self", heads=heads)
    layer = sa.SelfAttention(64, cfg, torch.float32, use_pallas=True, gen=gen)
    plain = sa.SelfAttention(64, cfg, torch.float32, use_pallas=False, gen=gen)
    with torch.no_grad():
        layer.gamma.fill_(0.7)
        for conv in (layer.q, layer.k):
            conv.w.mul_(3.0)
    plain.load_state_dict(layer.state_dict())
    x = torch.randn(2, 16, 16, 64, device=cuda, generator=gen)
    dy = torch.randn(2, 16, 16, 64, device=cuda, generator=gen)
    before = fl.flash_fwd.launches, fl.flash_dq.launches, fl.flash_dkv.launches
    outs = []
    for m in (layer, plain):
        xx = x.clone().requires_grad_(True)
        y = m(xx)
        outs.append((y.detach(), *torch.autograd.grad(y, [xx, *m.parameters()], dy)))
    assert (fl.flash_fwd.launches, fl.flash_dq.launches, fl.flash_dkv.launches) == tuple(
        b + 1 for b in before)
    names = ["y", "dx", *(n for n, _ in layer.named_parameters())]
    grads = dict(zip(names, zip(*outs)))
    for name, (got, want) in grads.items():
        # the key bias's gradient is rounding noise around 0 (a shift of every
        # key's score, which the softmax ignores): on the key weights' scale
        scale = grads["k.w"][1] if name == "k.b" else want
        assert float((got - want).norm() / scale.norm()) <= F32_TOL, name


# ---------------------------------------------------------------------------
# the two routes of the flash backward passes (mma: bf16 on the tensor cores)
# ---------------------------------------------------------------------------

# (T, dh, dv) of all nine self-attention layers of lsun_bedroom_128 (G's six
# and D's three others)
FLASH_ALL_SHAPES = FLASH_SHAPES + [(1024, 16, 64), (256, 32, 128), (64, 64, 256)]


def flash_backward_on(route, q, k, v, do, scale):
    """(dq, dk, dv) of the two backward passes on `route` (None: the route
    `flash_route` picks), from the kernel forward's ell."""
    with torch.no_grad():
        o, ell = fl.flash_fwd(q, k, v, scale)
        delta = fl.row_delta(o, do)
        out = (fl.flash_dq(q, k, v, do, ell, delta, scale, route=route),
               *fl.flash_dkv(q, k, v, do, ell, delta, scale, route=route))
        torch.cuda.synchronize()
    return out


def check_mma(b, t, s, dh, dv, device, seed=0):
    """The mma route against the plain versions (the bf16 rule); the simt
    route on the same inputs under the same rule; two mma runs bitwise
    equal; one launch of each mma kernel a call."""
    q, k, v, do = flash_inputs(b, t, s, dh, dv, torch.bfloat16, device, seed)
    scale = dh ** -0.5
    assert fl.flash_route(q.dtype, dh, dv) == fl.MMA
    before = fl.flash_dq.launches_mma, fl.flash_dkv.launches_mma
    mma = flash_backward_on(None, q, k, v, do, scale)
    assert (fl.flash_dq.launches_mma, fl.flash_dkv.launches_mma) == (before[0] + 1,
                                                                     before[1] + 1)
    again = flash_backward_on(fl.MMA, q, k, v, do, scale)
    simt = flash_backward_on(fl.SIMT, q, k, v, do, scale)
    plain = flash_run(q, k, v, do, scale, kernel=False)[2:]
    truth = flash_run(*(x.float() for x in (q, k, v, do)), scale, kernel=False)[2:]
    scales = flash_scales(q, k, v, do, scale)
    for name, a, a2, sm, p, tr, sc in zip(("dq", "dk", "dv"), mma, again, simt, plain, truth,
                                          scales):
        assert a.shape == p.shape and a.dtype == p.dtype, name
        assert bool(torch.isfinite(a).all()), name
        assert torch.equal(a, a2), name
        hold(name, a, p, tr, scale=sc)
        hold(f"{name} simt", sm, p, tr, scale=sc)


@pytest.mark.gpu
@pytest.mark.parametrize("t,dh,dv", FLASH_ALL_SHAPES)
def test_flash_mma_route_at_lsun_shapes(cuda, t, dh, dv):
    check_mma(1 if t == 16384 else 4, t, t, dh, dv, cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,s,dh,dv", [
    (2, 100, 77, 8, 32),       # ragged q and kv tiles, S < T
    (3, 17, 17, 8, 16),        # T 17: one short tile; heads = 2's widths, dv 16
    (2, 1024, 1024, 8, 16),    # heads = 2 at 32^2 (dh 8, dv 16 padded to 16, 16)
    (2, 77, 300, 16, 64),      # S > T
    (2, 333, 100, 16, 8),      # dv 8 padded to 16
    (2, 130, 200, 24, 40),     # widths between templates: padded to (32, 128)
    (2, 64, 64, 64, 256),      # the widest template, dV in shared memory
    (2, 200, 200, 64, 256),    # the same over several q tiles
])
def test_flash_mma_route_edges_and_padding(cuda, b, t, s, dh, dv):
    check_mma(b, t, s, dh, dv, cuda, seed=5)


@pytest.mark.gpu
def test_flash_mma_route_is_bitwise_repeatable(cuda):
    q, k, v, do = flash_inputs(3, 1000, 1000, 8, 32, torch.bfloat16, cuda, seed=6)
    first = flash_backward_on(fl.MMA, q, k, v, do, 8 ** -0.5)
    again = flash_backward_on(fl.MMA, q, k, v, do, 8 ** -0.5)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "mma"), (torch.float32, "simt")])
def test_flash_route_counters_after_one_backward(cuda, dtype, route):
    """One `FlashAttention` backward launches each backward pass once, on
    the route `flash_route` picks: mma in bf16, simt in f32."""
    q, k, v, do = flash_inputs(2, 96, 96, 8, 32, dtype, cuda, seed=7)
    before = {f: (f.launches, f.launches_mma, f.launches_simt)
              for f in (fl.flash_dq, fl.flash_dkv)}
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    o = fl.flash_attention(*leaves, scale=0.25)
    torch.autograd.grad(o, leaves, do)
    for f, (n, n_mma, n_simt) in before.items():
        assert f.launches == n + 1
        assert (f.launches_mma - n_mma, f.launches_simt - n_simt) == (
            (1, 0) if route == "mma" else (0, 1))


@pytest.mark.gpu
def test_flash_mma_widths_match_the_library(cuda):
    """Every template `MMA_WIDTHS` names (the pairs `mma_widths` pads to) is
    instantiated in the library, with shared memory that fits and at least
    one block an SM; a pair that is no template has none; an explicit
    route the call cannot take raises."""
    lib = fl._library()
    for dh, dv in [(8, 16), (8, 32), (16, 8), (16, 64), (24, 40), (32, 128), (64, 256)]:
        assert fl.mma_widths(dh, dv) in fl.MMA_WIDTHS
    for wide in fl.MMA_WIDTHS:
        for kind in (fl._FWD, fl._DQ, fl._DKV):
            assert 0 < lib.locate_flash_mma_smem_bytes(kind, *wide) <= fl._MAX_SMEM
            assert lib.locate_flash_blocks_per_sm(1, kind, 1, *wide, 0) >= 1
    for dh, dv in [(12, 20), (72, 64), (64, 264), (8, 32), (24, 40)]:
        assert lib.locate_flash_mma_smem_bytes(fl._DQ, dh, dv) == 0
        assert lib.locate_flash_mma_smem_bytes(fl._FWD, dh, dv) == 0
    for dh, dv in [(12, 20), (72, 64), (64, 264)]:
        assert fl.mma_widths(dh, dv) is None
    q, k, v, do = flash_inputs(1, 32, 32, 12, 20, torch.bfloat16, cuda)
    with torch.no_grad():
        o, ell = fl.flash_fwd(q, k, v, 0.5)
        delta = fl.row_delta(o, do)
        with pytest.raises(ValueError, match="mma route"):
            fl.flash_dq(q, k, v, do, ell, delta, 0.5, route=fl.MMA)
        with pytest.raises(ValueError, match="route must be"):
            fl.flash_dkv(q, k, v, do, ell, delta, 0.5, route="tensor")


@pytest.mark.gpu
def test_flash_mma_launch_refuses_a_template_that_cannot_hold_the_widths(cuda):
    """The C interface runs the template it is named and pads nothing: a
    pair narrower than the widths, or no template at all, is refused
    before any launch; the pair `mma_widths` names launches."""
    q, k, v, do = flash_inputs(1, 32, 32, 8, 32, torch.bfloat16, cuda)
    lib = fl._library()
    with torch.no_grad():
        o, ell = fl.flash_fwd(q, k, v, 0.5)
        delta = fl.row_delta(o, do)
    dq = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream

    def launch(wide):
        return lib.locate_flash_dq(1, 1, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                                   ell.data_ptr(), delta.data_ptr(), dq.data_ptr(), 1, 32, 32,
                                   8, 32, 0, *wide, 0.5, stream)

    assert launch((16, 16)) != 0      # dv 32 does not fit DV 16
    assert launch((24, 32)) != 0      # no such template
    assert launch(fl.mma_widths(8, 32)) == 0
    torch.cuda.synchronize()
    assert torch.equal(dq, fl.flash_dq(q, k, v, do, ell, delta, 0.5))


@pytest.mark.gpu
def test_flash_mma_route_takes_unaligned_views(cuda):
    """Operands that are contiguous views starting off a 16-byte boundary
    (the mma kernels copy 16 bytes at a time) give the same gradients as
    aligned copies of the same values."""
    q, k, v, do = flash_inputs(2, 64, 64, 8, 32, torch.bfloat16, cuda, seed=8)

    def shifted(x):  # the same values one element into a larger buffer
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
        view = buf[1:].view(x.shape)
        view.copy_(x)
        assert view.is_contiguous() and view.data_ptr() % 16 != 0
        return view

    want = flash_backward_on(fl.MMA, q, k, v, do, 8 ** -0.5)
    got = flash_backward_on(fl.MMA, *(shifted(x) for x in (q, k, v, do)), 8 ** -0.5)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the forward's mma route (flash_fwd_mma)
# ---------------------------------------------------------------------------


def forward_on(route, q, k, v, scale):
    """(o, ell) of the forward on `route` (None: `flash_route`'s choice)."""
    with torch.no_grad():
        out = fl.flash_fwd(q, k, v, scale, route=route)
        torch.cuda.synchronize()
    return out


def check_fwd_mma(b, t, s, dh, dv, device, seed=0):
    """The forward's mma route against the plain version (the bf16 rule);
    the simt forward on the same inputs under the same rule; two mma runs
    bitwise equal; one mma launch a call."""
    q, k, v, _ = flash_inputs(b, t, s, dh, dv, torch.bfloat16, device, seed)
    scale = dh ** -0.5
    assert fl.flash_route(q.dtype, dh, dv) == fl.MMA
    before = fl.flash_fwd.launches_mma
    mma = forward_on(None, q, k, v, scale)
    assert fl.flash_fwd.launches_mma == before + 1
    again = forward_on(fl.MMA, q, k, v, scale)
    simt = forward_on(fl.SIMT, q, k, v, scale)
    with torch.no_grad():
        plain = fl.flash_forward_reference(q, k, v, scale)
        truth = fl.flash_forward_reference(q.float(), k.float(), v.float(), scale)
    for name, a, a2, sm, p, tr in zip(("o", "ell"), mma, again, simt, plain, truth):
        assert a.shape == p.shape and a.dtype == p.dtype, name
        assert bool(torch.isfinite(a).all()), name
        assert torch.equal(a, a2), name
        hold(name, a, p, tr)
        hold(f"{name} simt", sm, p, tr)


@pytest.mark.gpu
@pytest.mark.parametrize("t,dh,dv", FLASH_ALL_SHAPES)
def test_flash_fwd_mma_at_lsun_shapes(cuda, t, dh, dv):
    """Every template at the widths of lsun_bedroom_128's nine layers."""
    check_fwd_mma(1 if t == 16384 else 4, t, t, dh, dv, cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,s,dh,dv", [
    (2, 100, 300, 8, 32),      # ragged q and kv tiles, S > T
    (2, 300, 100, 16, 64),     # S < T: one ragged kv tile
    (3, 17, 17, 8, 16),        # one short tile of each; heads = 2's widths
    (2, 1024, 1024, 8, 16),    # heads = 2 at 32^2
    (2, 333, 100, 16, 8),      # dv 8 padded to 16
    (2, 130, 200, 24, 40),     # widths between templates: padded to (32, 128)
    (2, 64, 64, 64, 256),      # the widest template, O in shared memory
    (2, 200, 333, 64, 256),    # the same over several ragged q and kv tiles
])
def test_flash_fwd_mma_edges_and_padding(cuda, b, t, s, dh, dv):
    check_fwd_mma(b, t, s, dh, dv, cuda, seed=9)


@pytest.mark.gpu
def test_flash_fwd_mma_is_bitwise_repeatable(cuda):
    q, k, v, _ = flash_inputs(3, 1000, 1000, 8, 32, torch.bfloat16, cuda, seed=10)
    first = forward_on(fl.MMA, q, k, v, 8 ** -0.5)
    again = forward_on(fl.MMA, q, k, v, 8 ** -0.5)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_flash_fwd_mma_takes_unaligned_views(cuda):
    """Operands that start off a 16-byte boundary give the forward the same
    (o, ell) as aligned copies of the same values."""
    q, k, v, _ = flash_inputs(2, 96, 80, 8, 32, torch.bfloat16, cuda, seed=11)

    def shifted(x):
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
        view = buf[1:].view(x.shape)
        view.copy_(x)
        assert view.is_contiguous() and view.data_ptr() % 16 != 0
        return view

    want = forward_on(fl.MMA, q, k, v, 8 ** -0.5)
    got = forward_on(fl.MMA, *(shifted(x) for x in (q, k, v)), 8 ** -0.5)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "mma"), (torch.float32, "simt")])
def test_flash_fwd_route_counters_after_one_forward(cuda, dtype, route):
    """One `FlashAttention` forward launches the forward once, on the route
    `flash_route` picks, and no backward pass."""
    q, k, v, _ = flash_inputs(2, 96, 96, 8, 32, dtype, cuda, seed=12)
    counters = (fl.flash_fwd, fl.flash_dq, fl.flash_dkv)
    before = [(f.launches, f.launches_mma, f.launches_simt) for f in counters]
    with torch.no_grad():
        fl.flash_attention(q, k, v, scale=0.25)
    after = [(f.launches, f.launches_mma, f.launches_simt) for f in counters]
    assert after[0] == (before[0][0] + 1, before[0][1] + (route == "mma"),
                        before[0][2] + (route == "simt"))
    assert after[1:] == before[1:]


@pytest.mark.gpu
def test_flash_fwd_mma_launch_refuses_a_template_that_cannot_hold_the_widths(cuda):
    """The forward's C interface runs the template it is named: a pair too
    narrow for the widths, no template, or f32 on the mma route is refused
    before any launch."""
    q, k, v, _ = flash_inputs(1, 32, 32, 8, 32, torch.bfloat16, cuda)
    lib = fl._library()
    o = torch.empty(1, 32, 32, dtype=q.dtype, device=cuda)
    ell = torch.empty(1, 32, dtype=torch.float32, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream

    def launch(wide, is_bf16=1):
        return lib.locate_flash_fwd(1, is_bf16, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                    o.data_ptr(), ell.data_ptr(), 1, 32, 32, 8, 32, 0, *wide,
                                    0.5, stream)

    assert launch((16, 16)) != 0      # dv 32 does not fit DV 16
    assert launch((24, 32)) != 0      # no such template
    assert launch((16, 32), is_bf16=0) != 0
    assert launch(fl.mma_widths(8, 32)) == 0
    torch.cuda.synchronize()
    want = fl.flash_fwd(q, k, v, 0.5)
    assert torch.equal(o, want[0]) and torch.equal(ell, want[1])
