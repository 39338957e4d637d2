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

import math

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


def run_both(ops, act, gate_max, hw):
    """(kernel (m, se, y), plain (m, se, y)) on the same inputs."""
    kw = dict(act=act, leaky_slope=0.2)
    with torch.inference_mode():
        km, ks = fa.softmax_gate_stats(*ops, **kw)
        ky = fa.softmax_gate_apply(*ops, km, ks, hw_scale=float(hw),
                                   gate_max=gate_max, **kw)
        pm, ps = fa.softmax_gate_stats_reference(*ops, **kw)
        py = fa.softmax_gate_apply_reference(*ops, pm, ps, hw_scale=float(hw),
                                             gate_max=gate_max, **kw)
        torch.cuda.synchronize()
    return (km, ks, ky), (pm, ps, py)


def check_bf16(ops, act, gate_max, hw):
    kern, plain = run_both(ops, act, gate_max, hw)
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


def run_backward(ops, dy, act, gate_max, hw, kernel):
    """(c, dx, dpos_proj, dW1x, db1, dW2, db2): stats, csum and backward,
    all kernels or all plain versions."""
    kw = dict(act=act, leaky_slope=0.2)
    opts = dict(hw_scale=float(hw), gate_max=gate_max, **kw)
    if kernel:
        stats, csum, bwd = fa.softmax_gate_stats, fa.softmax_gate_csum, fa.softmax_gate_backward
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


def check_backward(ops, dy, act, gate_max, hw):
    kern = run_backward(ops, dy, act, gate_max, hw, kernel=True)
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
