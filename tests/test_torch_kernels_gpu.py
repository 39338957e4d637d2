"""The port's CUDA location-attention kernels against their plain PyTorch
version, on the card (marker `gpu`; each test skips without a card).

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
@pytest.mark.parametrize("hw,c,hd", MAIN_SHAPES)
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
    ops = make_inputs(2, 64, 32, 8, 32, torch.bfloat16, cuda)
    s0, a0 = fa.softmax_gate_stats.launches, fa.softmax_gate_apply.launches
    with torch.inference_mode():
        fa.fused_locate_attention(ops[0].reshape(2, 8, 8, 32), *ops[1:],
                                  gate_max=16.0)
    assert fa.softmax_gate_stats.launches == s0 + 1
    assert fa.softmax_gate_apply.launches == a0 + 1
    w1 = ops[2].clone().requires_grad_(True)
    with pytest.raises(NotImplementedError):
        fa.softmax_gate_stats(ops[0], ops[1], w1, *ops[3:], act="leaky_relu",
                              leaky_slope=0.2)
