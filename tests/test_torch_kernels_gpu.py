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


def stage_bwd(ops, dw, up, plain):
    fn = fs.stage_conv_bwd_reference if plain else fs.stage_conv_bwd
    with torch.no_grad():
        out = fn(ops[0], dw, ops[1], ops[2], ops[3], ops[4], ops[6], upsample=up, **STAGE_KW)
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
