"""The routes of the softmax gate's csum pass (`softmax_gate_csum`) and of
the sigmoid gate's forward (`sigmoid_gate`) on the CPU: which kernel each
takes (csum the forward pair's route, `gate_fwd_route`: mma for bf16 at
(C, Hd, Cout) = (64, 16, 64) with HW a multiple of 128; the sigmoid gate
`sigmoid_gate_route`: mma for bf16 at (512, 128, 512) with HW a multiple of
16; simt for everything else), that one call's csum takes the route its
stats took, what the wrappers refuse, that a CPU call runs the plain
version on any route and counts no launch, both plain versions against
the JAX package's Pallas kernels in interpret mode, and what chip_smoke.py
reads of the two mma kernels (names, per-step route counts, the kernels
line). The kernels themselves run on the card only
(tests/test_torch_kernels_gpu.py, `-k "csum_mma or sigmoid_gate_mma"`).

Tolerances: float32, 2e-5 relative and 2e-5 of the largest magnitude
absolute (tests/test_torch_gate_bwd_wide.py's: the two frameworks sum in
other orders); bf16 csum 1e-2 (tests/test_torch_gate_fwd_routes.py's
statistics), bf16 y elementwise one bf16 rounding step (2^-7) of y's
scale, since the two round h and y at the same places but may round a
different way where their f32 sums differ."""

import functools
import importlib.util
import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from locate_tpu.ops.pallas import fused_attention as jfa
from locate_tpu_torch.ops import fused_attention as fa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(act="leaky_relu", leaky_slope=0.2)
WIDE = (512, 128, 512)
TOL = dict(rtol=2e-5)
BF16_STEP = 2.0 ** -7


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _gate(dtype, n=2, hw=256, c=64, hd=16, cout=64, seed=0, w2_scale=3.0):
    """(x, dy, pos_proj, w1x, b1, w2, b2) as torch tensors and numpy arrays,
    made with numpy; x and dy in `dtype`, the rest f32."""
    rng = np.random.default_rng(seed)

    def r(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    arrays = (r(n, hw, c), r(n, hw, c), r(hw, hd, scale=0.5), r(c, hd, scale=1 / np.sqrt(c)),
              r(hd, scale=0.1), r(hd, cout, scale=w2_scale / np.sqrt(hd)), r(cout, scale=0.1))
    ops = [torch.from_numpy(a) for a in arrays]
    return [ops[0].to(dtype), ops[1].to(dtype)] + ops[2:], arrays


def _csum(ops, hw, route=None, gate_max=16.0):
    """c of the wrapper on `route`, from the plain statistics."""
    x, dy, *gate = ops
    m, se = fa.softmax_gate_stats_reference(x, *gate, **KW)
    return fa.softmax_gate_csum(x, dy, *gate, m, se, hw_scale=float(hw), gate_max=gate_max,
                                route=route, **KW)


# ---------------------------------------------------------------------------
# the route functions
# ---------------------------------------------------------------------------

# (dtype, HW, C, Hd, Cout): the gate widths of the main paths and beside them
CASES = [(d, hw, c, hd, cout)
         for d in (torch.bfloat16, torch.float32)
         for hw, c, hd, cout in [(1024, 64, 16, 64), (4096, 64, 16, 64), (16384, 64, 16, 64),
                                 (65536, 64, 16, 64), (262144, 64, 16, 64), (128, 64, 16, 64),
                                 (1000, 64, 16, 64), (64, 64, 16, 64), (1024, 64, 16, 1),
                                 (1024, 64, 32, 64), (256, 128, 32, 128), (1024, 128, 32, 128),
                                 (64, 256, 64, 256), (256, 256, 64, 256), (16, 512, 128, 512),
                                 (64, 512, 128, 512), (24, 512, 128, 512), (16, 512, 128, 1)]]


@pytest.mark.parametrize("dtype,hw,c,hd,cout", CASES)
def test_csum_takes_the_route_its_stats_took(monkeypatch, dtype, hw, c, hd, cout):
    """For every (dtype, (C, Hd, Cout), HW), the route a csum call picks is
    the one its stats call picked: both ask `_fwd_route_of`, whose choice is
    `gate_fwd_route`'s; c must come from the l that gave m and se."""
    picked = []
    original = fa._fwd_route_of

    def spy(route, x2d, w1x, w2):
        picked.append(original(route, x2d, w1x, w2))
        return picked[-1]

    monkeypatch.setattr(fa, "_fwd_route_of", spy)
    x = torch.zeros(1, hw, c, dtype=dtype)
    pp, w1, b1 = torch.zeros(hw, hd), torch.zeros(c, hd), torch.zeros(hd)
    w2, b2 = torch.zeros(hd, cout), torch.zeros(cout)
    m, se = fa.softmax_gate_stats(x, pp, w1, b1, w2, b2, **KW)
    fa.softmax_gate_csum(x, x, pp, w1, b1, w2, b2, m, se, hw_scale=float(hw), gate_max=16.0,
                         **KW)
    assert picked == [fa.gate_fwd_route(dtype, hw, c, hd, cout)] * 2


@pytest.mark.parametrize("hw", [1024, 4096, 16384, 65536, 262144])
def test_at_the_64_channel_gate_csum_stats_and_backward_share_the_mma_route(hw):
    """At (64, 16, 64) in bf16 the forward pair, the csum pass and the
    backward all run on the mma route: one l for m, se, c and g."""
    assert fa.GATE_FWD_MMA_WIDTHS == (64, 16, 64)
    assert (fa.gate_fwd_route(torch.bfloat16, hw, 64, 16, 64)
            == fa.gate_bwd_route(torch.bfloat16, hw, 64, 16, 64) == fa.MMA)


@pytest.mark.parametrize("hw", [16, 64])
def test_at_the_512_channel_gate_csum_stays_simt(hw):
    """C = 512: the wide softmax backward recomputes l in the simt stats
    pass's order, so csum stays with the forward pair on simt there."""
    assert fa.gate_bwd_route(torch.bfloat16, hw, *WIDE) == fa.MMA
    assert fa.gate_fwd_route(torch.bfloat16, hw, *WIDE) == fa.SIMT
    assert "csum" in inspect.getdoc(fa.gate_fwd_route)


@pytest.mark.parametrize("hw", [16, 64, 256, 1024])
def test_sigmoid_gate_at_the_wide_template_takes_the_mma_route(hw):
    assert fa.GATE_WIDE == WIDE
    assert fa.sigmoid_gate_route(torch.bfloat16, hw, *WIDE) == fa.MMA


@pytest.mark.parametrize("dtype,hw,c,hd,cout", [
    (torch.float32, 16, 512, 128, 512),    # f32 keeps f32 products
    (torch.float16, 16, 512, 128, 512),
    (torch.bfloat16, 24, 512, 128, 512),   # 16 does not divide HW
    (torch.bfloat16, 16, 512, 128, 1),     # a gate broadcast over the channels
    (torch.bfloat16, 16, 512, 64, 512),    # Hd != 128
    (torch.bfloat16, 64, 256, 64, 256),    # C = 256 and 128: K1d and K1e
    (torch.bfloat16, 256, 256, 64, 256),
    (torch.bfloat16, 256, 128, 32, 128),
    (torch.bfloat16, 4096, 64, 16, 64),
])
def test_every_other_sigmoid_gate_takes_the_simt_route(dtype, hw, c, hd, cout):
    assert fa.sigmoid_gate_route(dtype, hw, c, hd, cout) == fa.SIMT


@pytest.mark.parametrize("n,hw,splits", [
    (16, 16, 8),     # ffhq_512's 4^2 gate: 8 row blocks, 64 blocks
    (16, 64, 4),     # its 8^2 gate: 32 row blocks, 128 blocks
    (64, 16, 4),     # lsun_bedroom_128's batch: 32 row blocks
    (64, 64, 1),     # 128 row blocks: a split would pass one block an SM
    (34, 32, 2),     # 34 row blocks: 136 at four splits
    (1, 16, 8),
])
def test_the_wide_grid_splits_cout_chunks(n, hw, splits):
    """The sigmoid gate's wide forward splits Cout's eight 64-column chunks
    over blocks: the most of 8, 4, 2 that keeps the grid within one block
    an SM of the H100's 132 (each split recomputes u), else 1."""
    assert fa.GATE_WIDE_ROWS == 32
    got = fa.sigmoid_wide_splits(n, hw, 132)
    assert got == splits and WIDE[2] // 64 % got == 0
    assert -(-n * hw // 32) * got <= 132 or got == 1


# ---------------------------------------------------------------------------
# refusals and the CPU path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,hw,hd,cout,c", [
    (torch.float32, 256, 16, 64, 64),     # f32
    (torch.bfloat16, 200, 16, 64, 64),    # 128 does not divide HW
    (torch.bfloat16, 256, 8, 64, 64),     # Hd != 16
    (torch.bfloat16, 256, 16, 1, 64),     # Cout 1
    (torch.bfloat16, 256, 32, 128, 128),  # C = 128
    (torch.bfloat16, 64, 128, 512, 512),  # C = 512
])
def test_csum_mma_route_on_an_unfit_call_raises(dtype, hw, hd, cout, c):
    ops, _ = _gate(dtype, n=1, hw=hw, c=c, hd=hd, cout=cout)
    with pytest.raises(ValueError, match=r"mma route takes bf16 at \(C, Hd, Cout\) = "
                                         r"\(64, 16, 64\)"):
        _csum(ops, hw, route=fa.MMA)


@pytest.mark.parametrize("dtype,hw,hd,cout,c", [
    (torch.float32, 16, 128, 512, 512),   # f32
    (torch.bfloat16, 24, 128, 512, 512),  # 16 does not divide HW
    (torch.bfloat16, 16, 64, 512, 512),   # Hd != 128
    (torch.bfloat16, 16, 128, 1, 512),    # Cout 1
    (torch.bfloat16, 64, 64, 256, 256),   # C = 256
    (torch.bfloat16, 256, 16, 64, 64),    # C = 64
])
def test_sigmoid_gate_mma_route_on_an_unfit_call_raises(dtype, hw, hd, cout, c):
    ops, _ = _gate(dtype, n=1, hw=hw, c=c, hd=hd, cout=cout)
    with pytest.raises(ValueError, match=r"mma route takes bf16 at \(C, Hd, Cout\) = "
                                         r"\(512, 128, 512\) with HW a multiple of 16"):
        fa.sigmoid_gate(ops[0], *ops[2:], gate_max=1.5, route=fa.MMA, **KW)


def test_unknown_routes_raise():
    ops, _ = _gate(torch.bfloat16)
    with pytest.raises(ValueError, match="route must be"):
        _csum(ops, 256, route="wgmma")
    ops, _ = _gate(torch.bfloat16, n=1, hw=16, c=512, hd=128, cout=512)
    with pytest.raises(ValueError, match="route must be"):
        fa.sigmoid_gate(ops[0], *ops[2:], gate_max=1.5, route="wgmma", **KW)


def _counts(*wrappers):
    return [(f.launches, f.launches_mma, f.launches_simt) for f in wrappers]


@pytest.mark.parametrize("route", [None, "mma", "simt"])
def test_cpu_csum_runs_the_plain_version_on_any_route(route):
    ops, _ = _gate(torch.bfloat16)
    before = _counts(fa.softmax_gate_csum)
    got = _csum(ops, 256, route)
    x, dy, *gate = ops
    m, se = fa.softmax_gate_stats_reference(x, *gate, **KW)
    want = fa.softmax_gate_csum_reference(x, dy, *gate, m, se, hw_scale=256.0, gate_max=16.0,
                                          **KW)
    assert torch.equal(got, want) and got.shape == (2, 1, 64) and got.dtype == torch.float32
    assert _counts(fa.softmax_gate_csum) == before


@pytest.mark.parametrize("route", [None, "mma", "simt"])
def test_cpu_sigmoid_gate_runs_the_plain_version_on_any_route(route):
    ops, _ = _gate(torch.bfloat16, n=2, hw=16, c=512, hd=128, cout=512, w2_scale=1.0)
    before = _counts(fa.sigmoid_gate)
    got = fa.sigmoid_gate(ops[0], *ops[2:], gate_max=1.5, route=route, **KW)
    want = fa.sigmoid_gate_reference(ops[0], *ops[2:], gate_max=1.5, **KW)
    assert torch.equal(got, want) and got.dtype == torch.bfloat16
    assert _counts(fa.sigmoid_gate) == before


def test_cpu_gate_functions_count_no_launch():
    """Both autograd Functions' CPU paths at the new templates' widths run
    the plain passes: no launch counted on either route of csum or of the
    sigmoid gate."""
    ops, _ = _gate(torch.bfloat16, seed=5)
    before = _counts(fa.softmax_gate_csum, fa.sigmoid_gate)
    w1 = ops[3].clone().requires_grad_(True)
    y = fa.fused_locate_attention(ops[0].reshape(2, 16, 16, 64), ops[2], w1, *ops[4:],
                                  gate_max=16.0)
    y.float().sum().backward()
    ops, _ = _gate(torch.bfloat16, n=1, hw=16, c=512, hd=128, cout=512, seed=6)
    fa.fused_locate_attention(ops[0].reshape(1, 4, 4, 512), *ops[2:], mode="sigmoid",
                              gate_max=1.5)
    assert _counts(fa.softmax_gate_csum, fa.sigmoid_gate) == before
    assert w1.grad is not None


@pytest.mark.parametrize("wrapper", [fa.softmax_gate_csum, fa.sigmoid_gate],
                         ids=["csum", "sigmoid_gate"])
def test_the_wrappers_have_the_routes(wrapper):
    assert inspect.signature(wrapper).parameters["route"].default is None
    assert wrapper.launches == wrapper.launches_mma + wrapper.launches_simt


# ---------------------------------------------------------------------------
# the plain versions against the JAX package
# ---------------------------------------------------------------------------

def _jax_csum(arrays, dtype, hw, gate_max):
    """c of the JAX package's csum pass, `_softmax_csum_kernel` called as
    its `_pallas_backward` calls it, in interpret mode, from the JAX
    package's own statistics."""
    from jax.experimental.pallas import tpu as pltpu

    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    x, dy = (jnp.asarray(a, jd) for a in arrays[:2])
    pp, w1, b1, w2, b2 = (jnp.asarray(a) for a in arrays[2:])
    m, se = jfa.softmax_gate_stats(x, pp, w1, b1, w2, b2, interpret=True, **KW)
    n, _, c = x.shape
    hd, cout = w1.shape[1], w2.shape[1]
    t = jfa._pick_tile(hw, c)
    w1c, b1r, w2c, b2r, ppf = jfa._prep_operands(x, pp, w1, b1, w2, b2)
    x_spec, pp_spec = jfa._tile_specs(t, c, hd, batch_major=True)
    w_specs = [jfa._full_spec(w1c.shape), jfa._full_spec((1, hd)),
               jfa._full_spec(w2c.shape), jfa._full_spec((1, cout))]
    stat_spec = pl.BlockSpec((1, 1, cout), lambda i, j: (i, 0, 0), memory_space=pltpu.VMEM)
    csum = pl.pallas_call(
        functools.partial(jfa._softmax_csum_kernel, hw_scale=float(hw), gate_max=gate_max, **KW),
        grid=(n, hw // t),
        in_specs=[x_spec, x_spec, pp_spec] + w_specs + [stat_spec, stat_spec],
        out_specs=stat_spec,
        out_shape=jax.ShapeDtypeStruct((n, 1, cout), jnp.float32),
        scratch_shapes=[pltpu.VMEM((1, cout), jnp.float32)],
        interpret=True,
    )(x, dy, ppf, w1c, b1r, w2c, b2r, m, se)
    return np.asarray(csum)


@pytest.mark.parametrize("gate_max", [0.0, 16.0])
@pytest.mark.parametrize("dtype,route", [(torch.float32, None), (torch.float32, "simt"),
                                         (torch.bfloat16, None), (torch.bfloat16, "mma"),
                                         (torch.bfloat16, "simt")])
def test_cpu_csum_equals_the_jax_csum_pass(dtype, route, gate_max):
    """`softmax_gate_csum` on the CPU at the template's widths, on either
    route, against `_softmax_csum_kernel` in interpret mode, each from its
    own package's statistics; at gate_max 16 the clamp binds at a part of
    the 256 locations. f32 to 2e-5 relative, 2e-5 of c's largest magnitude
    absolute; bf16 (h rounded where the two frameworks' f32 sums differ)
    to 1e-2 alike."""
    ops, arrays = _gate(dtype, seed=7)
    x, dy, *gate = ops
    m, se = fa.softmax_gate_stats(x, *gate, route=route, **KW)
    got = fa.softmax_gate_csum(x, dy, *gate, m, se, hw_scale=256.0, gate_max=gate_max,
                               route=route, **KW).numpy()
    want = _jax_csum(arrays, dtype, 256, gate_max)
    if gate_max:
        l = fa.gate_logits_reference(x.float(), *gate, **KW)
        assert bool((torch.exp(l - m) / se * 256 > gate_max).any())
    rtol = TOL["rtol"] if dtype == torch.float32 else 1e-2
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


def _jax_sigmoid(arrays, dtype, gate_max):
    """y of the JAX package's `_sigmoid_kernel`, called by its forward
    wrapper (the pallas_call of `_pallas_forward_with_stats`) in interpret
    mode."""
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    pp, w1, b1, w2, b2 = (jnp.asarray(a) for a in arrays[2:])
    y, m, se = jfa._pallas_forward_with_stats(
        jnp.asarray(arrays[0], jd), pp, w1, b1, w2, b2, mode="sigmoid", hw_scale=1.0,
        gate_max=gate_max, interpret=True, **KW)
    assert m is None and se is None
    return np.asarray(y.astype(jnp.float32))


@pytest.mark.parametrize("hw", [16, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_sigmoid_gate_at_the_wide_gate_equals_the_jax_kernel(dtype, hw):
    """`sigmoid_gate` on the CPU at (512, 128, 512), HW 16 and 64 (the
    ffhq_512 shapes the mma route takes), N 2, gate_max 1.5 (the clamp binds
    at a part of the locations), against `_sigmoid_kernel` in interpret
    mode: f32 to 2e-5 relative and 2e-5 of y's largest magnitude absolute;
    bf16 one rounding step of y's largest magnitude elementwise."""
    ops, arrays = _gate(dtype, n=2, hw=hw, c=512, hd=128, cout=512, seed=8, w2_scale=1.0)
    got = fa.sigmoid_gate(ops[0], *ops[2:], gate_max=1.5, **KW).float().numpy()
    want = _jax_sigmoid(arrays, dtype, 1.5)
    l = fa.gate_logits_reference(ops[0].float(), *ops[2:], **KW)
    share = float((2 * torch.sigmoid(l) > 1.5).float().mean())
    assert 0.05 < share < 0.95, share
    rtol = TOL["rtol"] if dtype == torch.float32 else BF16_STEP
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


# ---------------------------------------------------------------------------
# chip_smoke.py
# ---------------------------------------------------------------------------

def test_step_route_counts(smoke):
    """csum takes the forward pair's route at the backward's shapes: 9 of
    a lsun_bedroom_128 step's 24 launches on the mma route (G's 1024, 4096,
    16384 once, D's 4096 and 16384 three times), 17 of an ffhq_512 step's
    32 (the C = 64 gates from 32^2 to 512^2, the fused stages' four at
    512^2 among them). The sigmoid gate's forward under the card's profile:
    none of an ffhq_512-sigmoid step's 33 (the gates at C = 512 run plain),
    nor of a served forward's 1."""
    assert smoke.gate_routes_per_step(fa, smoke.BWD_PER_STEP,
                                      forward=True) == {"mma": 9, "simt": 15}
    assert smoke.gate_routes_per_step(fa, smoke.FFHQ_BWD_PER_STEP,
                                      forward=True) == {"mma": 17, "simt": 15}
    assert sum(smoke.FFHQ_BWD_PER_STEP.values()) == smoke.FFHQ_GATE_PER_STEP["softmax_csum"]
    assert smoke.gate_routes_per_step(fa, smoke.SIGMOID_FWD_PER_STEP,
                                      sigmoid=True) == {"mma": 0, "simt": 33}
    assert smoke.gate_routes_per_step(fa, smoke.SIGMOID_FWD_PER_STEP, 3,
                                      sigmoid=True) == {"mma": 0, "simt": 99}
    assert sum(smoke.SIGMOID_FWD_PER_STEP.values()) == smoke.SIGMOID_PER_STEP["sigmoid_gate"]
    assert smoke.gate_routes_per_step(fa, smoke.SIGMOID_SERVE,
                                      sigmoid=True) == {"mma": 0, "simt": 1}
    for kernel in ("softmax_csum", "sigmoid_gate"):
        assert smoke.read_gate_routes(kernel).keys() == {"mma", "simt"}


def test_step_phases_check_both_kernels_routes(smoke):
    """Phases 6, 11, 12, 17 and 18 read the two kernels' route counters."""
    for fn, needles in ((smoke.phase_train, ('"softmax_csum"', "forward=True)")),
                        (smoke.phase_train_grads, ('"csum_route"',)),
                        (smoke.phase_ffhq_train, ('"softmax_csum"', "sigmoid=True)")),
                        (smoke.phase_ffhq_checked_backward, ('"softmax_csum"',)),
                        (smoke.phase_ffhq_serving, ('"sigmoid_gate"', "sigmoid=True)"))):
        src = inspect.getsource(fn)
        for needle in needles:
            assert needle in src, (fn.__name__, needle)


def test_phases_4_8_and_15_time_both_routes(smoke):
    """Phases 4 and 8 run csum on both routes at the five C = 64 shapes,
    hold both to the rule against c's absolute terms, repeat them bitwise,
    time them and compare db2 with c from either; phase 15 runs the sigmoid
    gate on both routes at the C = 512 template's 4^2 shape (off the path
    under the card's profile) and times the unsplit grid too."""
    bf16 = {(hw, c, hd) for hw, c, hd, d in smoke.cases() + smoke.ffhq_gate_cases(wide=True)
            if d == torch.bfloat16 and fa.gate_fwd_route(d, hw, c, hd, c) == fa.MMA}
    assert bf16 == {(1024, 64, 16), (4096, 64, 16), (16384, 64, 16), (65536, 64, 16),
                    (262144, 64, 16)}
    src = inspect.getsource(smoke.phase_backward)
    for needle in ('csum_route="simt"', 'check_mma_wins("softmax_csum"', "scale=scales[0]",
                   "db2_rel_err_c_from_mma_csum", "db2_rel_err_c_from_simt_csum",
                   'read_gate_routes(k)'):
        assert needle in src, needle
    wide = {(hw, c, hd) for hw, c, hd, d, fwd in smoke.sigmoid_gate_cases()
            if fwd and fa.sigmoid_gate_route(d, hw, c, hd, c) == fa.MMA}
    assert wide == {(16, 512, 128)}
    src = inspect.getsource(smoke.phase_sigmoid_gate)
    for needle in ('fwd_route="simt"', 'check_mma_wins("sigmoid_gate"', "ms_unsplit",
                   "wide_splits(fa, 1)"):
        assert needle in src, needle


def _ptxas_entry(mangled, regs, spill=0):
    return (f"ptxas info    : Compiling entry function '{mangled}' for 'sm_90a'\n"
            f"ptxas info    : Function properties for {mangled}\n"
            f"    0 bytes stack frame, {spill} bytes spill stores, {spill} bytes spill loads\n"
            f"ptxas info    : Used {regs} registers, 400 bytes cmem[0]\n")


CSUM_MMA = "_ZN12_GLOBAL__N_116softmax_csum_mmaEPK13__nv_bfloat16S2_PKfS2_S4_S2_S4_S4_S4_Pfiiifff"
SIGMOID_MMA = ("_ZN12_GLOBAL__N_121sigmoid_gate_wide_mmaILi512ELi128ELi512EEEvPK13__nv_bfloat16"
               "PKfS3_S5_S3_S5_PS1_iiifff")
SIGMOID_SIMT = "_ZN12_GLOBAL__N_112sigmoid_gateI13__nv_bfloat16EEvPKT_PKfS4_S6_S4_S6_PS2_iiiiiiiff"


def test_build_phase_names_the_new_kernels(smoke):
    """The two kernels keep names of their own, apart from the simt
    sigmoid_gate whose name the wide kernel's contains; phase 2 holds their
    HMMA, spills, shared memory and blocks an SM, and the forward pair's
    three blocks an SM."""
    assert "softmax_csum_mma" in smoke.GATE_FWD_MMA_KERNELS
    assert smoke.FWD_MMA_PASS == {"softmax_stats_mma": 0, "softmax_apply_mma": 1,
                                  "softmax_csum_mma": 2}
    assert smoke.SIGMOID_MMA_KERNELS == ("sigmoid_gate_wide_mma",)
    names = smoke.ALL_CUDA_KERNELS
    assert names.index("sigmoid_gate_wide_mma") < names.index("sigmoid_gate")
    kernels = smoke.parse_ptxas(_ptxas_entry(CSUM_MMA, 96) + _ptxas_entry(SIGMOID_MMA, 120)
                                + _ptxas_entry(SIGMOID_SIMT, 32))
    assert set(kernels) == {"softmax_csum_mma", "sigmoid_gate_wide_mma<512,128,512>",
                            "sigmoid_gate<bf16>"}
    assert kernels["softmax_csum_mma"]["registers"] == 96
    assert kernels["sigmoid_gate_wide_mma<512,128,512>"]["spill_stores"] == 0
    src = inspect.getsource(smoke.phase_build)
    for needle in ("SIGMOID_MMA_KERNELS", "locate_sigmoid_gate_mma_blocks_per_sm",
                   "locate_sigmoid_gate_mma_smem_bytes", "FWD_MMA_PASS[k]", "FWD_MMA_BLOCKS"):
        assert needle in src, needle


def _timing(route, ms, simt_ms=None):
    t = dict(ms=ms, plain_ms=3.0, bound_ms=0.1, bound_by="bytes", route=route)
    if simt_ms is not None:
        t["ms_simt"] = simt_ms
    return t


def test_kernels_line_carries_the_csum_routes(smoke):
    """Row 4 of the kernels line: csum's per-step time on its routes (9
    launches a lsun step on mma, 15 on simt), beside the simt route's time
    of the same launches and the main path's launches on the mma route."""
    rows = []
    for hw, c, hd in smoke.SHAPES:
        route = fa.gate_fwd_route(torch.bfloat16, hw, c, hd, c)
        mma = route == fa.MMA
        rows.append(dict(shape=dict(N=smoke.BATCH, HW=hw, C=c, Hd=hd, Cout=c),
                         dtype="bfloat16", c_max_abs_err=0.01,
                         softmax_csum=_timing(route, 1.0 if mma else 2.0,
                                              4.0 if mma else None)))
    launches = smoke.expected({"softmax_csum": 24}, 3)
    routes = smoke.gate_routes_per_step(fa, smoke.BWD_PER_STEP, 3, forward=True)
    entry = smoke.gate_entry("softmax_csum", [], rows, launches, launches, launches, routes)
    assert entry["ms"] == 9 * 1.0 + 15 * 2.0
    assert entry["ms_simt"] == 9 * 4.0 + 15 * 2.0
    assert entry["routes"] == ["mma", "simt"] and entry["launches_mma"] == 27
    assert entry["launches"] == 72 and entry["library_ms"] is None
    assert sum("ms_simt" in s for s in entry["shapes"]) == 3


def test_kernels_line_carries_the_sigmoid_gate_routes(smoke):
    """Row 3: the sigmoid gate's per-step time on its routes (33 launches an
    ffhq_512-sigmoid step, all on simt under the card's profile) beside the
    simt route's time of the same launches, the mma route's launches, and
    the mma shape's unsplit grid (timed off the path)."""
    rows = []
    for hw, c, hd, dtype, fwd in smoke.sigmoid_gate_cases():
        if not fwd:
            continue
        route = fa.sigmoid_gate_route(dtype, hw, c, hd, c)
        mma = route == fa.MMA
        t = _timing(route, 1.0 if mma else 2.0, 4.0 if mma else None)
        if mma:
            t.update(ms_unsplit=1.5, splits=fa.sigmoid_wide_splits(16, hw, 132))
        rows.append(dict(shape=dict(N=16, HW=hw, C=c, Hd=hd, Cout=c),
                         dtype=str(dtype).replace("torch.", ""), y_max_abs_err=0.01,
                         sigmoid_gate=t))
    launches = smoke.expected({"sigmoid_gate": 33}, 3)
    routes = {"sigmoid_gate": smoke.gate_routes_per_step(fa, smoke.SIGMOID_FWD_PER_STEP, 3,
                                                         sigmoid=True)}
    entry = smoke.sigmoid_entry("sigmoid_gate", rows, launches, launches, routes)
    assert entry["ms"] == 33 * 2.0
    assert entry["ms_simt"] == 33 * 2.0
    assert entry["routes"] == ["mma", "simt"] and entry["launches_mma"] == 0
    assert entry["launches"] == 99 and entry["launches_serving"] == 99
    assert sum("ms_unsplit" in s for s in entry["shapes"]) == 1
    for key in ("name", "route", "source", "replaces", "max_abs_err", "plain_ms", "bound_ms",
                "bound_by", "library_ms"):
        assert key in entry


def test_wide_splits_fixes_the_split_for_a_timing(smoke):
    """Phase 15 times the unsplit grid by fixing the split inside a block;
    the wrapper's own choice comes back after it."""
    pick = fa.sigmoid_wide_splits
    with smoke.wide_splits(fa, 1):
        assert fa.sigmoid_wide_splits(16, 16, 132) == 1
    assert fa.sigmoid_wide_splits is pick and fa.sigmoid_wide_splits(16, 16, 132) == 8
