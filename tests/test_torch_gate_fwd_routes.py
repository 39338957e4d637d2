"""The routes of the softmax gate's forward pair, `softmax_gate_stats` and
`softmax_gate_apply`, on the CPU: which kernel `gate_fwd_route` picks (mma:
bf16 on the tensor cores at (C, Hd, Cout) = (64, 16, 64) with HW a multiple
of 128; simt: f32, Cout 1, C = 128, 256 and 512, and every other shape),
what the wrappers refuse, that a CPU call runs the plain version on any
route, counts no launch and equals the JAX package, the mma route's grid,
and what chip_smoke.py reads of the two mma kernels (their names in ptxas
and SASS listings, the route counts of the served forwards and the train
steps, phases 3 and 8, the stage's statistics check, the kernels line).
The kernels themselves run on the card only (tests/test_torch_kernels_gpu.py,
`-k "fwd_mma or share_one_l"`)."""

import importlib.util
import inspect
import os
import stat
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from locate_tpu.ops.pallas import fused_attention as jfa
from locate_tpu_torch.ops import fused_attention as fa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(act="leaky_relu", leaky_slope=0.2)
TOL = dict(rtol=2e-5, atol=2e-5)  # f32, as tests/test_torch_fused_attention.py


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("hw", [128, 1024, 4096, 16384, 65536, 262144])
def test_bf16_at_the_template_takes_the_mma_route(hw):
    assert fa.GATE_FWD_MMA_WIDTHS == (64, 16, 64) and fa.GATE_MMA_TILE == 128
    assert fa.gate_fwd_route(torch.bfloat16, hw, 64, 16, 64) == fa.MMA


@pytest.mark.parametrize("dtype,hw,c,hd,cout", [
    (torch.float32, 1024, 64, 16, 64),        # f32 keeps f32 products
    (torch.float16, 1024, 64, 16, 64),
    (torch.bfloat16, 1024, 64, 16, 1),        # a gate broadcast over the channels
    (torch.bfloat16, 256, 128, 32, 128),      # C = 128 and 256 stay with their simt backward
    (torch.bfloat16, 1024, 128, 32, 128),
    (torch.bfloat16, 64, 256, 64, 256),
    (torch.bfloat16, 256, 256, 64, 256),
    (torch.bfloat16, 16, 512, 128, 512),      # C = 512: its backward needs the simt l
    (torch.bfloat16, 64, 512, 128, 512),
    (torch.bfloat16, 1024, 64, 32, 64),       # Hd != 16
    (torch.bfloat16, 1000, 64, 16, 64),       # 128 does not divide HW
    (torch.bfloat16, 64, 64, 16, 64),
    (torch.bfloat16, 16448, 64, 16, 64),
])
def test_everything_else_takes_the_simt_route(dtype, hw, c, hd, cout):
    assert fa.gate_fwd_route(dtype, hw, c, hd, cout) == fa.SIMT


def test_c512_backward_keeps_its_mma_route_while_its_forward_stays_simt():
    """The forward's C = 512 stays on simt although the backward's wide
    template takes bf16 there: the wide softmax backward recomputes l in
    the simt stats pass's order, which a tensor-core stats pass would
    break."""
    for hw in (16, 64):
        assert fa.gate_bwd_route(torch.bfloat16, hw, 512, 128, 512) == fa.MMA
        assert fa.gate_fwd_route(torch.bfloat16, hw, 512, 128, 512) == fa.SIMT
    assert "C = 512" in inspect.getdoc(fa.gate_fwd_route)


def _gate(dtype, n=2, hw=256, c=64, hd=16, cout=64, seed=0):
    """(x, pos_proj, w1x, b1, w2, b2) of a small gate, made with numpy,
    whose weights make the gate vary and pass the clamp at 16."""
    rng = np.random.default_rng(seed)

    def r(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    arrays = (r(n, hw, c), r(hw, hd, scale=0.5), r(c, hd, scale=1 / np.sqrt(c)),
              r(hd, scale=0.1), r(hd, cout, scale=3 / np.sqrt(hd)), r(cout, scale=0.1))
    ops = [torch.from_numpy(a) for a in arrays]
    return [ops[0].to(dtype)] + ops[1:], arrays


def _forward(ops, hw, route=None, plain=False):
    """(m, se, y) of the two wrappers on `route`, or of their plain versions."""
    if plain:
        m, se = fa.softmax_gate_stats_reference(*ops, **KW)
        return m, se, fa.softmax_gate_apply_reference(*ops, m, se, hw_scale=float(hw),
                                                      gate_max=16.0, **KW)
    m, se = fa.softmax_gate_stats(*ops, route=route, **KW)
    return m, se, fa.softmax_gate_apply(*ops, m, se, hw_scale=float(hw), gate_max=16.0,
                                        route=route, **KW)


WRAPPERS = (fa.softmax_gate_stats, fa.softmax_gate_apply)


def _counts():
    return [(f.launches, f.launches_mma, f.launches_simt) for f in WRAPPERS]


@pytest.mark.parametrize("route", [None, "mma", "simt"])
def test_cpu_forward_runs_the_plain_version_on_any_route(route):
    """On CPU tensors the route names the card's kernels only: the plain
    versions run, bitwise, and no launch is counted."""
    ops, _ = _gate(torch.bfloat16)
    before = _counts()
    got = _forward(ops, 256, route)
    for a, b in zip(got, _forward(ops, 256, plain=True)):
        assert torch.equal(a, b)
    assert _counts() == before
    assert got[2].dtype == torch.bfloat16 and got[2].shape == (2, 256, 64)
    assert got[0].shape == got[1].shape == (2, 1, 64)


@pytest.mark.parametrize("dtype,route", [(torch.float32, None), (torch.float32, "simt"),
                                         (torch.bfloat16, None), (torch.bfloat16, "mma"),
                                         (torch.bfloat16, "simt")])
def test_cpu_forward_equals_the_jax_package(dtype, route):
    """The CPU path of either route at the template's widths against the JAX
    package: its stats kernel in interpret mode and its XLA composition.
    f32 to 2e-5; in bf16 both round h and y at the same places, but their
    f32 sums differ in order, so an h or y element may round to the
    neighbouring bf16 value: m and se to 1e-2, y elementwise to 1e-2 at 99 %
    of the elements (tests/test_torch_fused_attention.py's bf16 rule)."""
    ops, arrays = _gate(dtype, seed=3)
    x, rest = arrays[0], [jnp.asarray(a) for a in arrays[1:]]
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    m, se, y = _forward(ops, 256, route)
    jm, jse = jfa.softmax_gate_stats(jx, *rest, interpret=True, **KW)
    jy = jfa.locate_attention_xla_core(jx, *rest, mode="softmax", hw_scale=256.0,
                                       gate_max=16.0, **KW)
    jy = np.asarray(jy.astype(jnp.float32))
    if dtype == torch.float32:
        np.testing.assert_allclose(m.numpy(), np.asarray(jm), **TOL)
        np.testing.assert_allclose(se.numpy(), np.asarray(jse), rtol=1e-4)
        np.testing.assert_allclose(y.numpy(), jy, **TOL)
        return
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(se.numpy(), np.asarray(jse), rtol=1e-2)
    close = np.isclose(y.float().numpy(), jy, rtol=1e-2, atol=1e-2)
    assert close.mean() > 0.99, close.mean()


def test_cpu_softmax_gate_counts_no_forward_launch():
    """The autograd Function's forward on CPU tensors at the template's
    widths: the plain passes, no launch counted on either route."""
    ops, _ = _gate(torch.bfloat16, seed=5)
    before = _counts()
    y = fa.fused_locate_attention(ops[0].reshape(2, 16, 16, 64), *ops[1:], gate_max=16.0)
    assert _counts() == before
    want = _forward(ops, 256, plain=True)[2]
    assert torch.equal(y.reshape(want.shape), want)


@pytest.mark.parametrize("dtype,hw,hd,cout,c", [
    (torch.float32, 256, 16, 64, 64),     # f32
    (torch.bfloat16, 200, 16, 64, 64),    # 128 does not divide HW
    (torch.bfloat16, 256, 8, 64, 64),     # Hd != 16
    (torch.bfloat16, 256, 16, 1, 64),     # Cout 1
    (torch.bfloat16, 256, 32, 128, 128),  # C = 128
    (torch.bfloat16, 64, 128, 512, 512),  # C = 512
])
@pytest.mark.parametrize("wrapper", ["stats", "apply"])
def test_mma_route_on_an_unfit_call_raises(wrapper, dtype, hw, hd, cout, c):
    """An explicit mma route raises where the template cannot take the
    call, on the CPU too, naming the template."""
    ops, _ = _gate(dtype, n=1, hw=hw, c=c, hd=hd, cout=cout)
    template = r"mma route takes bf16 at \(C, Hd, Cout\) = \(64, 16, 64\)"
    with pytest.raises(ValueError, match=template):
        if wrapper == "stats":
            fa.softmax_gate_stats(*ops, route=fa.MMA, **KW)
        else:
            m, se = fa.softmax_gate_stats_reference(*ops, **KW)
            fa.softmax_gate_apply(*ops, m, se, hw_scale=float(hw), gate_max=16.0,
                                  route=fa.MMA, **KW)


@pytest.mark.parametrize("wrapper", WRAPPERS, ids=["stats", "apply"])
def test_unknown_route_raises(wrapper):
    ops, _ = _gate(torch.bfloat16)
    extra = {} if wrapper is fa.softmax_gate_stats else dict(
        hw_scale=256.0, gate_max=16.0)
    args = ops if wrapper is fa.softmax_gate_stats else [
        *ops, *fa.softmax_gate_stats_reference(*ops, **KW)]
    with pytest.raises(ValueError, match="route must be"):
        wrapper(*args, route="wgmma", **extra, **KW)


@pytest.mark.parametrize("wrapper", WRAPPERS, ids=["stats", "apply"])
def test_the_forward_wrappers_have_the_routes(wrapper):
    """Both forward wrappers take a route and count each route's launches
    beside the total, as the backward wrappers do."""
    assert inspect.signature(wrapper).parameters["route"].default is None
    assert wrapper.launches == wrapper.launches_mma + wrapper.launches_simt


@pytest.mark.parametrize("n,hw,slots,rows", [
    (64, 1024, 396, 256),      # 8 tiles, 6 groups wanted: 2 tiles a block, 4 groups
    (64, 4096, 396, 768),      # 32 tiles, 6 groups: 6 tiles a block (the last 2)
    (64, 16384, 396, 2816),    # 128 tiles: 22 a block, 6 groups (the last 18)
    (16, 65536, 396, 2816),    # 512 tiles, 24 groups
    (16, 262144, 396, 11008),  # 2048 tiles: 86 a block, 24 groups (the last 70)
    (1, 16384, 396, 128),      # one request: a tile a block
    (500, 1024, 396, 1024),    # more rows than slots: a row a block
    (4, 128, 396, 128),
])
def test_mma_grid_fills_about_one_wave(n, hw, slots, rows):
    """Locations a block of the forward's mma route: whole 128-location
    tiles, as many as keep (ceil(HW / rows) x N) blocks within the card's
    slots, or one row's worth when the batch alone fills them."""
    assert fa.fwd_mma_rows(n, hw, slots) == rows
    assert rows % fa.GATE_MMA_TILE == 0 and 0 < rows <= hw
    assert -(-hw // rows) * n <= max(slots, n)


def test_simt_tile_is_unchanged():
    assert fa.tile_rows(64) == 64 and fa.tile_rows(512) == 8


# ---------------------------------------------------------------------------
# chip_smoke.py
# ---------------------------------------------------------------------------


def test_step_and_serving_route_counts(smoke):
    """A lsun_bedroom_128 step runs each forward pass 30 times: 12 on the mma
    route (G's 1024, 4096 and 16384 twice, D's 16384 and 4096 three times),
    18 on simt; a served forward 3 of 6. An ffhq_512 step, G's stages from
    64^2 to 512^2 fused under the card's profile: stats 64 (31 mma: D's
    C = 64 gates six times, G's 32^2 gate three times, each fused backward
    call's statistics once), apply 72 (39: those forwards, and each fused
    G stage's three times); a served ffhq_512 forward stats 1 of 4 (G's
    gates to 32^2), apply 5 of 8 (and its four fused stages)."""
    assert smoke.gate_routes_per_step(fa, smoke.FWD_PER_STEP,
                                      forward=True) == {"mma": 12, "simt": 18}
    assert smoke.gate_routes_per_step(fa, smoke.FWD_PER_STEP, 3,
                                      forward=True) == {"mma": 36, "simt": 54}
    assert smoke.gate_routes_per_step(fa, smoke.SERVE, forward=True) == {"mma": 3, "simt": 3}
    gate = smoke.FFHQ_GATE_PER_STEP
    assert sum(smoke.FFHQ_STATS_PER_STEP.values()) == gate["softmax_stats"] == 64
    assert sum(smoke.FFHQ_APPLY_PER_STEP.values()) == gate["softmax_apply"] == 72
    assert smoke.gate_routes_per_step(fa, smoke.FFHQ_STATS_PER_STEP,
                                      forward=True) == {"mma": 31, "simt": 33}
    assert smoke.gate_routes_per_step(fa, smoke.FFHQ_APPLY_PER_STEP,
                                      forward=True) == {"mma": 39, "simt": 33}
    serve = smoke.FFHQ_SERVE_PER_FORWARD
    assert sum(smoke.FFHQ_STATS_SERVE.values()) == serve["softmax_stats"] == 4
    assert sum(smoke.FFHQ_APPLY_SERVE.values()) == serve["softmax_apply"] == 8
    assert smoke.gate_routes_per_step(fa, smoke.FFHQ_STATS_SERVE,
                                      forward=True) == {"mma": 1, "simt": 3}
    assert smoke.gate_routes_per_step(fa, smoke.FFHQ_APPLY_SERVE,
                                      forward=True) == {"mma": 5, "simt": 3}
    assert smoke.read_fwd_routes().keys() == {"softmax_stats", "softmax_apply"}
    for routes in smoke.read_fwd_routes().values():
        assert routes.keys() == {"mma", "simt"}


def test_phases_3_and_8_time_both_routes(smoke):
    """Phases 3 and 8 run every C = 64 shape of the two main paths in bf16,
    the shapes the mma route takes, and there run the simt route on the same
    inputs too, each twice bitwise, hold both to the bf16 rule, time both and
    fail unless the mma route beats the simt route and the plain version."""
    bf16 = {(hw, c, hd) for hw, c, hd, d in smoke.cases() + smoke.ffhq_gate_cases()
            if d == torch.bfloat16 and fa.gate_fwd_route(d, hw, c, hd, c) == fa.MMA}
    assert bf16 == {(1024, 64, 16), (4096, 64, 16), (16384, 64, 16), (65536, 64, 16),
                    (262144, 64, 16)}
    hw, c, hd, d = smoke.cases()[-1]
    assert d == torch.float32 and fa.gate_fwd_route(d, hw, c, hd, c) == fa.SIMT
    src = inspect.getsource(smoke.phase_forward)
    for needle in ('route="simt"', "check_mma_wins(kernel", "torch.equal(a, b)",
                   'hold(f"simt_{name}"', "ms_simt", "read_fwd_routes()"):
        assert needle in src, needle
    run = inspect.getsource(smoke.run_forward)
    assert "route=route" in run


def _ptxas_entry(mangled, regs, spill=0):
    return (f"ptxas info    : Compiling entry function '{mangled}' for 'sm_90a'\n"
            f"ptxas info    : Function properties for {mangled}\n"
            f"    0 bytes stack frame, {spill} bytes spill stores, {spill} bytes spill loads\n"
            f"ptxas info    : Used {regs} registers, 400 bytes cmem[0]\n")


STATS_MMA = "_ZN12_GLOBAL__N_117softmax_stats_mmaEPK13__nv_bfloat16PKfS2_S4_S2_S4_PfS5_iiif"
APPLY_MMA = "_ZN12_GLOBAL__N_117softmax_apply_mmaEPK13__nv_bfloat16PKfS2_S4_S2_S4_S4_S4_PS0_iiifff"
STAGE_STATS_MMA = ("_ZN12_GLOBAL__N_123stage_softmax_stats_mmaILi64ELi64EEEvPK13__nv_bfloat16"
                   "PKfS5_S3_S3_S5_S3_S5_S3_S5_S3_S5_PS1_PfS7_iiiifi")
APPLY_SIMT = ("_ZN12_GLOBAL__N_113softmax_applyI13__nv_bfloat16EEvPKT_PKfS4_S6_S4_S6_S6_S6_"
              "PS2_iiiiiifff")


def test_build_phase_names_the_forward_mma_kernels(smoke):
    """The forward pair's mma kernels keep names of their own: apart from the
    simt kernel whose name softmax_apply_mma contains, and from the stage's
    stats pass whose name contains softmax_stats_mma; phase 2 checks their
    HMMA, spills, shared memory and blocks an SM."""
    assert smoke.GATE_FWD_MMA_KERNELS == ("softmax_stats_mma", "softmax_apply_mma",
                                          "softmax_csum_mma")
    names = smoke.ALL_CUDA_KERNELS
    for k in names:
        assert all(names.index(k) < names.index(o) for o in names if o != k and o in k), k
    log = (_ptxas_entry(STATS_MMA, 72) + _ptxas_entry(APPLY_MMA, 80)
           + _ptxas_entry(STAGE_STATS_MMA, 120) + _ptxas_entry(APPLY_SIMT, 40))
    kernels = smoke.parse_ptxas(log)
    assert set(kernels) == {"softmax_stats_mma", "softmax_apply_mma",
                            "stage_softmax_stats_mma<64,64>", "softmax_apply<bf16>"}
    assert kernels["softmax_stats_mma"]["registers"] == 72
    assert kernels["softmax_apply_mma"]["registers"] == 80
    assert kernels["softmax_apply_mma"]["spill_stores"] == 0
    src = inspect.getsource(smoke.phase_build)
    for needle in ("GATE_FWD_MMA_KERNELS", "locate_softmax_fwd_mma_blocks_per_sm",
                   "locate_softmax_fwd_mma_smem_bytes", "gate_fwd_kernels"):
        assert needle in src, needle


def test_sass_counts_the_forward_mma_kernels(smoke, tmp_path, monkeypatch):
    listing = tmp_path / "listing.txt"
    listing.write_text(
        f"\t\tFunction : {STATS_MMA}\n"
        "        /*0100*/                   HMMA.16816.F32.BF16 R24, R4, R20, R24 ;\n"
        "        /*0120*/                   HMMA.16816.F32.BF16 R28, R4, R22, R28 ;\n"
        f"\t\tFunction : {APPLY_MMA}\n"
        "        /*0100*/                   HMMA.16816.F32.BF16 R24, R4, R20, R24 ;\n"
        f"\t\tFunction : {APPLY_SIMT}\n"
        "        /*0100*/                   FFMA R1, R2, R3, R1 ;\n")
    tool = tmp_path / "cuobjdump"
    tool.write_text(f"#!{sys.executable}\nimport sys\nprint(open({str(listing)!r}).read())\n")
    tool.chmod(tool.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(smoke, "cuobjdump_path", lambda: str(tool))
    assert smoke.sass_tensor_ops("lib.so") == {"softmax_stats_mma": 2, "softmax_apply_mma": 1,
                                               "softmax_apply<bf16>": 0}


def test_stage_statistics_check(smoke):
    """Phase 9's last check holds the fused 512^2 stage's m bitwise to
    softmax_stats_mma's on the stored w, and se within the f32 steps of the
    longer merge chain; main runs it after phase 9."""
    assert smoke.SE_ORDER_TOL == (2048 + 128) * 2.0 ** -24
    src = inspect.getsource(smoke.phase_stage_shares_l)
    for needle in ("torch.equal(m, m2)", "fa.softmax_gate_stats(", "SE_ORDER_TOL",
                   '"up", "plain"'):
        assert needle in src, needle
    main = inspect.getsource(smoke.main)
    assert main.index("phase_stage_kernels(fs, fa)") < main.index("phase_stage_shares_l(fs, fa)")


def test_step_phases_check_the_forward_routes(smoke):
    """Phases 5, 6, 10 and 11 read the forward pair's route counters and
    hold them to the counts of their shapes."""
    for fn in (smoke.phase_generator, smoke.phase_train, smoke.phase_ffhq_serving,
               smoke.phase_ffhq_train):
        src = inspect.getsource(fn)
        assert "forward=True)" in src, fn.__name__
        assert "read_fwd_routes()" in src or "GATE_FWD_ROUTED" in src, fn.__name__


@pytest.mark.parametrize("kernel", ["softmax_stats", "softmax_apply"])
def test_kernels_line_carries_the_forward_routes(smoke, kernel):
    """Rows 1 and 2 of the kernels line: the per-step time on the routes the
    wrappers pick (12 launches a lsun step on the mma route, 18 on simt),
    beside the simt route's time of the same launches and the main path's
    launches on the mma route."""
    rows = []
    for hw, c, hd in smoke.SHAPES:
        route = fa.gate_fwd_route(torch.bfloat16, hw, c, hd, c)
        t = dict(ms=1.0 if route == fa.MMA else 2.0, plain_ms=3.0, bound_ms=0.1,
                 bound_by="bytes", route=route)
        if route == fa.MMA:
            t["ms_simt"] = 4.0
        rows.append(dict(shape=dict(N=smoke.BATCH, HW=hw, C=c, Hd=hd, Cout=c),
                         dtype="bfloat16", **{kernel: t},
                         **{f"{n}_max_abs_err": 0.01 for n in ("m", "se", "y")}))
    launches = smoke.expected({kernel: 30}, 3)
    routes = smoke.gate_routes_per_step(fa, smoke.FWD_PER_STEP, 3, forward=True)
    entry = smoke.gate_entry(kernel, rows, [], launches, launches, launches, routes)
    assert entry["ms"] == 12 * 1.0 + 18 * 2.0
    assert entry["ms_simt"] == 12 * 4.0 + 18 * 2.0
    assert entry["routes"] == ["mma", "simt"] and entry["launches_mma"] == 36
    assert entry["launches"] == 90 and entry["route"] == "cuda"
    assert sum("ms_simt" in s for s in entry["shapes"]) == 3
    assert entry["ms_per_served_forward"] == 3 * 1.0 + 3 * 2.0
    for key in ("name", "source", "replaces", "max_abs_err", "plain_ms", "bound_ms",
                "bound_by", "library_ms"):
        assert key in entry
    # the csum pass takes the forward pair's route: two routes and their keys
    csum = smoke.gate_entry("softmax_csum", [], [dict(
        r, softmax_csum=r[kernel], c_max_abs_err=0.01) for r in rows],
        smoke.expected({"softmax_csum": 24}, 3), launches, launches,
        smoke.gate_routes_per_step(fa, smoke.BWD_PER_STEP, 3, forward=True))
    assert csum["routes"] == ["mma", "simt"] and csum["launches_mma"] == 27
    assert csum["ms_simt"] == 9 * 4.0 + 15 * 2.0
