"""The routes of the two gate backward wrappers, `softmax_gate_backward`
and `sigmoid_gate_backward`, on the CPU: which kernel `gate_bwd_route`
picks for both (mma: bf16 on the tensor cores at (C, Hd, Cout) = (64, 16,
64) with HW a multiple of 128 and at (512, 128, 512) with HW a multiple of
16; simt: f32 and every other width), what the wrappers refuse, that a CPU
call runs the plain version and counts no launch, the mma route's grid, and
what chip_smoke.py reads of the mma kernels (their names in ptxas and SASS
listings, the route counts of a train step, phase 15's cases, the kernels
line). The wide template's own cases are in
tests/test_torch_gate_bwd_wide.py. The kernels themselves run on the card
only (tests/test_torch_kernels_gpu.py, `-k "gate_bwd_mma or
sigmoid_bwd_mma or wide"`)."""

import importlib.util
import os
import stat
import sys

import numpy as np
import pytest
import torch

from locate_tpu_torch.ops import fused_attention as fa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPTS = dict(act="leaky_relu", leaky_slope=0.2, gate_max=16.0)

# (HW, C, Hd) of lsun_bedroom_128's gates at C >= 128 (G's 4^2-16^2, D's
# 32^2-4^2) by route: C = 512 on the wide mma template, C = 128 and 256 on
# the simt route
WIDE_MMA_SHAPES = [(16, 512, 128), (64, 512, 128)]
WIDE_SIMT_SHAPES = [(64, 256, 64), (256, 128, 32), (1024, 128, 32), (256, 256, 64)]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("hw", [128, 1024, 4096, 16384, 65536, 262144])
def test_bf16_at_the_template_takes_the_mma_route(hw):
    assert fa.GATE_MMA_WIDTHS[(64, 16, 64)] == fa.GATE_MMA_TILE == 128
    assert fa.gate_bwd_route(torch.bfloat16, hw, 64, 16, 64) == fa.MMA


@pytest.mark.parametrize("dtype,hw,c,hd,cout", [
    (torch.float32, 1024, 64, 16, 64),        # f32 keeps f32 products
    (torch.float16, 1024, 64, 16, 64),
    *[(torch.bfloat16, hw, c, hd, c) for hw, c, hd in WIDE_SIMT_SHAPES],
    (torch.bfloat16, 1024, 64, 16, 1),        # a gate broadcast over the channels
    (torch.bfloat16, 1024, 64, 32, 64),       # Hd != 16
    (torch.bfloat16, 1024, 64, 8, 64),
    (torch.bfloat16, 1000, 64, 16, 64),       # 128 does not divide HW
    (torch.bfloat16, 64, 64, 16, 64),
    (torch.bfloat16, 16448, 64, 16, 64),
])
def test_everything_else_takes_the_simt_route(dtype, hw, c, hd, cout):
    assert fa.gate_bwd_route(dtype, hw, c, hd, cout) == fa.SIMT


def _gate(dtype, n=2, hw=256, c=64, hd=16, cout=64, seed=0):
    """(x, dy, pos_proj, w1x, b1, w2, b2, m, se, c) of a small gate, made
    with numpy; the statistics and c from the plain passes."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((n, hw, c), dtype=np.float32)).to(dtype)
    dy = torch.from_numpy(rng.standard_normal((n, hw, c), dtype=np.float32)).to(dtype)
    pp = torch.from_numpy(rng.standard_normal((hw, hd), dtype=np.float32) * 0.5)
    w1 = torch.from_numpy(rng.standard_normal((c, hd), dtype=np.float32) / np.sqrt(c))
    b1 = torch.from_numpy(rng.standard_normal(hd, dtype=np.float32) * 0.1)
    w2 = torch.from_numpy(rng.standard_normal((hd, cout), dtype=np.float32) * 3 / np.sqrt(hd))
    b2 = torch.from_numpy(rng.standard_normal(cout, dtype=np.float32) * 0.1)
    kw = dict(act=OPTS["act"], leaky_slope=OPTS["leaky_slope"])
    m, se = fa.softmax_gate_stats_reference(x, pp, w1, b1, w2, b2, **kw)
    cs = fa.softmax_gate_csum_reference(x, dy, pp, w1, b1, w2, b2, m, se, hw_scale=float(hw),
                                        **OPTS)
    return x, dy, pp, w1, b1, w2, b2, m, se, cs


# the two gate backward wrappers and their plain versions; the sigmoid
# gate takes no softmax statistics, c or hw_scale
GATES = ("softmax", "sigmoid")


def _wrapper(gate):
    return fa.softmax_gate_backward if gate == "softmax" else fa.sigmoid_gate_backward


def _backward(gate, ops, hw, plain=False, **kw):
    """`gate`'s backward (or its plain version) on `_gate`'s operands."""
    if gate == "softmax":
        fn = fa.softmax_gate_backward_reference if plain else fa.softmax_gate_backward
        return fn(*ops, hw_scale=float(hw), **OPTS, **kw)
    fn = fa.sigmoid_gate_backward_reference if plain else fa.sigmoid_gate_backward
    return fn(*ops[:7], **OPTS, **kw)


def _counts(gate="softmax"):
    f = _wrapper(gate)
    return f.launches, f.launches_mma, f.launches_simt


@pytest.mark.parametrize("route", [None, "mma", "simt"])
@pytest.mark.parametrize("gate", GATES)
def test_cpu_backward_runs_the_plain_version_on_any_route(gate, route):
    """On CPU tensors the route names the card's kernels only: the plain
    version runs, bitwise, and no launch is counted."""
    ops = _gate(torch.bfloat16)
    before = _counts(gate)
    got = _backward(gate, ops, 256, route=route)
    want = _backward(gate, ops, 256, plain=True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert _counts(gate) == before
    assert got[0].dtype == torch.bfloat16 and got[0].shape == (2, 256, 64)


@pytest.mark.parametrize("dtype,hw,hd,cout", [
    (torch.float32, 256, 16, 64),    # f32
    (torch.bfloat16, 200, 16, 64),   # 128 does not divide HW
    (torch.bfloat16, 256, 8, 64),    # Hd != 16
    (torch.bfloat16, 256, 16, 1),    # Cout 1
])
@pytest.mark.parametrize("gate", GATES)
def test_mma_route_on_an_unfit_call_raises(gate, dtype, hw, hd, cout):
    """An explicit mma route raises where the template cannot take the call,
    on the CPU too."""
    ops = _gate(dtype, hw=hw, hd=hd, cout=cout)
    with pytest.raises(ValueError, match="mma route"):
        _backward(gate, ops, hw, route=fa.MMA)


@pytest.mark.parametrize("gate", GATES)
def test_mma_route_refuses_a_wider_gate(gate):
    """The widths that stay on simt, C = 128 and 256 (K1d, K1e), refuse the
    mma route."""
    for c, hd in ((128, 32), (256, 64)):
        ops = _gate(torch.bfloat16, n=1, hw=256, c=c, hd=hd, cout=c)
        with pytest.raises(ValueError, match="mma route"):
            _backward(gate, ops, 256, route=fa.MMA)
        assert len(_backward(gate, ops, 256, route=fa.SIMT)) == 6


@pytest.mark.parametrize("gate", GATES)
def test_unknown_route_raises(gate):
    ops = _gate(torch.bfloat16)
    with pytest.raises(ValueError, match="route must be"):
        _backward(gate, ops, 256, route="wgmma")


@pytest.mark.parametrize("gate", GATES)
def test_the_sigmoid_backward_has_the_routes(gate):
    """Both gates' backward take a route and count each route's launches,
    the sigmoid's as the softmax's: its launches are the sum of the two."""
    import inspect

    fn = _wrapper(gate)
    assert inspect.signature(fn).parameters["route"].default is None
    assert fn.launches == fn.launches_mma + fn.launches_simt


@pytest.mark.parametrize("n,hw,slots,rows", [
    (64, 16384, 132, 64),    # 128 tiles: one batch group, one wave
    (64, 4096, 132, 16),     # 32 tiles x 4 groups
    (64, 1024, 132, 4),      # 8 tiles x 16 groups
    (64, 1024, 264, 2),
    (16, 65536, 132, 16),    # more tiles than slots: one group
    (16, 262144, 132, 16),
    (4, 1024, 132, 1),       # fewer rows than groups would take
    (5, 128, 132, 1),
])
def test_mma_grid_fills_one_wave(n, hw, slots, rows):
    """Batch rows per block of the mma route: as many batch groups as keep
    (tiles x groups) within the card's slots, each row in one group."""
    assert fa.bwd_mma_grid(n, hw, slots) == rows
    tiles, groups = hw // fa.GATE_MMA_TILE, -(-n // rows)
    assert groups * rows >= n and (groups - 1) * rows < n
    assert tiles * groups <= max(slots, tiles)


def test_simt_grid_is_unchanged():
    assert fa.bwd_grid(64, 16384, 64) == (64, 32)
    assert fa.bwd_grid(16, 262144, 64) == (64, 16)


def test_lsun_step_route_counts(smoke):
    """A lsun_bedroom_128 train step runs softmax_bwd 24 times: 16 on the
    mma route (C = 64: G's 1024, 4096 and 16384, D's 16384 and 4096 three
    times each; C = 512: G's 16, D's 16 and 64 three times each) and 8 on
    the simt route; ffhq_512's 32: 24 and 8. An ffhq_512-sigmoid step runs
    sigmoid_bwd 20 times (the card's profile: the gates from 32^2 up, G's
    fused stages from 64^2 to 512^2): 17 on the mma route (C = 64 with
    HW % 128 == 0), the 3 at D's 32^2 gate (C = 128) on the simt route."""
    assert smoke.gate_routes_per_step(fa, smoke.BWD_PER_STEP) == {"mma": 16, "simt": 8}
    assert smoke.gate_routes_per_step(fa, smoke.BWD_PER_STEP, 3) == {"mma": 48, "simt": 24}
    assert sum(smoke.FFHQ_BWD_PER_STEP.values()) == smoke.FFHQ_GATE_PER_STEP["softmax_bwd"]
    assert smoke.gate_routes_per_step(fa, smoke.FFHQ_BWD_PER_STEP) == {"mma": 24, "simt": 8}
    assert smoke.gate_routes_per_step(fa, {}) == {"mma": 0, "simt": 0}
    assert sum(smoke.SIGMOID_BWD_PER_STEP.values()) == smoke.SIGMOID_PER_STEP["sigmoid_bwd"]
    assert smoke.gate_routes_per_step(fa, smoke.SIGMOID_BWD_PER_STEP) == {"mma": 17, "simt": 3}
    assert smoke.gate_routes_per_step(fa, smoke.SIGMOID_BWD_PER_STEP, 3) == {"mma": 51,
                                                                            "simt": 9}
    for kernel in ("softmax_bwd", "sigmoid_bwd"):
        assert smoke.read_gate_routes(kernel).keys() == {"mma", "simt"}
    assert smoke.read_gate_routes() == smoke.read_gate_routes("softmax_bwd")


def test_phases_4_and_8_cover_the_template(smoke):
    """Phases 4 and 8 run every C = 64 and C = 512 shape of the two main
    paths in bf16, the shapes the mma route takes, and one f32 shape
    (simt)."""
    bf16 = {(hw, c, hd) for hw, c, hd, d in smoke.cases() + smoke.ffhq_gate_cases()
            if d == torch.bfloat16 and fa.gate_bwd_route(d, hw, c, hd, c) == fa.MMA}
    assert bf16 == {(1024, 64, 16), (4096, 64, 16), (16384, 64, 16), (65536, 64, 16),
                    (262144, 64, 16), (16, 512, 128), (64, 512, 128)}
    hw, c, hd, d = smoke.cases()[-1]
    assert d == torch.float32 and fa.gate_bwd_route(d, hw, c, hd, c) == fa.SIMT


def test_phase_15_covers_both_routes(smoke):
    """Phase 15 runs the sigmoid backward in bf16 at every shape the card's
    profile gives the gate's kernels and at the C = 512 template's 4^2
    shape, the mma route at C = 64 (HW % 128 == 0) and C = 512, the simt
    route at D's 32^2 gate (C = 128) and the f32 shape; the forward at each
    of them (no fused stage has a shape of its own)."""
    cases = smoke.sigmoid_gate_cases()
    routes = {(hw, c, hd, d): fa.gate_bwd_route(d, hw, c, hd, c) for hw, c, hd, d, _ in cases}
    assert [k for k, r in routes.items() if r == fa.MMA] == [
        (hw, 64, 16, torch.bfloat16) for hw in (262144, 65536, 16384, 4096, 1024)] + [
        (16, 512, 128, torch.bfloat16)]
    assert [k for k, r in routes.items() if r == fa.SIMT] == [
        (1024, 128, 32, torch.bfloat16), (*smoke.SIGMOID_F32_SHAPE, torch.float32)]
    assert all(fwd for *_, fwd in cases) and smoke.SIGMOID_STAGE_BWD_SHAPES == []


GATE_PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115softmax_bwd_mmaEPK13__nv_bfloat16S2_PKfS2_S4_S2_S4_S4_S4_S4_PS0_PfS6_iiiiiff' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_115softmax_bwd_mmaEPK13__nv_bfloat16S2_PKfS2_S4_S2_S4_S4_S4_S4_PS0_PfS6_iiiiiff
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, 472 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115sigmoid_bwd_mmaEPK13__nv_bfloat16S2_PKfS2_S4_S2_S4_PS0_PfS6_iiiiiff' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_115sigmoid_bwd_mmaEPK13__nv_bfloat16S2_PKfS2_S4_S2_S4_PS0_PfS6_iiiiiff
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 160 registers, 448 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120softmax_bwd_wide_mmaILi512ELi128ELi512EEEvPK13__nv_bfloat16S3_PKfS3_S5_S3_S5_S5_S5_S5_PS1_PfS7_PS1_S8_S8_iiifff' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_120softmax_bwd_wide_mmaILi512ELi128ELi512EEEvPK13__nv_bfloat16S3_PKfS3_S5_S3_S5_S5_S5_S5_PS1_PfS7_PS1_S8_S8_iiifff
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 200 registers, 472 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119gate_wgrad_wide_mmaILi512ELi128ELi512EEEvPK13__nv_bfloat16S3_S3_S3_Pfii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_119gate_wgrad_wide_mmaILi512ELi128ELi512EEEvPK13__nv_bfloat16S3_S3_S3_Pfii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, 36864 bytes smem, 384 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_111sigmoid_bwdI13__nv_bfloat16EEvPKT_S4_PKfS4_S6_S4_S6_PS2_PfS8_iiiiiiiiff' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_111sigmoid_bwdI13__nv_bfloat16EEvPKT_S4_PKfS4_S6_S4_S6_PS2_PfS8_iiiiiiiiff
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, 456 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_111softmax_bwdI13__nv_bfloat16EEvPKT_S4_PKfS4_S6_S4_S6_S6_S6_S6_PS2_PfS8_iiiiiiiifff' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_111softmax_bwdI13__nv_bfloat16EEvPKT_S4_PKfS4_S6_S4_S6_S6_S6_S6_PS2_PfS8_iiiiiiiifff
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, 480 bytes cmem[0]
"""


def test_ptxas_names_the_gate_mma_kernel(smoke):
    """The gate backward's mma kernels keep names of their own, apart from
    the simt kernels whose names they contain; the wide template's carry
    its widths."""
    assert smoke.GATE_MMA_KERNELS == ("softmax_bwd_mma", "sigmoid_bwd_mma",
                                      "softmax_bwd_wide_mma", "sigmoid_bwd_wide_mma",
                                      "gate_wgrad_wide_mma")
    names = smoke.ALL_CUDA_KERNELS
    for k in smoke.GATE_MMA_KERNELS:
        assert all(names.index(k) < names.index(o) for o in names if o != k and o in k)
    kernels = smoke.parse_ptxas(GATE_PTXAS_LOG)
    assert set(kernels) == {"softmax_bwd_mma", "sigmoid_bwd_mma", "softmax_bwd<bf16>",
                            "sigmoid_bwd<bf16>", "softmax_bwd_wide_mma<512,128,512>",
                            "gate_wgrad_wide_mma<512,128,512>"}
    assert set(kernels) - {"softmax_bwd<bf16>", "sigmoid_bwd<bf16>"} < set(
        smoke.gate_mma_instances(fa))
    assert kernels["softmax_bwd_wide_mma<512,128,512>"]["registers"] == 200
    assert kernels["gate_wgrad_wide_mma<512,128,512>"]["static_smem"] == 36864
    assert kernels["softmax_bwd_mma"]["registers"] == 168
    assert kernels["sigmoid_bwd_mma"]["registers"] == 160
    assert kernels["sigmoid_bwd_mma"]["spill_stores"] == kernels["softmax_bwd_mma"]["spill_loads"] == 0


def test_sass_counts_the_gate_mma_kernel(smoke, tmp_path, monkeypatch):
    listing = tmp_path / "listing.txt"
    listing.write_text(
        "\t\tFunction : _ZN12_GLOBAL__N_115softmax_bwd_mmaEPK13__nv_bfloat16S2_PKf\n"
        "        /*0100*/                   HMMA.16816.F32.BF16 R24, R4, R20, R24 ;\n"
        "        /*0110*/                   LDSM.16.MT88.4 R8, [R2] ;\n"
        "        /*0120*/                   HMMA.16816.F32.BF16 R28, R4, R22, R28 ;\n"
        "\t\tFunction : _ZN12_GLOBAL__N_115sigmoid_bwd_mmaEPK13__nv_bfloat16S2_PKf\n"
        "        /*0100*/                   HMMA.16816.F32.BF16 R24, R4, R20, R24 ;\n"
        "\t\tFunction : _ZN12_GLOBAL__N_111softmax_bwdI13__nv_bfloat16EEvPKT_S4_PKf\n"
        "        /*0100*/                   FFMA R1, R2, R3, R1 ;\n")
    tool = tmp_path / "cuobjdump"
    tool.write_text(f"#!{sys.executable}\nimport sys\nprint(open({str(listing)!r}).read())\n")
    tool.chmod(tool.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(smoke, "cuobjdump_path", lambda: str(tool))
    assert smoke.sass_tensor_ops("lib.so") == {"softmax_bwd_mma": 2, "sigmoid_bwd_mma": 1,
                                               "softmax_bwd<bf16>": 0}


def test_kernels_line_carries_the_gate_routes(smoke):
    """Row 5 of the kernels line: the per-step time on the routes the
    wrapper picks, beside the simt route's time of the same launches and
    the main path's launches on the mma route."""
    rows = []
    for hw, c, hd in smoke.SHAPES:
        route = fa.gate_bwd_route(torch.bfloat16, hw, c, hd, c)
        t = dict(ms=1.0 if route == fa.MMA else 2.0, plain_ms=3.0, bound_ms=0.1,
                 bound_by="bytes", route=route)
        if route == fa.MMA:
            t["ms_simt"] = 4.0
        rows.append(dict(shape=dict(N=smoke.BATCH, HW=hw, C=c, Hd=hd, Cout=c),
                         dtype="bfloat16", softmax_bwd=t,
                         **{f"{n}_max_abs_err": 0.01 for n in smoke.GRAD_NAMES}))
    launches = smoke.expected({"softmax_bwd": 24}, 3)
    routes = smoke.gate_routes_per_step(fa, smoke.BWD_PER_STEP, 3)
    entry = smoke.gate_entry("softmax_bwd", [], rows, launches, launches, launches, routes)
    assert entry["ms"] == 16 * 1.0 + 8 * 2.0
    assert entry["ms_simt"] == 16 * 4.0 + 8 * 2.0
    assert entry["routes"] == ["mma", "simt"] and entry["launches_mma"] == 48
    assert entry["launches"] == 72 and entry["route"] == "cuda"
    assert {s["route"] for s in entry["shapes"]} == {"mma", "simt"}
    assert sum("ms_simt" in s for s in entry["shapes"]) == 5
    for key in ("name", "source", "replaces", "max_abs_err", "plain_ms", "bound_ms",
                "bound_by", "library_ms"):
        assert key in entry


def test_kernels_line_carries_the_sigmoid_routes(smoke):
    """Row 6 of the kernels line: sigmoid_bwd's per-step time on the routes
    the wrapper picks (17 launches a step on the mma route, at C = 64, 3 on
    simt; the C = 512 shape, held off the path, none), beside the simt
    route's time of the same launches and the main path's launches on the
    mma route."""
    rows = []
    for hw, c, hd, dtype, forward in smoke.sigmoid_gate_cases():
        route = fa.gate_bwd_route(dtype, hw, c, hd, c)
        t = dict(ms=1.0 if route == fa.MMA else 2.0, plain_ms=3.0, bound_ms=0.1,
                 bound_by="bytes", route=route)
        if route == fa.MMA:
            t["ms_simt"] = 5.0
        rows.append(dict(shape=dict(N=smoke.FFHQ_BATCH, HW=hw, C=c, Hd=hd, Cout=c),
                         dtype=str(dtype).replace("torch.", ""), sigmoid_bwd=t,
                         **{f"{n}_max_abs_err": 0.01 for n in smoke.GRAD_NAMES[1:]}))
    launches = smoke.expected(smoke.SIGMOID_PER_STEP, 3)
    routes = {"sigmoid_bwd": smoke.gate_routes_per_step(fa, smoke.SIGMOID_BWD_PER_STEP, 3)}
    entry = smoke.sigmoid_entry("sigmoid_bwd", rows, launches, {}, routes)
    assert entry["ms"] == 17 * 1.0 + 3 * 2.0
    assert entry["ms_simt"] == 17 * 5.0 + 3 * 2.0
    assert entry["routes"] == ["mma", "simt"] and entry["launches_mma"] == 51
    assert entry["launches"] == 60 and entry["route"] == "cuda"
    assert sum("ms_simt" in s for s in entry["shapes"]) == 6
    for key in ("name", "source", "replaces", "max_abs_err", "plain_ms", "bound_ms",
                "bound_by", "library_ms"):
        assert key in entry
