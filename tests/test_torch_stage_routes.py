"""The routes of `stage_conv`, `stage_sigmoid`, `stage_softmax_stats`,
`stage_softmax_apply_pool` and `stage_conv_bwd`, on the CPU: which kernels
`stage_route` picks (mma: bf16 on the tensor cores at the (C, Co) of a
template, the apply-pool pass's at (Co, Hd, Cout) = (64, 16, 64); simt: f32
and every other width), what the wrappers refuse, how a route counts its
launches and asks the library for its tile, and what chip_smoke.py reads
of the five mma kernels (their names in ptxas and SASS listings, the route
counters of an ffhq_512 step, the kernels line). The kernels themselves
run on the card only (tests/test_torch_kernels_gpu.py)."""

import importlib.util
import os
import stat
import sys

import numpy as np
import pytest
import torch

from locate_tpu_torch.config import get_config
from locate_tpu_torch.ops import fused_stage as fs
from torch_threads import on_one_thread

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(act="leaky_relu", leaky_slope=0.2)


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("c,co", [(64, 64), (32, 64)])
def test_bf16_templates_take_the_mma_route(c, co):
    assert (c, co) in fs.STAGE_MMA_WIDTHS
    assert fs.stage_route(torch.bfloat16, c, co) == fs.MMA
    assert fs.stage_route(torch.bfloat16, c, co, skip=c != co, h=512, w=512, hd=16,
                          cout=co) == fs.MMA


def test_ffhq_512_fused_stages_are_on_a_template():
    """Every stage that fuses in ffhq_512 (256^2 and 512^2: 64 channels,
    the gate's hidden width C / 4 = 16, per-channel gate) fits the
    (64, 64) template."""
    model = get_config("ffhq_512").model
    chans = dict(zip(model.stage_resolutions(), model.stage_channels()))
    assert chans[256] == chans[512] == 64
    hd = max(8, 64 // model.attention.bottleneck)
    assert model.attention.per_channel
    for res in (256, 512):
        assert fs.stage_route(torch.bfloat16, chans[res], chans[res], skip=False, h=res,
                              w=res, hd=hd, cout=chans[res]) == fs.MMA


@pytest.mark.parametrize("dtype,c,co,shape", [
    (torch.float32, 64, 64, {}),              # f32 keeps f32 products (TF32 misses 1e-4)
    (torch.float16, 64, 64, {}),
    (torch.bfloat16, 32, 32, {}),             # widths no template takes
    (torch.bfloat16, 48, 64, {}),
    (torch.bfloat16, 64, 32, {}),
    (torch.bfloat16, 128, 128, {}),
    (torch.bfloat16, 64, 64, dict(skip=True)),    # a 1x1 skip where C == Co
    (torch.bfloat16, 32, 64, dict(skip=False)),   # C != Co needs the skip
    (torch.bfloat16, 64, 64, dict(h=20, w=32)),   # the 8 x 16 tile does not divide
    (torch.bfloat16, 64, 64, dict(h=16, w=24)),
    (torch.bfloat16, 64, 64, dict(hd=32, cout=64)),  # the gate's widths
    (torch.bfloat16, 64, 64, dict(hd=16, cout=1)),
])
def test_everything_else_takes_the_simt_route(dtype, c, co, shape):
    assert fs.stage_route(dtype, c, co, **shape) == fs.SIMT


def _stage(dtype, n=2, hin=16, c=64, co=64, seed=0, up=False):
    """(x, a, b, wr, wc, b_col, ws) and the gate (pos_proj, w1x, b1, w2, b2)
    of a small stage, made with numpy, in `dtype` where the kernels take
    it."""
    rng = np.random.default_rng(seed)

    def r(*shape, scale=0.1):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * scale)

    ws = r(c, co, scale=c ** -0.5).to(dtype) if c != co else None
    ops = [r(n, hin, hin, c, scale=1.0).to(dtype), 1 + r(n, c), r(n, c),
           r(3, c, co, scale=(3 * c) ** -0.5).to(dtype),
           r(3, co, co, scale=(3 * co) ** -0.5).to(dtype), r(co), ws]
    h = 2 * hin if up else hin
    gate = [r(h * h, 16, scale=0.5), r(co, 16, scale=co ** -0.5).to(dtype), r(16),
            r(16, co, scale=0.75).to(dtype), r(co)]
    return ops, gate


def _counts(fn):
    return fn.launches, fn.launches_mma, fn.launches_simt


@pytest.mark.parametrize("route", [None, "mma", "simt"])
@pytest.mark.parametrize("c,co,up", [(64, 64, False), (32, 64, True)])
@on_one_thread
def test_cpu_wrappers_run_the_plain_version_on_any_route(route, c, co, up):
    """On CPU tensors the route names the card's kernels only: the plain
    versions run, bitwise, and no launch is counted."""
    ops, gate = _stage(torch.bfloat16, hin=8 if up else 16, c=c, co=co, up=up)
    dw = torch.randn(2, 16, 16, co, generator=torch.Generator().manual_seed(1)).bfloat16()
    counts = [_counts(f) for f in (fs.stage_softmax_stats, fs.stage_conv_bwd)]
    got = fs.stage_softmax_stats(*ops, *gate, upsample=up, route=route, **KW)
    want = fs.stage_softmax_stats_reference(*ops, *gate, upsample=up, **KW)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    got = fs.stage_conv_bwd(ops[0], dw, *ops[1:5], ops[6], upsample=up, route=route, **KW)
    want = fs.stage_conv_bwd_reference(ops[0], dw, *ops[1:5], ops[6], upsample=up, **KW)
    for a, b in zip(got, want):
        assert (a is None and b is None) or torch.equal(a, b)
    assert counts == [_counts(f) for f in (fs.stage_softmax_stats, fs.stage_conv_bwd)]


def test_wrappers_refuse_a_route_the_call_cannot_take():
    """An explicit mma route raises for f32, for widths no template holds
    and for a shape the tile does not divide, on the CPU too; an unknown
    route raises."""
    ops, gate = _stage(torch.float32)
    dw = torch.zeros(2, 16, 16, 64)
    with pytest.raises(ValueError, match="mma route"):
        fs.stage_softmax_stats(*ops, *gate, route=fs.MMA, **KW)
    with pytest.raises(ValueError, match="mma route"):
        fs.stage_conv_bwd(ops[0], dw, *ops[1:5], ops[6], route=fs.MMA, **KW)
    ops, gate = _stage(torch.bfloat16, c=32, co=32)
    with pytest.raises(ValueError, match="mma route"):
        fs.stage_conv_bwd(ops[0], dw[..., :32], *ops[1:5], ops[6], route=fs.MMA, **KW)
    ops, gate = _stage(torch.bfloat16, hin=12)
    with pytest.raises(ValueError, match="mma route"):
        fs.stage_softmax_stats(*ops, *gate, route=fs.MMA, **KW)
    ops, gate = _stage(torch.bfloat16)
    with pytest.raises(ValueError, match="route must be"):
        fs.stage_softmax_stats(*ops, *gate, route="wgmma", **KW)
    with pytest.raises(ValueError, match="route must be"):
        fs.stage_conv_bwd(ops[0], dw, *ops[1:5], ops[6], route="tensor", **KW)


# (C, Co, upsample, downsample): the forms of the two forward passes the
# mma route takes, on a 16^2 fine image (the 8 x 16 tile divides it)
FORWARD_FORMS = [(64, 64, False, False), (64, 64, True, False), (64, 64, False, True),
                 (32, 64, False, False), (32, 64, False, True)]


def _forward_call(dtype, c, co, up, hin=None, hd=16, cout=None, skip=None):
    """The conv and gate operands of a forward call at fine 16^2 (x coarse
    8^2 under `up`): (ops, gate) with Hd `hd` and Cout `cout` (Co if None);
    `skip` overrides whether a 1x1 skip is passed."""
    hin = hin or (8 if up else 16)
    ops, gate = _stage(dtype, hin=hin, c=c, co=co, up=up)
    if skip is not None:
        rng = torch.Generator().manual_seed(2)
        ops[6] = (torch.randn(c, co, generator=rng) * c ** -0.5).to(dtype) if skip else None
    cout = co if cout is None else cout
    gen = torch.Generator().manual_seed(3)
    h = 2 * hin if up else hin
    gate = [torch.randn(h * h, hd, generator=gen) * 0.5,
            (torch.randn(co, hd, generator=gen) * co ** -0.5).to(dtype), torch.zeros(hd),
            (torch.randn(hd, cout, generator=gen) * 0.75).to(dtype), torch.zeros(cout)]
    return ops, gate


@pytest.mark.parametrize("c,co,up,dn", FORWARD_FORMS)
def test_conv_and_sigmoid_calls_take_the_mma_route(c, co, up, dn):
    """bf16 conv and sigmoid calls at (64, 64) and (32, 64) with its 1x1
    skip go to the mma route in every form; a `down` call is routed by the
    fine dims the tile divides (its output is 8 x 8 here)."""
    ops, gate = _forward_call(torch.bfloat16, c, co, up)
    x, wr, ws = ops[0], ops[3], ops[6]
    assert fs._call_route(None, x, wr, ws, up) == fs.MMA                      # stage_conv
    assert fs._call_route(None, x, wr, ws, up, gate[1], gate[3]) == fs.MMA    # stage_sigmoid
    out = fs.stage_conv(*ops, upsample=up, downsample=dn, route=fs.MMA, **KW)
    assert out.shape == (2, 8, 8, co) if dn else out.shape == (2, 16, 16, co)


UNFIT = {  # what a forward call names, and why the mma route does not take it
    "f32": dict(dtype=torch.float32),
    "gate_cout_1": dict(cout=1),              # a gate shared by the channels
    "gate_hd_8": dict(hd=8),
    "gate_hd_32": dict(hd=32),
    "tile_does_not_divide": dict(hin=12),     # 12 rows: the 8 x 16 tile does not fit
    "skip_where_c_equals_co": dict(skip=True),
    "widths_32_32": dict(c=32, co=32),
}


@pytest.mark.parametrize("why", sorted(UNFIT))
def test_unfit_conv_and_sigmoid_calls_take_the_simt_route(why):
    """f32, a gate with Cout 1 or Hd != 16, an image the tile does not
    divide, a 1x1 skip where C == Co and widths no template takes go to
    the simt route (the conv pass, which has no gate, goes to mma where only
    the gate's widths are off); an explicit mma route raises for them, on
    the CPU too."""
    kw = dict(dtype=torch.bfloat16, c=64, co=64)
    kw.update(UNFIT[why])
    dtype, c, co = kw.pop("dtype"), kw.pop("c"), kw.pop("co")
    ops, gate = _forward_call(dtype, c, co, False, **kw)
    x, wr, ws = ops[0], ops[3], ops[6]
    gate_only = why.startswith("gate_")
    assert fs._call_route(None, x, wr, ws, False, gate[1], gate[3]) == fs.SIMT
    assert fs._call_route(None, x, wr, ws, False) == (fs.MMA if gate_only else fs.SIMT)
    with pytest.raises(ValueError, match="mma route"):
        fs.stage_sigmoid(*ops, *gate, gate_max=1.5, route=fs.MMA, **KW)
    if not gate_only:
        with pytest.raises(ValueError, match="mma route"):
            fs.stage_conv(*ops, route=fs.MMA, **KW)


def _apply_pool_call(dtype=torch.bfloat16, co=64, hd=16, cout=None, h=16, w=32):
    """(w_pre, pos_proj, w1x, b1, w2, b2, m, se) of an apply-pool call on
    an h x w fine image, the statistics from the plain stats pass."""
    cout = co if cout is None else cout
    gen = torch.Generator().manual_seed(4)
    w_pre = torch.randn(2, h, w, co, generator=gen).to(dtype)
    gate = [torch.randn(h * w, hd, generator=gen) * 0.5,
            (torch.randn(co, hd, generator=gen) * co ** -0.5).to(dtype),
            torch.randn(hd, generator=gen) * 0.1,
            (torch.randn(hd, cout, generator=gen) * 0.75).to(dtype),
            torch.randn(cout, generator=gen) * 0.1]
    m, se = fs.fa.softmax_gate_stats_reference(w_pre.reshape(2, h * w, co), *gate, **KW)
    return [w_pre, *gate, m, se]


POOL_OPTS = dict(hw_scale=512.0, gate_max=16.0, **KW)


def test_bf16_apply_pool_at_the_template_takes_the_mma_route():
    """The pooled apply pass goes to stage_softmax_apply_pool_mma for bf16 at
    (Co, Hd, Cout) = (64, 16, 64) on an image the 8 x 16 tile divides:
    every D stage that fuses in ffhq_512 (512^2 and 256^2)."""
    for h in (16, 256, 512):
        assert fs.stage_route(torch.bfloat16, 64, 64, h=h, w=h, hd=16, cout=64) == fs.MMA
    ops = _apply_pool_call()
    assert fs._route_of(None, torch.bfloat16, 64, 64, h=16, w=32, hd=16, cout=64) == fs.MMA
    assert fs.stage_softmax_apply_pool(*ops, route=fs.MMA, **POOL_OPTS).shape == (2, 8, 16, 64)


APPLY_POOL_UNFIT = {  # what an apply-pool call names, and why the mma route does not take it
    "f32": dict(dtype=torch.float32),
    "co_32": dict(co=32, hd=8),
    "gate_hd_32": dict(hd=32),
    "gate_cout_1": dict(cout=1),
    "tile_does_not_divide_h": dict(h=12),
    "tile_does_not_divide_w": dict(w=24),
}


@pytest.mark.parametrize("why", sorted(APPLY_POOL_UNFIT))
@on_one_thread
def test_unfit_apply_pool_calls_take_the_simt_route(why):
    """f32, Co != 64, a gate with Hd != 16 or Cout 1 and an image the tile
    does not divide take the simt route; an explicit mma route raises for
    them, on the CPU too, and the simt route runs the plain version."""
    ops = _apply_pool_call(**APPLY_POOL_UNFIT[why])
    w_pre = ops[0]
    _, h, w, co = w_pre.shape
    assert fs._route_of(None, w_pre.dtype, co, co, h=h, w=w, hd=ops[2].shape[1],
                        cout=ops[4].shape[1]) == fs.SIMT
    with pytest.raises(ValueError, match="mma route"):
        fs.stage_softmax_apply_pool(*ops, route=fs.MMA, **POOL_OPTS)
    assert torch.equal(fs.stage_softmax_apply_pool(*ops, route=fs.SIMT, **POOL_OPTS),
                       fs.stage_softmax_apply_pool_reference(*ops, **POOL_OPTS))


@pytest.mark.parametrize("route", [None, "mma", "simt"])
@on_one_thread
def test_cpu_apply_pool_runs_the_plain_version_on_any_route(route):
    """On CPU tensors the pooled apply pass returns its plain version
    bitwise on any route and counts no launch on either route."""
    ops = _apply_pool_call()
    fn = fs.stage_softmax_apply_pool
    before = _counts(fn)
    assert torch.equal(fn(*ops, route=route, **POOL_OPTS),
                       fs.stage_softmax_apply_pool_reference(*ops, **POOL_OPTS))
    assert _counts(fn) == before
    assert fn.launches == fn.launches_mma + fn.launches_simt


def test_unknown_route_of_the_apply_pool_pass_raises():
    with pytest.raises(ValueError, match="route must be"):
        fs.stage_softmax_apply_pool(*_apply_pool_call(), route="wgmma", **POOL_OPTS)


@pytest.mark.parametrize("route", [None, "mma", "simt"])
@pytest.mark.parametrize("c,co,up,dn", [(64, 64, True, False), (32, 64, False, True)])
@on_one_thread
def test_cpu_conv_and_sigmoid_run_the_plain_version_on_any_route(route, c, co, up, dn):
    """On CPU tensors `stage_conv` and `stage_sigmoid` return their plain
    versions bitwise on any route and count no launch on either."""
    ops, gate = _forward_call(torch.bfloat16, c, co, up)
    counts = [_counts(f) for f in (fs.stage_conv, fs.stage_sigmoid)]
    kw = dict(upsample=up, downsample=dn, **KW)
    assert torch.equal(fs.stage_conv(*ops, route=route, **kw),
                       fs.stage_conv_reference(*ops, **kw))
    assert torch.equal(fs.stage_sigmoid(*ops, *gate, gate_max=1.5, route=route, **kw),
                       fs.stage_sigmoid_reference(*ops, *gate, gate_max=1.5, **kw))
    assert counts == [_counts(f) for f in (fs.stage_conv, fs.stage_sigmoid)]
    for fn in (fs.stage_conv, fs.stage_sigmoid):
        assert fn.launches == fn.launches_mma + fn.launches_simt


def test_unknown_route_of_the_forward_passes_raises():
    ops, gate = _forward_call(torch.bfloat16, 64, 64, False)
    with pytest.raises(ValueError, match="route must be"):
        fs.stage_conv(*ops, route="wgmma", **KW)
    with pytest.raises(ValueError, match="route must be"):
        fs.stage_sigmoid(*ops, *gate, gate_max=1.5, route="tensor", **KW)


def test_wrappers_refuse_other_devices():
    m = torch.zeros(2, 16, 16, 64, device="meta")
    w = torch.zeros(3, 64, 64, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        fs.stage_conv_bwd(m, m, m[:, 0, 0], m[:, 0, 0], w, w, None, route=fs.SIMT, **KW)


def test_each_launch_counts_on_its_route():
    class Fn:
        launches = launches_mma = launches_simt = 0

    for route in (fs.MMA, fs.SIMT, fs.MMA, fs.MMA):
        fs._count(Fn, route)
    assert (Fn.launches, Fn.launches_mma, Fn.launches_simt) == (4, 3, 1)
    for fn in (fs.stage_softmax_stats, fs.stage_conv_bwd, fs.stage_softmax_apply_pool):
        assert fn.launches == fn.launches_mma + fn.launches_simt


class _Lib:
    """A stand-in for the library's shared-memory query."""

    def __init__(self, nbytes):
        self.nbytes, self.asked = nbytes, []

    def locate_stage_smem_bytes(self, route, kind, c, co, hd, cout, th, tw):
        self.asked.append((route, kind, c, co, hd, cout, th, tw))
        return self.nbytes


def test_the_mma_tile_asks_the_library():
    """On the mma route the tile is the route's 8 x 16, and the library is
    asked for that block's bytes (route code 1); 0 means no template,
    bytes over an SM's refuse, and so does an image the tile does not
    divide. The simt route asks with code 0."""
    lib = _Lib(155520)
    assert fs.pick_tile(fs._BWD, 512, 512, 64, 64, lib=lib, route=fs.MMA) == (8, 16)
    assert lib.asked == [(1, fs._BWD, 64, 64, 0, 0, 8, 16)]
    lib = _Lib(103232)
    assert fs.pick_tile(fs._STATS, 512, 512, 32, 64, 16, 64, lib=lib, route=fs.MMA) == (8, 16)
    assert lib.asked == [(1, fs._STATS, 32, 64, 16, 64, 8, 16)]
    lib = _Lib(71424)
    assert fs.pick_tile(fs._APPLY_POOL, 512, 512, 64, 64, 16, 64, lib=lib,
                        route=fs.MMA) == (8, 16)
    assert lib.asked == [(1, fs._APPLY_POOL, 64, 64, 16, 64, 8, 16)]
    with pytest.raises(ValueError, match="no mma template"):
        fs.pick_tile(fs._STATS, 512, 512, 64, 64, 32, 64, lib=_Lib(0), route=fs.MMA)
    with pytest.raises(ValueError, match="shared memory"):
        fs.pick_tile(fs._BWD, 512, 512, 64, 64, lib=_Lib(300000), route=fs.MMA)
    with pytest.raises(ValueError, match="does not divide"):
        fs.pick_tile(fs._BWD, 512, 520, 64, 64, lib=_Lib(1000), route=fs.MMA)
    lib = _Lib(1000)
    assert fs.pick_tile(fs._BWD, 512, 512, 64, 64, lib=lib) == fs._BWD_TILES[0]
    assert lib.asked[0][0] == 0


def test_mma_backward_blocks_follow_the_card():
    """The mma backward's persistent blocks: as many as fit on the card at
    once, never more than there are tiles."""
    assert fs.bwd_blocks(16, 512, 512, 8, 16, 132) == 132
    assert fs.bwd_blocks(1, 16, 32, 8, 16, 132) == 4
    assert fs.bwd_blocks(16, 512, 512, 4, 16) == fs._BWD_TARGET_BLOCKS


def test_the_fused_stage_takes_the_routes_choice():
    """`FusedStage`'s chain calls both wrappers without a route: on the
    CPU it runs the plain chain, bf16 as f32."""
    ops, gate = _stage(torch.bfloat16)
    x = ops[0].requires_grad_(True)
    w_row = ops[3].permute(2, 1, 0)[:, :, None, :].float().requires_grad_(True)
    w_col = ops[4].permute(2, 1, 0)[:, :, :, None].float().requires_grad_(True)
    y = fs.fused_stage(x, torch.ones(64), torch.zeros(64), w_row, w_col, ops[5], None,
                       groups=4, mode="softmax", pos_proj=gate[0], w1x=gate[1].float(),
                       b1=gate[2], w2=gate[3].float(), b2=gate[4], gate_max=16.0)
    dx, dr, dc = torch.autograd.grad(y.float().sum(), [x, w_row, w_col])
    assert dx.dtype == torch.bfloat16 and torch.isfinite(dx.float()).all()
    assert torch.isfinite(dr).all() and torch.isfinite(dc).all()


STAGE_PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__0000c1d2_14_fused_stage_cu_7a1e3f2b23stage_softmax_stats_mmaILi64ELi64EEEvPK13__nv_bfloat16PKfS5_S3_S3_S5_S3_S5_S3_S5_S3_S5_PS1_PfS7_iiiifi' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 124 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__0000c1d2_14_fused_stage_cu_7a1e3f2b18stage_conv_bwd_mmaILi32ELi64EEEvPK13__nv_bfloat16S3_PKfS5_S3_S3_S3_PS1_S6_Pfiiiifi' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 203 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__0000c1d2_14_fused_stage_cu_7a1e3f2b14stage_conv_bwdI13__nv_bfloat16EEvPKT_S4_PKfS6_S4_S4_S4_S4_PS2_S7_Pfiiiiiiiiifi' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 187 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__0000c1d2_14_fused_stage_cu_7a1e3f2b19stage_softmax_statsIfEEvPKT_PKfS5_S3_S3_S5_S3_S5_S3_S5_S3_S5_PS1_PfS7_iiiiiiiiifi' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 120 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__0000c1d2_14_fused_stage_cu_7a1e3f2b14stage_conv_mmaILi64ELi64EEEvPK13__nv_bfloat16PKfS5_S3_S3_S5_S3_PS1_iiiifii' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 110 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__0000c1d2_14_fused_stage_cu_7a1e3f2b17stage_sigmoid_mmaILi32ELi64EEEvPK13__nv_bfloat16PKfS5_S3_S3_S5_S3_S5_S3_S5_S3_S5_PS1_iiiiffii' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 126 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__0000c1d2_14_fused_stage_cu_7a1e3f2b28stage_softmax_apply_pool_mmaEPK13__nv_bfloat16PKfS2_S4_S2_S4_S4_S4_PS0_iiiifff' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__0000c1d2_14_fused_stage_cu_7a1e3f2b24stage_softmax_apply_poolI13__nv_bfloat16EEvPKT_PKfS4_S6_S4_S6_S6_S6_PS2_iiiiiiiiifff' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers
"""


def test_ptxas_names_the_stage_mma_kernels(smoke):
    """The stage's mma kernels are templates on (C, Co): each instance keeps
    a name of its own, apart from the simt kernel whose name it contains."""
    assert smoke.STAGE_MMA_KERNELS == ("stage_softmax_stats_mma", "stage_conv_bwd_mma",
                                       "stage_conv_mma", "stage_sigmoid_mma",
                                       "stage_softmax_apply_pool_mma")
    for k in smoke.STAGE_MMA_KERNELS:
        simt = k[:-len("_mma")]
        assert smoke.ALL_CUDA_KERNELS.index(k) < smoke.ALL_CUDA_KERNELS.index(simt)
    kernels = smoke.parse_ptxas(STAGE_PTXAS_LOG)
    assert set(kernels) == {"stage_softmax_stats_mma<64,64>", "stage_conv_bwd_mma<32,64>",
                            "stage_conv_bwd<bf16>", "stage_softmax_stats<f32>",
                            "stage_conv_mma<64,64>", "stage_sigmoid_mma<32,64>",
                            "stage_softmax_apply_pool_mma", "stage_softmax_apply_pool<bf16>"}
    assert kernels["stage_softmax_apply_pool_mma"]["registers"] == 80
    assert kernels["stage_sigmoid_mma<32,64>"]["registers"] == 126
    assert kernels["stage_conv_bwd_mma<32,64>"]["registers"] == 203
    assert kernels["stage_softmax_stats_mma<64,64>"]["spill_stores"] == 0


def test_sass_counts_the_stage_mma_kernels(smoke, tmp_path, monkeypatch):
    listing = tmp_path / "listing.txt"
    listing.write_text(
        "\t\tFunction : _ZN50_GLOBAL__N__0_fused_stage_cu_18stage_conv_bwd_mmaILi64ELi64EEEvPK\n"
        "        /*0100*/                   HMMA.16816.F32.BF16 R24, R4, R20, R24 ;\n"
        "        /*0110*/                   LDSM.16.MT88.4 R8, [R2] ;\n"
        "        /*0120*/                   HMMA.16816.F32.BF16 R28, R4, R22, R28 ;\n"
        "        /*0130*/                   HMMA.16816.F32.BF16 R32, R4, R22, R32 ;\n"
        "\t\tFunction : _ZN50_GLOBAL__N__0_fused_stage_cu_14stage_conv_bwdI13__nv_bfloat16EEvPK\n"
        "        /*0100*/                   FFMA R1, R2, R3, R1 ;\n"
        "\t\tFunction : _ZN50_GLOBAL__N__0_fused_stage_cu_28stage_softmax_apply_pool_mmaEPK13\n"
        "        /*0100*/                   HMMA.16816.F32.BF16 R24, R4, R20, R24 ;\n"
        "\t\tFunction : _ZN50_GLOBAL__N__0_fused_stage_cu_24stage_softmax_apply_poolI13__nv_bfloat16EEv\n"
        "        /*0100*/                   FFMA R1, R2, R3, R1 ;\n")
    tool = tmp_path / "cuobjdump"
    tool.write_text(f"#!{sys.executable}\nimport sys\nprint(open({str(listing)!r}).read())\n")
    tool.chmod(tool.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(smoke, "cuobjdump_path", lambda: str(tool))
    assert smoke.sass_tensor_ops("lib.so") == {"stage_conv_bwd_mma<64,64>": 3,
                                               "stage_conv_bwd<bf16>": 0,
                                               "stage_softmax_apply_pool_mma": 1,
                                               "stage_softmax_apply_pool<bf16>": 0}


def test_ffhq_512_step_route_expectation(smoke):
    """An ffhq_512 step (softmax gate; the card's profile fuses G's four
    stages from 64^2 to 512^2 and no D stage) launches 12 stats passes (3
    a fused stage: the fake, the G step, remat's rerun), no pooled apply
    pass, 4 conv passes (the backward's recompute of w) and 4 backward
    passes, all on the mma route; with the sigmoid gate 12 sigmoid passes,
    4 conv passes, 4 backward passes and no stats or apply pass; the f32
    step at 64^2 takes the simt route."""
    none = {"mma": 0, "simt": 0}
    per_step = {k: sum(v.values()) for k, v in smoke.FFHQ_STAGE_PER_STEP.items()}
    assert per_step["stage_softmax_apply_pool"] == 0
    launches = smoke.expected(per_step, 3)
    assert smoke.stage_routes_expected(launches) == {
        "stage_softmax_stats": {"mma": 36, "simt": 0}, "stage_conv_bwd": {"mma": 12, "simt": 0},
        "stage_conv": {"mma": 12, "simt": 0}, "stage_sigmoid": none,
        "stage_softmax_apply_pool": none}
    one = smoke.stage_routes_expected(smoke.expected(smoke.SIGMOID_PER_STEP))
    assert one["stage_sigmoid"] == {"mma": 12, "simt": 0}
    assert one["stage_conv"] == {"mma": 4, "simt": 0}
    sig = smoke.expected(smoke.SIGMOID_PER_STEP, 3)
    assert smoke.stage_routes_expected(sig) == {
        "stage_softmax_stats": none, "stage_conv_bwd": {"mma": 12, "simt": 0},
        "stage_conv": {"mma": 12, "simt": 0}, "stage_sigmoid": {"mma": 36, "simt": 0},
        "stage_softmax_apply_pool": none}
    assert smoke.stage_routes_expected({"stage_conv_bwd": 20, "stage_sigmoid": 10,
                                        "stage_softmax_apply_pool": 5}, "simt") == {
        "stage_softmax_stats": none, "stage_conv_bwd": {"mma": 0, "simt": 20},
        "stage_conv": none, "stage_sigmoid": {"mma": 0, "simt": 10},
        "stage_softmax_apply_pool": {"mma": 0, "simt": 5}}
    assert smoke.read_stage_routes().keys() == set(smoke.STAGE_ROUTED)


def test_phase_9_covers_every_template(smoke):
    """Phases 9 and 16 run every routed kernel at both templates: (64, 64)
    in the plain and `up` forms, (32, 64) with the 1x1 skip, and the two
    forward passes that pool in their `down` form; the pooled apply pass
    (routed too) at its one template, (64, 64), the form D runs. Every
    form and resolution the plans launch is among the cases, at its path's
    batch."""
    both = smoke.STAGE_CASES + smoke.SIGMOID_STAGE_CASES
    cases = {(k, f, c, co) for k, f, c, co, _, _ in both if k in smoke.STAGE_ROUTED}
    timed = {(k, smoke.stage_key(f, res, n)) for k, f, c, co, res, n in both}
    for plan in (smoke.FFHQ_PLAN, smoke.SIGMOID_PLAN):
        assert {(k, key) for k in smoke.STAGE_ROUTED for key in plan[k]} <= timed
    for k in smoke.STAGE_ROUTED:
        assert {(k, key + f"/{smoke.BATCH}") for key in smoke.LSUN_PLAN[k]} <= timed
    pool = "stage_softmax_apply_pool"
    assert pool in smoke.STAGE_ROUTED
    for k in smoke.STAGE_ROUTED:
        if k != pool:
            assert {(k, "plain", 64, 64), (k, "up", 64, 64), (k, "skip", 32, 64)} <= cases
    for k in ("stage_conv", "stage_sigmoid"):
        assert (k, "down", 64, 64) in cases
    assert {(k, f, c, co) for k, f, c, co in cases if k == pool} == {(pool, "plain", 64, 64)}
    assert fs.stage_route(torch.bfloat16, 64, 64, h=512, w=512, hd=16, cout=64) == fs.MMA
    assert {(c, co) for _, _, c, co in cases} == set(fs.STAGE_MMA_WIDTHS)
    assert ({k: len(v) for k, v in smoke.LSUN_PLAN.items() if k.startswith("stage")}
            == {"stage_conv": 2, "stage_conv_bwd": 2, "stage_softmax_stats": 0,
                "stage_softmax_apply_pool": 0, "stage_sigmoid": 0})


def test_kernels_line_carries_the_stage_routes(smoke):
    """Rows 7-11 of the kernels line: the mma route's per-step time, beside
    the simt route's time of the same launches and the main path's
    launches on the mma route (stage_sigmoid's from the ffhq_512-sigmoid
    steps); the apply-pool row, which the card's profile takes off the
    path, with one launch's times at 512^2 and the launches of the run
    with every stage fused."""
    times, err = {}, {}
    forms_of = dict(smoke.FFHQ_STAGE_PER_STEP,
                    stage_sigmoid=smoke.SIGMOID_STAGE_PER_STEP["stage_sigmoid"])
    for kernel, forms in forms_of.items():
        err[kernel] = 0.01
        for f in list(forms) + ["plain@512"]:
            times[(kernel, f)] = dict(ms=2.0, plain_ms=30.0, bound_ms=0.3, bound_by="bytes",
                                      ms_simt=20.0)
    launches = smoke.expected({k: sum(v.values()) for k, v in
                               smoke.FFHQ_STAGE_PER_STEP.items()}, 3)
    routes = smoke.stage_routes_expected(launches)
    forced = smoke.expected({k: 20 for k in smoke.STAGE_KERNELS})
    rows = {k: smoke.stage_entry(k, times, err, launches, routes=routes, forced=forced)
            for k in smoke.STAGE_KERNELS}
    sig_launches = smoke.expected(smoke.SIGMOID_PER_STEP, 3)
    rows["stage_sigmoid"] = smoke.stage_entry(
        "stage_sigmoid", times, err, sig_launches, forms_of["stage_sigmoid"],
        smoke.stage_routes_expected(sig_launches))
    assert rows["stage_softmax_stats"]["ms"] == 24.0
    assert rows["stage_softmax_stats"]["ms_simt"] == 240.0
    assert rows["stage_softmax_stats"]["launches_mma"] == 36
    assert rows["stage_conv_bwd"]["ms_simt"] == 80.0 and rows["stage_conv_bwd"]["routes"] == ["mma"]
    assert "ms_simt" in rows["stage_conv_bwd"]["forms"][0]
    assert rows["stage_conv"]["ms"] == 8.0 and rows["stage_conv"]["ms_simt"] == 80.0
    assert rows["stage_conv"]["launches_mma"] == 12 and rows["stage_conv"]["routes"] == ["mma"]
    assert rows["stage_sigmoid"]["ms"] == 24.0 and rows["stage_sigmoid"]["ms_simt"] == 240.0
    assert rows["stage_sigmoid"]["launches"] == rows["stage_sigmoid"]["launches_mma"] == 36
    assert {f["form"] for f in rows["stage_sigmoid"]["forms"]} == {
        f"up@{r}" for r in (64, 128, 256, 512)}
    apply_pool = rows["stage_softmax_apply_pool"]
    assert apply_pool["ms"] == 2.0 and apply_pool["ms_simt"] == 20.0
    assert apply_pool["launches"] == 20 and apply_pool["launches_mma"] == 0
    assert apply_pool["main_path"] is False and "every stage fused" in apply_pool[
        "launches_source"]
    assert apply_pool["routes"] == ["mma"] and "ms_simt" in apply_pool["forms"][0]
    assert all("main_path" not in r for k, r in rows.items() if k != "stage_softmax_apply_pool")
    for row in rows.values():
        assert {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
                "plain_ms", "bound_ms", "bound_by", "library_ms"} <= set(row)
