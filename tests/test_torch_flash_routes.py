"""The routes of the three flash passes, on the CPU: which kernels
`flash_route` picks (mma: bf16 on the tensor cores at the widths of a
template; simt: f32 and every other width), how widths pad to a template,
what the wrappers refuse, and what chip_smoke.py reads of the mma kernels
(their names in ptxas and SASS listings, the exponential floor, the route
counters, the checks against the library). The kernels themselves run on
the card only (tests/test_torch_kernels_gpu.py)."""

import importlib.util
import os
import stat
import sys

import numpy as np
import pytest
import torch

from locate_tpu_torch.ops import flash_attention as fl
from torch_threads import on_one_thread

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# (T, dh, dv) of lsun_bedroom_128's nine self-attention layers (heads 1) and
# the template each pads to; then heads = 2 at 32^2
LAYERS = [((16, 64, 256), (64, 256)), ((64, 32, 128), (32, 128)), ((256, 16, 64), (16, 64)),
          ((1024, 8, 32), (16, 32)), ((4096, 8, 32), (16, 32)), ((16384, 8, 32), (16, 32)),
          ((1024, 16, 64), (16, 64)), ((256, 32, 128), (32, 128)), ((64, 64, 256), (64, 256)),
          ((1024, 8, 16), (16, 16))]


@pytest.mark.parametrize("layer,padded", LAYERS)
def test_bf16_layers_take_the_mma_route(layer, padded):
    _, dh, dv = layer
    assert fl.flash_route(torch.bfloat16, dh, dv) == fl.MMA
    assert fl.mma_widths(dh, dv) == padded


def test_the_layers_are_chip_smokes(smoke):
    """The table above is chip_smoke.py's nine shapes plus heads = 2."""
    assert sorted(l for l, _ in LAYERS[:9]) == sorted(smoke.FLASH_SHAPES)


@pytest.mark.parametrize("dtype,dh,dv", [
    (torch.float32, 8, 32),      # f32 keeps f32 products (TF32 misses the 1e-4 rule)
    (torch.float32, 64, 256),
    (torch.bfloat16, 72, 64),    # dh beyond every template
    (torch.bfloat16, 64, 264),   # dv beyond every template
    (torch.bfloat16, 12, 20),    # not multiples of 8: no 16-byte row copies
    (torch.bfloat16, 5, 7),
    (torch.float16, 8, 32),
])
def test_everything_else_takes_the_simt_route(dtype, dh, dv):
    assert fl.flash_route(dtype, dh, dv) == fl.SIMT


def test_padding_goes_to_the_narrowest_template():
    assert fl.MMA_WIDTHS == ((16, 16), (16, 32), (16, 64), (32, 128), (64, 256))
    assert fl.mma_widths(16, 8) == (16, 16)
    assert fl.mma_widths(24, 40) == (32, 128)   # dh alone would fit (32, 128)
    assert fl.mma_widths(16, 128) == (32, 128)  # dv pulls dh up
    assert fl.mma_widths(40, 8) == (64, 256)
    assert fl.mma_widths(64, 256) == (64, 256)
    assert fl.mma_widths(0, 16) is None


def test_the_mma_tile_asks_the_library():
    """On the mma route the library is asked for the bytes of the padded
    template (it pads nothing itself); there is no q tile to pick."""
    class Lib:
        def __init__(self, nbytes):
            self.nbytes, self.asked = nbytes, []

        def locate_flash_mma_smem_bytes(self, kind, dh, dv):
            self.asked.append((kind, dh, dv))
            return self.nbytes

    lib = Lib(25600)
    assert fl.pick_tile(fl._DKV, 64, 4096, 8, 32, lib, fl.MMA) == 0
    assert lib.asked == [(fl._DKV, 16, 32)]
    with pytest.raises(ValueError, match="no mma template"):
        fl.pick_tile(fl._DQ, 64, 4096, 12, 20, Lib(0), fl.MMA)
    with pytest.raises(ValueError, match="shared memory"):
        fl.pick_tile(fl._DQ, 64, 4096, 64, 256, Lib(300000), fl.MMA)


def _operands(dtype, b=2, t=24, s=40, dh=8, dv=16, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(sh, dtype=np.float32)).to(dtype)
                   for sh in ((b, t, dh), (b, s, dh), (b, s, dv), (b, t, dv)))
    o, ell = fl.flash_forward_reference(q, k, v, dh ** -0.5)
    return q, k, v, do, ell, fl.row_delta(o, do)


@pytest.mark.parametrize("route", [None, "mma", "simt"])
@on_one_thread
def test_cpu_wrappers_run_the_plain_version_on_any_route(route):
    """On CPU tensors the route names the card's kernels only: the plain
    versions run, and no launch is counted."""
    q, k, v, do, ell, delta = _operands(torch.bfloat16)
    counts = [(f.launches, f.launches_mma, f.launches_simt) for f in (fl.flash_dq, fl.flash_dkv)]
    dq = fl.flash_dq(q, k, v, do, ell, delta, 0.5, route=route)
    dk, dv = fl.flash_dkv(q, k, v, do, ell, delta, 0.5, route=route)
    assert torch.equal(dq, fl.flash_dq_reference(q, k, v, do, ell, delta, 0.5))
    for a, b in zip((dk, dv), fl.flash_dkv_reference(q, k, v, do, ell, delta, 0.5)):
        assert torch.equal(a, b)
    assert counts == [(f.launches, f.launches_mma, f.launches_simt)
                      for f in (fl.flash_dq, fl.flash_dkv)]


def test_wrappers_refuse_a_route_the_call_cannot_take():
    q, k, v, do, ell, delta = _operands(torch.float32)
    with pytest.raises(ValueError, match="mma route"):
        fl.flash_dq(q, k, v, do, ell, delta, 0.5, route=fl.MMA)
    q, k, v, do, ell, delta = _operands(torch.bfloat16, dh=12)
    with pytest.raises(ValueError, match="mma route"):
        fl.flash_dkv(q, k, v, do, ell, delta, 0.5, route=fl.MMA)
    with pytest.raises(ValueError, match="route must be"):
        fl.flash_dq(q, k, v, do, ell, delta, 0.5, route="wgmma")


def test_wrappers_refuse_other_devices_and_odd_shapes():
    m = torch.zeros(1, 4, 8, device="meta")
    for fn in (fl.flash_dq, fl.flash_dkv):
        with pytest.raises(ValueError, match="no kernel for device"):
            fn(m, m, m, m, m[..., 0], m[..., 0], 1.0, route=fl.MMA)
    # the card path validates shapes before it looks for a library
    q, k, v, do, ell, delta = _operands(torch.bfloat16)
    with pytest.raises(ValueError, match="do not match"):
        fl._backward_call(fl._DQ, q, k[:, :, :4], v, do, ell, delta, None)
    with pytest.raises(ValueError, match="do must be"):
        fl._backward_call(fl._DKV, q, k, v, do[:, :-1], ell, delta, None)
    with pytest.raises(ValueError, match="ell must be"):
        fl._backward_call(fl._DQ, q, k, v, do, ell[:, :-1], delta, None)


def test_each_launch_counts_on_its_route():
    class Fn:
        launches = launches_mma = launches_simt = 0

    for route in (fl.MMA, fl.MMA, fl.SIMT):
        fl._count(Fn, route)
    assert (Fn.launches, Fn.launches_mma, Fn.launches_simt) == (3, 2, 1)


MMA_PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__0000baa4_18_flash_attention_cu_51c301b513flash_dkv_mmaILi64ELi256EEEvPK13__nv_bfloat16S3_S3_S3_PKfS5_PS1_S6_iiiiif' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 194 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__0000baa4_18_flash_attention_cu_51c301b512flash_dq_mmaILi16ELi32EEEvPK13__nv_bfloat16S3_S3_S3_PKfS5_PS1_iiiiif' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 109 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__0000baa4_18_flash_attention_cu_51c301b58flash_dqI13__nv_bfloat16Li4EEvPKT_S4_S4_S4_PKfS6_PS2_iiiiif' for 'sm_90a'
    0 bytes stack frame, 16 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 71 registers, used 1 barriers
"""


def test_ptxas_names_the_mma_kernels(smoke):
    """The mma kernels are templates on the padded widths alone; each
    instance keeps a name of its own, apart from the simt kernel whose name
    it contains."""
    kernels = smoke.parse_ptxas(MMA_PTXAS_LOG)
    assert set(kernels) == {"flash_dkv_mma<64,256>", "flash_dq_mma<16,32>", "flash_dq<bf16,4>"}
    assert kernels["flash_dkv_mma<64,256>"]["registers"] == 194
    assert kernels["flash_dq<bf16,4>"]["spill_stores"] == 16


def test_sass_counts_tensor_core_instructions(smoke, tmp_path, monkeypatch):
    """`sass_tensor_ops` reads `cuobjdump -sass`: HMMA and HGMMA lines per
    kernel, by readable name."""
    listing = tmp_path / "listing.txt"
    listing.write_text(
        "\t\tFunction : _ZN50_GLOBAL__N__0_flash_attention_cu_13flash_dkv_mmaILi16ELi32EEEvPKf\n"
        "        /*0100*/                   HMMA.16816.F32.BF16 R24, R4, R20, R24 ;\n"
        "        /*0110*/                   LDSM.16.MT88.4 R8, [R2] ;\n"
        "        /*0120*/                   HMMA.16816.F32.BF16 R28, R4, R22, R28 ;\n"
        "\t\tFunction : _ZN50_GLOBAL__N__0_flash_attention_cu_9flash_dqIfLi4EEvPKT_\n"
        "        /*0100*/                   FFMA R1, R2, R3, R1 ;\n")
    tool = tmp_path / "cuobjdump"
    tool.write_text(f"#!{sys.executable}\nimport sys\nprint(open({str(listing)!r}).read())\n")
    tool.chmod(tool.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(smoke, "cuobjdump_path", lambda: str(tool))
    assert smoke.sass_tensor_ops("lib.so") == {"flash_dkv_mma<16,32>": 2, "flash_dq<f32,4>": 0}


def test_exp_floor_of_the_dominant_shape(smoke):
    """B T S exponentials on 132 x 16 SFU lanes at the SXM card's 1.98 GHz
    (the clock of PEAK_FLOPS's f32 figure): 0.2568 ms a backward pass at
    batch 64, T = S = 4096 (the 64^2 layers)."""
    assert abs(smoke.flash_exp_floor(64, 4096, 4096) - 0.2568) < 1e-4
    assert smoke.SFU_LANES == 2112
    # 66.9e12, which PEAK_FLOPS rounds to 67e12
    assert round(132 * 128 * 2 * smoke.SFU_HZ / 1e12) * 1e12 == smoke.PEAK_FLOPS[torch.float32]
    assert "flash_dq_mma" in smoke.ALL_CUDA_KERNELS
    assert (smoke.ALL_CUDA_KERNELS.index("flash_dq_mma")
            < smoke.ALL_CUDA_KERNELS.index("flash_dq"))  # a name before any it contains


def test_route_counters_expected(smoke):
    assert smoke.routes_expected(smoke.FLASH_PER_STEP) == {
        "flash_fwd": {"mma": 25, "simt": 0}, "flash_dq": {"mma": 20, "simt": 0},
        "flash_dkv": {"mma": 20, "simt": 0}}
    assert smoke.routes_expected({"flash_dkv": 3}, "simt") == {
        "flash_fwd": {"mma": 0, "simt": 0}, "flash_dq": {"mma": 0, "simt": 0},
        "flash_dkv": {"mma": 0, "simt": 3}}
    assert smoke.read_route_counters().keys() == {"flash_fwd", "flash_dq", "flash_dkv"}
    assert smoke.RAISED_GRAD_NORM_LIMIT > 2e7  # above random-weight ffhq_512 G's norm


# ---------------------------------------------------------------------------
# the forward's two routes
# ---------------------------------------------------------------------------


def _forward_counts():
    return fl.flash_fwd.launches, fl.flash_fwd.launches_mma, fl.flash_fwd.launches_simt


@pytest.mark.parametrize("layer,padded", LAYERS)
@on_one_thread
def test_the_forward_takes_the_mma_route_at_every_bf16_layer(layer, padded):
    """The forward routes as the backward passes do: each bf16 layer of the
    model goes to the mma kernel of its template; on CPU tensors that route
    runs the plain version and counts no launch."""
    _, dh, dv = layer
    assert fl.flash_route(torch.bfloat16, dh, dv) == fl.MMA
    q, k, v, *_ = _operands(torch.bfloat16, dh=dh, dv=dv)
    before = _forward_counts()
    o, ell = fl.flash_fwd(q, k, v, dh ** -0.5, route=fl.MMA)
    want = fl.flash_forward_reference(q, k, v, dh ** -0.5)
    assert torch.equal(o, want[0]) and torch.equal(ell, want[1])
    assert _forward_counts() == before


@pytest.mark.parametrize("route", [None, "mma", "simt"])
@on_one_thread
def test_cpu_forward_runs_the_plain_version_on_any_route(route):
    q, k, v, *_ = _operands(torch.bfloat16)
    before = _forward_counts()
    o, ell = fl.flash_fwd(q, k, v, 0.5, route=route)
    want = fl.flash_forward_reference(q, k, v, 0.5)
    assert torch.equal(o, want[0]) and torch.equal(ell, want[1])
    assert o.dtype == torch.bfloat16 and ell.dtype == torch.float32
    assert _forward_counts() == before


@on_one_thread
def test_f32_forward_keeps_the_simt_route():
    """f32 keeps its f32 products: the forward takes the simt kernel by
    default and refuses the mma route, on the CPU too."""
    q, k, v, *_ = _operands(torch.float32)
    assert fl.flash_route(q.dtype, 8, 16) == fl.SIMT
    with pytest.raises(ValueError, match="mma route"):
        fl.flash_fwd(q, k, v, 0.5, route=fl.MMA)
    o, _ = fl.flash_fwd(q, k, v, 0.5, route=fl.SIMT)
    assert torch.equal(o, fl.flash_forward_reference(q, k, v, 0.5)[0])


@pytest.mark.parametrize("dh,dv", [(12, 20), (72, 64), (64, 264), (5, 7)])
def test_forward_refuses_the_mma_route_outside_the_templates(dh, dv):
    q, k, v, *_ = _operands(torch.bfloat16, dh=dh, dv=dv)
    with pytest.raises(ValueError, match="mma route"):
        fl.flash_fwd(q, k, v, 0.5, route=fl.MMA)
    with pytest.raises(ValueError, match="route must be"):
        fl.flash_fwd(q, k, v, 0.5, route="wgmma")


def test_the_forward_mma_tile_asks_the_library():
    """The forward's mma block is the template's: the library is asked for
    the bytes of kind 0 (the forward) at the padded widths."""
    asked = []

    class Lib:
        def locate_flash_mma_smem_bytes(self, kind, dh, dv):
            asked.append((kind, dh, dv))
            return 22528

    assert fl._FWD == 0
    assert fl.pick_tile(fl._FWD, 64, 4096, 8, 32, Lib(), fl.MMA) == 0
    assert fl.pick_tile(fl._FWD, 16, 256, 32, 128, Lib(), fl.MMA) == 0
    assert asked == [(fl._FWD, 16, 32), (fl._FWD, 32, 128)]


def test_the_forward_refuses_other_devices():
    m = torch.zeros(1, 4, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        fl.flash_fwd(m, m, m, 1.0, route=fl.MMA)


FWD_PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__0000baa4_18_flash_attention_cu_51c301b513flash_fwd_mmaILi16ELi32EEEvPK13__nv_bfloat16S3_S3_PS1_Pfiiiiif' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__0000baa4_18_flash_attention_cu_51c301b513flash_fwd_mmaILi64ELi256EEEvPK13__nv_bfloat16S3_S3_PS1_Pfiiiiif' for 'sm_90a'
    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__0000baa4_18_flash_attention_cu_51c301b59flash_fwdI13__nv_bfloat16Li4EEvPKT_S4_S4_PS2_Pfiiiiif' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 60 registers, used 1 barriers
"""


def test_ptxas_and_sass_name_the_forward_mma_kernel(smoke, tmp_path, monkeypatch):
    """flash_fwd_mma's instances keep names of their own, apart from the
    simt forward whose name theirs contains, in ptxas's report and in the
    SASS listing; phase 2 checks all three mma kernels."""
    assert smoke.FLASH_MMA_KERNELS == ("flash_fwd_mma", "flash_dq_mma", "flash_dkv_mma")
    assert (smoke.ALL_CUDA_KERNELS.index("flash_fwd_mma")
            < smoke.ALL_CUDA_KERNELS.index("flash_fwd"))
    kernels = smoke.parse_ptxas(FWD_PTXAS_LOG)
    assert set(kernels) == {"flash_fwd_mma<16,32>", "flash_fwd_mma<64,256>", "flash_fwd<bf16,4>"}
    assert kernels["flash_fwd_mma<64,256>"]["spill_stores"] == 8
    assert kernels["flash_fwd_mma<16,32>"]["registers"] == 96
    listing = tmp_path / "listing.txt"
    listing.write_text(
        "\t\tFunction : _ZN50_GLOBAL__N__0_flash_attention_cu_13flash_fwd_mmaILi32ELi128EEEvPK\n"
        "        /*0100*/                   HMMA.16816.F32.BF16 R24, R4, R20, R24 ;\n"
        "        /*0110*/                   MUFU.EX2 R8, R8 ;\n"
        "\t\tFunction : _ZN50_GLOBAL__N__0_flash_attention_cu_9flash_fwdI13__nv_bfloat16Li1EEvPK\n"
        "        /*0100*/                   FFMA R1, R2, R3, R1 ;\n")
    tool = tmp_path / "cuobjdump"
    tool.write_text(f"#!{sys.executable}\nimport sys\nprint(open({str(listing)!r}).read())\n")
    tool.chmod(tool.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(smoke, "cuobjdump_path", lambda: str(tool))
    assert smoke.sass_tensor_ops("lib.so") == {"flash_fwd_mma<32,128>": 1, "flash_fwd<bf16,1>": 0}
