"""What of chip_smoke.py runs without a card: its ptxas parser on every
kernel of csrc/fused_attention.cu, csrc/fused_stage.cu and
csrc/flash_attention.cu (and on a kernel it does not know), its bounds and
launch counts, the softmax and the sigmoid gate's and the flash kernels',
read from the models' dispatch under the card's gate profile (and, under
the JAX package's thresholds, the counts chip_smoke.py pinned before the
profile), and its refusal to report anything when there is no card."""

import importlib.util
import json
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def jax_thresholds(tmp_path, monkeypatch):
    """A gate profile holding the JAX package's dispatch: every flavor fuses
    at 512^2, the sigmoid gate runs its kernels up to 256 locations."""
    from locate_tpu_torch.ops import gate_profile

    path = tmp_path / "gate_profile.json"
    path.write_text(json.dumps({"meta": {}, "min_locations": {f: 512 * 512 for f in
                                                              gate_profile.FLAVORS},
                                "sigmoid_locations": [{"min": 0, "max": 256}]}))
    monkeypatch.setenv(gate_profile.ENV, str(path))


PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__436c6669_18_fused_attention_cu_10596a5e11softmax_bwdIfEEvPKT_S3_PKfS3_S5_S3_S5_S5_S5_S5_PS1_PfS7_iiiiiiiifff' for 'sm_90a'
    8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 32 registers, used 1 barriers, 8 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__436c6669_18_fused_attention_cu_10596a5e20softmax_csum_partialI13__nv_bfloat16EEvPKT_S4_PKfS4_S6_S4_S6_S6_S6_Pfiiiiiifff' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__436c6669_18_fused_attention_cu_10596a5e15reduce_partialsEPKfPfii' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 1 barriers, 1056 bytes smem
ptxas info    : Compiling entry function '_Z13some_new_kernelPf' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 12 registers, used 0 barriers
"""


def test_ptxas_parser_reads_every_kernel(smoke):
    """The first parser looked up a fixed regex's match on every kernel
    name and crashed on a name it did not know."""
    kernels = smoke.parse_ptxas(PTXAS_LOG)
    assert kernels["softmax_bwd<f32>"] == dict(spill_stores=8, spill_loads=8, registers=32,
                                               static_smem=0)
    assert kernels["softmax_csum_partial<bf16>"]["registers"] == 40
    assert kernels["reduce_partials"]["static_smem"] == 1056
    assert kernels["_Z13some_new_kernelPf"]["registers"] == 12


def test_bounds_of_the_backward_kernels(smoke):
    """At 128^2 x 64 channels, batch 64, bf16 both backward passes are
    bound by bytes: csum reads x and dy (~80 us), the backward reads both
    and writes dx (~120 us)."""
    csum = smoke.bound("softmax_csum", 64, 16384, 64, 16, 64, torch.bfloat16)
    bwd = smoke.bound("softmax_bwd", 64, 16384, 64, 16, 64, torch.bfloat16)
    assert csum[1] == bwd[1] == "bytes"
    assert 0.079 < csum[0] < 0.082 and 0.119 < bwd[0] < 0.122


def test_launches_per_step_add_up(smoke):
    assert sum(smoke.FWD_PER_STEP.values()) == 30
    assert sum(smoke.BWD_PER_STEP.values()) == 24
    assert len(smoke.SHAPES) == 9 and sum(smoke.SERVE.values()) == 6


STAGE_PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__35eedcd4_14_fused_stage_cu_ac477c5714stage_conv_bwdIfEEvPKT_S3_PKfS5_S3_S3_S3_S3_PS1_S6_Pfiiiiiiiifi' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 185 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__35eedcd4_14_fused_stage_cu_ac477c5724stage_softmax_apply_poolI13__nv_bfloat16EEvPKT_PKfS4_S6_S4_S6_S6_S6_PS2_iiiiiiiifff' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__35eedcd4_14_fused_stage_cu_ac477c5710stage_convIfEEvPKT_PKfS5_S3_S3_S5_S3_PS1_iiiiiiifii' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 114 registers, used 1 barriers
"""


def test_ptxas_parser_names_the_stage_kernels(smoke):
    """A stage kernel whose name holds another kernel's name (the stage's
    apply pass holds the gate's `softmax_apply`) is named as itself."""
    kernels = smoke.parse_ptxas(STAGE_PTXAS_LOG)
    assert set(kernels) == {"stage_conv_bwd<f32>", "stage_softmax_apply_pool<bf16>",
                            "stage_conv<f32>"}
    assert kernels["stage_conv_bwd<f32>"]["registers"] == 185


def test_bounds_of_the_stage_kernels(smoke):
    """ffhq_512's 512^2 stage, batch 16, C = Co = 64, bf16: G's stats pass
    reads 134 MB of coarse x and writes 537 MB of w_pre but is bound by its
    2.2e11 flops (~0.23 ms); D's moves ~1.07 GB (~0.32 ms); the pooled apply
    ~671 MB (~0.20 ms); the conv backward's 5.2e11 flops ~0.52 ms, but in
    D's plain form its four 537 MB tensors (x, dw, du, dxs) take longer."""
    bf16 = torch.bfloat16
    t, by = smoke.stage_bound("stage_softmax_stats", 16, 64, 64, bf16, "up")
    assert by == "operations" and 0.22 < t < 0.23
    t, by = smoke.stage_bound("stage_softmax_stats", 16, 64, 64, bf16, "plain")
    assert by == "bytes" and 0.31 < t < 0.33
    t, by = smoke.stage_bound("stage_softmax_apply_pool", 16, 64, 64, bf16, "plain")
    assert by == "bytes" and 0.19 < t < 0.21
    t, by = smoke.stage_bound("stage_conv_bwd", 16, 64, 64, bf16, "up")
    assert by == "operations" and 0.51 < t < 0.53
    t, by = smoke.stage_bound("stage_conv_bwd", 16, 64, 64, bf16, "plain")
    assert by == "bytes" and 0.63 < t < 0.65


def test_ffhq_launches_per_step_add_up(smoke, jax_thresholds):
    """Under the card's profile G's four stages from 64^2 to 512^2 fuse
    (up_pair) and no stage of D does: each fused stage runs its stats pass
    three times a step (the fake, the G step, its remat recompute) and its
    backward once (w recomputed once), D's 512^2 gate runs unfused, and
    the pooled apply pass has no launch. Under the JAX package's
    thresholds (512^2 for every flavor) the plan gives the counts chip_smoke
    pinned by hand before: G's and D's 512^2 stages fused, D's stats pass
    six times."""
    per_step = {k: sum(v.values()) for k, v in smoke.FFHQ_STAGE_PER_STEP.items()}
    assert per_step == {"stage_softmax_stats": 12, "stage_softmax_apply_pool": 0,
                        "stage_conv": 4, "stage_conv_bwd": 4}
    assert smoke.FFHQ_STAGE_PER_STEP["stage_softmax_stats"] == {
        f"up@{r}": 3 for r in (64, 128, 256, 512)}
    # 4 backward calls x 8 stages: G's, D's three
    assert smoke.FFHQ_GATE_PER_STEP["softmax_csum"] == 4 * 8
    assert smoke.FFHQ_GATE_PER_STEP == {"softmax_stats": 64, "softmax_apply": 72,
                                        "softmax_csum": 32, "softmax_bwd": 32}
    assert smoke.FFHQ_SERVE_PER_FORWARD == {"softmax_stats": 4, "softmax_apply": 8,
                                            "stage_softmax_stats": 4}
    jax = smoke.totals(smoke.path_plan(smoke.ffhq_config()))
    assert jax == {"softmax_stats": 67, "softmax_apply": 66, "softmax_csum": 32,
                   "softmax_bwd": 32, "stage_conv": 4, "stage_softmax_stats": 9,
                   "stage_softmax_apply_pool": 6, "stage_conv_bwd": 4}
    assert smoke.totals(smoke.path_plan(smoke.ffhq_config(), serve=True)) == {
        "softmax_stats": 7, "softmax_apply": 8, "stage_softmax_stats": 1}


SIGMOID_PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__436c6669_18_fused_attention_cu_10596a5e12sigmoid_gateI13__nv_bfloat16EEvPKT_PKfS4_S6_S4_S6_PS2_iiiiiiff' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__436c6669_18_fused_attention_cu_10596a5e11sigmoid_bwdIfEEvPKT_S3_PKfS3_S5_S3_S5_PS1_PfS7_iiiiiiiiff' for 'sm_90a'
    8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 32 registers, used 1 barriers, 8 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__35eedcd4_14_fused_stage_cu_ac477c5713stage_sigmoidI13__nv_bfloat16EEvPKT_PKfS6_S4_S4_S6_S4_S6_S4_S6_S4_S6_PS2_iiiiiiiiiffii' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 122 registers, used 1 barriers
"""


def test_ptxas_parser_names_the_sigmoid_kernels(smoke):
    """The sigmoid gate's two kernels and the stage's sigmoid pass, each
    under its own name (none of the three holds another kernel's name)."""
    kernels = smoke.parse_ptxas(SIGMOID_PTXAS_LOG)
    assert set(kernels) == {"sigmoid_gate<bf16>", "sigmoid_bwd<f32>", "stage_sigmoid<bf16>"}
    assert kernels["sigmoid_bwd<f32>"]["spill_stores"] == 8
    assert kernels["stage_sigmoid<bf16>"]["registers"] == 122
    assert {"sigmoid_gate", "sigmoid_bwd"} <= set(smoke.CUDA_KERNELS)
    assert "stage_sigmoid" in smoke.STAGE_CUDA_KERNELS


def test_bounds_of_the_sigmoid_kernels(smoke):
    """ffhq_512, batch 16, bf16. The stage's sigmoid pass at 512^2, C = Co
    = 64: in its plain form it reads x and writes y (1.074 GB) and reads
    the f32 pos_proj (16.8 MB), 0.3255 ms by bytes; in G's `up` and D's
    `down` forms its 53,248 flops a pixel over 4,194,304 pixels take 0.2258
    ms, more than their 671 MB of traffic (0.200 ms). The gate's backward at
    the stage's 262,144 locations reads x and dy and writes dx (1.61 GB),
    and reads pos_proj and writes dpos_proj: 0.4908 ms. At the gate's
    shapes of 16^2 and less every bound is at most 2 microseconds; at 512^2
the gate reads x and writes y, 1.074 GB, 0.3255 ms."""
    bf16 = torch.bfloat16
    t, by = smoke.stage_bound("stage_sigmoid", 16, 64, 64, bf16, "plain")
    assert by == "bytes" and 0.3255 < t < 0.3256
    assert smoke.stage_bound("stage_conv", 16, 64, 64, bf16, "plain")[0] < t  # no pos_proj
    for form in ("up", "down"):
        t, by = smoke.stage_bound("stage_sigmoid", 16, 64, 64, bf16, form)
        assert by == "operations" and 0.2258 < t < 0.2259
    t, by = smoke.bound("sigmoid_bwd", 16, 262144, 64, 16, 64, bf16)
    assert by == "bytes" and 0.490 < t < 0.491
    for hw, c, hd in smoke.SIGMOID_SHAPES:
        for kind in ("sigmoid_gate", "sigmoid_bwd"):
            assert hw > 256 or smoke.bound(kind, 16, hw, c, hd, c, bf16)[0] < 2e-3
    t, by = smoke.bound("sigmoid_gate", 16, 262144, 64, 16, 64, bf16)
    assert by == "bytes" and 0.3255 < t < 0.3256


def test_sigmoid_launches_per_step_add_up(smoke, jax_thresholds):
    """One ffhq_512-sigmoid train step: G forwards three times (the fake,
    the G step, its remat recompute) and D six (real, fake, the G step,
    each recomputed). Under the card's profile the gate's one-pass kernel
    runs from 32^2 to 512^2 (G's 32^2 gate, D's five), the stage's sigmoid
    pass in G's four fused stages from 64^2 to 512^2; each backward pass
    runs the gate's backward at those gates, and G's in each fused stage's
    backward, with the conv recompute and the conv backward. One served
    forward: G's 32^2 gate and its four fused stages. Under the JAX package's thresholds: the gates up to 16^2 and
    both 512^2 stages, as chip_smoke pinned by hand before."""
    assert smoke.SIGMOID_PER_STEP == {"sigmoid_gate": 33, "sigmoid_bwd": 20,
                                      "stage_sigmoid": 12, "stage_conv": 4,
                                      "stage_conv_bwd": 4}
    assert sum(smoke.SIGMOID_FWD_PER_STEP.values()) == 1 * 3 + 5 * 6
    assert sum(smoke.SIGMOID_BWD_PER_STEP.values()) == 1 + 5 * 3 + 4
    assert smoke.SIGMOID_SERVE_PER_FORWARD == {"sigmoid_gate": 1, "stage_sigmoid": 4}
    assert len(smoke.SIGMOID_SHAPES) == 6
    jax = smoke.path_plan(smoke.ffhq_config(**smoke.SIGMOID))
    assert smoke.totals(jax) == {"sigmoid_gate": 27, "sigmoid_bwd": 16, "stage_sigmoid": 9,
                                 "stage_conv": 4, "stage_conv_bwd": 4}
    assert len(jax["sigmoid_gate"]) == 5
    assert smoke.SIGMOID_GATE_MAX < 2.0  # the clamp binds below the gate's ceiling
    per_step = {k: sum(v.values()) for k, v in smoke.SIGMOID_STAGE_PER_STEP.items()}
    assert all(smoke.SIGMOID_PER_STEP[k] == v for k, v in per_step.items())
    assert set(smoke.REPLACES) == set(smoke.KERNELS) | set(smoke.STAGE_KERNELS) | {
        "sigmoid_gate", "sigmoid_bwd", "stage_sigmoid"} | set(smoke.FLASH_KERNELS)


FLASH_PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__0000baa4_18_flash_attention_cu_51c301b59flash_dkvI13__nv_bfloat16Li4EEvPKT_S4_S4_S4_PKfS6_PS2_S7_iiiiif' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 77 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__0000baa4_18_flash_attention_cu_51c301b59flash_dkvIfLi1EEvPKT_S3_S3_S3_PKfS5_PS1_S6_iiiiif' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 79 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__0000baa4_18_flash_attention_cu_51c301b58flash_dqIfLi4EEvPKT_S3_S3_S3_PKfS5_PS1_iiiiif' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 71 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__0000baa4_18_flash_attention_cu_51c301b59flash_fwdI13__nv_bfloat16Li1EEvPKT_S4_S4_PS2_Pfiiiiif' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 60 registers, used 1 barriers
"""


def test_ptxas_parser_names_the_flash_kernels(smoke):
    """The flash kernels are templates on the operand type and the rows a
    thread takes of a score tile (4: 64-row q tiles, 1: 16-row ones): each
    instance keeps a name of its own."""
    kernels = smoke.parse_ptxas(FLASH_PTXAS_LOG)
    assert set(kernels) == {"flash_dkv<bf16,4>", "flash_dkv<f32,1>", "flash_dq<f32,4>",
                            "flash_fwd<bf16,1>"}
    assert kernels["flash_dkv<bf16,4>"]["registers"] == 77
    assert set(smoke.FLASH_KERNELS) <= set(smoke.ALL_CUDA_KERNELS)


def test_bounds_of_the_flash_kernels(smoke):
    """lsun_bedroom_128's self-attention layers, bf16. At 64^2 and batch 64
    (T 4096, dh 8, dv 32) the three are bound by operations: 2 B T S times
    40, 48 and 80 flops over 989 TFLOP/s, 0.0869, 0.1042 and 0.1737 ms, far
    above their O(T) traffic. At 4^2 (T 16, dh 64, dv 256) the operands
    outweigh the work: bound by bytes, under a microsecond. The dK/dV
    pass's flops are those of the forward and the dQ pass less the shared
    score product: (2 dh + 2 dv) = (dh + dv) + (2 dh + dv) - dh."""
    bf16 = torch.bfloat16
    want = {"flash_fwd": 0.0869, "flash_dq": 0.1042, "flash_dkv": 0.1737}
    for kernel, ms in want.items():
        t, by = smoke.flash_bound(kernel, 64, 4096, 4096, 8, 32, bf16)
        assert by == "operations" and abs(t - ms) < 1e-4
        t, by = smoke.flash_bound(kernel, 64, 16, 16, 64, 256, bf16)
        assert by == "bytes" and t < 1e-3
    # f32 operands: the CUDA cores' 67 TFLOP/s
    t, _ = smoke.flash_bound("flash_fwd", 16, 16384, 16384, 8, 32, torch.float32)
    assert abs(t - 2 * 16 * 16384 ** 2 * 40 / 67e12 * 1e3) < 1e-6


def test_flash_launches_per_step_add_up(smoke):
    """One self-attention train step (five layers a net, no remat): G
    forwards twice and D three times, 25 flash_fwd launches; the four
    backward passes (G once, D three times) run one dQ and one dK/dV pass a
    layer, 20 each. G's and D's layers share two shapes (64^2, and 4^2,
    where both are 512 wide)."""
    assert smoke.FLASH_PER_STEP == {"flash_fwd": 25, "flash_dq": 20, "flash_dkv": 20}
    assert len(smoke.FLASH_FWD_PER_STEP) == 8 and len(smoke.FLASH_SHAPES) == 9
    assert smoke.FLASH_FWD_PER_STEP[(4096, 8, 32)] == 5
    assert smoke.FLASH_BWD_PER_STEP[(16, 64, 256)] == 4
    assert (16384, 8, 32) not in smoke.FLASH_FWD_PER_STEP  # training drops the 128^2 layer
    assert smoke.SELF_TRAIN_STAGES == ",".join(str(r) for r in smoke.FLASH_TRAIN_RES)


def test_flash_shapes_are_the_configs(smoke):
    """chip_smoke's table of (T, dh, dv) is what the config gives: G's layer
    at a stage's own width, D's at its stage's output width."""
    from locate_tpu_torch.config import get_config
    from locate_tpu_torch.ops.self_attention import _head_dims

    cfg = get_config("lsun_bedroom_128", smoke.SELF).model
    chans, res = cfg.stage_channels(), cfg.stage_resolutions()
    for i, r in enumerate(res):
        assert smoke.FLASH_G_SHAPES[r] == (r * r, *_head_dims(chans[i], cfg.attention))
        assert smoke.FLASH_D_SHAPES[r] == (r * r, *_head_dims(chans[max(i - 1, 0)],
                                                              cfg.attention))


def test_chunked_plain_versions(smoke):
    """The plain versions run a few batch rows at a time on the card; the
    joined result is the whole call's."""
    from locate_tpu_torch.ops import flash_attention as fl

    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(5, 12, d, generator=g) for d in (4, 4, 6, 6))
    whole = smoke.run_flash(fl, q, k, v, do, 0.5, plain=True)
    parts = smoke.chunked(lambda *a: smoke.run_flash(fl, *a, 0.5, plain=True), (q, k, v, do), 2)
    for a, b in zip(whole, parts):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    assert smoke.batch_chunk(16384, 16384) == 2 and smoke.batch_chunk(4096, 4096) == 32
    # on CPU tensors the wrappers take the plain versions: the same numbers
    for a, b in zip(whole, smoke.run_flash(fl, q, k, v, do, 0.5, plain=False)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: chip_smoke.py would run")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def _flash_row(shape3, b, fwd_ms, fwd_library, route="mma", case=None):
    """A phase-22 row as `flash_times` fills it, with made-up times."""
    t, dh, dv = shape3
    row = dict(shape=dict(B=b, T=t, S=t, dh=dh, dv=dv), dtype="bfloat16")
    if case:
        row["case"] = case
    for kernel, ms, library in (("flash_fwd", fwd_ms, fwd_library), ("flash_dq", 1.0, 5.0),
                                ("flash_dkv", 2.0, 5.0)):
        row[kernel] = dict(ms=ms, plain_ms=10 * ms, bound_ms=0.1, bound_by="operations",
                           library_ms=library, route=route, ms_simt=4 * ms)
    return row


def _library_rows(smoke, d16_ms=0.01, d64_ms=0.7, route="mma"):
    rows = [_flash_row(s, 16, d16_ms if s == smoke.FLASH_D_SHAPES[16] else 0.5, 0.05, route,
                       "layer") for s in smoke.FLASH_SHAPES]
    rows.append(_flash_row((1024, 8, 32), 16, 9.0, 0.05, route, "S != T"))
    train = [_flash_row(s, 64, d64_ms if s == smoke.FLASH_D_SHAPES[64] else 9.0, 15.0, route)
             for s in smoke.FLASH_FWD_PER_STEP]
    return rows, train


def test_phase_22_holds_flash_fwd_to_the_library(smoke):
    """Phase 22 fails where flash_fwd, on the mma route, is not faster than
    the library's forward at D's 16^2 layer (batch 16) or at the 64^2
    layers (batch 64); other shapes do not decide it."""
    smoke.check_against_library(*_library_rows(smoke))
    for kw in (dict(d16_ms=0.06), dict(d64_ms=15.5), dict(route="simt")):
        with pytest.raises(smoke.SmokeFailure, match="flash_"):
            smoke.check_against_library(*_library_rows(smoke, **kw))


def test_kernels_line_gives_the_forward_its_routes(smoke):
    """The `flash_fwd` entry of the kernels line carries, like the backward
    pair's, its launches on the mma route and the simt route's time of the
    same launches: each shape's time times its launches a step."""
    rows, train = _library_rows(smoke)
    for r in rows:
        r.update(o_max_abs_err=0.01, ell_max_abs_err=0.002)
    launches = {"flash_fwd": 75, "flash_dq": 60, "flash_dkv": 60}
    routes = smoke.routes_expected(launches)
    entry = smoke.flash_entry("flash_fwd", rows, train, launches, {"flash_fwd": 18}, routes)
    per_step = sum(smoke.FLASH_FWD_PER_STEP.values())
    assert entry["launches"] == 75 and entry["launches_mma"] == 75
    assert entry["launches_serving"] == 18 and entry["routes"] == ["mma"]
    want = 0.7 * 5 + 9.0 * (per_step - 5)  # (4096, 8, 32) runs 5 times a step
    assert abs(entry["ms"] - want) < 1e-9 and abs(entry["ms_simt"] - 4 * want) < 1e-9
    assert entry["max_abs_err"] == 0.01
    for key in ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
                "plain_ms", "bound_ms", "bound_by", "library_ms"):
        assert key in entry
