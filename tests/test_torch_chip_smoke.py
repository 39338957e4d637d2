"""What of chip_smoke.py runs without a card: its ptxas parser on every
kernel of csrc/fused_attention.cu, csrc/fused_stage.cu and
csrc/flash_attention.cu (and on a kernel it does not know), its bounds and
launch counts, the softmax and the sigmoid gate's and the flash kernels',
and its refusal to report anything when there is no card."""

import importlib.util
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


def test_ffhq_launches_per_step_add_up(smoke):
    """G's 512^2 stage runs its stats pass three times a step (the fake, the
    G step, its remat recompute), D's six (real, fake, the G step, each
    recomputed); each of the four fused backward calls recomputes w once."""
    per_step = {k: sum(v.values()) for k, v in smoke.FFHQ_STAGE_PER_STEP.items()}
    assert per_step == {"stage_softmax_stats": 9, "stage_softmax_apply_pool": 6,
                        "stage_conv": 4, "stage_conv_bwd": 4}
    assert smoke.FFHQ_GATE_PER_STEP["softmax_csum"] == 4 * 8  # 4 backward calls x 8 stages
    assert set(smoke.FFHQ_SERVE_PER_FORWARD) == set(smoke.KERNELS) | set(smoke.STAGE_KERNELS)


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
    shapes up to 16^2 every bound is at most 2 microseconds."""
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
            assert smoke.bound(kind, 16, hw, c, hd, c, bf16)[0] < 2e-3


def test_sigmoid_launches_per_step_add_up(smoke):
    """One ffhq_512-sigmoid train step: G forwards three times (the fake,
    the G step, its remat recompute) and D six (real, fake, the G step,
    each recomputed); the gate's one-pass kernel runs at the stages up to
    16^2 (three in G, three in D), the stage's sigmoid pass at 512^2; each
    of the four backward passes (G once, D three times) runs the gate's
    backward at its three small stages and in the fused stage's backward,
    with the conv recompute and the conv backward. One served forward:
    G's three gates and its 512^2 stage."""
    assert smoke.SIGMOID_PER_STEP == {"sigmoid_gate": 27, "sigmoid_bwd": 16,
                                      "stage_sigmoid": 9, "stage_conv": 4, "stage_conv_bwd": 4}
    assert sum(smoke.SIGMOID_FWD_PER_STEP.values()) == 9 * 3
    assert sum(smoke.SIGMOID_BWD_PER_STEP.values()) == 4 * 4
    assert smoke.SIGMOID_SERVE_PER_FORWARD == {"sigmoid_gate": 3, "stage_sigmoid": 1}
    assert len(smoke.SIGMOID_SHAPES) == 5
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
