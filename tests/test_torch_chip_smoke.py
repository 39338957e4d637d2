"""What of chip_smoke.py runs without a card: its ptxas parser on every
kernel of csrc/fused_attention.cu and csrc/fused_stage.cu (and on a kernel
it does not know), its bounds and launch counts, and its refusal to report
anything when there is no card."""

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


def test_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: chip_smoke.py would run")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
