#!/usr/bin/env python3
"""Smoke test of the PyTorch port of locate-tpu on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's paths through the entry points a user calls and holds
every CUDA kernel against its plain PyTorch version: lsun_bedroom_128 at
full width (use_pallas=true, bf16 compute, f32 params), serving and the
alternating train step, the main path of the softmax gate's kernels; then
ffhq_512 at full width and depth, serving and its train step with lazy R1,
the main path of the fused-stage kernels; then ffhq_512 with
model.attention.mode=sigmoid, serving and training alike, the main path of
the sigmoid gate's three kernels; then lsun_bedroom_128 with
model.attention.kind=self, serving with all six self-attention layers and
training with five, the main path of the three flash kernels. Phases, one
line each:

  1. the card: torch's name for it, and `name, power.limit` from nvidia-smi;
  2. build: csrc/fused_attention.cu, csrc/fused_stage.cu and
     csrc/flash_attention.cu, one nvcc each, started together, with
     `-Xptxas -v`: each kernel's registers, shared memory and spills, and
     the dynamic shared memory of the gate's blocks at every (C, Hd) of the
     path, of the stage's at 512^2 x 64 and of the flash kernels' at every
     (T, dh, dv) with the q tile picked there;
  3. the gate's forward kernels (stats, apply) against the plain version at
     the nine G and D gate shapes of lsun_bedroom_128, batch 64, bf16, with
     gate weights that make the gate vary and pass the clamp at 16, plus one
     f32 shape with TF32 off; then at ffhq_512's new shapes (HW 65536 and
     262144, C 64), batch 16. Rule in bf16: the kernel's norm-relative error
     against an f32 plain computation of the same inputs is at most twice
     the bf16 plain version's. Rule in f32: at most 1e-4 against the plain
     version;
  4. the gate's backward kernels (csum, backward) at the same shapes under
     the same rules, for c, dx, dpos_proj, dW1x, db1, dW2 and db2. These are
     sums that cancel (db2 exactly: sum_s dl = c - c), so each error is taken
     against the norm of the sum of its terms' absolute values, the scale
     rounding error grows with; the same inputs run twice give bitwise-equal
     gradients;
  5. lsun_bedroom_128 serving: seeded random weights with non-zero logit
     convs serve requests of batch 1, 16 and 64 through `generate_samples`;
     the launch counters read 6 per forward for each forward gate kernel and
     0 for every other; each attention layer of the batch-64 request is held
     against the plain version on the activations it received; the kernel
     path, the plain path and an f32 plain generator run the same latents
     (kernel error <= 2x plain error); `bench-sample`'s images/sec at batch
     64 for both paths, peak memory, idle share;
  6. lsun_bedroom_128 training: the shipped preset (R1 gamma 1 every 16
     steps, the grad-norm and non-finite guards, EMA 0.999), batch 64, seeded
     weights, 3 steps from step 0 through `make_train_step`: losses, norms and
     r1 finite, G, D and EMA moved, the guard counters as the norms imply,
     launch counters 30 / 30 / 24 / 24 per step and no fused-stage launch.
     Then one step's gradients from one state and batch with the same latents
     on the kernel path, the plain path and an f32 plain path: the kernel
     path's error against f32 is at most twice the plain path's, for D and
     for G. With random weights the 128^2 model's gradient is ill-conditioned
     (the f32 plain path's own gradient moves by percents when the weights
     move by 1e-7, printed), so two more checks carry the weight: each of the
     step's 24 gate backward calls is held against the plain backward on its
     own saved tensors (the bf16 rule), and at 64^2 (one stage fewer, same
     widths) the f32 kernel path's gradients are within 1e-3 of the f32 plain
     path's (or ten times the plain path's own change under 1e-7 weight
     noise, if larger), each call within 1e-4;
  7. lsun_bedroom_128 training throughput: `bench 128 20` and `bench 128 20
     xla` (images/sec, flops per step, MFU), peak memory of a batch-128 step
     with R1 firing (r1_remat on and off), and over 3 steps of each path the
     device's idle share and its kernels by time;
  8. (in 3 and 4) each gate kernel's time at each shape (CUDA graphs of
     back-to-back launches timed with CUDA events) beside its bound, share
     of the bound and the plain version's time;
  9. the four fused-stage kernels against their plain versions at
     ffhq_512's 512^2 stage (C = Co = 64, Hd = 16), batch 16, bf16 and f32
     under the rules of 3: the softmax stats pass in G's `up` form (coarse
     256^2 in) and D's plain form, the pooled apply pass, the conv pass
     plain, `up`, `down` and with a 1x1 skip (C 32), the conv backward plain
     and `up` (its outputs against their absolute-term scales, two f32 runs
     bitwise equal); each bf16 case timed beside its bound and the plain
     version's time;
 10. ffhq_512 serving: one request of 4 through `generate_samples` (the
     launches of one forward: the stage's stats pass once, the gate's kernels
     at the seven stages below), the kernel path, the plain path and an f32
     plain generator on the same latents (kernel error <= 2x plain error),
     the idle share of a batch-16 request, and `bench-sample ffhq_512
     --batch=16` on both paths with peak memory;
 11. ffhq_512 training (the fused-stage kernels' main path): the preset as
     shipped (R1 gamma 0.1 every 16 steps, remat, both guards) at batch 16,
     3 steps from step 0: the checks of 6, launches per step of all eight
     kernels as the step implies, sec/step, images/sec, peak memory, idle
     share and top kernels; then the plain path's 3 steps alike;
 12. one ffhq_512 step's gradients with R1 on the kernel path, each of its
     four fused-stage backward calls held against the plain backward chain
     on its own saved tensors (the bf16 rule);
 13. one step's whole gradients at ffhq_512's widths cut to 64^2 with every
     stage fused, f32 kernel path against f32 plain path (the tolerance of
     6), each of the 20 fused-stage backward calls within 1e-4;
 14. one 512^2 G stage and one D stage, forward plus backward, fused,
     unfused and on the plain path;
 15. the sigmoid gate's two kernels (sigmoid_gate, sigmoid_bwd) against
     their plain versions at ffhq_512's five gate shapes up to 16^2 (G's
     three, D's two others), batch 16, bf16, one also in f32, and the
     backward at the 512^2 stage's (262144, 64, 16), under the rules of 3
     and 4 at gate_max 1.5 (below the gate's ceiling of 2, so the clamp
     binds at about a third of the locations); two runs bitwise equal; each
     timed beside its bound and the plain version's time;
 16. the stage's sigmoid pass (stage_sigmoid) at 512^2 in G's `up` and
     D's `down` forms, plain and with a 1x1 skip, under the rules of 9 at
     gate_max 1.5, timed alike;
 17. ffhq_512-sigmoid serving as 10: one forward launches the gate's
     kernel 3 times and the stage's sigmoid pass once, no softmax kernel;
 18. ffhq_512-sigmoid training as 11: 27 / 16 / 9 launches a step of
     sigmoid_gate / sigmoid_bwd / stage_sigmoid, 4 of stage_conv and of
     stage_conv_bwd, none of the softmax kernels;
 19. as 12, the four sigmoid stage backward calls of one step;
 20. as 13, at 64^2 with every sigmoid stage fused;
 21. one sigmoid attention layer at ffhq_512's shapes from 32^2 to 256^2
     (C 64), forward and forward plus backward through the kernels and the
     plain composition: the input to a retune of the 256-location threshold;
 22. the three flash kernels (flash_fwd, flash_dq, flash_dkv) against their
     plain versions at the nine (T, dh, dv) of lsun_bedroom_128's
     self-attention layers (G's six from T = 16, dh 64, dv 256 to T = 16384,
     dh 8, dv 32, and D's three others), batch 16, plus heads = 2 and one
     S != T case, bf16 and f32, under the rules of 3 and 4; two runs bitwise
     equal; each bf16 case timed beside its bound, its plain version and
     `F.scaled_dot_product_attention` (forward, and autograd backward for the
     two backward kernels together), which the port never calls; then the
     training shapes at batch 64, timed only;
 23. lsun_bedroom_128 + attention.kind=self serving, all six layers:
     requests of 1, 16 and 64 (6 flash_fwd launches a forward, nothing
     else), each layer of the batch-16 request against the plain composition
     on its own q, k, v, the three generators on the same latents,
     `bench-sample` at batch 1, 16, 64 with peak memory, the plain path at
     the largest batch the allocator grants (its refusal at batch 64, one
     68.7 GB score tensor, is caught and recorded), idle share, top kernels;
 24. the same preset training as shipped (batch 64, R1, both guards, EMA)
     with attention at 4^2..64^2: 3 steps from step 0 under the checks of 6,
     launches 25 / 20 / 20 a step, sec/step, images/sec, peak memory, idle
     share, top kernels; then the plain path alike; a refused batch is
     halved and recorded;
 25. one such step's gradients with each of its 20 flash backward calls held
     against the plain backward on its own saved tensors (bf16), and at
     64^2 in f32 the whole gradients against the plain path (the tolerance
     of 6), each call within 1e-4;
 26. one JSON line `{"kernels": [...]}` for the fourteen kernels;
 27. the card's name and power limit again, then the last line
     `{"ok": true, "device": {...}}`.

Any failed check exits non-zero before the last line. Needs one card; run
it from the root of a checkout (the kernels build into .build/kernels/).
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import re
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

PEAK_BYTES_PER_S = 3.35e12                        # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
BATCH = 64
# (HW, C, Hd) of the six lsun_bedroom_128 generator stages and of the six
# discriminator stages (the gate runs at a D stage's output width); Cout = C
G_SHAPES = [(16, 512, 128), (64, 256, 64), (256, 128, 32),
            (1024, 64, 16), (4096, 64, 16), (16384, 64, 16)]
D_SHAPES = [(16384, 64, 16), (4096, 64, 16), (1024, 128, 32),
            (256, 256, 64), (64, 512, 128), (16, 512, 128)]
SHAPES = G_SHAPES + [s for s in D_SHAPES if s not in G_SHAPES]
# launches per shape: one served forward, and one train step (G no-grad and
# G forwards, D on real, fake and in the G step; backward of D real, D
# fake, D in the G step, and G)
SERVE = {s: int(s in G_SHAPES) for s in SHAPES}
FWD_PER_STEP = {s: 2 * (s in G_SHAPES) + 3 * (s in D_SHAPES) for s in SHAPES}
BWD_PER_STEP = {s: 1 * (s in G_SHAPES) + 3 * (s in D_SHAPES) for s in SHAPES}
F32_SHAPE = (1024, 64, 16)
F32_TOL = 1e-4
# a whole step's gradient tree at 64^2, kernel path vs plain path, f32: at
# most this, or ten times what 1e-7 weight noise moves the plain path by
TRAIN_F32_TOL = 1e-3
BF16_FACTOR = 2.0
# two errors both under this are both rounding noise: the 2x rule is not applied
BF16_FLOOR = 1e-5
GRAD_NAMES = ("c", "dx", "dpos_proj", "dW1x", "db1", "dW2", "db2")
SOURCE = "locate_tpu_torch/csrc/fused_attention.cu"
KERNELS = ("softmax_stats", "softmax_apply", "softmax_csum", "softmax_bwd")
REPLACES = {"softmax_stats": "locate_tpu/ops/pallas/fused_attention.py:152",
            "softmax_apply": "locate_tpu/ops/pallas/fused_attention.py:179",
            "softmax_csum": "locate_tpu/ops/pallas/fused_attention.py:358",
            "softmax_bwd": "locate_tpu/ops/pallas/fused_attention.py:397",
            "stage_conv": "locate_tpu/ops/pallas/fused_stage.py:366",
            "stage_softmax_stats": "locate_tpu/ops/pallas/fused_stage.py:410",
            "stage_softmax_apply_pool": "locate_tpu/ops/pallas/fused_stage.py:397",
            "stage_conv_bwd": "locate_tpu/ops/pallas/fused_stage.py:451",
            "sigmoid_gate": "locate_tpu/ops/pallas/fused_attention.py:145",
            "sigmoid_bwd": "locate_tpu/ops/pallas/fused_attention.py:387",
            "stage_sigmoid": "locate_tpu/ops/pallas/fused_stage.py:378",
            "flash_fwd": "locate_tpu/ops/pallas/flash_attention.py:86",
            "flash_dq": "locate_tpu/ops/pallas/flash_attention.py:178",
            "flash_dkv": "locate_tpu/ops/pallas/flash_attention.py:202"}
# the CUDA kernels of csrc/fused_attention.cu and csrc/fused_stage.cu, as
# ptxas and the profiler name them (a name before any name it contains)
CUDA_KERNELS = ("softmax_stats_partial", "softmax_stats_merge", "softmax_apply",
                "softmax_csum_partial", "softmax_bwd", "reduce_partials", "sigmoid_gate",
                "sigmoid_bwd")
STAGE_SOURCE = "locate_tpu_torch/csrc/fused_stage.cu"
STAGE_KERNELS = ("stage_conv", "stage_softmax_stats", "stage_softmax_apply_pool",
                 "stage_conv_bwd")
STAGE_CUDA_KERNELS = ("stage_conv_bwd", "stage_softmax_apply_pool", "stage_softmax_stats",
                      "stage_conv", "stage_sigmoid", "softmax_stats_merge", "reduce_partials")
FLASH_SOURCE = "locate_tpu_torch/csrc/flash_attention.cu"
FLASH_KERNELS = ("flash_fwd", "flash_dq", "flash_dkv")
ALL_CUDA_KERNELS = STAGE_CUDA_KERNELS + CUDA_KERNELS + FLASH_KERNELS

# ffhq_512 (config.py:792-808): batch 16 per card (the preset's global 256
# over a v5p-32's 16 chips); the gate's new shapes (HW, C, Hd) at 256^2 and
# 512^2; per train step, the fused-stage launches of each shape (G's 512^2
# stage runs `up` forms, D's the plain ones; remat reruns each stage's
# forward in the backward), and the gate's launches per step and per served
# forward (every stage below 512^2 of G and D, plus G's 512^2 apply and the
# four fused backward calls' gate stats, csum and backward)
FFHQ_BATCH = 16
FFHQ_GATE_SHAPES = [(65536, 64, 16), (262144, 64, 16)]
FFHQ_STAGE_PER_STEP = {"stage_softmax_stats": {"up": 3, "plain": 6},
                       "stage_softmax_apply_pool": {"plain": 6},
                       "stage_conv": {"up": 1, "plain": 3},
                       "stage_conv_bwd": {"up": 1, "plain": 3}}
FFHQ_GATE_PER_STEP = {"softmax_stats": 67, "softmax_apply": 66, "softmax_csum": 32,
                      "softmax_bwd": 32}
FFHQ_SERVE_PER_FORWARD = {"softmax_stats": 7, "softmax_apply": 8, "softmax_csum": 0,
                          "softmax_bwd": 0, "stage_conv": 0, "stage_softmax_stats": 1,
                          "stage_softmax_apply_pool": 0, "stage_conv_bwd": 0}

# ffhq_512 with model.attention.mode=sigmoid: the gate runs its one-pass
# kernel at the stages up to 16^2 (the JAX layer's 256 locations), the
# plain composition from 32^2 to 256^2, and the fused stage's sigmoid pass
# at 512^2 (G `up`, D `down`); each fused backward recomputes w with the
# conv pass and runs the gate's one-pass backward on its 262,144 locations.
# (HW, C, Hd) of the gates at G's 4^2, 8^2, 16^2 stages, then D's 16^2,
# 8^2, 4^2 (D's gate runs at its stage's output width).
SIGMOID = {"model.attention.mode": "sigmoid"}
SIGMOID_KERNELS = ("sigmoid_gate", "sigmoid_bwd")
SIGMOID_G_SHAPES = [(16, 512, 128), (64, 256, 64), (256, 128, 32)]
SIGMOID_D_SHAPES = [(256, 256, 64), (64, 512, 128), (16, 512, 128)]
SIGMOID_SHAPES = SIGMOID_G_SHAPES + [s for s in SIGMOID_D_SHAPES if s not in SIGMOID_G_SHAPES]
SIGMOID_STAGE_BWD_SHAPE = (262144, 64, 16)
SIGMOID_F32_SHAPE = (256, 128, 32)
# below the sigmoid gate's ceiling of 2, so that the clamp binds in the
# kernel checks (the preset's 16 never does)
SIGMOID_GATE_MAX = 1.5
# launches per train step (G forwards 3, D forwards 6, each D and G
# backward once per pass: G 1, D 3) and per served forward
SIGMOID_FWD_PER_STEP = {s: 3 * (s in SIGMOID_G_SHAPES) + 6 * (s in SIGMOID_D_SHAPES)
                        for s in SIGMOID_SHAPES}
SIGMOID_BWD_PER_STEP = {**{s: 1 * (s in SIGMOID_G_SHAPES) + 3 * (s in SIGMOID_D_SHAPES)
                           for s in SIGMOID_SHAPES}, SIGMOID_STAGE_BWD_SHAPE: 4}
SIGMOID_SERVE = {s: int(s in SIGMOID_G_SHAPES) for s in SIGMOID_SHAPES}
SIGMOID_STAGE_PER_STEP = {"stage_sigmoid": {"up": 3, "down": 6},
                          "stage_conv": {"up": 1, "plain": 3},
                          "stage_conv_bwd": {"up": 1, "plain": 3}}
SIGMOID_PER_STEP = {"sigmoid_gate": sum(SIGMOID_FWD_PER_STEP.values()),
                    "sigmoid_bwd": sum(SIGMOID_BWD_PER_STEP.values()),
                    **{k: sum(v.values()) for k, v in SIGMOID_STAGE_PER_STEP.items()}}
SIGMOID_SERVE_PER_FORWARD = {"sigmoid_gate": sum(SIGMOID_SERVE.values()), "stage_sigmoid": 1}

# lsun_bedroom_128 with model.attention.kind=self (heads 1, dk = C/8,
# dv = C/2): serving runs all six layers (T up to 16384); training drops the
# 128^2 layer, because R1 runs through the kernel-free twin of D, whose
# plain attention holds (T, T) f32 matrices, 1.07 GB a tensor an image at
# 128^2. (T, dh, dv) of G's layer at each resolution, and of D's (whose
# layer runs at its stage's output width).
SELF = {"model.attention.kind": "self"}
SELF_TRAIN_STAGES = "4,8,16,32,64"
FLASH_BATCH = 16
FLASH_G_SHAPES = {4: (16, 64, 256), 8: (64, 32, 128), 16: (256, 16, 64), 32: (1024, 8, 32),
                  64: (4096, 8, 32), 128: (16384, 8, 32)}
FLASH_D_SHAPES = {128: (16384, 8, 32), 64: (4096, 8, 32), 32: (1024, 16, 64),
                  16: (256, 32, 128), 8: (64, 64, 256), 4: (16, 64, 256)}
FLASH_SHAPES = list(FLASH_G_SHAPES.values()) + [s for s in FLASH_D_SHAPES.values()
                                                if s not in FLASH_G_SHAPES.values()]
FLASH_TRAIN_RES = (4, 8, 16, 32, 64)
# launches per train step of each (T, dh, dv): forward G twice (the fake,
# the G step) and D three times (real, fake, the G step); backward G once
# and D three times, each one dQ and one dK/dV pass; no remat, and R1's
# twin launches nothing
FLASH_FWD_PER_STEP, FLASH_BWD_PER_STEP = {}, {}
for _res in FLASH_TRAIN_RES:
    for _shape, _fwd, _bwd in ((FLASH_G_SHAPES[_res], 2, 1), (FLASH_D_SHAPES[_res], 3, 3)):
        FLASH_FWD_PER_STEP[_shape] = FLASH_FWD_PER_STEP.get(_shape, 0) + _fwd
        FLASH_BWD_PER_STEP[_shape] = FLASH_BWD_PER_STEP.get(_shape, 0) + _bwd
FLASH_PER_STEP = {"flash_fwd": sum(FLASH_FWD_PER_STEP.values()),
                  "flash_dq": sum(FLASH_BWD_PER_STEP.values()),
                  "flash_dkv": sum(FLASH_BWD_PER_STEP.values())}
FLASH_NAMES = ("o", "ell", "dq", "dk", "dv")


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + json.dumps(fields), flush=True)


def rel_err(got: torch.Tensor, truth: torch.Tensor, scale: torch.Tensor = None) -> float:
    got, truth = got.double(), truth.double()
    scale = truth if scale is None else scale.double()
    return float((got - truth).norm() / scale.norm().clamp_min(1e-12))


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def kernel_name(mangled: str) -> str:
    """The readable name of a compiled kernel: its ALL_CUDA_KERNELS name
    with <bf16> or <f32> for the templates (and a second, integer argument
    where there is one, as the flash kernels' rows per thread), else the
    mangled name itself."""
    base = next((k for k in ALL_CUDA_KERNELS if k in mangled), mangled)
    m = re.search(r"I(f|13__nv_bfloat16)(?:Li(\d+))?E", mangled)
    if not m:
        return base
    dtype = "f32" if m.group(1) == "f" else "bf16"
    return f"{base}<{dtype}{',' + m.group(2) if m.group(2) else ''}>"


def parse_ptxas(log: str) -> dict:
    """{kernel: {registers, static_smem, spill_stores, spill_loads}} from
    the `-Xptxas -v` output of a build."""
    kernels, current = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            current = kernel_name(m.group(1))
            kernels[current] = {}
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and current:
            kernels[current].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and current:
            kernels[current]["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            kernels[current]["static_smem"] = int(s.group(1)) if s else 0
    return kernels


def graph_ms(fn, reps: int = 10, replays: int = 5) -> float:
    """Device time of one `fn()` call: `reps` calls captured in a CUDA
    graph (so host overhead leaves no gaps), replayed, timed by events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (reps * replays)
    del graph
    return ms


def kernel_split(fn, calls: int = 5) -> dict:
    """Device microseconds per call of each CUDA kernel `fn` launches,
    by kernel name, from torch.profiler (empty if it records none)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        name = next((k for k in ALL_CUDA_KERNELS if k in ev.key), None)
        if name:
            total = getattr(ev, "device_time_total", None)
            if total is None:
                total = ev.cuda_time_total
            out[name] = out.get(name, 0.0) + total / calls
    return out


def gate_inputs(n, hw, c, hd, dtype, seed):
    """Gate operands whose weights make the gate vary and pass 16 where
    HW > 16: x (N, HW, C) in `dtype`, the rest f32 as the layer holds them,
    and a cotangent dy like x."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    dev = dict(device="cuda", generator=g)
    x = torch.randn(n, hw, c, **dev).to(dtype)
    pp = torch.randn(hw, hd, **dev) * 0.5
    w1 = torch.randn(c, hd, **dev) / math.sqrt(c)
    b1 = torch.randn(hd, **dev) * 0.1
    w2 = torch.randn(hd, c, **dev) * 3.0 / math.sqrt(hd)
    b2 = torch.randn(c, **dev) * 0.1
    dy = torch.randn(n, hw, c, **dev).to(dtype)
    return [x, pp, w1, b1, w2, b2], dy


def bound(kind: str, n, hw, c, hd, cout, dtype):
    """(bound_ms, bound_by): the larger of the bytes the function must move
    (each input read once, each output written once) over the memory rate
    and its multiply-adds over the peak rate for the operands' type. Every
    pass must compute the gate MLP (2*(C*Hd + Hd*Cout) flops a location);
    a backward pass three times that (the forward, dh and dx, dW1x and
    dW2). The sigmoid gate's two passes read no statistics."""
    es = torch.finfo(dtype).bits // 8
    weights = (c * hd + hd * cout) * es + (hw * hd + hd + cout) * 4
    xbytes = n * hw * c * es
    stats = 2 * n * cout * 4
    mlp = 2.0 * n * hw * (c * hd + hd * cout)
    grads = (c * hd + hd * cout + hd + cout + hw * hd) * 4
    if kind == "softmax_stats":
        nbytes, flops = xbytes + weights + stats, mlp
    elif kind == "softmax_apply":
        nbytes, flops = 2 * xbytes + weights + stats, mlp
    elif kind == "softmax_csum":
        nbytes, flops = 2 * xbytes + weights + stats + n * cout * 4, mlp
    elif kind == "sigmoid_gate":  # reads x, writes y
        nbytes, flops = 2 * xbytes + weights, mlp
    elif kind == "sigmoid_bwd":  # reads x and dy; writes dx and f32 gradients
        nbytes, flops = 3 * xbytes + weights + grads, 3 * mlp
    else:  # softmax_bwd: reads x, dy, stats, c; writes dx and f32 gradients
        nbytes, flops = 3 * xbytes + weights + stats + n * cout * 4 + grads, 3 * mlp
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


KW = dict(act="leaky_relu", leaky_slope=0.2)


def run_forward(fa, ops, hw, plain: bool):
    if plain:
        m, se = fa.softmax_gate_stats_reference(*ops, **KW)
        y = fa.softmax_gate_apply_reference(*ops, m, se, hw_scale=float(hw),
                                            gate_max=16.0, **KW)
    else:
        m, se = fa.softmax_gate_stats(*ops, **KW)
        y = fa.softmax_gate_apply(*ops, m, se, hw_scale=float(hw), gate_max=16.0, **KW)
    return m, se, y


def run_backward(fa, ops, dy, hw, plain: bool):
    """(c, dx, dpos_proj, dW1x, db1, dW2, db2), each path its own stats."""
    opts = dict(hw_scale=float(hw), gate_max=16.0, **KW)
    if plain:
        m, se = fa.softmax_gate_stats_reference(*ops, **KW)
        c = fa.softmax_gate_csum_reference(ops[0], dy, *ops[1:], m, se, **opts)
        grads = fa.softmax_gate_backward_reference(ops[0], dy, *ops[1:], m, se, c, **opts)
    else:
        m, se = fa.softmax_gate_stats(*ops, **KW)
        c = fa.softmax_gate_csum(ops[0], dy, *ops[1:], m, se, **opts)
        grads = fa.softmax_gate_backward(ops[0], dy, *ops[1:], m, se, c, **opts)
    return (c, *grads)


def term_scales(fa, x2d, dy, pp, w1x, b1, w2, b2, m, se, c, opts):
    """(c, dx, dpos_proj, dW1x, db1, dW2, db2) computed on the absolute
    values of their terms: the scale a sum's rounding error grows with.
    Several of these sums cancel (db2 to exactly 0, since sum_s dl = c - c;
    dW1x and db1 nearly so where x or act'(u) barely vary over the
    locations), so errors are measured against these scales, not against
    the gradients themselves."""
    cd = x2d.dtype
    xf, dyf = x2d.float(), dy.float()
    w1c, w2c = w1x.to(cd).float(), w2.to(cd).float()
    u = xf @ w1c + pp.float() + b1.float()
    h = fa._act(opts["act"], opts["leaky_slope"])(u).to(cd).float()
    l = h @ w2c + b2.float()
    hw = opts["hw_scale"]
    g = torch.exp(l - m) / se * hw
    dg = fa._dgate(xf, dyf, l.shape[-1]) * fa._gate_mask(g, opts["gate_max"])
    terms_c = fa._dgate(xf.abs(), dyf.abs(), l.shape[-1]) * g
    dl = (g * dg).abs() + (g / hw) * c.abs()
    du = fa._act_grad(opts["act"], opts["leaky_slope"])(u).abs() * (dl @ w2c.abs().t())
    dx = fa._clamp_gate(g, opts["gate_max"]) * dyf.abs() + du @ w1c.abs().t()
    return (terms_c.sum(dim=1, keepdim=True), dx, du.sum(dim=0),
            torch.einsum("nsc,nsh->ch", xf.abs(), du), du.sum(dim=(0, 1)),
            torch.einsum("nsh,nsc->hc", h.abs(), dl), dl.sum(dim=(0, 1)))


def hold(name, shape, k, p, t, dtype, row, scale=None):
    """The agreement rule for one output: bf16 against f32, f32 against plain."""
    check(bool(torch.isfinite(k).all()), f"{name} not finite at {shape}")
    row[f"{name}_max_abs_err"] = float((k.float() - p.float()).abs().max())
    if dtype == torch.bfloat16:
        ek, ep = rel_err(k, t, scale), rel_err(p, t, scale)
        row[f"{name}_rel_err_kernel_vs_f32"] = ek
        row[f"{name}_rel_err_plain_vs_f32"] = ep
        check(ek <= max(BF16_FACTOR * ep, BF16_FLOOR),
              f"{name} at {shape}: kernel error {ek:.3e} > {BF16_FACTOR} x plain bf16 "
              f"error {ep:.3e}")
    else:
        e = rel_err(k, p, scale)
        row[f"{name}_rel_err_kernel_vs_plain"] = e
        check(e <= F32_TOL, f"{name} at {shape} f32: {e:.3e} > {F32_TOL}")


def timed(kind, fn, plain_fn, n, hw, c, hd, dtype):
    ms, plain_ms = graph_ms(fn), graph_ms(plain_fn)
    b_ms, b_by = bound(kind, n, hw, c, hd, c, dtype)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                share_of_bound=b_ms / ms)


def cases():
    out = [(hw, c, hd, torch.bfloat16) for hw, c, hd in SHAPES]
    return out + [(*F32_SHAPE, torch.float32)]


def ffhq_gate_cases():
    return [(hw, c, hd, torch.bfloat16) for hw, c, hd in FFHQ_GATE_SHAPES]


def phase_forward(fa, shapes, batch, phase="forward-kernels-vs-plain"):
    """Phase 3 and the forward half of phase 8."""
    rows = []
    for i, (hw, c, hd, dtype) in enumerate(shapes):
        ops, _ = gate_inputs(batch, hw, c, hd, dtype, seed=100 + i)
        shape = dict(N=batch, HW=hw, C=c, Hd=hd, Cout=c)
        with torch.inference_mode():
            kern = run_forward(fa, ops, hw, plain=False)
            plain = run_forward(fa, ops, hw, plain=True)
            truth = run_forward(fa, [ops[0].float()] + ops[1:], hw, plain=True)
            torch.cuda.synchronize()
            l = fa.gate_logits_reference(ops[0].float(), *ops[1:], **KW)
            gate = torch.exp(l - truth[0]) / truth[1] * hw
            clamped = float((gate > 16.0).float().mean())
            gate_std = float(gate.std())
            del l, gate
        row = dict(shape=shape, dtype=str(dtype).replace("torch.", ""),
                   gate_std=round(gate_std, 3), clamped_share=clamped)
        for name, k, p, t in zip(("m", "se", "y"), kern, plain, truth):
            hold(name, shape, k, p, t, dtype, row)
        check(gate_std > 0.5, f"gate barely varies at {shape}")
        if hw > 16:
            check(clamped > 0.0, f"gate never reaches the clamp at {shape}")
        del kern, plain, truth

        # timing: operands pre-cast as the kernel takes them
        kops = [ops[0], ops[1], ops[2].to(dtype), ops[3], ops[4].to(dtype), ops[5]]
        apply_kw = dict(hw_scale=float(hw), gate_max=16.0, **KW)
        with torch.inference_mode():
            m, se = fa.softmax_gate_stats(*kops, **KW)
            row["softmax_stats"] = timed(
                "softmax_stats", lambda: fa.softmax_gate_stats(*kops, **KW),
                lambda: fa.softmax_gate_stats_reference(*kops, **KW), batch, hw, c, hd, dtype)
            row["softmax_apply"] = timed(
                "softmax_apply", lambda: fa.softmax_gate_apply(*kops, m, se, **apply_kw),
                lambda: fa.softmax_gate_apply_reference(*kops, m, se, **apply_kw),
                batch, hw, c, hd, dtype)
            row["profiler_us_per_call"] = kernel_split(lambda: fa.softmax_gate_apply(
                *kops, *fa.softmax_gate_stats(*kops, **KW), **apply_kw))
        say(phase, **row)
        rows.append(row)
        del ops, kops, m, se
        torch.cuda.empty_cache()
    return rows


def phase_backward(fa, shapes, batch, phase="backward-kernels-vs-plain"):
    """Phase 4 and the backward half of phase 8."""
    rows = []
    for i, (hw, c, hd, dtype) in enumerate(shapes):
        ops, dy = gate_inputs(batch, hw, c, hd, dtype, seed=200 + i)
        shape = dict(N=batch, HW=hw, C=c, Hd=hd, Cout=c)
        with torch.no_grad():
            kern = run_backward(fa, ops, dy, hw, plain=False)
            again = run_backward(fa, ops, dy, hw, plain=False)
            plain = run_backward(fa, ops, dy, hw, plain=True)
            truth = run_backward(fa, [ops[0].float()] + ops[1:], dy.float(), hw, plain=True)
            torch.cuda.synchronize()
        row = dict(shape=shape, dtype=str(dtype).replace("torch.", ""),
                   bwd_grid=dict(zip(("tile_rows", "batch_rows_per_block"),
                                     fa.bwd_grid(batch, hw, c))))
        for name, k, a in zip(GRAD_NAMES, kern, again):
            check(torch.equal(k, a), f"{name} at {shape}: two runs differ bitwise")
        row["bitwise_repeatable"] = True
        with torch.no_grad():
            m, se = fa.softmax_gate_stats_reference(ops[0].float(), *ops[1:], **KW)
            scales = term_scales(fa, ops[0].float(), dy.float(), *ops[1:], m, se, truth[0],
                                 dict(hw_scale=float(hw), gate_max=16.0, **KW))
        for name, k, p, t, sc in zip(GRAD_NAMES, kern, plain, truth, scales):
            hold(name, shape, k, p, t, dtype, row, scale=sc)
        del kern, again, plain, truth

        kops = [ops[0], ops[1], ops[2].to(dtype), ops[3], ops[4].to(dtype), ops[5]]
        opts = dict(hw_scale=float(hw), gate_max=16.0, **KW)
        with torch.no_grad():
            m, se = fa.softmax_gate_stats(*kops, **KW)
            cs = fa.softmax_gate_csum(kops[0], dy, *kops[1:], m, se, **opts)
            row["softmax_csum"] = timed(
                "softmax_csum", lambda: fa.softmax_gate_csum(kops[0], dy, *kops[1:], m, se,
                                                             **opts),
                lambda: fa.softmax_gate_csum_reference(kops[0], dy, *kops[1:], m, se, **opts),
                batch, hw, c, hd, dtype)
            row["softmax_bwd"] = timed(
                "softmax_bwd", lambda: fa.softmax_gate_backward(kops[0], dy, *kops[1:], m, se,
                                                                cs, **opts),
                lambda: fa.softmax_gate_backward_reference(kops[0], dy, *kops[1:], m, se, cs,
                                                           **opts),
                batch, hw, c, hd, dtype)
            row["profiler_us_per_call"] = kernel_split(lambda: fa.softmax_gate_backward(
                kops[0], dy, *kops[1:], m, se,
                fa.softmax_gate_csum(kops[0], dy, *kops[1:], m, se, **opts), **opts))
        say(phase, **row)
        rows.append(row)
        del ops, dy, kops, m, se, cs
        torch.cuda.empty_cache()
    return rows


def run_sigmoid(fa, ops, dy, plain: bool, forward: bool = True):
    """(y, dx, dpos_proj, dW1x, db1, dW2, db2) of the sigmoid gate at
    SIGMOID_GATE_MAX, kernels or plain versions; y is None without
    `forward`."""
    kw = dict(gate_max=SIGMOID_GATE_MAX, **KW)
    fwd = fa.sigmoid_gate_reference if plain else fa.sigmoid_gate
    bwd = fa.sigmoid_gate_backward_reference if plain else fa.sigmoid_gate_backward
    return (fwd(*ops, **kw) if forward else None, *bwd(ops[0], dy, *ops[1:], **kw))


def sigmoid_term_scales(fa, x2d, dy, pp, w1x, b1, w2, b2):
    """The sigmoid backward's (dx, dpos_proj, dW1x, db1, dW2, db2) computed
    on the absolute values of their terms, as `term_scales`."""
    cd = x2d.dtype
    xf, dyf = x2d.float(), dy.float()
    w1c, w2c = w1x.to(cd).float(), w2.to(cd).float()
    u = xf @ w1c + pp.float() + b1.float()
    h = fa._act(KW["act"], KW["leaky_slope"])(u).to(cd).float()
    p = torch.sigmoid(h @ w2c + b2.float())
    dl = (2.0 * p * (1.0 - p) * fa._dgate(xf.abs(), dyf.abs(), w2.shape[1])
          * fa._gate_mask(2.0 * p, SIGMOID_GATE_MAX))
    du = fa._act_grad(KW["act"], KW["leaky_slope"])(u).abs() * (dl @ w2c.abs().t())
    dx = fa._clamp_gate(2.0 * p, SIGMOID_GATE_MAX) * dyf.abs() + du @ w1c.abs().t()
    return (dx, du.sum(dim=0), torch.einsum("nsc,nsh->ch", xf.abs(), du),
            du.sum(dim=(0, 1)), torch.einsum("nsh,nsc->hc", h.abs(), dl), dl.sum(dim=(0, 1)))


def phase_sigmoid_gate(fa):
    """Phase 15: the sigmoid gate's two kernels against their plain versions
    at ffhq_512's five gate shapes up to 16^2, batch 16, bf16, one of them
    also in f32, and the backward at the 512^2 stage's (262144, 64, 16),
    under the rules of phases 3-4 at gate_max 1.5 (the clamp binds at a
    part of the locations); two runs bitwise equal; each timed beside its
    bound and the plain version's time."""
    n = FFHQ_BATCH
    cases = ([(hw, c, hd, torch.bfloat16, True) for hw, c, hd in SIGMOID_SHAPES]
             + [(*SIGMOID_F32_SHAPE, torch.float32, True),
                (*SIGMOID_STAGE_BWD_SHAPE, torch.bfloat16, False)])
    names = ("y",) + GRAD_NAMES[1:]
    kw = dict(gate_max=SIGMOID_GATE_MAX, **KW)
    rows = []
    for i, (hw, c, hd, dtype, forward) in enumerate(cases):
        ops, dy = gate_inputs(n, hw, c, hd, dtype, seed=600 + i)
        shape = dict(N=n, HW=hw, C=c, Hd=hd, Cout=c)
        with torch.no_grad():
            kern = run_sigmoid(fa, ops, dy, False, forward)
            again = run_sigmoid(fa, ops, dy, False, forward)
            plain = run_sigmoid(fa, ops, dy, True, forward)
            truth = run_sigmoid(fa, [ops[0].float()] + ops[1:], dy.float(), True, forward)
            scales = (None, *sigmoid_term_scales(fa, ops[0].float(), dy, *ops[1:]))
            l = fa.gate_logits_reference(ops[0].float(), *ops[1:], **KW)
            clamped = float((2.0 * torch.sigmoid(l) > SIGMOID_GATE_MAX).float().mean())
            del l
            torch.cuda.synchronize()
        row = dict(shape=shape, dtype=str(dtype).replace("torch.", ""),
                   gate_max=SIGMOID_GATE_MAX, clamped_share=clamped,
                   bwd_grid=dict(zip(("tile_rows", "batch_rows_per_block"),
                                     fa.bwd_grid(n, hw, c))))
        check(0.05 < clamped < 0.95, f"gate_max {SIGMOID_GATE_MAX} clamps {clamped} at {shape}")
        for name, k, a in zip(names, kern, again):
            check(k is None or torch.equal(k, a), f"{name} at {shape}: two runs differ bitwise")
        row["bitwise_repeatable"] = True
        for name, k, p, t, sc in zip(names, kern, plain, truth, scales):
            if k is not None:
                hold(name, shape, k, p, t, dtype, row, scale=sc)
        del kern, again, plain, truth, scales

        kops = [ops[0], ops[1], ops[2].to(dtype), ops[3], ops[4].to(dtype), ops[5]]
        with torch.no_grad():
            if forward:
                row["sigmoid_gate"] = timed(
                    "sigmoid_gate", lambda: fa.sigmoid_gate(*kops, **kw),
                    lambda: fa.sigmoid_gate_reference(*kops, **kw), n, hw, c, hd, dtype)
            row["sigmoid_bwd"] = timed(
                "sigmoid_bwd", lambda: fa.sigmoid_gate_backward(kops[0], dy, *kops[1:], **kw),
                lambda: fa.sigmoid_gate_backward_reference(kops[0], dy, *kops[1:], **kw),
                n, hw, c, hd, dtype)
            row["profiler_us_per_call"] = kernel_split(
                lambda: fa.sigmoid_gate_backward(kops[0], dy, *kops[1:], **kw))
        say("sigmoid-gate-kernels-vs-plain", **row)
        rows.append(row)
        del ops, dy, kops
        torch.cuda.empty_cache()
    return rows


def fill_gammas(model, value: float = 0.5) -> int:
    """Set every self-attention block's zero-init `gamma`, so that the
    block attends and its gradients are not all zero; returns how many."""
    n = 0
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("gamma"):
                p.fill_(value)
                n += 1
    return n


def randomize_logit_convs(model, seed: int, scale: float) -> None:
    """Fill the zero-init logit convs (and all biases) so every gate
    varies: a zero logit conv makes the gate exactly 1, and a wrong gate
    MLP would pass unseen. Logits of std about 0.7 * scale."""
    g = torch.Generator(device="cpu")
    g.manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("to_logits.w"):
                hd = p.shape[1]
                p.copy_(torch.randn(p.shape, generator=g) * scale / math.sqrt(hd))
            elif name.endswith(".b"):
                p.copy_(torch.randn(p.shape, generator=g) * 0.1)


def check_attention_layers(fa, captured):
    """Each attention layer of the served batch-64 request, held against
    the plain version on the very activations it received."""
    out = []
    for layer, x, y in captured:
        with torch.inference_mode():
            xc, *w = layer.fused_operands(x)
            n, h, wd, c = xc.shape
            kw = dict(mode="softmax", act=layer.act, leaky_slope=layer.leaky_slope,
                      hw_scale=float(h * wd), gate_max=layer.cfg.gate_max)
            x2d = xc.reshape(n, h * wd, c)
            plain = fa.locate_attention_core_reference(x2d, *w, **kw)
            truth = fa.locate_attention_core_reference(x2d.float(), *w, **kw)
            l = fa.gate_logits_reference(x2d.float(), *w,
                                         act=layer.act, leaky_slope=layer.leaky_slope)
            gate = torch.softmax(l, dim=1) * (h * wd)
        y2d = y.reshape(n, h * wd, c)
        ek, ep = rel_err(y2d, truth), rel_err(plain, truth)
        row = dict(HW=h * wd, C=c, rel_err_kernel_vs_f32=ek, rel_err_plain_vs_f32=ep,
                   max_abs_err_kernel_vs_plain=float((y2d.float() - plain.float()).abs().max()),
                   gate_std=float(gate.std()), clamped_share=float((gate > 16.0).float().mean()))
        check(ek <= max(BF16_FACTOR * ep, 1e-6),
              f"attention layer at HW={h * wd}: kernel error {ek:.3e} > "
              f"{BF16_FACTOR} x plain error {ep:.3e}")
        check(row["gate_std"] > 0.01, f"attention layer at HW={h * wd}: constant gate")
        out.append(row)
    return out


def counters():
    """{kernel: its wrapper} for the fourteen kernels of the three libraries."""
    from locate_tpu_torch.ops import flash_attention as fl
    from locate_tpu_torch.ops import fused_attention as fa
    from locate_tpu_torch.ops import fused_stage as fs

    return {"softmax_stats": fa.softmax_gate_stats, "softmax_apply": fa.softmax_gate_apply,
            "softmax_csum": fa.softmax_gate_csum, "softmax_bwd": fa.softmax_gate_backward,
            **{k: getattr(fs, k) for k in STAGE_KERNELS},
            "sigmoid_gate": fa.sigmoid_gate, "sigmoid_bwd": fa.sigmoid_gate_backward,
            "stage_sigmoid": fs.stage_sigmoid,
            **{k: getattr(fl, k) for k in FLASH_KERNELS}}


def expected(launches: dict, times: int = 1) -> dict:
    """Every counter's launches for `times` runs of a path that launches
    `launches` (the kernels it does not name: none)."""
    return {k: launches.get(k, 0) * times for k in counters()}


def reset_counters():
    for fn in counters().values():
        fn.launches = 0


def read_counters() -> dict:
    return {k: fn.launches for k, fn in counters().items()}


def phase_generator(fa, cfg):
    from locate_tpu_torch.io.sampling import generate_samples
    from locate_tpu_torch.models.generator import build_generator
    from locate_tpu_torch.ops.attention import LocateAttention

    kernel_cfg = dataclasses.replace(cfg.model, use_pallas=True)
    plain_cfg = dataclasses.replace(cfg.model, use_pallas=False)
    model = build_generator(kernel_cfg, "bfloat16", "cuda", seed=0).eval()
    # scale 0.25: the gates vary, and a bf16 generator stays within a few
    # percent of the f32 one; peakier gates concentrate the feature maps
    # and bf16 rounding then moves whole images (both paths alike)
    randomize_logit_convs(model, seed=1, scale=0.25)
    params = sum(p.numel() for p in model.parameters())
    stages = len(cfg.model.stage_resolutions())
    captured = []

    def capture(layer, inputs, output):
        if inputs[0].shape[0] == BATCH:
            captured.append((layer, inputs[0], output))

    hooks = [m.register_forward_hook(capture) for m in model.modules()
             if isinstance(m, LocateAttention)]

    # the serving path: requests through the user-facing entry point
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    requests = (1, 16, BATCH)
    reset_counters()
    images = [generate_samples(model, gen, b) for b in requests]
    launches = read_counters()
    for h in hooks:
        h.remove()
    check(len(captured) == stages, f"captured {len(captured)} attention layers")
    layers = check_attention_layers(fa, captured)
    del captured
    for b, img in zip(requests, images):
        check(img.shape == (b, 128, 128, 3) and str(img.dtype) == "uint8",
              f"request of {b}: images {img.shape} {img.dtype}")
        check(float(img.std()) > 0.0, f"request of {b}: constant images")
    want = stages * len(requests)
    check(launches == expected({"softmax_stats": want, "softmax_apply": want}),
          f"serving launched {launches} for {len(requests)} forwards of {stages} stages")

    # the kernel path against the plain path, both against f32
    plain = build_generator(plain_cfg, "bfloat16", "cuda").eval()
    truth = build_generator(plain_cfg, "float32", "cuda").eval()
    plain.load_state_dict(model.state_dict())
    truth.load_state_dict(model.state_dict())
    gz = torch.Generator(device="cuda")
    gz.manual_seed(3)
    z = torch.randn(16, cfg.model.latent_dim, device="cuda", generator=gz)
    with torch.inference_mode():
        yk, yp, yt = (m(z).float() for m in (model, plain, truth))
    torch.cuda.synchronize()
    for name, y in (("kernel", yk), ("plain", yp), ("f32", yt)):
        check(bool(torch.isfinite(y).all()), f"{name} generator: non-finite images")
        check(float(y.abs().max()) <= 1.0, f"{name} generator: images outside [-1, 1]")
    ek, ep = rel_err(yk, yt), rel_err(yp, yt)
    check(ek <= max(BF16_FACTOR * ep, 1e-6),
          f"generator: kernel path error {ek:.3e} > {BF16_FACTOR} x plain path {ep:.3e}")
    say("generator", config="lsun_bedroom_128", params=params, requests=list(requests),
        launches=launches, rel_err_kernel_path_vs_f32=ek, rel_err_plain_path_vs_f32=ep,
        max_abs_err_kernel_vs_plain_path=float((yk - yp).abs().max()),
        image_std=float(yt.std()), attention_layers=layers)
    del model, plain, truth
    torch.cuda.empty_cache()
    return launches


def run_cli(argv) -> dict:
    from locate_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    check(rc == 0, f"{' '.join(argv)} returned {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def profile_calls(fn, calls: int = 3, top: int = 0):
    """(idle share, top kernels) over `calls` calls of `fn`, from
    torch.profiler: the share of wall time with no kernel running (None
    when it records no device time), and the `top` CUDA kernels by device
    time per call, with their share of the device's busy time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = []
    for ev in prof.events():
        if getattr(ev, "device_type", None) == torch.autograd.DeviceType.CUDA:
            spans.append((ev.time_range.start, ev.time_range.end))
    if not spans:
        return None, []
    spans.sort()
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    kernels = []
    if top:
        for ev in prof.key_averages():
            if getattr(ev, "device_type", None) != torch.autograd.DeviceType.CUDA:
                continue  # an operator's row: its kernels have rows of their own
            total = getattr(ev, "self_device_time_total", None)
            if total is None:
                total = getattr(ev, "self_cuda_time_total", 0.0)
            if total > 0:
                kernels.append((total, ev.key))
        kernels = [dict(kernel=k[:90], ms_per_call=t / calls * 1e-3, share_of_busy=t / busy)
                   for t, k in sorted(kernels, reverse=True)[:top]]
    return max(0.0, 1.0 - busy * 1e-6 / wall), kernels


def phase_serving(cfg):
    from locate_tpu_torch.io.sampling import generate_samples
    from locate_tpu_torch.models.generator import build_generator

    def bench_sample(use_pallas):
        return run_cli(["bench-sample", "lsun_bedroom_128",
                        f"use_pallas={str(use_pallas).lower()}", "--batch=64", "--steps=10"])

    torch.cuda.reset_peak_memory_stats()
    serve = bench_sample(True)
    peak = torch.cuda.max_memory_allocated()
    serve_plain = bench_sample(False)
    model = build_generator(dataclasses.replace(cfg.model, use_pallas=True),
                            "bfloat16", "cuda").eval()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    idle, _ = profile_calls(lambda: generate_samples(model, gen, BATCH))
    say("serving", kernel_path=serve, plain_path=serve_plain,
        peak_memory_bytes_kernel_path=peak,
        device_idle_share=("not measured" if idle is None else idle))
    del model
    torch.cuda.empty_cache()


def fixed_batch(n, res=128, device="cuda"):
    import numpy as np

    host = np.random.default_rng(0).integers(0, 256, (n, res, res, 3), dtype=np.uint8)
    return {"image": torch.from_numpy(host).to(device),
            "label": torch.zeros(n, dtype=torch.long, device=device)}


def trainer(cfg, seed=0):
    """A seeded GAN with non-zero logit convs (and self-attention gammas),
    its fresh state and step."""
    from locate_tpu_torch.models.gan import build_gan
    from locate_tpu_torch.train.state import create_train_state
    from locate_tpu_torch.train.step import make_train_step

    gan = build_gan(cfg, "cuda", seed=seed)
    for net in (gan.generator, gan.discriminator):
        randomize_logit_convs(net, seed=seed + 1, scale=0.25)
        fill_gammas(net)
    return gan, create_train_state(cfg, gan, seed=seed + 2), make_train_step(cfg, gan)


def check_history(history, tcfg):
    """The steps' metrics as floats, after checking them: all finite, R1 at
    its steps only, the guard counters as the gradient norms imply (no
    non-finite skips)."""
    history = [{k: float(v) for k, v in m.items()} for m in history]
    for i, m in enumerate(history):
        for k, v in m.items():
            check(math.isfinite(v), f"step {i}: {k} = {v}")
        check((m["r1"] > 0.0) == (i % tcfg.r1_interval == 0), f"step {i}: r1 = {m['r1']}")
    for net in ("d", "g"):
        count = streak = 0
        for i, m in enumerate(history):
            too_large = m[f"{net}_grad_norm"] > tcfg.grad_norm_limit
            count += too_large
            streak = streak + 1 if too_large else 0
            guards = tuple(m[f"{net}_{k}"] for k in ("grad_limit_count", "grad_limit_streak",
                                                    "nonfinite_streak"))
            check(guards == (count, streak, 0),
                  f"step {i}: {net} guard counters {guards}, the norms imply "
                  f"{(count, streak, 0)}")
    return history


def check_moved(before, state, history, tcfg):
    """The largest change of G, D and the EMA (which follows G). A net
    whose update passed the grad-norm guard at some step (a norm above
    `grad_norm_limit` skips the update) moved, and so did the EMA with G;
    a net whose every update was skipped did not move, and the EMA then
    stays on G up to its own rounding."""
    moved = {name: float((after - b).abs().max()) for name, b, after in zip(
        ("g", "d", "ema"), before,
        (state.g_params.flat, state.d_params.flat, state.ema_params))}
    for name, delta in moved.items():
        net = "g" if name == "ema" else name
        applied = sum(not (tcfg.grad_norm_limit > 0.0
                           and m[f"{net}_grad_norm"] > tcfg.grad_norm_limit) for m in history)
        if applied:
            check(delta > 0.0, f"{name} params did not move after {applied} applied updates")
        else:
            check(delta <= (1e-5 if name == "ema" else 0.0),
                  f"{name} params moved by {delta} though the guard skipped every update")
    return moved


def phase_train(fa):
    """Phase 6: the main path, three preset steps from step 0."""
    from locate_tpu_torch.config import get_config

    cfg = get_config("lsun_bedroom_128", {"use_pallas": "true"})
    tcfg = cfg.train
    check(tcfg.global_batch == BATCH and tcfg.compute_dtype == "bfloat16"
          and tcfg.r1_gamma == 1.0 and tcfg.grad_norm_limit == 1e6
          and tcfg.max_nonfinite_skips == 200 and tcfg.ema_decay == 0.999,
          "lsun_bedroom_128 is not the shipped recipe")
    gan, state, step = trainer(cfg)
    batch = fixed_batch(BATCH)
    before = [t.clone() for t in (state.g_params.flat, state.d_params.flat, state.ema_params)]
    steps = 3
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    history = []
    for _ in range(steps):
        state, metrics = step(state, batch)
        history.append(metrics)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counters()
    history = check_history(history, tcfg)
    moved = check_moved(before, state, history, tcfg)
    # no stage fuses at 128^2
    per_step = {"softmax_stats": 30, "softmax_apply": 30, "softmax_csum": 24,
                "softmax_bwd": 24}
    check(launches == expected(per_step, steps),
          f"train steps launched {launches}, want {per_step} per step")
    say("train", config="lsun_bedroom_128 as shipped, use_pallas=true", batch=BATCH,
        steps=steps, seconds=seconds, launches=launches, metrics=history,
        max_param_change=moved,
        params=dict(g=state.g_params.flat.numel(), d=state.d_params.flat.numel()))
    weights = (gan.generator.state_dict(), gan.discriminator.state_dict())
    del gan, state, step, before
    torch.cuda.empty_cache()
    return cfg, weights, launches


@contextlib.contextmanager
def checked_gate_backward(fa, record):
    """Hold every backward of the gate Function run inside the block
    against the plain backward on the very tensors that call saved: in bf16
    by the rule of phase 4 (against an f32 plain backward of the same
    inputs), in f32 to F32_TOL. One row per call goes to `record`."""
    original = fa.SoftmaxGate.backward

    def backward(ctx, dy):
        grads = original(ctx, dy)
        x2d, pp, w1x, b1, w2, b2, m, se = ctx.saved_tensors
        opts = ctx.options
        with torch.no_grad():
            def plain(x, d, m, se):
                c = fa.softmax_gate_csum_reference(x, d, pp, w1x, b1, w2, b2, m, se, **opts)
                return fa.softmax_gate_backward_reference(x, d, pp, w1x, b1, w2, b2, m, se, c,
                                                          **opts)

            p = plain(x2d, dy, m, se)
            t = p
            xf = x2d.float()
            stats = fa.softmax_gate_stats_reference(xf, pp, w1x, b1, w2, b2,
                                                    act=opts["act"],
                                                    leaky_slope=opts["leaky_slope"])
            if x2d.dtype == torch.bfloat16:  # the f32 truth, its own softmax stats
                t = plain(xf, dy.float(), *stats)
            c = fa.softmax_gate_csum_reference(xf, dy.float(), pp, w1x, b1, w2, b2, *stats,
                                               **opts)
            scales = term_scales(fa, xf, dy.float(), pp, w1x, b1, w2, b2, *stats, c, opts)
        n, hw, c = x2d.shape
        row = dict(N=n, HW=hw, C=c, dtype=str(x2d.dtype).replace("torch.", ""))
        shape = dict(N=n, HW=hw, C=c)
        for name, k, pi, ti, sc in zip(GRAD_NAMES[1:], grads, p, t, scales[1:]):
            hold(name, shape, k, pi, ti, x2d.dtype, row, scale=sc)
        record.append(row)
        return grads

    fa.SoftmaxGate.backward = staticmethod(backward)
    try:
        yield
    finally:
        fa.SoftmaxGate.backward = original


def step_grads(cfg, weights, z_d, z_g, res, use_pallas, dtype, perturb=0.0):
    """(D gradient, G gradient, D loss, G loss, r1) of one step's two halves
    on one path, from `weights`; `perturb` scales every weight by
    (1 + perturb * N(0, 1)) first."""
    from locate_tpu_torch.models.gan import build_gan
    from locate_tpu_torch.train.state import create_train_state
    from locate_tpu_torch.train.step import make_train_step

    pcfg = dataclasses.replace(
        cfg, use_pallas=use_pallas,
        model=dataclasses.replace(cfg.model, use_pallas=use_pallas),
        train=dataclasses.replace(cfg.train, compute_dtype=dtype))
    gan = build_gan(pcfg, "cuda")
    gan.generator.load_state_dict(weights[0])
    gan.discriminator.load_state_dict(weights[1])
    if perturb:
        g = torch.Generator(device="cuda")
        g.manual_seed(9)
        with torch.no_grad():
            for p in [*gan.generator.parameters(), *gan.discriminator.parameters()]:
                p.mul_(1.0 + perturb * torch.randn(p.shape, device="cuda", generator=g))
    state = create_train_state(pcfg, gan)
    step = make_train_step(pcfg, gan)
    real, labels, zd, ld, zg, lg = step.prepare(state, fixed_batch(z_d.shape[0], res),
                                                z_d=z_d, z_g=z_g)
    d_loss, d_aux, d_grads = step.d_loss_and_grads(state, real, labels, zd, ld)
    g_loss, g_grads = step.g_loss_and_grads(state, zg, lg)
    torch.cuda.synchronize()
    out = (d_grads, g_grads, float(d_loss), float(g_loss), float(d_aux.get("r1", 0.0)))
    del gan, state, step
    torch.cuda.empty_cache()
    return out


def phase_train_grads(fa, cfg, weights):
    """Phase 6, second half: one step's gradients (R1 firing) on several
    paths from one state, batch and pair of latents."""
    g = torch.Generator(device="cuda")
    g.manual_seed(5)
    z_d = torch.randn(BATCH, cfg.model.latent_dim, device="cuda", generator=g)
    z_g = torch.randn(BATCH, cfg.model.latent_dim, device="cuda", generator=g)

    # 128^2, bf16: the kernel path's error against f32 at most twice the
    # plain path's; each gate backward of the kernel path held to the plain
    # backward on its own saved tensors
    calls = []
    with checked_gate_backward(fa, calls):
        kernel = step_grads(cfg, weights, z_d, z_g, 128, True, "bfloat16")
    check(len(calls) == 24, f"{len(calls)} gate backward calls in one step's gradients")
    paths = {"kernel": kernel,
             "plain": step_grads(cfg, weights, z_d, z_g, 128, False, "bfloat16"),
             "f32": step_grads(cfg, weights, z_d, z_g, 128, False, "float32"),
             # how far the f32 plain path itself moves when the weights move by 1e-7
             "f32_perturbed": step_grads(cfg, weights, z_d, z_g, 128, False, "float32",
                                         perturb=1e-7)}
    rows = {}
    for i, net in enumerate(("D", "G")):
        ek = rel_err(paths["kernel"][i], paths["f32"][i])
        ep = rel_err(paths["plain"][i], paths["f32"][i])
        rows[net] = dict(rel_err_kernel_vs_f32=ek, rel_err_plain_vs_f32=ep,
                         rel_change_f32_at_1e7_weight_noise=rel_err(
                             paths["f32_perturbed"][i], paths["f32"][i]))
        check(ek <= BF16_FACTOR * ep,
              f"{net} gradient: kernel path error {ek:.3e} > {BF16_FACTOR} x plain {ep:.3e}")
    worst = {name: max(r[f"{name}_rel_err_kernel_vs_f32"] / max(r[f"{name}_rel_err_plain_vs_f32"],
                                                              1e-12) for r in calls)
             for name in GRAD_NAMES[1:]}

    # 64^2 (one stage fewer, the same widths), f32: the kernel path within
    # TRAIN_F32_TOL of the plain path, every gate backward within F32_TOL
    from locate_tpu_torch.config import get_config

    cfg64 = get_config("lsun_bedroom_128", {"use_pallas": "true", "model.resolution": "64",
                                            "data.resolution": "64"})
    gan, _, _ = trainer(cfg64)
    w64 = (gan.generator.state_dict(), gan.discriminator.state_dict())
    del gan
    calls64 = []
    with checked_gate_backward(fa, calls64):
        k64 = step_grads(cfg64, w64, z_d, z_g, 64, True, "float32")
    p64 = step_grads(cfg64, w64, z_d, z_g, 64, False, "float32")
    noisy64 = step_grads(cfg64, w64, z_d, z_g, 64, False, "float32", perturb=1e-7)
    for i, net in enumerate(("D", "G")):
        e, moved = rel_err(k64[i], p64[i]), rel_err(noisy64[i], p64[i])
        limit = max(TRAIN_F32_TOL, 10.0 * moved)
        rows[net].update(rel_err_kernel_vs_plain_f32_at_64=e,
                         rel_change_f32_at_64_at_1e7_weight_noise=moved)
        check(e <= limit, f"{net} gradient at 64^2 f32: kernel path error {e:.3e} > {limit:.3e}")
    say("train-grads", batch=BATCH, r1_fired=True, gradients=rows,
        gate_backward_calls_checked={"bf16_128": len(calls), "f32_64": len(calls64)},
        worst_kernel_over_plain_error_ratio_bf16=worst,
        losses={k: dict(d_loss=v[2], g_loss=v[3], r1=v[4]) for k, v in paths.items()})


def phase_train_throughput():
    """Phase 7."""
    from locate_tpu_torch import cli
    from locate_tpu_torch.config import get_config

    kernel = run_cli(["bench", "128", "20"])
    torch.cuda.empty_cache()
    plain = run_cli(["bench", "128", "20", "xla"])
    torch.cuda.empty_cache()
    check(kernel["flops_per_step"] == plain["flops_per_step"], "flop counts differ")
    peaks = {}
    for remat in (True, False):
        cfg = get_config("lsun_bedroom_128", {"use_pallas": "true",
                                              "train.global_batch": "128",
                                              "train.r1_remat": str(remat).lower()})
        gan, state, step = trainer(cfg)
        batch = fixed_batch(128)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state, metrics = step(state, batch)  # step 0: R1 fires
        torch.cuda.synchronize()
        check(float(metrics["r1"]) > 0.0, "R1 did not fire at step 0")
        peaks[f"r1_remat={remat}"] = torch.cuda.max_memory_allocated()
        del gan, state, step, batch
        torch.cuda.empty_cache()
    profiles = {}
    for name, use_pallas in (("kernel_path", True), ("plain_path", False)):
        gan, state, step = trainer(cli.bench_config(128, [] if use_pallas else ["xla"]))
        batch = fixed_batch(128)
        idle, top = profile_calls(lambda: step(state, batch), top=15)
        profiles[name] = dict(device_idle_share="not measured" if idle is None else idle,
                              top_kernels=top)
        del gan, state, step, batch
        torch.cuda.empty_cache()
    say("train-throughput", kernel_path=kernel, plain_path=plain,
        peak_memory_bytes_batch128_with_r1=peaks, profile_3_steps_batch128=profiles)
    return kernel, plain


# ---------------------------------------------------------------------------
# ffhq_512: the fused-stage path
# ---------------------------------------------------------------------------

STAGE_KW = dict(act="leaky_relu", leaky_slope=0.2)
BWD_NAMES = ("du", "dxs", "dWr", "dWc", "db_col", "dWskip")
STAGE_OUTPUTS = {"stage_conv": ("y",), "stage_softmax_stats": ("w_pre", "m", "se"),
                 "stage_softmax_apply_pool": ("y",), "stage_conv_bwd": BWD_NAMES,
                 "stage_sigmoid": ("y",)}
# (kernel, form, C, Co): G's 512^2 stage runs `up` forms from 256^2 x 64,
# D's the plain ones; `down` is the conv-only pool tail; `skip` a 1x1 skip
STAGE_CASES = [("stage_softmax_stats", "up", 64, 64), ("stage_softmax_stats", "plain", 64, 64),
               ("stage_softmax_apply_pool", "plain", 64, 64),
               ("stage_conv", "plain", 64, 64), ("stage_conv", "up", 64, 64),
               ("stage_conv", "down", 64, 64), ("stage_conv", "skip", 32, 64),
               ("stage_conv_bwd", "plain", 64, 64), ("stage_conv_bwd", "up", 64, 64)]
# the sigmoid pass: G's `up`, D's `down`, and the plain and 1x1-skip forms
SIGMOID_STAGE_CASES = [("stage_sigmoid", "up", 64, 64), ("stage_sigmoid", "down", 64, 64),
                       ("stage_sigmoid", "plain", 64, 64), ("stage_sigmoid", "skip", 32, 64)]


def ffhq_config(**overrides):
    from locate_tpu_torch.config import get_config

    return get_config("ffhq_512", {"train.global_batch": str(FFHQ_BATCH), **overrides})


def stage_inputs(n, hin, c, co, dtype, seed):
    """(x, a, b, wr, wc, b_col, ws) of one stage as the kernels take them:
    weights scaled to keep the stage's output of order one."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)

    def r(*shape, scale=0.1):
        return torch.randn(*shape, device="cuda", generator=g) * scale

    ws = r(c, co, scale=1 / math.sqrt(c)).to(dtype) if c != co else None
    return [r(n, hin, hin, c, scale=1.0).to(dtype), 1 + r(n, c), r(n, c),
            r(3, c, co, scale=1 / math.sqrt(3 * c)).to(dtype),
            r(3, co, co, scale=1 / math.sqrt(3 * co)).to(dtype), r(co), ws]


def stage_gate(hw, co, seed):
    """(pos_proj, w1x, b1, w2, b2), f32, making the gate vary and pass 16."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    hd = co // 4
    r = lambda *shape, scale: torch.randn(*shape, device="cuda", generator=g) * scale  # noqa
    return [r(hw, hd, scale=0.5), r(co, hd, scale=1 / math.sqrt(co)), r(hd, scale=0.1),
            r(hd, co, scale=3 / math.sqrt(hd)), r(co, scale=0.1)]


def as_f32(ts):
    return [None if t is None else t.float() for t in ts]


def run_stage(fs, kind, ops, gate, form, dw=None, stats=None, plain=False):
    """One fused-stage kernel (or its plain version) on `ops`: its outputs,
    named by STAGE_OUTPUTS[kind]. The apply pass takes x as w_pre, with
    the softmax statistics `stats` of its gate logits."""
    up, down = form == "up", form == "down"
    if kind == "stage_conv":
        fn = fs.stage_conv_reference if plain else fs.stage_conv
        return (fn(*ops, upsample=up, downsample=down, **STAGE_KW),)
    if kind == "stage_sigmoid":
        fn = fs.stage_sigmoid_reference if plain else fs.stage_sigmoid
        return (fn(*ops, *gate, upsample=up, downsample=down, gate_max=SIGMOID_GATE_MAX,
                   **STAGE_KW),)
    if kind == "stage_softmax_stats":
        fn = fs.stage_softmax_stats_reference if plain else fs.stage_softmax_stats
        return fn(*ops, *gate, upsample=up, **STAGE_KW)
    if kind == "stage_softmax_apply_pool":
        h, w = ops[0].shape[1:3]
        fn = fs.stage_softmax_apply_pool_reference if plain else fs.stage_softmax_apply_pool
        return (fn(ops[0], *gate, *stats, hw_scale=float(h * w), gate_max=16.0, **STAGE_KW),)
    fn = fs.stage_conv_bwd_reference if plain else fs.stage_conv_bwd
    return fn(ops[0], dw, *ops[1:5], ops[6], upsample=up, **STAGE_KW)


def conv_bwd_scales(fs, ops, dw, up):
    """`stage_conv_bwd`'s outputs computed on the absolute values of their
    terms (f32): the scale each sum's rounding error grows with."""
    x, a, b, wr, wc, _, ws = as_f32(ops)
    u = fs._norm_act(x, a, b, **STAGE_KW)
    if up:
        u = fs.up2x(u)
    v = fs._conv3(u, wr, dim=2)
    dy0 = dw.float().abs() * fs.SQRT_HALF
    dv = fs._conv3(dy0, wc.abs().transpose(1, 2), dim=1, sign=-1)
    du = fs._conv3(dv, wr.abs().transpose(1, 2), dim=2, sign=-1)
    dwc = torch.einsum("nhwkj,nhwc->kjc", fs._taps(v.abs(), 1).unflatten(-1, (3, -1)), dy0)
    dwr = torch.einsum("nhwkc,nhwo->kco", fs._taps(u.abs(), 2).unflatten(-1, (3, -1)), dv)
    dbc = dy0.sum(dim=(0, 1, 2))
    if up:
        du, dy0 = fs._pool2x_sum(du), fs._pool2x_sum(dy0)
    if ws is None:
        return du, dy0, dwr, dwc, dbc, None
    return (du, dy0 @ ws.abs().t(), dwr, dwc, dbc,
            torch.einsum("nhwc,nhwo->co", x.abs(), dy0))


def stage_bound(kind, n, c, co, dtype, form, h=512):
    """(bound_ms, bound_by) of one stage kernel at (N, h, h) fine pixels:
    the bytes it must move (x, dw, w_pre in and out once, weights, f32
    statistics and weight gradients) over the memory rate, and the convs'
    and gate MLP's multiply-adds over the peak rate of the operand type."""
    es = torch.finfo(dtype).bits // 8
    up, down = form == "up", form == "down"
    pf = n * h * h                       # fine pixels
    px = pf // 4 if up else pf           # x-side pixels
    skip = c != co
    hd = co // 4
    weights = (3 * c * co + 3 * co * co + (c * co if skip else 0)) * es + co * 4 + 2 * n * c * 4
    gate_weights = 2 * co * hd * es + (h * h * hd + hd + co) * 4  # pos_proj among them
    gate_bytes = gate_weights + 2 * n * co * 4  # and the softmax statistics
    conv_flops = 2.0 * pf * 3 * (c * co + co * co) + (2.0 * px * c * co if skip else 0.0)
    gate_flops = 2.0 * pf * 2 * co * hd
    if kind == "stage_conv":
        nbytes = px * c * es + pf * co * es // (4 if down else 1) + weights
        flops = conv_flops
    elif kind == "stage_softmax_stats":
        nbytes, flops = px * c * es + pf * co * es + weights + gate_bytes, conv_flops + gate_flops
    elif kind == "stage_sigmoid":  # x in, y out (pooled under down), no statistics
        nbytes = px * c * es + pf * co * es // (4 if down else 1) + weights + gate_weights
        flops = conv_flops + gate_flops
    elif kind == "stage_softmax_apply_pool":
        nbytes, flops = pf * co * es + pf * co * es // 4 + gate_bytes, gate_flops
    else:  # recompute v; dv, du; dWr, dWc; the skip's two products
        nbytes = 3 * px * c * es + pf * co * es + weights + (3 * c * co + 3 * co * co + co) * 4
        flops = (2.0 * pf * 3 * (3 * c * co + 2 * co * co)
                 + (4.0 * px * c * co if skip else 0.0))
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_stage_kernels(fs, fa, cases=STAGE_CASES, phase="stage-kernels-vs-plain"):
    """Phase 9 (and 16 with the sigmoid cases): the fused-stage kernels
    against their plain versions at ffhq_512's 512^2 stage shapes, batch
    16, in bf16 (timed) and f32; the backward's outputs against their
    absolute-term scales, and bitwise repeatable in f32; the sigmoid pass
    at gate_max 1.5, where the clamp binds at a part of the pixels."""
    n = FFHQ_BATCH
    rows, times, max_err = [], {}, {}
    for i, (kind, form, c, co) in enumerate(cases):
        for dtype in (torch.bfloat16, torch.float32):
            ops = stage_inputs(n, 256 if form == "up" else 512, c, co, dtype, seed=300 + i)
            gate = stage_gate(512 * 512, co, seed=400 + i)
            dw = None
            if kind == "stage_conv_bwd":
                g = torch.Generator(device="cuda")
                g.manual_seed(500 + i)
                dw = torch.randn(n, 512, 512, co, device="cuda", generator=g).to(dtype)
            shape = dict(kernel=kind, form=form, N=n, H=512, C=c, Co=co)
            row = dict(shape, dtype=str(dtype).replace("torch.", ""))
            with torch.no_grad():
                # the apply pass's statistics, each path's own: x's in its
                # dtype for the kernel and the plain version, f32 for the truth
                stats = truth_stats = None
                if kind == "stage_softmax_apply_pool":
                    stats, truth_stats = (fa.softmax_gate_stats_reference(
                        t.reshape(n, 512 * 512, co), *gate, **STAGE_KW)
                        for t in (ops[0], ops[0].float()))
                kern = run_stage(fs, kind, ops, gate, form, dw, stats)
                plain = run_stage(fs, kind, ops, gate, form, dw, stats, plain=True)
                truth = (plain if dtype == torch.float32 else
                         run_stage(fs, kind, as_f32(ops), gate, form,
                                   None if dw is None else dw.float(), truth_stats, plain=True))
                scales = ((None,) * len(kern) if dw is None
                          else conv_bwd_scales(fs, ops, dw, form == "up"))
                if kind == "stage_conv_bwd" and dtype == torch.float32:
                    again = run_stage(fs, kind, ops, gate, form, dw)
                    for name, k, a in zip(BWD_NAMES, kern, again):
                        check(k is None or torch.equal(k, a),
                              f"{kind} {form}: {name} differs bitwise between two runs")
                    row["bitwise_repeatable"] = True
                torch.cuda.synchronize()
            for name, k, p, t, sc in zip(STAGE_OUTPUTS[kind], kern, plain, truth, scales):
                if k is None:
                    continue
                hold(name, shape, k, p, t, dtype, row, scale=sc)
                max_err[kind] = max(max_err.get(kind, 0.0), row[f"{name}_max_abs_err"])
            if kind == "stage_sigmoid" and dtype == torch.float32:
                with torch.no_grad():
                    w = fs.stage_conv_reference(*ops, upsample=form == "up", **STAGE_KW)
                    l = fa.gate_logits_reference(w.reshape(n, 512 * 512, co), *gate, **STAGE_KW)
                    row["clamped_share"] = float(
                        (2.0 * torch.sigmoid(l) > SIGMOID_GATE_MAX).float().mean())
                    del w, l
                check(0.05 < row["clamped_share"] < 0.95,
                      f"{kind} {form}: gate_max {SIGMOID_GATE_MAX} clamps {row['clamped_share']}")
            del kern, plain, truth, scales
            if dtype == torch.bfloat16:
                with torch.no_grad():
                    ms = graph_ms(lambda: run_stage(fs, kind, ops, gate, form, dw, stats), 3, 3)
                    plain_ms = graph_ms(lambda: run_stage(fs, kind, ops, gate, form, dw, stats,
                                                          plain=True), 3, 3)
                b_ms, b_by = stage_bound(kind, n, c, co, dtype, form)
                times[(kind, form)] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                           bound_by=b_by, share_of_bound=b_ms / ms)
                row.update(times[(kind, form)])
            say(phase, **row)
            rows.append(row)
            del ops, gate, dw, stats, truth_stats
            torch.cuda.empty_cache()
    return rows, times, max_err


def plain_stage_backward(fs, fa, o, gy, saved):
    """`FusedStage`'s backward chain on its saved tensors through the
    kernels' plain versions: the gradients of its twelve inputs."""
    x, gn_scale, gn_bias, w_row, w_col, b_col, w_skip, *gate = saved
    kw = dict(act=o.act, leaky_slope=o.leaky_slope)
    if o.downsample:
        gy = fs.up2x(gy.float() * 0.25).to(gy.dtype)
    a, b = fs.fold_groupnorm(x, gn_scale, gn_bias, o.groups, o.eps)
    wr, wc, ws = fs.kernel_weights(w_row, w_col, w_skip, x.dtype)
    gate_grads, dw = (None,) * 5, gy
    if o.mode is not None:
        w_pre = fs.stage_conv_reference(x, a, b, wr, wc, b_col, ws, upsample=o.upsample, **kw)
        n, h, w, co = w_pre.shape
        w2d, gy2 = w_pre.reshape(n, h * w, co), gy.reshape(n, h * w, co)
        if o.mode == "softmax":
            opts = dict(hw_scale=float(h * w), gate_max=o.gate_max, **kw)
            m, se = fa.softmax_gate_stats_reference(w2d, *gate, **kw)
            c = fa.softmax_gate_csum_reference(w2d, gy2, *gate, m, se, **opts)
            dw2d, *gate_grads = fa.softmax_gate_backward_reference(w2d, gy2, *gate, m, se, c,
                                                                   **opts)
        else:
            dw2d, *gate_grads = fa.sigmoid_gate_backward_reference(w2d, gy2, *gate,
                                                                   gate_max=o.gate_max, **kw)
        dw = dw2d.reshape(w_pre.shape)
    du, dxs, dwr, dwc, dbc, dws = fs.stage_conv_bwd_reference(x, dw, a, b, wr, wc, ws,
                                                              upsample=o.upsample, **kw)
    dx, d_scale, d_bias = fs.groupnorm_act_backward(x, du, dxs, gn_scale, gn_bias,
                                                    groups=o.groups, eps=o.eps, **kw)
    return (dx, d_scale, d_bias, dwr.permute(2, 1, 0)[:, :, None, :],
            dwc.permute(2, 1, 0)[:, :, :, None], dbc,
            None if dws is None else dws.t()[:, :, None, None], *gate_grads)


@contextlib.contextmanager
def checked_stage_backward(fs, fa, record):
    """Hold every backward of `FusedStage` run inside the block against the
    plain chain on the very tensors that call saved: in bf16 by the rule of
    phase 4 (against the f32 plain chain on the same inputs), in f32 to
    F32_TOL; a softmax gate's db2, zero in exact arithmetic, against dW2's
    scale. One row per call goes to `record`."""
    original = fs.FusedStage.backward

    def backward(ctx, gy):
        # the saved tensors are unpacked once (a checkpointed stage allows
        # no more): the kernel chain runs here on them, as the original does
        o, saved = ctx.options, ctx.saved_tensors
        check(o.hand_written, "the checked stage backward runs the kernel chain only")
        with torch.no_grad():
            grads = (None, *fs._backward(o, gy, *saved[:7], saved[7:]))
            plain = plain_stage_backward(fs, fa, o, gy, saved)
            truth = plain
            if saved[0].dtype != torch.float32:
                truth = plain_stage_backward(fs, fa, o, gy.float(), as_f32(saved))
        x = saved[0]
        shape = dict(N=x.shape[0], H=o.h, C=x.shape[-1], mode=o.mode, up=o.upsample,
                     down=o.downsample)
        row = dict(shape, dtype=str(x.dtype).replace("torch.", ""))
        names = fs._NAMES
        for name, k, p, t in zip(names, grads[1:], plain, truth):
            if k is None:
                continue
            scale = truth[names.index("w2")] if name == "b2" and o.mode == "softmax" else None
            hold(name, shape, k, p, t, x.dtype, row, scale=scale)
        record.append(row)
        return grads

    fs.FusedStage.backward = staticmethod(backward)
    try:
        yield
    finally:
        fs.FusedStage.backward = original


def phase_ffhq_serving(overrides=None, want=FFHQ_SERVE_PER_FORWARD, phase="ffhq-serving"):
    """Phase 10 (and 17 with the sigmoid gate): serving ffhq_512 (with the
    config `overrides`) through `generate_samples` and `bench-sample`, the
    kernel path against the plain path; one forward launches `want`."""
    overrides = overrides or {}
    cfg_g = ffhq_config(**overrides)
    from locate_tpu_torch.io.sampling import generate_samples
    from locate_tpu_torch.models.gan import model_config
    from locate_tpu_torch.models.generator import build_generator

    mcfg = model_config(cfg_g)
    check(mcfg.use_pallas and mcfg.resolution == 512, "ffhq_512 does not serve fused at 512^2")
    model = build_generator(mcfg, "bfloat16", "cuda", seed=0).eval()
    randomize_logit_convs(model, seed=1, scale=0.25)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    reset_counters()
    images = generate_samples(model, gen, 4)
    launches = read_counters()
    check(images.shape == (4, 512, 512, 3) and str(images.dtype) == "uint8",
          f"ffhq_512 request: images {images.shape} {images.dtype}")
    check(float(images.std()) > 0.0, "ffhq_512 request: constant images")
    check(launches == expected(want), f"one ffhq_512 forward launched {launches}, want {want}")
    plain_cfg = dataclasses.replace(mcfg, use_pallas=False)
    plain = build_generator(plain_cfg, "bfloat16", "cuda").eval()
    truth = build_generator(plain_cfg, "float32", "cuda").eval()
    plain.load_state_dict(model.state_dict())
    truth.load_state_dict(model.state_dict())
    gz = torch.Generator(device="cuda")
    gz.manual_seed(3)
    z = torch.randn(4, mcfg.latent_dim, device="cuda", generator=gz)
    with torch.inference_mode():
        yk, yp, yt = (m(z).float() for m in (model, plain, truth))
    torch.cuda.synchronize()
    for name, y in (("kernel", yk), ("plain", yp), ("f32", yt)):
        check(bool(torch.isfinite(y).all()), f"ffhq_512 {name} generator: non-finite images")
    ek, ep = rel_err(yk, yt), rel_err(yp, yt)
    check(ek <= max(BF16_FACTOR * ep, 1e-6),
          f"ffhq_512 generator: kernel path error {ek:.3e} > {BF16_FACTOR} x plain {ep:.3e}")
    idle, _ = profile_calls(lambda: generate_samples(model, gen, FFHQ_BATCH))
    del model, plain, truth
    torch.cuda.empty_cache()

    def bench_sample(use_pallas):
        torch.cuda.reset_peak_memory_stats()
        out = run_cli(["bench-sample", "ffhq_512", f"use_pallas={str(use_pallas).lower()}",
                       *(f"{k}={v}" for k, v in overrides.items()), f"--batch={FFHQ_BATCH}",
                       "--steps=3"])
        torch.cuda.empty_cache()
        return dict(out, peak_memory_bytes=torch.cuda.max_memory_allocated())

    say(phase, config="ffhq_512", overrides=overrides, launches_one_forward=launches,
        rel_err_kernel_path_vs_f32=ek, rel_err_plain_path_vs_f32=ep,
        max_abs_err_kernel_vs_plain_path=float((yk - yp).abs().max()),
        kernel_path=bench_sample(True), plain_path=bench_sample(False),
        device_idle_share_batch16=("not measured" if idle is None else idle))
    return launches


def timed_steps(step, state, batch, steps):
    """(state, metrics of each step, seconds of each step)."""
    history, seconds = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        history.append(metrics)
    return state, history, seconds


def phase_ffhq_train(overrides=None, per_step=None, phase="ffhq-train"):
    """Phase 11 (and 18 with the sigmoid gate): the main path of the
    fused-stage kernels, ffhq_512 as shipped (with the config `overrides`)
    at batch 16, three steps from step 0 (lazy R1 fires), launching
    `per_step` kernels a step, then the plain path's three steps, and a
    profile of each."""
    overrides = overrides or {}
    per_step = per_step or {**FFHQ_GATE_PER_STEP,
                            **{k: sum(v.values()) for k, v in FFHQ_STAGE_PER_STEP.items()}}
    cfg = ffhq_config(**overrides)
    tcfg = cfg.train
    check(cfg.use_pallas and cfg.model.remat and cfg.model.resolution == 512
          and tcfg.compute_dtype == "bfloat16" and tcfg.r1_gamma == 0.1
          and tcfg.grad_norm_limit == 1e6 and tcfg.max_nonfinite_skips == 200,
          "ffhq_512 is not the shipped recipe")
    gan, state, step = trainer(cfg)
    batch = fixed_batch(FFHQ_BATCH, 512)
    before = [t.clone() for t in (state.g_params.flat, state.d_params.flat, state.ema_params)]
    steps = 3
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    state, history, seconds = timed_steps(step, state, batch, steps)
    launches = read_counters()
    peak = torch.cuda.max_memory_allocated()
    history = check_history(history, tcfg)
    moved = check_moved(before, state, history, tcfg)
    check(launches == expected(per_step, steps),
          f"ffhq_512 steps launched {launches}, want {per_step} per step")
    idle, top = profile_calls(lambda: step(state, batch), calls=2, top=15)
    weights = (gan.generator.state_dict(), gan.discriminator.state_dict())
    params = dict(g=state.g_params.flat.numel(), d=state.d_params.flat.numel())
    del gan, state, step, before
    torch.cuda.empty_cache()

    pcfg = ffhq_config(use_pallas="false", **overrides)
    gan, state, step = trainer(pcfg)
    torch.cuda.reset_peak_memory_stats()
    state, plain_history, plain_seconds = timed_steps(step, state, batch, steps)
    plain_peak = torch.cuda.max_memory_allocated()
    plain_history = check_history(plain_history, tcfg)
    plain_idle, plain_top = profile_calls(lambda: step(state, batch), calls=2, top=15)
    del gan, state, step
    torch.cuda.empty_cache()

    def rates(secs):
        return dict(seconds_per_step=secs,
                    images_per_sec_after_step0=FFHQ_BATCH * (len(secs) - 1) / sum(secs[1:]))

    say(phase, config="ffhq_512 as shipped, batch 16", overrides=overrides, steps=steps,
        params=params,
        launches=launches, launches_per_step={k: v / steps for k, v in launches.items()},
        metrics=history, max_param_change=moved,
        kernel_path=dict(rates(seconds), peak_memory_bytes=peak,
                         device_idle_share="not measured" if idle is None else idle,
                         top_kernels_2_steps=top),
        plain_path=dict(rates(plain_seconds), peak_memory_bytes=plain_peak,
                        metrics=plain_history,
                        device_idle_share=("not measured" if plain_idle is None
                                           else plain_idle),
                        top_kernels_2_steps=plain_top))
    return cfg, weights, launches


def phase_ffhq_checked_backward(fs, fa, cfg, weights, phase="ffhq-checked-stage-backward"):
    """Phase 12 (and 19 with the sigmoid gate): one ffhq_512 step's
    gradients (R1 firing) on the kernel path, each of its four fused-stage
    backward calls held against the plain chain on its own saved tensors."""
    g = torch.Generator(device="cuda")
    g.manual_seed(6)
    z = [torch.randn(FFHQ_BATCH, cfg.model.latent_dim, device="cuda", generator=g)
         for _ in range(2)]
    calls = []
    with checked_stage_backward(fs, fa, calls):
        _, _, d_loss, g_loss, r1 = step_grads(cfg, weights, *z, 512, True, "bfloat16")
    check(len(calls) == 4, f"{len(calls)} fused-stage backward calls in one ffhq_512 step")
    check(all(math.isfinite(v) for v in (d_loss, g_loss, r1)) and r1 > 0.0,
          f"ffhq_512 step losses {d_loss}, {g_loss}, r1 {r1}")
    say(phase, calls=calls, d_loss=d_loss, g_loss=g_loss, r1=r1)


def phase_ffhq_grads_64(fs, fa, blocks, overrides=None, kernels=STAGE_KERNELS,
                        phase="ffhq-train-grads-64"):
    """Phase 13 (and 20 with the sigmoid gate): one step's whole gradients
    at ffhq_512's widths cut to 64^2, every stage fused (FUSE_MIN_LOCATIONS
    = 0), f32 kernel path against the f32 plain path: within
    TRAIN_F32_TOL, or ten times what 1e-7 weight noise moves the plain path
    by if larger; each fused-stage backward call within F32_TOL of the
    plain chain; each of `kernels` launched."""
    cfg = ffhq_config(**{"model.resolution": "64", "data.resolution": "64",
                         **(overrides or {})})
    gan, _, _ = trainer(cfg)
    weights = (gan.generator.state_dict(), gan.discriminator.state_dict())
    del gan
    g = torch.Generator(device="cuda")
    g.manual_seed(7)
    z = [torch.randn(FFHQ_BATCH, cfg.model.latent_dim, device="cuda", generator=g)
         for _ in range(2)]
    calls = []
    blocks.FUSE_MIN_LOCATIONS = 0
    try:
        with checked_stage_backward(fs, fa, calls):
            reset_counters()
            kernel = step_grads(cfg, weights, *z, 64, True, "float32")
            launches = read_counters()
    finally:
        blocks.FUSE_MIN_LOCATIONS = None
    stages = len(cfg.model.stage_resolutions())
    check(len(calls) == 4 * stages, f"{len(calls)} fused-stage backward calls at 64^2")
    check(all(launches[k] > 0 for k in kernels), f"64^2 step launched {launches}")
    plain = step_grads(cfg, weights, *z, 64, False, "float32")
    noisy = step_grads(cfg, weights, *z, 64, False, "float32", perturb=1e-7)
    rows = {}
    for i, net in enumerate(("D", "G")):
        e, moved = rel_err(kernel[i], plain[i]), rel_err(noisy[i], plain[i])
        limit = max(TRAIN_F32_TOL, 10.0 * moved)
        rows[net] = dict(rel_err_kernel_vs_plain_f32=e,
                         rel_change_f32_at_1e7_weight_noise=moved)
        check(e <= limit, f"{net} gradient at 64^2 f32, every stage fused: {e:.3e} > {limit:.3e}")
    say(phase, batch=FFHQ_BATCH, fused_stages=stages, gradients=rows,
        launches=launches, stage_backward_calls_checked=len(calls),
        worst_stage_backward_rel_err=max(v for r in calls for k, v in r.items()
                                          if k.endswith("rel_err_kernel_vs_plain")),
        losses=dict(kernel=kernel[2:], plain=plain[2:]))


def event_ms(fn, reps=5):
    """Milliseconds of one `fn()` by CUDA events over `reps` calls, after
    two warm-up calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_fusion_timing(blocks):
    """Phase 14: forward plus backward of one 512^2 G stage and one D stage
    of ffhq_512 (bf16, batch 16): fused; unfused (its layers one by one,
    the gate through its own kernels); and the plain path (use_pallas off)."""
    from locate_tpu_torch.models.gan import model_config

    mcfg = model_config(ffhq_config())
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    builds = {
        "G_512_up_pair": (lambda c: blocks.generator_stage(
            64, 64, 512, c, first=False, compute_dtype=torch.bfloat16, gen=gen),
            (FFHQ_BATCH, 256, 256, 64)),
        "D_512_down_pair": (lambda c: blocks.discriminator_stage(
            64, 64, 512, c, last=False, compute_dtype=torch.bfloat16, gen=gen),
            (FFHQ_BATCH, 512, 512, 64)),
    }
    rows = {}
    for name, (build, shape) in builds.items():
        stage = build(mcfg)
        randomize_logit_convs(stage, seed=12, scale=0.25)
        plain = build(dataclasses.replace(mcfg, use_pallas=False))
        plain.load_state_dict(stage.state_dict())
        x = torch.randn(shape, device="cuda", generator=gen).to(torch.bfloat16)
        x.requires_grad_(True)
        with torch.no_grad():
            dy = torch.randn(stage(x).shape, device="cuda", generator=gen).to(torch.bfloat16)

        def fwd_bwd(module):
            y = module(x)
            torch.autograd.grad(y, [x, *module.parameters()], dy)

        times = {}
        for mode, threshold in (("fused", None), ("unfused", 1 << 62)):
            blocks.FUSE_MIN_LOCATIONS = threshold
            times[f"{mode}_ms"] = event_ms(lambda: fwd_bwd(stage))
        blocks.FUSE_MIN_LOCATIONS = None
        times["plain_path_ms"] = event_ms(lambda: fwd_bwd(plain))
        times["fused_over_unfused"] = times["fused_ms"] / times["unfused_ms"]
        rows[name] = times
        del stage, plain, x, dy
        torch.cuda.empty_cache()
    say("fusion-timing", batch=FFHQ_BATCH, dtype="bfloat16", stages=rows)
    return rows


def phase_sigmoid_threshold():
    """Phase 21: one sigmoid LocateAttention layer at ffhq_512's G shapes
    from 32^2 to 256^2 (C 64, Hd 16; there both packages run the plain
    composition), batch 16, bf16: forward, and forward plus backward,
    through the one-pass kernels and through the plain composition. The
    input to a retune of SIGMOID_FUSED_MAX_LOCATIONS (256, the TPU's)."""
    from locate_tpu_torch.config import AttentionConfig
    from locate_tpu_torch.ops.attention import LocateAttention

    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    rows = {}
    for side in (32, 64, 128, 256):
        layer = LocateAttention(64, AttentionConfig(mode="sigmoid", gate_max=16.0),
                                compute_dtype=torch.bfloat16, use_pallas=True, gen=gen)
        randomize_logit_convs(layer, seed=14, scale=0.25)
        x = torch.randn(FFHQ_BATCH, side, side, 64, device="cuda", generator=gen)
        x = x.to(torch.bfloat16).requires_grad_(True)
        dy = torch.randn(x.shape, device="cuda", generator=gen).to(torch.bfloat16)
        row = {}
        for path, fn in (("kernel", layer.forward_fused), ("plain", layer.forward_composed)):
            with torch.no_grad():
                row[f"{path}_forward_ms"] = event_ms(lambda: fn(x))
            row[f"{path}_forward_backward_ms"] = event_ms(
                lambda: torch.autograd.grad(fn(x), [x, *layer.parameters()], dy))
        row["kernel_over_plain_forward_backward"] = (row["kernel_forward_backward_ms"]
                                                     / row["plain_forward_backward_ms"])
        rows[f"{side}^2"] = row
        del layer, x, dy
        torch.cuda.empty_cache()
    say("sigmoid-threshold-timing", batch=FFHQ_BATCH, C=64, Hd=16, dtype="bfloat16",
        rows=rows)


# ---------------------------------------------------------------------------
# lsun_bedroom_128 with attention.kind=self: the flash kernels' path
# ---------------------------------------------------------------------------


def flash_inputs(b, t, s, dh, dv, dtype, seed):
    """(q, k, v, do): k and v of unit variance, q of variance 4, so the
    scaled scores have a standard deviation of 2 and no softmax row is flat."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, device="cuda", generator=g) * scale).to(dtype)

    return r(b, t, dh, scale=2.0), r(b, s, dh), r(b, s, dv), r(b, t, dv)


def batch_chunk(t, s):
    """Batch rows a plain version takes at once: its (T, S) f32 matrices,
    half a dozen of them in the backward, stay at 2 GB each."""
    return max(1, 2 ** 29 // (t * s))


def chunked(fn, tensors, chunk):
    """`fn` over `chunk` batch rows of `tensors` at a time, its outputs
    joined again (every batch row of an attention call is independent)."""
    b = tensors[0].shape[0]
    if chunk >= b:
        out = fn(*tensors)
        return out if isinstance(out, tuple) else (out,)
    parts = []
    for i in range(0, b, chunk):
        out = fn(*(x[i:i + chunk] for x in tensors))
        parts.append(out if isinstance(out, tuple) else (out,))
    return tuple(torch.cat(col) for col in zip(*parts))


def run_flash(fl, q, k, v, do, scale, plain: bool):
    """(o, ell, dq, dk, dv) through the three kernels, or through their
    plain versions a few batch rows at a time."""
    if not plain:
        o, ell = fl.flash_fwd(q, k, v, scale)
        delta = fl.row_delta(o, do)
        return (o, ell, fl.flash_dq(q, k, v, do, ell, delta, scale),
                *fl.flash_dkv(q, k, v, do, ell, delta, scale))

    def one(q, k, v, do):
        o, ell = fl.flash_forward_reference(q, k, v, scale)
        return (o, ell, *fl.flash_backward_reference(q, k, v, o, ell, do, scale))

    return chunked(one, (q, k, v, do), batch_chunk(q.shape[1], k.shape[1]))


def flash_scales(fl, q, k, v, do, scale):
    """(None, None, dq, dk, dv): the backward outputs computed on the
    absolute values of their terms (f32), the scale each sum's rounding
    error grows with."""
    def one(q, k, v, do):
        q, k, v, do = (x.float() for x in (q, k, v, do))
        o, ell = fl.flash_forward_reference(q, k, v, scale)
        p = torch.exp(fl._scores(q, k, scale) - ell.unsqueeze(-1))
        ds = p * (torch.matmul(do.abs(), v.abs().transpose(1, 2))
                  + (do.abs() * o.abs()).sum(-1, keepdim=True))
        return (torch.matmul(ds, k.abs()) * scale,
                torch.matmul(ds.transpose(1, 2), q.abs()) * scale,
                torch.matmul(p.transpose(1, 2), do.abs()))

    return (None, None, *chunked(one, (q, k, v, do), batch_chunk(q.shape[1], k.shape[1])))


def flash_bound(kernel, b, t, s, dh, dv, dtype):
    """(bound_ms, bound_by): the bytes the kernel must move (q, k, v and,
    for the backward passes, dO, ell and delta read once; its outputs
    written once) over the memory rate, and its products' flops, 2 B T S
    times (dh + dv) forward, (2 dh + dv) for dQ, (2 dh + 2 dv) for dK/dV,
    over the peak rate of the operand type."""
    es = torch.finfo(dtype).bits // 8
    qkv = b * (t * dh + s * dh + s * dv)
    if kernel == "flash_fwd":
        nbytes, width = es * (qkv + b * t * dv) + 4 * b * t, dh + dv
    elif kernel == "flash_dq":
        nbytes, width = es * (qkv + b * t * dv + b * t * dh) + 8 * b * t, 2 * dh + dv
    else:
        nbytes = es * (qkv + b * t * dv + b * s * (dh + dv)) + 8 * b * t
        width = 2 * dh + 2 * dv
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = 2.0 * b * t * s * width / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_times(fl, q, k, v, do, scale):
    """{kernel: ms, plain_ms, bound_ms, bound_by, library_ms} of the three
    kernels on these operands. The kernels and the library call are timed
    as CUDA graphs of back-to-back launches; the plain versions, which run
    a few batch rows at a time, by events. The library yardstick is
    `F.scaled_dot_product_attention`: its forward for flash_fwd, its
    autograd backward (dQ, dK and dV in one) for flash_dq and flash_dkv
    together. Where the allocator refuses the library call, its time is
    None and the refusal is recorded."""
    import torch.nn.functional as F

    b, t, dh = q.shape
    s, dv = v.shape[1], v.shape[2]
    big = t * s >= 4096 * 4096
    reps = (3, 2) if big else (10, 5)
    chunk = batch_chunk(t, s)
    with torch.no_grad():
        o, ell = fl.flash_fwd(q, k, v, scale)
        delta = fl.row_delta(o, do)
        ms = {"flash_fwd": graph_ms(lambda: fl.flash_fwd(q, k, v, scale), *reps),
              "flash_dq": graph_ms(lambda: fl.flash_dq(q, k, v, do, ell, delta, scale), *reps),
              "flash_dkv": graph_ms(lambda: fl.flash_dkv(q, k, v, do, ell, delta, scale), *reps)}
        plain = {
            "flash_fwd": event_ms(lambda: chunked(
                lambda q, k, v: fl.flash_forward_reference(q, k, v, scale), (q, k, v), chunk),
                2 if big else 5),
            "flash_dq": event_ms(lambda: chunked(
                lambda *a: fl.flash_dq_reference(*a, scale), (q, k, v, do, ell, delta), chunk),
                2 if big else 5),
            "flash_dkv": event_ms(lambda: chunked(
                lambda *a: fl.flash_dkv_reference(*a, scale), (q, k, v, do, ell, delta), chunk),
                2 if big else 5)}
    library, refusal = {"flash_fwd": None, "flash_bwd": None}, None
    try:
        with torch.no_grad():
            library["flash_fwd"] = graph_ms(
                lambda: F.scaled_dot_product_attention(q, k, v, scale=scale), *reps)
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = F.scaled_dot_product_attention(*leaves, scale=scale)
        library["flash_bwd"] = event_ms(
            lambda: torch.autograd.grad(out, leaves, do, retain_graph=True), 3 if big else 10)
        del leaves, out
    except torch.cuda.OutOfMemoryError as e:
        refusal = str(e).split(". GPU")[0]
    release_memory()
    rows = {}
    for kernel in FLASH_KERNELS:
        b_ms, b_by = flash_bound(kernel, b, t, s, dh, dv, q.dtype)
        rows[kernel] = dict(ms=ms[kernel], plain_ms=plain[kernel], bound_ms=b_ms, bound_by=b_by,
                            share_of_bound=b_ms / ms[kernel],
                            library_ms=library["flash_fwd" if kernel == "flash_fwd"
                                               else "flash_bwd"])
    rows["flash_dq"]["library_covers"] = rows["flash_dkv"]["library_covers"] = (
        "flash_dq and flash_dkv together (one autograd backward, timed by events)")
    if refusal:
        rows["library_refused"] = refusal
    return rows


def check_flash(fl, q, k, v, do, scale, shape, row):
    """Hold the three kernels to their plain versions on these operands by
    the rules of phases 3-4, two runs bitwise equal; fills `row`."""
    dtype = q.dtype
    with torch.no_grad():
        kern = run_flash(fl, q, k, v, do, scale, plain=False)
        again = run_flash(fl, q, k, v, do, scale, plain=False)
        plain = run_flash(fl, q, k, v, do, scale, plain=True)
        truth = plain
        if dtype != torch.float32:
            truth = run_flash(fl, *(x.float() for x in (q, k, v, do)), scale, plain=True)
        scales = flash_scales(fl, q, k, v, do, scale)
        torch.cuda.synchronize()
    for name, a, b in zip(FLASH_NAMES, kern, again):
        check(torch.equal(a, b), f"{name} at {shape}: two runs differ bitwise")
    row["bitwise_repeatable"] = True
    for name, kk, pp, tt, sc in zip(FLASH_NAMES, kern, plain, truth, scales):
        check(kk.shape == pp.shape and kk.dtype == pp.dtype, f"{name} at {shape}: {kk.shape}")
        hold(name, shape, kk, pp, tt, dtype, row, scale=sc)


def softmax_peak(fl, q, k, scale):
    """Mean over the first image's rows of S times the largest probability:
    1 for a flat softmax."""
    with torch.no_grad():
        s = fl._scores(q[:1].float(), k[:1].float(), scale)
        return float((torch.softmax(s, dim=-1).amax(dim=-1) * k.shape[1]).mean())


def phase_flash_kernels(fl):
    """Phase 22: the three flash kernels against their plain versions at the
    nine (T, dh, dv) of lsun_bedroom_128's self-attention layers (G's six,
    D's three others), batch 16, plus heads = 2 at 32^2 (batch 32, dh 8,
    dv 16) and one S != T case, in bf16 and f32, with a random dO, under
    the rules of phases 3 and 4 (backward outputs against the norm of the
    sum of their absolute terms); two runs bitwise equal; each bf16 case
    timed beside its bound, its plain version and the library call. Then
    the training shapes again at the train batch (64), timed only: the
    per-step numbers of the kernels line."""
    cases = [(FLASH_BATCH, t, t, dh, dv, "layer") for t, dh, dv in FLASH_SHAPES]
    cases += [(2 * FLASH_BATCH, 1024, 1024, 8, 16, "heads=2"),
              (FLASH_BATCH, 1024, 4096, 8, 32, "S != T")]
    rows = []
    for i, (b, t, s, dh, dv, what) in enumerate(cases):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, do = flash_inputs(b, t, s, dh, dv, dtype, seed=700 + i)
            scale = dh ** -0.5
            shape = dict(B=b, T=t, S=s, dh=dh, dv=dv)
            row = dict(shape=shape, case=what, dtype=str(dtype).replace("torch.", ""),
                       softmax_peak=softmax_peak(fl, q, k, scale))
            check(row["softmax_peak"] > 2.0, f"flat softmax at {shape}")
            check_flash(fl, q, k, v, do, scale, shape, row)
            if dtype == torch.bfloat16:
                row.update(flash_times(fl, q, k, v, do, scale))
            say("flash-kernels-vs-plain", **row)
            rows.append(row)
            del q, k, v, do
            torch.cuda.empty_cache()
    train_rows = []
    for i, shape3 in enumerate(FLASH_FWD_PER_STEP):
        t, dh, dv = shape3
        q, k, v, do = flash_inputs(BATCH, t, t, dh, dv, torch.bfloat16, seed=750 + i)
        row = dict(shape=dict(B=BATCH, T=t, S=t, dh=dh, dv=dv), dtype="bfloat16",
                   launches_per_step=dict(flash_fwd=FLASH_FWD_PER_STEP[shape3],
                                          flash_dq=FLASH_BWD_PER_STEP[shape3],
                                          flash_dkv=FLASH_BWD_PER_STEP[shape3]),
                   **flash_times(fl, q, k, v, do, dh ** -0.5))
        say("flash-kernels-train-batch", **row)
        train_rows.append(row)
        del q, k, v, do
        torch.cuda.empty_cache()
    return rows, train_rows


def self_config(**overrides):
    from locate_tpu_torch.config import get_config

    return get_config("lsun_bedroom_128", {"use_pallas": "true", **SELF, **overrides})


def check_self_attention_layers(fl, captured):
    """Each self-attention layer of a served request, held against the
    plain composition on the very q, k, v it computed (the bf16 rule)."""
    out = []
    for layer, (q, k, v), o in captured:
        with torch.inference_mode():
            chunk = batch_chunk(q.shape[1], k.shape[1])
            (plain,) = chunked(lambda *a: fl.attention_reference(*a, scale=layer.scale),
                               (q, k, v), chunk)
            (truth,) = chunked(lambda *a: fl.attention_reference(
                *(x.float() for x in a), scale=layer.scale), (q, k, v), chunk)
        ek, ep = rel_err(o, truth), rel_err(plain, truth)
        row = dict(B=q.shape[0], T=q.shape[1], dh=q.shape[2], dv=v.shape[2],
                   rel_err_kernel_vs_f32=ek, rel_err_plain_vs_f32=ep,
                   softmax_peak=softmax_peak(fl, q, k, layer.scale))
        check(ek <= max(BF16_FACTOR * ep, BF16_FLOOR),
              f"self-attention layer at T={q.shape[1]}: kernel error {ek:.3e} > "
              f"{BF16_FACTOR} x plain error {ep:.3e}")
        check(row["softmax_peak"] > 1.5, f"self-attention layer at T={q.shape[1]}: flat softmax")
        out.append(row)
    return out


def phase_self_serving(fl):
    """Phase 23: serving lsun_bedroom_128 with attention.kind=self, all six
    layers (T up to 16384). Requests of batch 1, 16 and 64 through
    `generate_samples`: 6 flash_fwd launches a forward and no other kernel;
    each layer of the batch-16 request held against the plain composition
    on the q, k, v it computed; the kernel path, the plain path and an f32
    plain generator on the same 4 latents; `bench-sample` at batch 1, 16 and
    64 on the kernel path with peak memory, and on the plain path at batch
    16 (halved while the allocator refuses it) and at batch 64, where one
    f32 score tensor alone is 68.7 GB: that refusal is caught and recorded;
    the idle share and top kernels of a batch-16 request."""
    from locate_tpu_torch.io.sampling import generate_samples
    from locate_tpu_torch.models.gan import model_config
    from locate_tpu_torch.models.generator import build_generator
    from locate_tpu_torch.ops.self_attention import SelfAttention

    cfg = self_config()
    mcfg = model_config(cfg)
    check(mcfg.attention.kind == "self" and mcfg.attention_stages == "all"
          and mcfg.use_pallas and mcfg.attention.heads == 1, "not the self-attention preset")
    model = build_generator(mcfg, "bfloat16", "cuda", seed=0).eval()
    randomize_logit_convs(model, seed=1, scale=0.25)
    stages = len(mcfg.stage_resolutions())
    check(fill_gammas(model) == stages, "a stage has no self-attention layer")
    captured = []
    original = SelfAttention.attend

    def attend(layer, q, k, v):
        o = original(layer, q, k, v)
        if q.shape[0] == FLASH_BATCH:
            captured.append((layer, (q, k, v), o))
        return o

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    requests = (1, FLASH_BATCH, BATCH)
    SelfAttention.attend = attend
    try:
        reset_counters()
        images = [generate_samples(model, gen, b) for b in requests]
        launches = read_counters()
    finally:
        SelfAttention.attend = original
    check(launches == expected({"flash_fwd": stages * len(requests)}),
          f"serving launched {launches} for {len(requests)} forwards of {stages} layers")
    for b, img in zip(requests, images):
        check(img.shape == (b, 128, 128, 3) and str(img.dtype) == "uint8",
              f"request of {b}: images {img.shape} {img.dtype}")
        check(float(img.std()) > 0.0, f"request of {b}: constant images")
    check([tuple(c[1][0].shape[1:]) + (c[1][2].shape[2],) for c in captured]
          == list(FLASH_G_SHAPES.values()), "the layers' (T, dh, dv) are not FLASH_G_SHAPES")
    layers = check_self_attention_layers(fl, captured)
    del captured, images

    plain = build_generator(dataclasses.replace(mcfg, use_pallas=False), "bfloat16", "cuda").eval()
    truth = build_generator(dataclasses.replace(mcfg, use_pallas=False), "float32", "cuda").eval()
    plain.load_state_dict(model.state_dict())
    truth.load_state_dict(model.state_dict())
    gz = torch.Generator(device="cuda")
    gz.manual_seed(3)
    z = torch.randn(4, mcfg.latent_dim, device="cuda", generator=gz)
    with torch.inference_mode():
        yk, yp, yt = (m(z).float() for m in (model, plain, truth))
    torch.cuda.synchronize()
    for name, y in (("kernel", yk), ("plain", yp), ("f32", yt)):
        check(bool(torch.isfinite(y).all()), f"self-attention {name} generator: non-finite")
        check(float(y.abs().max()) <= 1.0, f"self-attention {name} generator: outside [-1, 1]")
    ek, ep = rel_err(yk, yt), rel_err(yp, yt)
    check(ek <= max(BF16_FACTOR * ep, 1e-6),
          f"self-attention generator: kernel path error {ek:.3e} > {BF16_FACTOR} x plain {ep:.3e}")
    idle, top = profile_calls(lambda: generate_samples(model, gen, FLASH_BATCH), top=8)
    del model, plain, truth
    torch.cuda.empty_cache()

    def bench_sample(use_pallas, batch, steps):
        torch.cuda.reset_peak_memory_stats()
        out = run_cli(["bench-sample", "lsun_bedroom_128", "model.attention.kind=self",
                       f"use_pallas={str(use_pallas).lower()}", f"--batch={batch}",
                       f"--steps={steps}"])
        torch.cuda.empty_cache()
        return dict(out, batch=batch, peak_memory_bytes=torch.cuda.max_memory_allocated())

    kernel_path = [bench_sample(True, b, steps) for b, steps in ((1, 10), (FLASH_BATCH, 5),
                                                                 (BATCH, 3))]
    plain_path, refusals = None, []
    for b in (BATCH, FLASH_BATCH, FLASH_BATCH // 2, FLASH_BATCH // 4):
        # the one place a refusal of the allocator is expected: the plain
        # path's (T, T) f32 scores at 128^2
        release_memory()
        try:
            plain_path = bench_sample(False, b, 3)
            break
        except torch.cuda.OutOfMemoryError as e:
            refusals.append(dict(batch=b, refused=str(e).split(". GPU")[0]))
    release_memory()
    check(plain_path is not None, f"the plain path served no batch: {refusals}")
    say("self-serving", config="lsun_bedroom_128, attention.kind=self, all six layers",
        requests=list(requests), launches=launches, attention_layers_batch_16=layers,
        rel_err_kernel_path_vs_f32=ek, rel_err_plain_path_vs_f32=ep,
        max_abs_err_kernel_vs_plain_path=float((yk - yp).abs().max()), image_std=float(yt.std()),
        kernel_path=kernel_path, plain_path=plain_path, plain_path_refused=refusals,
        device_idle_share_batch16=("not measured" if idle is None else idle),
        top_kernels_batch16=top)
    return launches


def release_memory():
    """Drop what a refused call left behind (its frames hold tensors until
    the exception is gone) and hand the cached blocks back."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def self_train_attempt(cfg, batch_size, steps=3):
    """`steps` preset steps from step 0 at `batch_size`, checked: (times,
    memory, metrics and profile; the launches; the GAN's weights). The
    allocator's refusal is the caller's to catch."""
    tcfg = cfg.train
    gan, state, step = trainer(cfg)
    batch = fixed_batch(batch_size)
    before = [t.clone() for t in (state.g_params.flat, state.d_params.flat, state.ema_params)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    state, history, seconds = timed_steps(step, state, batch, steps)
    launches = read_counters()
    peak = torch.cuda.max_memory_allocated()
    history = check_history(history, tcfg)
    moved = check_moved(before, state, history, tcfg)
    idle, top = profile_calls(lambda: step(state, batch), calls=2, top=12)
    out = dict(batch=batch_size, seconds_per_step=seconds,
               images_per_sec_after_step0=batch_size * (steps - 1) / sum(seconds[1:]),
               peak_memory_bytes=peak, metrics=history, max_param_change=moved,
               device_idle_share="not measured" if idle is None else idle,
               top_kernels_2_steps=top,
               params=dict(g=state.g_params.flat.numel(), d=state.d_params.flat.numel()))
    weights = (gan.generator.state_dict(), gan.discriminator.state_dict())
    return out, launches, weights


def halving(run, first):
    """`run(batch)` at `first`, halved while the allocator refuses it:
    (result, batch, the refusals)."""
    refusals, batch = [], first
    while batch >= 1:
        release_memory()
        try:
            return run(batch), batch, refusals
        except torch.cuda.OutOfMemoryError as e:
            refusals.append(dict(batch=batch, refused=str(e).split(". GPU")[0]))
        batch //= 2
    raise SmokeFailure(f"no batch fits: {refusals}")


def phase_self_train():
    """Phase 24: the flash kernels' main path. lsun_bedroom_128 as shipped
    (batch 64, R1 gamma 1 every 16 steps, both guards, EMA) with
    attention.kind=self at the stages 4^2..64^2 (five layers a net), 3 steps
    from step 0 (R1 fires, through the kernel-free twin of D): the checks of
    phase 6, launches per step 25 / 20 / 20 of flash_fwd / flash_dq /
    flash_dkv and no other kernel, sec/step, images/sec, peak memory, idle
    share and top kernels; then the plain path's 3 steps alike. A batch the
    allocator refuses is halved and the refusal recorded."""
    cfg = self_config(**{"model.attention_stages": SELF_TRAIN_STAGES})
    tcfg = cfg.train
    check(tcfg.global_batch == BATCH and tcfg.compute_dtype == "bfloat16"
          and tcfg.r1_gamma == 1.0 and tcfg.r1_interval == 16 and tcfg.r1_remat
          and tcfg.grad_norm_limit == 1e6 and tcfg.max_nonfinite_skips == 200
          and tcfg.ema_decay == 0.999 and not cfg.model.remat,
          "lsun_bedroom_128 is not the shipped recipe")
    check([r for r in cfg.model.stage_resolutions() if cfg.model.attention_at(r)]
          == list(FLASH_TRAIN_RES), "attention stages are not 4..64")
    steps = 3
    (kernel, launches, weights), batch, refusals = halving(
        lambda b: self_train_attempt(cfg, b, steps), BATCH)
    check(launches == expected(FLASH_PER_STEP, steps),
          f"self-attention train steps launched {launches}, want {FLASH_PER_STEP} per step")
    torch.cuda.empty_cache()
    pcfg = self_config(**{"model.attention_stages": SELF_TRAIN_STAGES, "use_pallas": "false"})
    (plain, _, _), plain_batch, plain_refusals = halving(
        lambda b: self_train_attempt(pcfg, b, steps), batch)
    torch.cuda.empty_cache()
    say("self-train", config="lsun_bedroom_128 as shipped, attention.kind=self at 4..64",
        steps=steps, launches=launches,
        launches_per_step={k: v / steps for k, v in launches.items()},
        kernel_path=kernel, kernel_path_refused=refusals,
        plain_path=plain, plain_path_refused=plain_refusals)
    return cfg, weights, launches, batch


@contextlib.contextmanager
def checked_flash_backward(fl, record):
    """Hold every backward of `FlashAttention` run inside the block against
    the plain backward on the very tensors that call saved: in bf16 by the
    rule of phase 4 (against an f32 plain backward from an f32 plain
    forward of the same q, k, v), in f32 to F32_TOL; each output against
    the norm of the sum of its absolute terms. One row per call goes to
    `record`."""
    original = fl.FlashAttention.backward

    def backward(ctx, do):
        q, k, v, o, ell = ctx.saved_tensors  # unpacked once
        scale = ctx.scale
        with torch.no_grad():
            grads = fl.flash_backward(q, k, v, o, ell, do, scale)
            chunk = batch_chunk(q.shape[1], k.shape[1])
            plain = chunked(lambda *a: fl.flash_backward_reference(*a, scale),
                            (q, k, v, o, ell, do), chunk)
            truth = plain
            if q.dtype != torch.float32:
                def f32(q, k, v, do):
                    q, k, v, do = (x.float() for x in (q, k, v, do))
                    return fl.flash_backward_reference(
                        q, k, v, *fl.flash_forward_reference(q, k, v, scale), do, scale)

                truth = chunked(f32, (q, k, v, do), chunk)
            scales = flash_scales(fl, q, k, v, do, scale)[2:]
        shape = dict(B=q.shape[0], T=q.shape[1], dh=q.shape[2], dv=v.shape[2])
        row = dict(shape, dtype=str(q.dtype).replace("torch.", ""))
        for name, kk, pp, tt, sc in zip(FLASH_NAMES[2:], grads, plain, truth, scales):
            hold(name, shape, kk, pp, tt, q.dtype, row, scale=sc)
        record.append(row)
        return (*grads, None)

    fl.FlashAttention.backward = staticmethod(backward)
    try:
        yield
    finally:
        fl.FlashAttention.backward = original


def phase_self_train_grads(fl, cfg, weights, batch):
    """Phase 25: one step's gradients (R1 firing) of the training
    configuration on the kernel path, each of its 20 flash backward calls
    held against the plain backward on its own saved tensors (bf16 rule);
    then at 64^2 with all five layers, f32, batch 16: the kernel path's
    whole gradients within TRAIN_F32_TOL of the plain path's (or ten times
    what 1e-7 weight noise moves the plain path by, if larger), each flash
    backward call within F32_TOL."""
    g = torch.Generator(device="cuda")
    g.manual_seed(8)
    z_d = torch.randn(batch, cfg.model.latent_dim, device="cuda", generator=g)
    z_g = torch.randn(batch, cfg.model.latent_dim, device="cuda", generator=g)
    calls = []
    with checked_flash_backward(fl, calls):
        reset_counters()
        _, _, d_loss, g_loss, r1 = step_grads(cfg, weights, z_d, z_g, 128, True, "bfloat16")
        launches = read_counters()
    want = FLASH_PER_STEP["flash_dq"]
    check(len(calls) == want, f"{len(calls)} flash backward calls in one step, want {want}")
    check(launches == expected({"flash_fwd": FLASH_PER_STEP["flash_fwd"], "flash_dq": want,
                                "flash_dkv": want}), f"one step's gradients launched {launches}")
    check(all(math.isfinite(x) for x in (d_loss, g_loss, r1)) and r1 > 0.0,
          f"self-attention step losses {d_loss}, {g_loss}, r1 {r1}")
    # over the calls whose errors are above the rounding-noise floor
    worst = {name: max([r[f"{name}_rel_err_kernel_vs_f32"] / r[f"{name}_rel_err_plain_vs_f32"]
                        for r in calls if r[f"{name}_rel_err_plain_vs_f32"] > BF16_FLOOR],
                       default=None)
             for name in FLASH_NAMES[2:]}

    cfg64 = self_config(**{"model.resolution": "64", "data.resolution": "64"})
    gan, _, _ = trainer(cfg64)
    w64 = (gan.generator.state_dict(), gan.discriminator.state_dict())
    del gan
    z = [t[:FLASH_BATCH] for t in (z_d, z_g)]  # the whole batch where it is smaller
    calls64 = []
    with checked_flash_backward(fl, calls64):
        k64 = step_grads(cfg64, w64, *z, 64, True, "float32")
    p64 = step_grads(cfg64, w64, *z, 64, False, "float32")
    noisy64 = step_grads(cfg64, w64, *z, 64, False, "float32", perturb=1e-7)
    check(len(calls64) == want, f"{len(calls64)} flash backward calls at 64^2, want {want}")
    rows = {}
    for i, net in enumerate(("D", "G")):
        e, moved = rel_err(k64[i], p64[i]), rel_err(noisy64[i], p64[i])
        limit = max(TRAIN_F32_TOL, 10.0 * moved)
        rows[net] = dict(rel_err_kernel_vs_plain_f32_at_64=e,
                         rel_change_f32_at_64_at_1e7_weight_noise=moved)
        check(e <= limit, f"{net} gradient at 64^2 f32, self-attention: {e:.3e} > {limit:.3e}")
    say("self-train-grads", batch=batch, r1_fired=True, d_loss=d_loss, g_loss=g_loss, r1=r1,
        flash_backward_calls_checked={"bf16_128": len(calls), "f32_64": len(calls64)},
        worst_kernel_over_plain_error_ratio_bf16=worst,
        worst_flash_backward_rel_err_f32=max(v for r in calls64 for k, v in r.items()
                                             if k.endswith("rel_err_kernel_vs_plain")),
        gradients_f32_at_64=rows, losses_at_64=dict(kernel=k64[2:], plain=p64[2:]),
        calls_bf16=calls)


def flash_entry(kernel, rows, train_rows, launches, serve_launches):
    """The {"kernels": [...]} entry of a flash kernel: per self-attention
    train step at batch 64, each shape's time times its launches a step
    (timed at batch 64 in phase 22's second half)."""
    mult = FLASH_FWD_PER_STEP if kernel == "flash_fwd" else FLASH_BWD_PER_STEP
    names = {"flash_fwd": ("o", "ell"), "flash_dq": ("dq",), "flash_dkv": ("dk", "dv")}[kernel]

    def total(key):
        vals = [r[kernel][key] for r in train_rows]
        if any(v is None for v in vals):
            return None
        return sum(mult[(r["shape"]["T"], r["shape"]["dh"], r["shape"]["dv"])] * v
                   for r, v in zip(train_rows, vals))

    by_ops = sum(mult[(r["shape"]["T"], r["shape"]["dh"], r["shape"]["dv"])]
                 * r[kernel]["bound_ms"] for r in train_rows
                 if r[kernel]["bound_by"] == "operations")
    entry = {
        "name": kernel,
        "route": "cuda",
        "source": FLASH_SOURCE,
        "replaces": REPLACES[kernel],
        "launches": launches[kernel],  # the self-attention configuration's three train steps
        "max_abs_err": max(r[f"{n}_max_abs_err"] for r in rows for n in names),
        "ms": total("ms"),
        "plain_ms": total("plain_ms"),
        "bound_ms": total("bound_ms"),
        "bound_by": "operations" if by_ops >= total("bound_ms") / 2 else "bytes",
        "library_ms": total("library_ms"),
        "shapes": [dict(r["shape"], dtype=r["dtype"],
                        **{k: r[kernel][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                     "library_ms")})
                   for r in rows + train_rows if kernel in r],
    }
    if kernel == "flash_fwd":
        entry["launches_serving"] = serve_launches[kernel]
    else:
        entry["library_covers"] = train_rows[0][kernel]["library_covers"]
    return entry


def sigmoid_entry(kernel, rows, launches, serve_launches):
    """The {"kernels": [...]} entry of a sigmoid gate kernel: per
    ffhq_512-sigmoid train step at batch 16, each shape's time times its
    launches a step."""
    mult = SIGMOID_FWD_PER_STEP if kernel == "sigmoid_gate" else SIGMOID_BWD_PER_STEP
    names = ("y",) if kernel == "sigmoid_gate" else GRAD_NAMES[1:]
    timed_rows = [r for r in rows if kernel in r]
    entry = {
        "name": kernel,
        "route": "cuda",
        "source": SOURCE,
        "replaces": REPLACES[kernel],
        "launches": launches[kernel],  # ffhq_512-sigmoid's three train steps
        "max_abs_err": max(r[f"{n}_max_abs_err"] for r in timed_rows for n in names),
        "ms": per_step(timed_rows, kernel, mult, "ms"),
        "plain_ms": per_step(timed_rows, kernel, mult, "plain_ms"),
        "bound_ms": per_step(timed_rows, kernel, mult, "bound_ms"),
        "bound_by": ("bytes" if all(r[kernel]["bound_by"] == "bytes" for r in timed_rows
                                    if r["dtype"] == "bfloat16") else "operations"),
        "library_ms": None,
        "shapes": [dict(N=r["shape"]["N"], HW=r["shape"]["HW"], C=r["shape"]["C"],
                        dtype=r["dtype"], launches_per_step=mult[(
                            r["shape"]["HW"], r["shape"]["C"], r["shape"]["Hd"])],
                        **{k: r[kernel][k] for k in ("ms", "plain_ms", "bound_ms")})
                   for r in timed_rows],
    }
    if kernel == "sigmoid_gate":
        entry["launches_serving"] = serve_launches[kernel]
        entry["ms_per_served_forward"] = per_step(timed_rows, kernel, SIGMOID_SERVE, "ms")
    return entry


def stage_entry(kernel, times, max_err, launches, forms=None):
    """The {"kernels": [...]} entry of a fused-stage kernel: per ffhq_512
    train step at batch 16, each form's time times its launches a step."""
    forms = forms or FFHQ_STAGE_PER_STEP[kernel]

    def total(key):
        return sum(times[(kernel, f)][key] * k for f, k in forms.items())

    by_ops = sum(times[(kernel, f)]["bound_ms"] * k for f, k in forms.items()
                 if times[(kernel, f)]["bound_by"] == "operations")
    return {
        "name": kernel,
        "route": "cuda",
        "source": STAGE_SOURCE,
        "replaces": REPLACES[kernel],
        "launches": launches[kernel],  # ffhq_512's three train steps
        "max_abs_err": max_err[kernel],
        "ms": total("ms"),
        "plain_ms": total("plain_ms"),
        "bound_ms": total("bound_ms"),
        "bound_by": "operations" if by_ops >= total("bound_ms") / 2 else "bytes",
        "library_ms": None,
        "forms": [dict(form=f, launches_per_step=k,
                       **{key: times[(kernel, f)][key]
                          for key in ("ms", "plain_ms", "bound_ms", "bound_by")})
                  for f, k in forms.items()],
    }


def per_step(rows, kind, mult, key):
    return sum(mult[(r["shape"]["HW"], r["shape"]["C"], r["shape"]["Hd"])] * r[kind][key]
               for r in rows if r["dtype"] == "bfloat16")


def phase_build(fa, fs, fl, build):
    """Phase 2: the three libraries, one nvcc each, started together."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    names = ("fused_attention", "fused_stage", "flash_attention")
    with ThreadPoolExecutor(len(names)) as pool:
        libs = dict(zip(names, pool.map(build.build, names)))
    reports = {name: parse_ptxas(build.ptxas_report(name)) for name in names}
    for name, wanted in (("fused_attention", CUDA_KERNELS), ("fused_stage", STAGE_CUDA_KERNELS),
                         ("flash_attention", FLASH_KERNELS)):
        for k in wanted:
            check(any(n.startswith(k) for n in reports[name]), f"ptxas reported no {k}")
    smem = {f"C={c},Hd={hd}": dict(
        forward=int(fa._library().locate_softmax_smem_bytes(c, hd, c, fa.tile_rows(c))),
        backward=int(fa._library().locate_softmax_bwd_smem_bytes(
            c, hd, c, fa.bwd_grid(BATCH, hw, c)[0])))
        for hw, c, hd in SHAPES}
    stage_lib = fs._library()
    stage_smem = {}
    for kind, k in (("conv", fs._CONV), ("stats", fs._STATS), ("apply_pool", fs._APPLY_POOL),
                    ("bwd", fs._BWD), ("sigmoid", fs._SIGMOID)):
        th, tw = fs.pick_tile(k, 512, 512, 64, 64, 16, 64, lib=stage_lib)
        stage_smem[kind] = dict(tile=f"{th}x{tw}", bytes=int(
            stage_lib.locate_stage_smem_bytes(k, 64, 64, 16, 64, th, tw)))
    flash_lib = fl._library()
    flash_smem = {}
    for t, dh, dv in FLASH_SHAPES:
        tiles = {k: fl.pick_tile(kind, FLASH_BATCH, t, dh, dv, flash_lib)
                 for k, kind in zip(FLASH_KERNELS, (fl._FWD, fl._DQ, fl._DKV))}
        flash_smem[f"T={t},dh={dh},dv={dv}"] = {
            k: dict(q_tile=bq, bytes=int(flash_lib.locate_flash_smem_bytes(kind, dh, dv, bq)))
            for (k, bq), kind in zip(tiles.items(), (fl._FWD, fl._DQ, fl._DKV))}
    say("build", libraries={n: os.path.relpath(str(p), REPO) for n, p in libs.items()},
        seconds=time.perf_counter() - t0, kernels=reports, dynamic_smem_bytes=smem,
        flash_dynamic_smem_at_batch_16=flash_smem,
        stage_dynamic_smem_at_512x512x64=stage_smem,
        stage_conv_bwd_blocks=fs.bwd_blocks(FFHQ_BATCH, 512, 512, *fs.pick_tile(
            fs._BWD, 512, 512, 64, 64, lib=stage_lib)))


def gate_entry(kernel, fwd_rows, bwd_rows, train_launches, serve_launches, ffhq_launches):
    rows = fwd_rows if kernel in ("softmax_stats", "softmax_apply") else bwd_rows
    mult = FWD_PER_STEP if rows is fwd_rows else BWD_PER_STEP
    names = {"softmax_stats": ("m", "se"), "softmax_apply": ("y",),
             "softmax_csum": ("c",)}.get(kernel, GRAD_NAMES[1:])
    lsun = [r for r in rows if r["shape"]["N"] == BATCH]
    entry = {
        "name": kernel,
        "route": "cuda",
        "source": SOURCE,
        "replaces": REPLACES[kernel],
        # launches of the main path's run (3 lsun_bedroom_128 train steps)
        "launches": train_launches[kernel],
        "max_abs_err": max(r[f"{n}_max_abs_err"] for r in rows for n in names),
        # per lsun_bedroom_128 train step at batch 64: each shape's time
        # times its launches
        "ms": per_step(lsun, kernel, mult, "ms"),
        "plain_ms": per_step(lsun, kernel, mult, "plain_ms"),
        "bound_ms": per_step(lsun, kernel, mult, "bound_ms"),
        "bound_by": ("bytes" if all(r[kernel]["bound_by"] == "bytes" for r in lsun)
                     else "operations"),
        "library_ms": None,
        "launches_ffhq_512_train": ffhq_launches[kernel],
        "shapes": [dict(N=r["shape"]["N"], HW=r["shape"]["HW"], C=r["shape"]["C"],
                        dtype=r["dtype"],
                        **{k: r[kernel][k] for k in ("ms", "plain_ms", "bound_ms")})
                   for r in rows],
    }
    if rows is fwd_rows:
        entry["launches_serving"] = serve_launches[kernel]
        entry["ms_per_served_forward"] = per_step(lsun, kernel, SERVE, "ms")
    return entry


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from locate_tpu_torch.config import get_config
    from locate_tpu_torch.nn import blocks
    from locate_tpu_torch.ops import flash_attention as fl
    from locate_tpu_torch.ops import fused_attention as fa
    from locate_tpu_torch.ops import fused_stage as fs
    from locate_tpu_torch.ops.cuda import build

    t_start = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    say("card", torch_name=kind, nvidia_smi=smi, count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)
    phase_build(fa, fs, fl, build)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    # the gate kernels at lsun_bedroom_128's shapes, then at ffhq_512's new ones
    fwd_rows = phase_forward(fa, cases(), BATCH)
    fwd_rows += phase_forward(fa, ffhq_gate_cases(), FFHQ_BATCH, "ffhq-gate-forward")
    bwd_rows = phase_backward(fa, cases(), BATCH)
    bwd_rows += phase_backward(fa, ffhq_gate_cases(), FFHQ_BATCH, "ffhq-gate-backward")

    # lsun_bedroom_128: serving and training (no stage fuses at 128^2)
    cfg = get_config("lsun_bedroom_128", {"use_pallas": "true"})
    serve_launches = phase_generator(fa, cfg)
    phase_serving(cfg)
    train_cfg, weights, train_launches = phase_train(fa)
    phase_train_grads(fa, train_cfg, weights)
    del weights
    phase_train_throughput()

    # ffhq_512: the fused-stage kernels, serving, training (their main path)
    stage_rows, stage_times, stage_err = phase_stage_kernels(fs, fa)
    phase_ffhq_serving()
    ffhq_cfg, ffhq_weights, ffhq_launches = phase_ffhq_train()
    phase_ffhq_checked_backward(fs, fa, ffhq_cfg, ffhq_weights)
    del ffhq_weights
    phase_ffhq_grads_64(fs, fa, blocks)
    phase_fusion_timing(blocks)

    # ffhq_512 with the sigmoid gate: its three kernels, serving, training
    sigmoid_rows = phase_sigmoid_gate(fa)
    _, sig_stage_times, sig_stage_err = phase_stage_kernels(
        fs, fa, SIGMOID_STAGE_CASES, "sigmoid-stage-kernels-vs-plain")
    sig_serve = phase_ffhq_serving(SIGMOID, SIGMOID_SERVE_PER_FORWARD, "ffhq-sigmoid-serving")
    sig_cfg, sig_weights, sig_launches = phase_ffhq_train(SIGMOID, SIGMOID_PER_STEP,
                                                          "ffhq-sigmoid-train")
    phase_ffhq_checked_backward(fs, fa, sig_cfg, sig_weights,
                                "ffhq-sigmoid-checked-stage-backward")
    del sig_weights
    phase_ffhq_grads_64(fs, fa, blocks, SIGMOID,
                        ("stage_sigmoid", "stage_conv", "stage_conv_bwd", "sigmoid_bwd"),
                        "ffhq-sigmoid-train-grads-64")
    phase_sigmoid_threshold()

    # lsun_bedroom_128 with full self-attention: the three flash kernels,
    # serving (all six layers), training (five layers a net, their main path)
    flash_rows, flash_train_rows = phase_flash_kernels(fl)
    self_serve = phase_self_serving(fl)
    self_cfg, self_weights, self_launches, self_batch = phase_self_train()
    phase_self_train_grads(fl, self_cfg, self_weights, self_batch)
    del self_weights

    out = [gate_entry(k, fwd_rows, bwd_rows, train_launches, serve_launches, ffhq_launches)
           for k in KERNELS]
    out += [stage_entry(k, stage_times, stage_err, ffhq_launches) for k in STAGE_KERNELS]
    out += [sigmoid_entry(k, sigmoid_rows, sig_launches, sig_serve) for k in SIGMOID_KERNELS]
    out.append(stage_entry("stage_sigmoid", sig_stage_times, sig_stage_err, sig_launches,
                           SIGMOID_STAGE_PER_STEP["stage_sigmoid"]))
    out += [flash_entry(k, flash_rows, flash_train_rows, self_launches, self_serve)
            for k in FLASH_KERNELS]
    for entry in out:
        entry["launches_ffhq_512_sigmoid_train"] = sig_launches[entry["name"]]
        entry["launches_self_attention_train"] = self_launches[entry["name"]]
        check(entry["launches"] > 0, f"{entry['name']} never launched on its main path")
    check(len(out) == 14, f"{len(out)} kernels listed")
    print(json.dumps({"kernels": out}), flush=True)
    say("done", seconds=time.perf_counter() - t_start)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
