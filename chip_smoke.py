#!/usr/bin/env python3
"""Smoke test of the PyTorch port of locate-tpu on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's two paths at the full width of lsun_bedroom_128
(use_pallas=true, bf16 compute, f32 params): serving (the generator) and
training (the alternating GAN train step, the main path), and holds every
CUDA kernel against its plain PyTorch version. Phases, one line each:

  1. the card: torch's name for it, and `name, power.limit` from nvidia-smi;
  2. build: compiles csrc/fused_attention.cu with `-Xptxas -v`, prints each
     kernel's registers, shared memory and spills, and the dynamic shared
     memory of the forward and backward blocks at every (C, Hd) of the path;
  3. forward kernels (stats, apply) against the plain version at the nine
     distinct gate shapes of G and D, batch 64, bf16, with gate weights
     that make the gate vary and pass the clamp at 16, plus one f32 shape
     with TF32 off. Rule in bf16: the kernel's norm-relative error against
     an f32 plain computation of the same inputs is at most twice the bf16
     plain version's. Rule in f32: norm-relative error against the plain
     version at most 1e-4;
  4. backward kernels (csum, backward) against the plain backward at the
     same shapes under the same rules, for c, dx, dpos_proj, dW1x, db1, dW2
     and db2. These are sums that cancel (db2 exactly: sum_s dl = c - c),
     so each error is taken against the norm of the sum of its terms'
     absolute values, the scale rounding error grows with; the same inputs
     run twice give bitwise-equal gradients;
  5. serving: seeded random weights with non-zero logit convs serve
     requests of batch 1, 16 and 64 through `generate_samples`; the forward
     launch counters read 6 per forward; each attention layer of the
     batch-64 request is held against the plain version on the activations
     it received; the kernel path, the plain path and an f32 plain
     generator run the same latents (kernel error <= 2x plain error);
     `bench-sample`'s images/sec at batch 64 for both paths, peak memory,
     idle share;
  6. training (the main path): the shipped preset (R1 gamma 1 every 16
     steps, the grad-norm and non-finite guards, EMA 0.999), batch 64,
     seeded weights, 3 steps from step 0 through `make_train_step`: losses,
     norms and r1 finite, G, D and EMA moved, the guard counters as the
     norms imply, launch counters 30 / 30 / 24 / 24 per step. Then one
     step's gradients from one state and batch with the same latents on
     the kernel path, the plain path and an f32 plain path: the kernel
     path's error against f32 is at most twice the plain path's, for D and
     for G. With random weights the 128^2 model's gradient is
     ill-conditioned (the f32 plain path's own gradient moves by percents
     when the weights move by 1e-7, printed), so two more checks carry the
     weight: each of the step's 24 gate backward calls is held against the
     plain backward on its own saved tensors (the bf16 rule), and at 64^2
     (one stage fewer, same widths) the f32 kernel path's gradients are
     within 1e-3 of the f32 plain path's (or ten times the plain path's own
     change under 1e-7 weight noise, if larger), each call within 1e-4;
  7. training throughput: `bench 128 20` and `bench 128 20 xla`
     (images/sec, flops per step, MFU), peak memory of a batch-128 step with
     R1 firing (r1_remat on and off), and over 3 steps of each path the
     device's idle share and its kernels by time;
  8. each kernel's time at each shape (CUDA graphs of back-to-back launches
     timed with CUDA events) beside its bound, share of the bound and the
     plain version's time;
  9. one JSON line `{"kernels": [...]}`;
 10. the card's name and power limit again, then the last line
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
            "softmax_bwd": "locate_tpu/ops/pallas/fused_attention.py:397"}
# the CUDA kernels of csrc/fused_attention.cu, as ptxas and the profiler name them
CUDA_KERNELS = ("softmax_stats_partial", "softmax_stats_merge", "softmax_apply",
                "softmax_csum_partial", "softmax_bwd", "reduce_partials")


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
    """The readable name of a compiled kernel: its CUDA_KERNELS name with
    <bf16> or <f32> for the templates, else the mangled name itself."""
    base = next((k for k in CUDA_KERNELS if k in mangled), mangled)
    if "nv_bfloat16" in mangled:
        return base + "<bf16>"
    if "IfE" in mangled:
        return base + "<f32>"
    return base


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
        name = next((k for k in CUDA_KERNELS if k in ev.key), None)
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
    the backward pass three times that (the forward, dh and dx, dW1x and
    dW2)."""
    es = torch.finfo(dtype).bits // 8
    weights = (c * hd + hd * cout) * es + (hw * hd + hd + cout) * 4
    xbytes = n * hw * c * es
    stats = 2 * n * cout * 4
    mlp = 2.0 * n * hw * (c * hd + hd * cout)
    if kind == "softmax_stats":
        nbytes, flops = xbytes + weights + stats, mlp
    elif kind == "softmax_apply":
        nbytes, flops = 2 * xbytes + weights + stats, mlp
    elif kind == "softmax_csum":
        nbytes, flops = 2 * xbytes + weights + stats + n * cout * 4, mlp
    else:  # softmax_bwd: reads x, dy, stats, c; writes dx and f32 gradients
        grads = (c * hd + hd * cout + hd + cout + hw * hd) * 4
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


def phase_forward(fa):
    """Phase 3 and the forward half of phase 8."""
    rows = []
    for i, (hw, c, hd, dtype) in enumerate(cases()):
        ops, _ = gate_inputs(BATCH, hw, c, hd, dtype, seed=100 + i)
        shape = dict(N=BATCH, HW=hw, C=c, Hd=hd, Cout=c)
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
                lambda: fa.softmax_gate_stats_reference(*kops, **KW), BATCH, hw, c, hd, dtype)
            row["softmax_apply"] = timed(
                "softmax_apply", lambda: fa.softmax_gate_apply(*kops, m, se, **apply_kw),
                lambda: fa.softmax_gate_apply_reference(*kops, m, se, **apply_kw),
                BATCH, hw, c, hd, dtype)
            row["profiler_us_per_call"] = kernel_split(lambda: fa.softmax_gate_apply(
                *kops, *fa.softmax_gate_stats(*kops, **KW), **apply_kw))
        say("forward-kernels-vs-plain", **row)
        rows.append(row)
        del ops, kops, m, se
        torch.cuda.empty_cache()
    return rows


def phase_backward(fa):
    """Phase 4 and the backward half of phase 8."""
    rows = []
    for i, (hw, c, hd, dtype) in enumerate(cases()):
        ops, dy = gate_inputs(BATCH, hw, c, hd, dtype, seed=200 + i)
        shape = dict(N=BATCH, HW=hw, C=c, Hd=hd, Cout=c)
        with torch.no_grad():
            kern = run_backward(fa, ops, dy, hw, plain=False)
            again = run_backward(fa, ops, dy, hw, plain=False)
            plain = run_backward(fa, ops, dy, hw, plain=True)
            truth = run_backward(fa, [ops[0].float()] + ops[1:], dy.float(), hw, plain=True)
            torch.cuda.synchronize()
        row = dict(shape=shape, dtype=str(dtype).replace("torch.", ""),
                   bwd_grid=dict(zip(("tile_rows", "batch_rows_per_block"),
                                     fa.bwd_grid(BATCH, hw, c))))
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
                BATCH, hw, c, hd, dtype)
            row["softmax_bwd"] = timed(
                "softmax_bwd", lambda: fa.softmax_gate_backward(kops[0], dy, *kops[1:], m, se,
                                                                cs, **opts),
                lambda: fa.softmax_gate_backward_reference(kops[0], dy, *kops[1:], m, se, cs,
                                                           **opts),
                BATCH, hw, c, hd, dtype)
            row["profiler_us_per_call"] = kernel_split(lambda: fa.softmax_gate_backward(
                kops[0], dy, *kops[1:], m, se,
                fa.softmax_gate_csum(kops[0], dy, *kops[1:], m, se, **opts), **opts))
        say("backward-kernels-vs-plain", **row)
        rows.append(row)
        del ops, dy, kops, m, se, cs
        torch.cuda.empty_cache()
    return rows


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


def reset_counters(fa):
    for name in ("softmax_gate_stats", "softmax_gate_apply", "softmax_gate_csum",
                 "softmax_gate_backward"):
        getattr(fa, name).launches = 0


def read_counters(fa) -> dict:
    return {"softmax_stats": fa.softmax_gate_stats.launches,
            "softmax_apply": fa.softmax_gate_apply.launches,
            "softmax_csum": fa.softmax_gate_csum.launches,
            "softmax_bwd": fa.softmax_gate_backward.launches}


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
    reset_counters(fa)
    images = [generate_samples(model, gen, b) for b in requests]
    launches = read_counters(fa)
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
    check(launches == {"softmax_stats": want, "softmax_apply": want, "softmax_csum": 0,
                       "softmax_bwd": 0},
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
    """A seeded GAN with non-zero logit convs, its fresh state and step."""
    from locate_tpu_torch.models.gan import build_gan
    from locate_tpu_torch.train.state import create_train_state
    from locate_tpu_torch.train.step import make_train_step

    gan = build_gan(cfg, "cuda", seed=seed)
    for net in (gan.generator, gan.discriminator):
        randomize_logit_convs(net, seed=seed + 1, scale=0.25)
    return gan, create_train_state(cfg, gan, seed=seed + 2), make_train_step(cfg, gan)


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
    reset_counters(fa)
    t0 = time.perf_counter()
    history = []
    for _ in range(steps):
        state, metrics = step(state, batch)
        history.append(metrics)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counters(fa)
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
    moved = {name: float((after - b).abs().max()) for name, b, after in zip(
        ("g", "d", "ema"), before,
        (state.g_params.flat, state.d_params.flat, state.ema_params))}
    for name, delta in moved.items():
        check(delta > 0.0, f"{name} params did not move")
    per_step = {"softmax_stats": 30, "softmax_apply": 30, "softmax_csum": 24,
                "softmax_bwd": 24}
    check(launches == {k: v * steps for k, v in per_step.items()},
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
    real, labels, zd, ld, zg, lg = step.prepare(state, fixed_batch(BATCH, res), z_d=z_d,
                                                z_g=z_g)
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


def per_step(rows, kind, mult, key):
    return sum(mult[(r["shape"]["HW"], r["shape"]["C"], r["shape"]["Hd"])] * r[kind][key]
               for r in rows if r["dtype"] == "bfloat16")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from locate_tpu_torch.config import get_config
    from locate_tpu_torch.ops import fused_attention as fa
    from locate_tpu_torch.ops.cuda import build

    t_start = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    say("card", torch_name=kind, nvidia_smi=smi, count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    lib = build.build("fused_attention")
    kernels = parse_ptxas(build.ptxas_report("fused_attention"))
    for k in CUDA_KERNELS:
        check(any(name.startswith(k) for name in kernels), f"ptxas reported no {k}")
    smem = {f"C={c},Hd={hd}": dict(
        forward=int(fa._library().locate_softmax_smem_bytes(c, hd, c, fa.tile_rows(c))),
        backward=int(fa._library().locate_softmax_bwd_smem_bytes(
            c, hd, c, fa.bwd_grid(BATCH, hw, c)[0])))
        for hw, c, hd in SHAPES}
    say("build", library=os.path.relpath(str(lib), REPO), seconds=time.perf_counter() - t0,
        kernels=kernels, dynamic_smem_bytes=smem)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    fwd_rows = phase_forward(fa)
    bwd_rows = phase_backward(fa)

    cfg = get_config("lsun_bedroom_128", {"use_pallas": "true"})
    serve_launches = phase_generator(fa, cfg)
    phase_serving(cfg)

    train_cfg, weights, train_launches = phase_train(fa)
    phase_train_grads(fa, train_cfg, weights)
    del weights
    phase_train_throughput()

    out = []
    for kernel in KERNELS:
        rows = fwd_rows if kernel in ("softmax_stats", "softmax_apply") else bwd_rows
        mult = FWD_PER_STEP if rows is fwd_rows else BWD_PER_STEP
        names = {"softmax_stats": ("m", "se"), "softmax_apply": ("y",),
                 "softmax_csum": ("c",)}.get(kernel, GRAD_NAMES[1:])
        entry = {
            "name": kernel,
            "route": "cuda",
            "source": SOURCE,
            "replaces": REPLACES[kernel],
            # launches of the main path's run (3 train steps)
            "launches": train_launches[kernel],
            "max_abs_err": max(r[f"{n}_max_abs_err"] for r in rows for n in names),
            # per train step at batch 64: each shape's time times its launches
            "ms": per_step(rows, kernel, mult, "ms"),
            "plain_ms": per_step(rows, kernel, mult, "plain_ms"),
            "bound_ms": per_step(rows, kernel, mult, "bound_ms"),
            "bound_by": ("bytes" if all(r[kernel]["bound_by"] == "bytes" for r in rows)
                         else "operations"),
            "library_ms": None,
            "shapes": [dict(HW=r["shape"]["HW"], C=r["shape"]["C"], dtype=r["dtype"],
                            **{k: r[kernel][k] for k in ("ms", "plain_ms", "bound_ms")})
                       for r in rows],
        }
        if rows is fwd_rows:
            entry["launches_serving"] = serve_launches[kernel]
            entry["ms_per_served_forward"] = per_step(rows, kernel, SERVE, "ms")
        out.append(entry)
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
