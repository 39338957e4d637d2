#!/usr/bin/env python3
"""Smoke test of the PyTorch port of locate-tpu on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's serving path (the lsun_bedroom_128 generator at full
width, use_pallas=true, bf16 compute, f32 params) and holds its CUDA
kernels against their plain PyTorch versions. Phases, one line each:

  1. the card: torch's name for it, and `name, power.limit` from nvidia-smi;
  2. build: compiles csrc/fused_attention.cu with `-Xptxas -v`, prints each
     kernel's registers, shared memory and spills;
  3. kernels against the plain version at the six generator-stage shapes,
     batch 64, bf16, with gate weights that make the gate vary and pass the
     clamp at 16, plus one f32 shape with TF32 off. Rule in bf16: the
     kernel's norm-relative error against an f32 plain computation of the
     same inputs is at most twice the bf16 plain version's. Rule in f32:
     norm-relative error against the plain version at most 1e-4;
  4. the generator: seeded random weights with non-zero logit convs serve
     requests of batch 1, 16 and 64 through `generate_samples`; every
     kernel launch counter reads 6 per forward; each attention layer of the
     batch-64 request is held against the plain version on the activations
     it received (the bf16 rule above); the kernel path, the plain
     (composed, use_pallas=false) path and an f32 plain generator then run
     the same latents, and the kernel path's error against f32 is at most
     twice the plain path's; images are finite and in [-1, 1];
  5. serving: `bench-sample`'s images/sec at batch 64, kernel path and
     plain path, peak memory, the device's idle share, and each kernel's
     time at each shape (CUDA graphs of back-to-back launches timed with
     CUDA events) beside its bound, its share of the bound and the plain
     version's time;
  6. one JSON line `{"kernels": [...]}`;
  7. the card's name and power limit again, then the last line
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
# (HW, C, Hd) of the six lsun_bedroom_128 generator stages; Cout = C
MAIN_SHAPES = [(16, 512, 128), (64, 256, 64), (256, 128, 32),
               (1024, 64, 16), (4096, 64, 16), (16384, 64, 16)]
F32_SHAPE = (1024, 64, 16)
F32_TOL = 1e-4
BF16_FACTOR = 2.0
SOURCE = "locate_tpu_torch/csrc/fused_attention.cu"
REPLACES = {"softmax_stats": "locate_tpu/ops/pallas/fused_attention.py:152",
            "softmax_apply": "locate_tpu/ops/pallas/fused_attention.py:179"}


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + json.dumps(fields), flush=True)


def rel_err(got: torch.Tensor, truth: torch.Tensor) -> float:
    got, truth = got.double(), truth.double()
    return float((got - truth).norm() / truth.norm().clamp_min(1e-12))


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


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
        name = re.search(r"softmax_(stats_partial|stats_merge|apply)", ev.key)
        if name:
            total = getattr(ev, "device_time_total", None)
            if total is None:
                total = ev.cuda_time_total
            out[name.group(0)] = total / calls
    return out


def gate_inputs(n, hw, c, hd, dtype, seed):
    """Gate operands whose weights make the gate vary and pass 16 where
    HW > 16: x (N, HW, C) in `dtype`, the rest f32 as the layer holds them."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    dev = dict(device="cuda", generator=g)
    x = torch.randn(n, hw, c, **dev).to(dtype)
    pp = torch.randn(hw, hd, **dev) * 0.5
    w1 = torch.randn(c, hd, **dev) / math.sqrt(c)
    b1 = torch.randn(hd, **dev) * 0.1
    w2 = torch.randn(hd, c, **dev) * 3.0 / math.sqrt(hd)
    b2 = torch.randn(c, **dev) * 0.1
    return [x, pp, w1, b1, w2, b2]


def bound(kind: str, n, hw, c, hd, cout, dtype):
    """(bound_ms, bound_by): the larger of the bytes the function must move
    (each input read once, each output written once) over the memory rate
    and its multiply-adds over the peak rate for the operands' type."""
    es = torch.finfo(dtype).bits // 8
    weights = (c * hd + hd * cout) * es + (hw * hd + hd + cout) * 4
    xbytes = n * hw * c * es
    stats = 2 * n * cout * 4
    nbytes = xbytes + weights + (stats if kind == "softmax_stats" else stats + xbytes)
    flops = 2.0 * n * hw * (c * hd + hd * cout)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def run_gate(fa, ops, hw, plain: bool):
    kw = dict(act="leaky_relu", leaky_slope=0.2)
    if plain:
        m, se = fa.softmax_gate_stats_reference(*ops, **kw)
        y = fa.softmax_gate_apply_reference(*ops, m, se, hw_scale=float(hw),
                                            gate_max=16.0, **kw)
    else:
        m, se = fa.softmax_gate_stats(*ops, **kw)
        y = fa.softmax_gate_apply(*ops, m, se, hw_scale=float(hw), gate_max=16.0, **kw)
    return m, se, y


def phase_kernels(fa):
    """Phase 3 (correctness) and the per-shape half of phase 5 (timing)."""
    rows = []
    cases = [(hw, c, hd, torch.bfloat16) for hw, c, hd in MAIN_SHAPES]
    cases.append((*F32_SHAPE, torch.float32))
    for i, (hw, c, hd, dtype) in enumerate(cases):
        ops = gate_inputs(BATCH, hw, c, hd, dtype, seed=100 + i)
        with torch.inference_mode():
            kern = run_gate(fa, ops, hw, plain=False)
            plain = run_gate(fa, ops, hw, plain=True)
            truth = run_gate(fa, [ops[0].float()] + ops[1:], hw, plain=True)
            torch.cuda.synchronize()
            l = fa.gate_logits_reference(ops[0].float(), *ops[1:], act="leaky_relu",
                                         leaky_slope=0.2)
            gate = torch.exp(l - truth[0]) / truth[1] * hw
            clamped = float((gate > 16.0).float().mean())
            gate_std = float(gate.std())
            del l, gate
        row = dict(shape=dict(N=BATCH, HW=hw, C=c, Hd=hd, Cout=c),
                   dtype=str(dtype).replace("torch.", ""),
                   gate_std=round(gate_std, 3), clamped_share=clamped)
        for name, k, p, t in zip(("m", "se", "y"), kern, plain, truth):
            check(bool(torch.isfinite(k).all()), f"{name} not finite at {row['shape']}")
            row[f"{name}_max_abs_err"] = float((k.float() - p.float()).abs().max())
            if dtype == torch.bfloat16:
                ek, ep = rel_err(k, t), rel_err(p, t)
                row[f"{name}_rel_err_kernel_vs_f32"] = ek
                row[f"{name}_rel_err_plain_vs_f32"] = ep
                check(ek <= max(BF16_FACTOR * ep, 1e-6),
                      f"{name} at {row['shape']}: kernel error {ek:.3e} > "
                      f"{BF16_FACTOR} x plain bf16 error {ep:.3e}")
            else:
                e = rel_err(k, p)
                row[f"{name}_rel_err_kernel_vs_plain"] = e
                check(e <= F32_TOL, f"{name} at {row['shape']} f32: {e:.3e} > {F32_TOL}")
        check(gate_std > 0.5, f"gate barely varies at {row['shape']}")
        if hw > 16:
            check(clamped > 0.0, f"gate never reaches the clamp at {row['shape']}")
        del kern, plain, truth

        # timing: operands pre-cast as the kernel takes them
        kops = [ops[0], ops[1], ops[2].to(dtype), ops[3], ops[4].to(dtype), ops[5]]
        kw = dict(act="leaky_relu", leaky_slope=0.2)
        with torch.inference_mode():
            m, se = fa.softmax_gate_stats(*kops, **kw)
            t = {
                "softmax_stats": (
                    graph_ms(lambda: fa.softmax_gate_stats(*kops, **kw)),
                    graph_ms(lambda: fa.softmax_gate_stats_reference(*kops, **kw))),
                "softmax_apply": (
                    graph_ms(lambda: fa.softmax_gate_apply(
                        *kops, m, se, hw_scale=float(hw), gate_max=16.0, **kw)),
                    graph_ms(lambda: fa.softmax_gate_apply_reference(
                        *kops, m, se, hw_scale=float(hw), gate_max=16.0, **kw))),
            }
            split = kernel_split(lambda: fa.softmax_gate_apply(
                *kops, *fa.softmax_gate_stats(*kops, **kw), hw_scale=float(hw),
                gate_max=16.0, **kw))
        for kind, (ms, plain_ms) in t.items():
            b_ms, b_by = bound(kind, BATCH, hw, c, hd, c, dtype)
            row[kind] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                             share_of_bound=b_ms / ms)
        row["profiler_us_per_call"] = split
        say("kernel-vs-plain", **row)
        rows.append(row)
        del ops, kops, m, se
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

    # the main path: serving requests through the user-facing entry point
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    requests = (1, 16, BATCH)
    fa.softmax_gate_stats.launches = 0
    fa.softmax_gate_apply.launches = 0
    images = [generate_samples(model, gen, b) for b in requests]
    launches = {"softmax_stats": fa.softmax_gate_stats.launches,
                "softmax_apply": fa.softmax_gate_apply.launches}
    for h in hooks:
        h.remove()
    check(len(captured) == stages, f"captured {len(captured)} attention layers")
    layers = check_attention_layers(fa, captured)
    del captured
    for b, img in zip(requests, images):
        check(img.shape == (b, 128, 128, 3) and str(img.dtype) == "uint8",
              f"request of {b}: images {img.shape} {img.dtype}")
        check(float(img.std()) > 0.0, f"request of {b}: constant images")
    for kind, n in launches.items():
        check(n == stages * len(requests),
              f"{kind} launched {n} times for {len(requests)} forwards of "
              f"{stages} attention stages")

    # the kernel path against the plain path, both against f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
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


def bench_sample(use_pallas: bool, steps: int = 10) -> dict:
    from locate_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["bench-sample", "lsun_bedroom_128", f"use_pallas={str(use_pallas).lower()}",
                       "--batch=64", f"--steps={steps}"])
    check(rc == 0, f"bench-sample use_pallas={use_pallas} returned {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def idle_share(cfg) -> float | None:
    """Share of wall time with no kernel running over three batch-64
    requests, from torch.profiler; None when it records no device time."""
    from torch.profiler import ProfilerActivity, profile

    from locate_tpu_torch.io.sampling import generate_samples
    from locate_tpu_torch.models.generator import build_generator

    model = build_generator(dataclasses.replace(cfg.model, use_pallas=True),
                            "bfloat16", "cuda").eval()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    generate_samples(model, gen, BATCH)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            generate_samples(model, gen, BATCH)
        wall = time.perf_counter() - t0
    spans = []
    for ev in prof.events():
        if getattr(ev, "device_type", None) == torch.autograd.DeviceType.CUDA:
            spans.append((ev.time_range.start, ev.time_range.end))
    if not spans:
        return None
    spans.sort()
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return max(0.0, 1.0 - busy * 1e-6 / wall)


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
    kernels = {}
    current = None
    for line in build.ptxas_report("fused_attention").splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            mangled = m.group(1)
            current = re.search(r"softmax_(stats_partial|stats_merge|apply)", mangled).group(0)
            if "nv_bfloat16" in mangled:
                current += "<bf16>"
            elif "IfE" in mangled:
                current += "<f32>"
            kernels[current] = {}
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and current:
            kernels[current].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and current:
            kernels[current]["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            kernels[current]["static_smem"] = int(s.group(1)) if s else 0
    check(len(kernels) >= 5, f"ptxas reported {len(kernels)} kernels")
    smem = {f"C={c}": int(fa._library().locate_softmax_smem_bytes(c, hd, c, fa.tile_rows(c)))
            for _, c, hd in MAIN_SHAPES[:4]}
    say("build", library=os.path.relpath(str(lib), REPO), seconds=time.perf_counter() - t0,
        kernels=kernels, dynamic_smem_bytes=smem)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    rows = phase_kernels(fa)

    cfg = get_config("lsun_bedroom_128", {"use_pallas": "true"})
    launches = phase_generator(fa, cfg)

    torch.cuda.reset_peak_memory_stats()
    serve = bench_sample(use_pallas=True)
    peak = torch.cuda.max_memory_allocated()
    serve_plain = bench_sample(use_pallas=False)
    idle = idle_share(cfg)
    say("serving", kernel_path=serve, plain_path=serve_plain,
        peak_memory_bytes_kernel_path=peak,
        device_idle_share=("not measured" if idle is None else idle))

    out = []
    for kind_name in ("softmax_stats", "softmax_apply"):
        bf = [r for r in rows if r["dtype"] == "bfloat16"]
        err = max(max(r["m_max_abs_err"], r["se_max_abs_err"]) if kind_name == "softmax_stats"
                  else r["y_max_abs_err"] for r in rows)
        out.append({
            "name": kind_name,
            "route": "cuda",
            "source": SOURCE,
            "replaces": REPLACES[kind_name],
            "launches": launches[kind_name],
            "max_abs_err": err,
            # per generator forward at batch 64: the six stages summed
            "ms": sum(r[kind_name]["ms"] for r in bf),
            "plain_ms": sum(r[kind_name]["plain_ms"] for r in bf),
            "bound_ms": sum(r[kind_name]["bound_ms"] for r in bf),
            "bound_by": "bytes" if all(r[kind_name]["bound_by"] == "bytes" for r in bf)
            else "operations",
            "library_ms": None,
            "shapes": [dict(HW=r["shape"]["HW"], C=r["shape"]["C"], dtype=r["dtype"],
                            **{k: r[kind_name][k] for k in ("ms", "plain_ms", "bound_ms")})
                       for r in rows],
        })
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
