#!/usr/bin/env python3
"""The softmax gate's csum pass and the sigmoid gate's forward on both
routes, on one NVIDIA card.

    python3 scripts/torch_gate_csum_routes.py

Builds csrc/fused_attention.cu and prints the registers, spills and
tensor-core instructions of `softmax_csum_mma`, `sigmoid_gate_wide_mma`
and the kernels beside them, the forward body's shared memory and blocks
an SM for each pass, and the card's name and power limit. Then one JSON
line for each (N, HW) of the five C = 64 gate shapes of lsun_bedroom_128
(batch 64) and ffhq_512 (batch 16): the largest difference between the
two csum routes' c on the same inputs, each route's error against an f32
plain computation over c's absolute terms, db2's error over its term
scale from the mma backward with c from either route, each csum route's
ms a launch (chip_smoke.py's CUDA-graph timing) beside the plain
version's and the byte bound, and the stats and apply passes' mma times.
Last, one line for each C = 512 shape of ffhq_512's sigmoid gate (batch
16, gate_max 1.5): the two routes' y against each other and against f32,
and the mma route's ms at each split of Cout over blocks (1, 2, 4, 8)
beside the split `sigmoid_wide_splits` picks, the simt route's and the
plain version's ms. A short first card call
for a change to either kernel; chip_smoke.py's phases 2, 4, 8 and 15 hold
the same kernels to their plain versions.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SHAPES = [(64, 1024), (64, 4096), (64, 16384), (16, 65536), (16, 262144)]
WIDE_SHAPES = [(16, 16), (16, 64)]
KW = dict(act="leaky_relu", leaky_slope=0.2)
KERNELS = ("softmax_csum_mma", "softmax_stats_mma", "softmax_apply_mma",
           "softmax_csum_partial<bf16>", "sigmoid_gate_wide_mma<512,128,512>",
           "sigmoid_gate<bf16>", "sigmoid_bwd_wide_mma<512,128,512>")


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_gate_csum_routes: needs a CUDA card", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from locate_tpu_torch.ops import fused_attention as fa
    from locate_tpu_torch.ops.cuda import build

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    lib = build.build("fused_attention")
    report, sass = cs.parse_ptxas(build.ptxas_report("fused_attention")), cs.sass_tensor_ops(lib)
    gl = fa._library()
    print(json.dumps(dict(build_seconds=time.perf_counter() - t0, kernels={
        k: dict(report.get(k, {}), tensor_core_instructions=sass.get(k)) for k in KERNELS},
        fwd_mma_smem_bytes=[gl.locate_softmax_fwd_mma_smem_bytes(p, *fa.GATE_FWD_MMA_WIDTHS)
                            for p in range(3)],
        fwd_mma_blocks_per_sm=[gl.locate_softmax_fwd_mma_blocks_per_sm(
            p, *fa.GATE_FWD_MMA_WIDTHS) for p in range(3)],
        sigmoid_mma_smem_bytes=gl.locate_sigmoid_gate_mma_smem_bytes(*fa.GATE_WIDE),
        sigmoid_mma_blocks_per_sm=gl.locate_sigmoid_gate_mma_blocks_per_sm(*fa.GATE_WIDE),
        card=cs.nvidia_smi())), flush=True)

    bf16 = torch.bfloat16
    for n, hw in SHAPES:
        ops, dy = cs.gate_inputs(n, hw, 64, 16, bf16, seed=1)
        ops = [ops[0], ops[1], ops[2].to(bf16), ops[3], ops[4].to(bf16), ops[5]]
        opts = dict(hw_scale=float(hw), gate_max=16.0, **KW)
        with torch.no_grad():
            m, se = fa.softmax_gate_stats(*ops, **KW)

            def csum(route, x=ops[0], d=dy, mm=m, ss=se):
                return fa.softmax_gate_csum(x, d, *ops[1:], mm, ss, route=route, **opts)

            c_mma, c_simt = csum("mma"), csum("simt")
            row = dict(N=n, HW=hw, c_max_abs_diff=float((c_mma - c_simt).abs().max()),
                       c_mma_bitwise_repeatable=bool(torch.equal(c_mma, csum("mma"))))
            xf = ops[0].float()
            mf, sf = fa.softmax_gate_stats_reference(xf, *ops[1:], **KW)
            c_f32 = fa.softmax_gate_csum_reference(xf, dy.float(), *ops[1:], mf, sf, **opts)
            scales = cs.term_scales(fa, xf, dy.float(), *ops[1:], mf, sf, c_f32, opts)
            c_plain = fa.softmax_gate_csum_reference(ops[0], dy, *ops[1:], m, se, **opts)
            for tag, c in (("mma", c_mma), ("simt", c_simt), ("plain", c_plain)):
                row[f"c_rel_err_{tag}_vs_f32"] = cs.rel_err(c, c_f32, scales[0])
            db2_f32 = fa.softmax_gate_backward_reference(xf, dy.float(), *ops[1:], mf, sf, c_f32,
                                                         **opts)[-1]
            for tag, c in (("mma", c_mma), ("simt", c_simt)):
                db2 = fa.softmax_gate_backward(ops[0], dy, *ops[1:], m, se, c, **opts)[-1]
                row[f"db2_rel_err_c_from_{tag}_csum"] = cs.rel_err(db2, db2_f32, scales[-1])
            row["csum_bound_ms"] = cs.bound("softmax_csum", n, hw, 64, 16, 64, bf16)[0]
            for route in ("mma", "simt"):
                row[f"csum_ms_{route}"] = cs.graph_ms(lambda: csum(route))
            row["csum_ms_plain"] = cs.graph_ms(lambda: fa.softmax_gate_csum_reference(
                ops[0], dy, *ops[1:], m, se, **opts))
            row["stats_ms_mma"] = cs.graph_ms(lambda: fa.softmax_gate_stats(*ops, **KW))
            row["apply_ms_mma"] = cs.graph_ms(lambda: fa.softmax_gate_apply(
                *ops, m, se, hw_scale=float(hw), gate_max=16.0, **KW))
        print(json.dumps(row), flush=True)
        del ops, dy, m, se
        torch.cuda.empty_cache()

    kw = dict(gate_max=cs.SIGMOID_GATE_MAX, **KW)
    for n, hw in WIDE_SHAPES:
        ops, _ = cs.gate_inputs(n, hw, 512, 128, bf16, seed=2)
        ops = [ops[0], ops[1], ops[2].to(bf16), ops[3], ops[4].to(bf16), ops[5]]
        with torch.no_grad():
            y_mma = fa.sigmoid_gate(*ops, route="mma", **kw)
            y_simt = fa.sigmoid_gate(*ops, route="simt", **kw)
            y_plain = fa.sigmoid_gate_reference(*ops, **kw)
            y_f32 = fa.sigmoid_gate_reference(ops[0].float(), *ops[1:], **kw)
            l = fa.gate_logits_reference(ops[0].float(), *ops[1:], **KW)
            row = dict(N=n, HW=hw, C=512,
                       clamped_share=float((2 * torch.sigmoid(l) > kw["gate_max"]).float().mean()),
                       y_max_abs_diff=float((y_mma.float() - y_simt.float()).abs().max()),
                       y_mma_bitwise_repeatable=bool(torch.equal(
                           y_mma, fa.sigmoid_gate(*ops, route="mma", **kw))),
                       bound_ms=cs.bound("sigmoid_gate", n, hw, 512, 128, 512, bf16)[0])
            for tag, y in (("mma", y_mma), ("simt", y_simt), ("plain", y_plain)):
                row[f"y_rel_err_{tag}_vs_f32"] = cs.rel_err(y, y_f32)
            row["splits_picked"] = fa.sigmoid_wide_splits(
                n, hw, torch.cuda.get_device_properties(0).multi_processor_count)
            for k in (1, 2, 4, 8):
                with cs.wide_splits(fa, k):
                    row[f"ms_mma_splits_{k}"] = cs.graph_ms(
                        lambda: fa.sigmoid_gate(*ops, route="mma", **kw))
            row["ms_simt"] = cs.graph_ms(lambda: fa.sigmoid_gate(*ops, route="simt", **kw))
            row["ms_plain"] = cs.graph_ms(lambda: fa.sigmoid_gate_reference(*ops, **kw))
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
