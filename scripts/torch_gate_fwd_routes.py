#!/usr/bin/env python3
"""The softmax gate's forward pair on both routes, on one NVIDIA card.

    python3 scripts/torch_gate_fwd_routes.py

Builds csrc/fused_attention.cu, prints the registers, spills and
tensor-core instructions of the forward pair's kernels (mma and simt), the
mma kernels' shared memory and blocks an SM, the card's name and power
limit, then one JSON line for each (N, HW) of the five C = 64 gate shapes
of lsun_bedroom_128 (batch 64) and ffhq_512 (batch 16): the largest
difference between the two routes' m, se and y on the same inputs, and
each route's ms a launch (chip_smoke.py's CUDA-graph timing) beside the
byte bound. A short first card call for a change to either kernel;
chip_smoke.py's phases 2, 3 and 8 hold the same kernels to their plain
versions.
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
KW = dict(act="leaky_relu", leaky_slope=0.2)
KERNELS = ("softmax_stats_mma", "softmax_apply_mma", "softmax_stats_partial<bf16>",
           "softmax_apply<bf16>")


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_gate_fwd_routes: needs a CUDA card", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from locate_tpu_torch.ops import fused_attention as fa
    from locate_tpu_torch.ops.cuda import build

    t0 = time.perf_counter()
    lib = build.build("fused_attention")
    report, sass = cs.parse_ptxas(build.ptxas_report("fused_attention")), cs.sass_tensor_ops(lib)
    print(json.dumps(dict(build_seconds=time.perf_counter() - t0, kernels={
        k: dict(report.get(k, {}), tensor_core_instructions=sass.get(k)) for k in KERNELS},
        smem_bytes=[fa._library().locate_softmax_fwd_mma_smem_bytes(
            apply, *fa.GATE_FWD_MMA_WIDTHS) for apply in (0, 1)],
        blocks_per_sm=[fa._library().locate_softmax_fwd_mma_blocks_per_sm(
            apply, *fa.GATE_FWD_MMA_WIDTHS) for apply in (0, 1)],
        card=cs.nvidia_smi())), flush=True)
    bf16 = torch.bfloat16
    for n, hw in SHAPES:
        ops, _ = cs.gate_inputs(n, hw, 64, 16, bf16, seed=1)
        ops = [ops[0], ops[1], ops[2].to(bf16), ops[3], ops[4].to(bf16), ops[5]]
        apply_kw = dict(hw_scale=float(hw), gate_max=16.0, **KW)
        with torch.inference_mode():
            m, se = fa.softmax_gate_stats(*ops, route="mma", **KW)
            ms, ss = fa.softmax_gate_stats(*ops, route="simt", **KW)
            y = fa.softmax_gate_apply(*ops, m, se, route="mma", **apply_kw)
            ys = fa.softmax_gate_apply(*ops, m, se, route="simt", **apply_kw)
            row = dict(N=n, HW=hw, m_max_abs_diff=float((m - ms).abs().max()),
                       se_max_rel_diff=float(((se - ss).abs() / ss).max()),
                       y_max_abs_diff=float((y.float() - ys.float()).abs().max()),
                       y_share_differing=float((y != ys).float().mean()))
            for route in ("mma", "simt"):
                row[f"stats_ms_{route}"] = cs.graph_ms(
                    lambda: fa.softmax_gate_stats(*ops, route=route, **KW))
                row[f"apply_ms_{route}"] = cs.graph_ms(
                    lambda: fa.softmax_gate_apply(*ops, m, se, route=route, **apply_kw))
            for kind in ("stats", "apply"):
                row[f"{kind}_bound_ms"] = cs.bound(f"softmax_{kind}", n, hw, 64, 16, 64, bf16)[0]
        print(json.dumps(row), flush=True)
        del ops, m, se, ms, ss, y, ys
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
