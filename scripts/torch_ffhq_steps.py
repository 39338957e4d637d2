#!/usr/bin/env python3
"""ffhq_512's train steps and fused-stage timing on one NVIDIA card.

    python3 scripts/torch_ffhq_steps.py [ROOT] [TAG]

Runs the port found at ROOT (default: this checkout; another commit's tree
unpacked with `git archive`, to compare two commits on one card in turns,
e.g. parent, change, change, parent) through that tree's own chip_smoke.py
helpers: chip_smoke.py's phase 14 (one 512^2 G stage and one D stage,
forward plus backward, fused, unfused and on the plain path), then the
ffhq_512 kernel path as shipped at batch 16, with the softmax gate and
with the sigmoid gate: six eager steps from step 0 (seconds of steps 1-5
kept) and the device's idle share and top kernels over two profiled
steps; then, where the tree has `make_multi_step`, the same from a fresh
state as CUDA-graph calls of STEPS_PER_CALL steps (the first call, with
R1's step 0 and the captures, apart; seconds a step of the next three
calls) and the idle share of one profiled call. Prints one JSON line
starting with "AB ".
"""

from __future__ import annotations

import json
import os
import sys
import time

STEPS_PER_CALL = 4


def graph_steps(cs, step, state, k):
    """(seconds a step of calls 2-4, idle share of one more call) of
    `make_multi_step(step, k)` on k different ffhq_512 batches."""
    import torch

    from locate_tpu_torch.train.step import make_multi_step

    multi = make_multi_step(step, k)
    batches = cs.stacked_batch(k, cs.FFHQ_BATCH, 512)
    multi(state, batches)  # step 0's R1 and the captures
    seconds = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        multi(state, batches)
        torch.cuda.synchronize()
        seconds.append((time.perf_counter() - t0) / k)
    idle, top = cs.profile_calls(lambda: multi(state, batches), calls=1, top=6)
    return dict(steps_per_call=k, seconds_per_step=seconds, idle=idle,
                top=[(t["kernel"][:60], t["ms_per_call"] / k) for t in top])


def main() -> int:
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                           os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    tag = sys.argv[2] if len(sys.argv) > 2 else os.path.basename(root)
    os.chdir(root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("torch_ffhq_steps: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from locate_tpu_torch.nn import blocks
    from locate_tpu_torch.train import step as step_module

    out = {"tag": tag, "device": torch.cuda.get_device_name(0), "nvidia_smi": cs.nvidia_smi()}
    t0 = time.perf_counter()
    out["fusion_ms"] = cs.phase_fusion_timing(blocks)
    for name, overrides in (("softmax", {}), ("sigmoid", cs.SIGMOID)):
        gan, state, step = cs.trainer(cs.ffhq_config(**overrides))
        batch = cs.fixed_batch(cs.FFHQ_BATCH, 512)
        state, _, seconds = cs.timed_steps(step, state, batch, 6)
        idle, top = cs.profile_calls(lambda: step(state, batch), calls=2, top=6)
        out[name] = dict(seconds_per_step=seconds[1:], idle=idle,
                         top=[(t["kernel"][:60], t["ms_per_call"]) for t in top])
        del gan, state, step
        torch.cuda.empty_cache()
        if hasattr(step_module, "make_multi_step"):
            gan, state, step = cs.trainer(cs.ffhq_config(**overrides))
            out[name + "_graph"] = graph_steps(cs, step, state, STEPS_PER_CALL)
            del gan, state, step
            cs.release_memory()
    out["seconds"] = time.perf_counter() - t0
    print("AB " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
