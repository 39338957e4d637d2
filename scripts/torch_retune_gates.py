#!/usr/bin/env python3
"""Re-tune the port's kernel dispatch thresholds on one NVIDIA card, the
counterpart of scripts/retune_gates.py.

    python3 scripts/torch_retune_gates.py              # measure and print
    python3 scripts/torch_retune_gates.py --write      # and rewrite the profile
    python3 scripts/torch_retune_gates.py --margin 0.02 --out PATH

Times, in bf16 on the card, forward plus backward of

- each stage flavor (pair, conv, up_pair, up_conv, down_pair, down_conv)
  run as one fused stage against its layers one by one, the gate of the
  unfused layers through its own kernels (the alternative the dispatch
  really chooses), in both gate modes where the flavor has a gate, over
  the presets' stage shapes from 64^2 to 512^2: lsun_bedroom_128's widths
  at batch 64 at 64^2 and 128^2, ffhq_512's at batch 16 at 256^2 and 512^2;
- one sigmoid LocateAttention layer through its one-pass kernels against
  the plain composition, at ffhq_512's gate widths from 4^2 to 512^2,
  batch 16;

each call captured in a CUDA graph and timed with CUDA events. The sigmoid
ranges are measured first and are in force while the stages' unfused
sigmoid gates run. Rules (never slower than the alternative):
`min_locations_rule` for a flavor, `sigmoid_ranges_rule` for the gate.
`--write` rewrites locate_tpu_torch/ops/gate_profile.json (or `--out`)
with the thresholds, the measurements, the card's name and power limit.
A rung that fails raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os
import subprocess
import sys
import tempfile
from typing import Dict, List, Sequence, Tuple

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# (resolution, channels, batch) of the stage ladder: the fine resolution
# (an up flavor's input is half of it), the stage's input and output width
STAGE_LADDER = [(64, 64, 64), (128, 64, 64), (256, 64, 16), (512, 64, 16)]
# (resolution, channels, batch) of the sigmoid ladder: ffhq_512's gate widths
SIGMOID_LADDER = [(4, 512, 16), (8, 256, 16), (16, 128, 16), (32, 64, 16), (64, 64, 16),
                  (128, 64, 16), (256, 64, 16), (512, 64, 16)]
# flavor -> (gate modes, upsample, downsample)
FLAVOR_SPECS = {
    "pair": (("softmax", "sigmoid"), False, False),
    "conv": ((None,), False, False),
    "up_pair": (("softmax", "sigmoid"), True, False),
    "up_conv": ((None,), True, False),
    "down_pair": (("softmax", "sigmoid"), False, True),
    "down_conv": ((None,), False, True),
}


def wins(alternative_ms: float, kernel_ms: float, margin: float) -> bool:
    """The kernel path counts as faster only if it beats the alternative by
    `margin` (the JAX script's `tx / tf >= 1 + margin`)."""
    return alternative_ms / kernel_ms >= 1.0 + margin


def min_locations_rule(rows: Sequence[Tuple[int, float, float]], margin: float,
                       ladder: Sequence[int]) -> int:
    """A flavor's threshold from (resolution, fused ms, unfused ms) rows,
    every gate mode's: the largest resolution where the fused stage loses
    sets it at (2 res)^2; where it wins everywhere, the smallest measured
    resolution's locations; where it loses at the top of `ladder`, twice
    the top (never fuse). scripts/retune_gates.py's rule."""
    losing = [res for res, fused, unfused in rows if not wins(unfused, fused, margin)]
    if not losing:
        return min(res for res, _, _ in rows) ** 2
    worst = max(losing)
    if worst >= max(ladder):
        return (2 * max(ladder)) ** 2
    return (2 * worst) ** 2


def sigmoid_ranges_rule(rows: Sequence[Tuple[int, float, float]],
                        margin: float) -> List[Dict[str, int]]:
    """The sigmoid gate's kernel ranges from (locations, kernel ms, plain
    ms) rows: each run of consecutive rungs where the kernels win, from its
    first rung's locations to its last's; none where they win nowhere."""
    ranges, run = [], []
    for locs, kernel, plain in sorted(rows) + [(None, 1.0, 0.0)]:
        if locs is not None and wins(plain, kernel, margin):
            run.append(locs)
        elif run:
            ranges.append({"min": run[0], "max": run[-1]})
            run = []
    return ranges


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def graph_ms(fn, reps: int = 3, replays: int = 3) -> float:
    """Device milliseconds of one `fn()`: `reps` calls captured in a CUDA
    graph after two warm-up calls on a side stream, replayed `replays`
    times between CUDA events."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
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
    torch.cuda.empty_cache()
    return ms


def model_config(mode: str):
    """ffhq_512's model config (use_pallas, the factorized 3x3 conv block,
    GroupNorm, leaky ReLU, the residual gate) with the gate in `mode`."""
    from locate_tpu_torch.config import get_config
    from locate_tpu_torch.models.gan import model_config as of

    mcfg = of(get_config("ffhq_512"))
    return dataclasses.replace(mcfg, attention=dataclasses.replace(mcfg.attention, mode=mode))


def fill_logits(module, gen, scale: float = 0.25) -> None:
    """Random logit convs (zero at init, where every gate is flat)."""
    import torch

    from locate_tpu_torch.ops.attention import LocateAttention

    for layer in module.modules():
        if isinstance(layer, LocateAttention):
            with torch.no_grad():
                w = layer.to_logits.w
                w.copy_(torch.randn(w.shape, generator=gen, device=w.device) * scale)


def build_stage(flavor: str, mode, c: int, gen):
    """A FusableStage of one flavor at width c -> c, bf16 compute."""
    import torch

    from locate_tpu_torch.nn import blocks
    from locate_tpu_torch.ops.conv import DownsampleAvg, UpsampleNearest

    mcfg = model_config(mode or "softmax")
    layers = [blocks.ConvBlock(c, c, mcfg, torch.bfloat16, gen)]
    if flavor.startswith("up_"):
        layers.insert(0, UpsampleNearest(2))
    if flavor.endswith("pair"):
        layers.append(blocks._attention_layer(mcfg, c, torch.bfloat16, gen))
    if flavor.startswith("down_"):
        layers.append(DownsampleAvg(2))
    stage = blocks.FusableStage(layers, mcfg, torch.bfloat16)
    fill_logits(stage, gen)
    return stage


def fwd_bwd(module, x, dy):
    import torch

    def run():
        torch.autograd.grad(module(x), [x, *module.parameters()], dy)
    return run


def inputs(n: int, res: int, c: int, gen, out_res: int):
    """(x, dy): x (n, res, res, c) bf16 needing its gradient, dy of the
    output's shape."""
    import torch

    x = torch.randn((n, res, res, c), device="cuda", generator=gen).to(torch.bfloat16)
    dy = torch.randn((n, out_res, out_res, c), device="cuda", generator=gen).to(torch.bfloat16)
    return x.requires_grad_(True), dy


def measure_stages(reps: int = 3, ladder=STAGE_LADDER) -> List[dict]:
    """One row per (flavor, mode, rung): fused and unfused ms of forward
    plus backward."""
    import torch

    from locate_tpu_torch.nn import blocks

    gen = torch.Generator(device="cuda")
    gen.manual_seed(21)
    rows = []
    for flavor, (modes, up, down) in FLAVOR_SPECS.items():
        for mode in modes:
            for res, c, n in ladder:
                stage = build_stage(flavor, mode, c, gen).cuda()
                out_res = res // 2 if down else res
                x, dy = inputs(n, res // 2 if up else res, c, gen, out_res)
                row = dict(flavor=flavor, mode=mode or "conv_only", res=res, channels=c,
                           batch=n)
                try:
                    for name, threshold in (("fused_ms", 0), ("unfused_ms", 1 << 62)):
                        blocks.FUSE_MIN_LOCATIONS = threshold
                        row[name] = graph_ms(fwd_bwd(stage, x, dy), reps)
                finally:
                    blocks.FUSE_MIN_LOCATIONS = None
                row["unfused_over_fused"] = row["unfused_ms"] / row["fused_ms"]
                print(json.dumps(row), flush=True)
                rows.append(row)
                del stage, x, dy
                torch.cuda.empty_cache()
    return rows


def measure_sigmoid(reps: int = 3, ladder=SIGMOID_LADDER) -> List[dict]:
    """One row per rung: a sigmoid LocateAttention layer's forward, and
    forward plus backward, through its kernels and the plain composition."""
    import torch

    from locate_tpu_torch.nn import blocks

    gen = torch.Generator(device="cuda")
    gen.manual_seed(22)
    mcfg = model_config("sigmoid")
    rows = []
    for res, c, n in ladder:
        layer = blocks._attention_layer(mcfg, c, torch.bfloat16, gen).cuda()
        fill_logits(layer, gen)
        x, dy = inputs(n, res, c, gen, res)
        row = dict(res=res, locations=res * res, channels=c, batch=n)
        for path, fn in (("kernel", layer.forward_fused), ("plain", layer.forward_composed)):
            with torch.no_grad():
                row[f"{path}_forward_ms"] = graph_ms(lambda: fn(x), reps)
            row[f"{path}_ms"] = graph_ms(
                lambda: torch.autograd.grad(fn(x), [x, *layer.parameters()], dy), reps)
        row["plain_over_kernel"] = row["plain_ms"] / row["kernel_ms"]
        print(json.dumps(row), flush=True)
        rows.append(row)
        del layer, x, dy
        torch.cuda.empty_cache()
    return rows


def thresholds(stage_rows: List[dict], margin: float) -> Dict[str, int]:
    ladder = sorted({r["res"] for r in stage_rows})
    return {flavor: min_locations_rule(
        [(r["res"], r["fused_ms"], r["unfused_ms"]) for r in stage_rows
         if r["flavor"] == flavor], margin, ladder) for flavor in FLAVOR_SPECS}


def retune(margin: float = 0.02, reps: int = 3) -> dict:
    """The measured profile: the sigmoid ranges first (in force, through a
    temporary profile file, while the stage ladder runs), then the stage
    flavors' thresholds."""
    from locate_tpu_torch.ops import gate_profile

    sigmoid_rows = measure_sigmoid(reps)
    ranges = sigmoid_ranges_rule(
        [(r["locations"], r["kernel_ms"], r["plain_ms"]) for r in sigmoid_rows], margin)
    prof = dict(gate_profile.load(), sigmoid_locations=ranges)
    old = os.environ.get(gate_profile.ENV)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "gate_profile.json")
        with open(path, "w") as fh:
            json.dump(prof, fh)
        os.environ[gate_profile.ENV] = path
        try:
            stage_rows = measure_stages(reps)
        finally:
            if old is None:
                del os.environ[gate_profile.ENV]
            else:
                os.environ[gate_profile.ENV] = old
    prof["min_locations"] = thresholds(stage_rows, margin)
    import torch

    prof["meta"] = {
        "source": "scripts/torch_retune_gates.py",
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": nvidia_smi(),
        "torch": torch.__version__,
        "date": datetime.datetime.now(datetime.timezone.utc).date().isoformat(),
        "rule": "never slower: the kernel path must beat the alternative by margin",
        "margin": margin,
        "reps": reps,
        "stage_ladder": "(res, channels, batch) " + json.dumps(STAGE_LADDER),
        "sigmoid_ladder": "(res, channels, batch) " + json.dumps(SIGMOID_LADDER),
        "stage_measurements": stage_rows,
        "sigmoid_measurements": sigmoid_rows,
    }
    return prof


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--write", action="store_true",
                    help="rewrite locate_tpu_torch/ops/gate_profile.json")
    ap.add_argument("--out", default="", help="write to this path instead")
    ap.add_argument("--margin", type=float, default=0.02)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_retune_gates: needs a CUDA card", file=sys.stderr)
        return 2
    from locate_tpu_torch.ops import gate_profile

    print(f"torch_retune_gates: {torch.cuda.get_device_name(0)} ({nvidia_smi()}), "
          f"margin {args.margin}", flush=True)
    prof = retune(args.margin)
    table = {"min_locations": prof["min_locations"],
             "sigmoid_locations": prof["sigmoid_locations"]}
    target = args.out or (gate_profile.profile_path() if args.write else "")
    if target:
        with open(target, "w") as fh:
            json.dump(prof, fh, indent=1)
            fh.write("\n")
        gate_profile.reload()
        print(f"wrote {target}")
    print("RETUNE " + json.dumps(table), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
