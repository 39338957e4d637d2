#!/usr/bin/env python3
"""Host cost of calling a kernel through its `torch.ops.locate.*` op.

    python3 scripts/torch_op_host_cost.py [--device=cpu|cuda] [--calls=N]

The port's fourteen kernels are registered with `torch.library.Library`
(`define` / `impl` / `register_fake`, `ops/flash_attention.py:define_op`).
This prints one JSON line with the host microseconds a call of
`softmax_gate_stats` at a tiny shape (N, HW, C, Hd) = (2, 128, 64, 16) in
bf16 takes four ways: the launcher or plain version called as a Python
function, the same function as an op of its own registered like the
port's (`Library` define / impl), the same function as a
`torch.library.custom_op`, and the port's public wrapper. On "cuda" the
function is the CUDA launcher (its kernel launched on the current stream,
not waited for), on "cpu" the plain version. The differences are the
dispatch cost a call pays on the eager step; replays of a CUDA graph pay
none of it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from locate_tpu_torch.ops import fused_attention as fa  # noqa: E402


def per_call_us(fn, calls: int, sync) -> float:
    for _ in range(100):
        fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    sync()
    return (time.perf_counter() - t0) / calls * 1e6


def main(argv) -> int:
    flags = dict(a[2:].split("=", 1) for a in argv if a.startswith("--") and "=" in a)
    device = torch.device(flags.get("device", "cuda"))
    calls = int(flags.get("calls", "20000"))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is False: pass --device=cpu")
    g = torch.Generator().manual_seed(0)
    n, hw, c, hd = 2, 128, 64, 16
    args = [torch.randn(s, generator=g).to(device) for s in
            ((n, hw, c), (hw, hd), (c, hd), (hd,), (hd, c), (c,))]
    args[0] = args[0].to(torch.bfloat16)
    impl = fa._softmax_gate_stats_cuda if device.type == "cuda" else fa._softmax_gate_stats_cpu

    lib = torch.library.Library("locate_host_cost", "DEF")
    lib.define("stats(Tensor x2d, Tensor pos_proj, Tensor w1x, Tensor b1, Tensor w2, Tensor b2, "
               "str act, float leaky_slope, str? route) -> (Tensor, Tensor)")
    lib.impl("stats", impl, "CUDA" if device.type == "cuda" else "CPU")
    library_op = torch.ops.locate_host_cost.stats.default

    @torch.library.custom_op("locate_host_cost::stats_custom", mutates_args=(),
                             device_types=device.type)
    def custom(x2d: torch.Tensor, pos_proj: torch.Tensor, w1x: torch.Tensor, b1: torch.Tensor,
               w2: torch.Tensor, b2: torch.Tensor, act: str, leaky_slope: float,
               route: str) -> tuple[torch.Tensor, torch.Tensor]:
        return impl(x2d, pos_proj, w1x, b1, w2, b2, act, leaky_slope, None)

    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    rows = {
        "python_function": lambda: impl(*args, "leaky_relu", 0.2, None),
        "library_op": lambda: library_op(*args, "leaky_relu", 0.2, None),
        "custom_op": lambda: custom(*args, "leaky_relu", 0.2, "auto"),
        "port_wrapper": lambda: fa.softmax_gate_stats(*args, act="leaky_relu", leaky_slope=0.2),
    }
    with torch.no_grad():
        us = {name: per_call_us(fn, calls, sync) for name, fn in rows.items()}
    out = dict(device=device.type, shape=dict(n=n, hw=hw, c=c, hd=hd), calls=calls,
               host_us_per_call=us, torch=torch.__version__)
    if device.type == "cuda":
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
