"""Command line of the PyTorch port, counterpart of `locate_tpu/cli.py`.

    python -m locate_tpu_torch bench [batch] [steps] [xla] [spc=N] [key=value ...] [--device=D]
    python -m locate_tpu_torch bench-sample lsun_bedroom_128 use_pallas=true --batch=64
    python -m locate_tpu_torch sample lsun_bedroom_128 --generator=PATH.npz --out=grid.png

All run on the card; `--device=cpu` asks for the CPU.
"""

from __future__ import annotations

import dataclasses
import json
import math
import sys
import time
from typing import List, Optional, Tuple

from locate_tpu_torch.config import Config, get_config, parse_cli_overrides


def _split_args(argv: List[str]):
    """(flags, bare arguments): --key=value / --key value flags, and the
    other arguments in order (config overrides, or bench's positionals)."""
    flags = {}
    bare = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a.startswith("--"):
            key, eq, val = a[2:].partition("=")
            if eq:
                flags[key] = val
            elif i + 1 < len(argv) and not argv[i + 1].startswith("--") and "=" not in argv[i + 1]:
                flags[key] = argv[i + 1]
                i += 1
            else:
                flags[key] = True
        else:
            bare.append(a)
        i += 1
    return flags, bare


def _str_flag(flags, key: str, default: Optional[str] = None) -> Optional[str]:
    val = flags.get(key, default)
    if val is True:
        raise SystemExit(f"--{key} requires a value (use --{key}=VALUE or --{key} VALUE)")
    return val


# H100 SXM dense bf16 tensor-core peak (NVIDIA's data sheet), MFU's denominator
PEAK_BF16_FLOPS = 989e12


def bench_modes(argv: List[str]) -> Tuple[int, int, List[str]]:
    """`[batch] [steps] [xla|fused|e2e|spc=N ...]`, as bench.py reads them."""
    nums = [a for a in argv if a.isdigit()]
    modes = [a for a in argv if not a.isdigit()]
    for m in modes:
        if m not in ("xla", "fused", "e2e") and not (m.startswith("spc=")
                                                     and m[4:].isdigit()):
            raise SystemExit(f"bench: unknown argument {m!r} "
                             "(usage: bench [batch] [steps] [xla|fused|e2e|spc=N])")
    batch = int(nums[0]) if nums else 128
    steps = int(nums[1]) if len(nums) > 1 else 20
    if batch < 1 or steps < 1 or any(m.startswith("spc=") and int(m[4:]) < 1
                                     for m in modes):
        raise SystemExit("bench: batch, steps and spc must be >= 1")
    return batch, steps, modes


def bench_config(batch: int, modes: List[str], overrides: Optional[dict] = None) -> Config:
    """The config bench.py (:101-175) builds for `modes`: lsun_bedroom_128
    at 128^2, bf16, use_pallas unless `xla`, the reference-parity pins
    (R1, ADA, LeCam, both update guards off), one device, and
    `steps_per_call` from spc=N, 16 by default (1 for e2e), with the
    cadences it requires. `overrides` (config key -> value, as
    `model.attention.kind=self` on the command line) are applied last."""
    spc = 1 if "e2e" in modes else 16
    for m in modes:
        if m.startswith("spc="):
            spc = int(m[4:])
    ov = {
        "train.global_batch": str(batch),
        "train.compute_dtype": "bfloat16",
        "use_pallas": "false" if "xla" in modes else "true",
        "train.fused_step": "true" if "fused" in modes else "false",
        "data.resolution": "128",
        "train.r1_gamma": "0.0",
        "train.ada_target": "0.0",
        "train.augment_p": "0.0",
        "train.lecam_gamma": "0.0",
        "train.grad_norm_limit": "0.0",
        "train.max_nonfinite_skips": "0",
    }
    if spc > 1:  # cadences must be multiples of steps_per_call
        ov.update({
            "train.log_every": str(100 * spc),
            "train.sample_every": str(2000 * spc),
            "train.checkpoint_every": str(2000 * spc),
            "train.total_steps": str(100_000 * spc),
            "train.steps_per_call": str(spc),
        })
    ov.update(overrides or {})
    cfg = get_config("lsun_bedroom_128", ov)
    if "e2e" in modes:
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, dataset="packed"))
    return dataclasses.replace(cfg, parallel=dataclasses.replace(cfg.parallel,
                                                                 data_parallel=1))


def step_flops(cfg: Config, device, batch: int) -> int:
    """Matmul and convolution flops of one train step, counted by
    `torch.utils.flop_counter.FlopCounterMode` on the plain path
    (use_pallas=false), so the count is the same work whatever implements
    the gate (the ctypes kernels are invisible to the counter)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from locate_tpu_torch.models.gan import build_gan
    from locate_tpu_torch.train.state import create_train_state
    from locate_tpu_torch.train.step import make_train_step

    plain = dataclasses.replace(cfg, use_pallas=False,
                                model=dataclasses.replace(cfg.model, use_pallas=False))
    gan = build_gan(plain, device)
    step = make_train_step(plain, gan)
    state = create_train_state(plain, gan)
    res = plain.data.resolution
    images = torch.zeros((batch, res, res, plain.model.img_channels), dtype=torch.uint8,
                         device=device)
    with FlopCounterMode(display=False) as counter:
        step(state, {"image": images, "label": torch.zeros(batch, dtype=torch.long,
                                                           device=device)})
    return int(counter.get_total_flops())


def bench_images_per_sec(cfg: Config, device, batch: int, steps: int) -> float:
    """Images/sec of the train step at `train.steps_per_call` = k steps a call (`make_multi_step`: a CUDA
    graph of the step replayed k times on the card): ceil(10 / k) warm-up
    calls, then the best of 3 windows of max(3, steps // k) calls, on one
    fixed uint8 batch a step (numpy seed 0), as bench.py times it; the
    last call's metrics must be finite."""
    import numpy as np
    import torch

    from locate_tpu_torch.models.gan import build_gan
    from locate_tpu_torch.train.state import create_train_state
    from locate_tpu_torch.train.step import make_multi_step, make_train_step

    k = cfg.train.steps_per_call
    gan = build_gan(cfg, device)
    step = make_multi_step(make_train_step(cfg, gan), k)
    state = create_train_state(cfg, gan)
    res = cfg.data.resolution
    shape = (batch, res, res, 3) if k == 1 else (k, batch, res, res, 3)
    host = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    fixed = {"image": torch.from_numpy(host).to(device),
             "label": torch.zeros(shape[:-3], dtype=torch.long, device=device)}

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for _ in range(-(-10 // k)):
        state, metrics = step(state, fixed)
    sync()
    calls = max(3, steps // k)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(calls):
            state, metrics = step(state, fixed)
        sync()
        best = min(best, time.perf_counter() - t0)
    metrics = {name: float(v) for name, v in metrics.items()}
    if not all(math.isfinite(v) for v in metrics.values()):
        raise RuntimeError(f"bench: non-finite metrics {metrics}")
    return calls * k * batch / best


def cmd_bench(argv: List[str]) -> int:
    """`bench [batch] [steps] [xla|fused|e2e|spc=N] [key=value ...] [--device D]`:
    training throughput of the lsun_bedroom_128 train step, the counterpart
    of `locate-tpu bench` (bench.py): k = spc (16 by default) steps a call,
    timed as `bench_images_per_sec` says; for k > 1 also one step a call
    (eager), as `single_step_images_per_sec`. `key=value` arguments
    override the config (for example `model.attention.kind=self
    model.attention_stages=4,8,16,32,64`). One JSON line: images/sec,
    flops per step, MFU."""
    import torch

    from locate_tpu_torch.device import device_name, resolve_device

    flags, bare = _split_args(argv)
    pairs = [a for a in bare if "=" in a and not a.startswith("spc=")]
    batch, steps, modes = bench_modes([a for a in bare if a not in pairs])
    overrides = parse_cli_overrides(pairs)
    cfg = bench_config(batch, modes, overrides)
    if "fused" in modes:
        raise NotImplementedError(
            "bench fused: the fused simultaneous step (train.fused_step) is not "
            "ported yet (ROADMAP.md Queue 1 item 11)")
    if "e2e" in modes:
        raise NotImplementedError(
            "bench e2e: the data pipeline is not ported yet (ROADMAP.md Queue 1 item 7)")
    device = resolve_device(_str_flag(flags, "device"))
    flops = step_flops(cfg, device, batch)
    k = cfg.train.steps_per_call
    images_per_sec = bench_images_per_sec(cfg, device, batch, steps)
    single = None
    if k > 1:
        if device.type == "cuda":
            torch.cuda.empty_cache()
        one = bench_config(batch, [m for m in modes if not m.startswith("spc=")] + ["spc=1"],
                           overrides)
        single = bench_images_per_sec(one, device, batch, steps)
    res = cfg.data.resolution
    name = device_name(device)

    def mfu(ips):  # a CPU run has no tensor-core peak to hold its rate against
        return round(flops * ips / batch / PEAK_BF16_FLOPS, 4) if device.type == "cuda" else None

    print(json.dumps({
        "metric": (f"images/sec @ {res}x{res} GAN train step (bf16, batch {batch}, "
                   f"device step, {name})"),
        "value": round(images_per_sec, 2),
        "unit": "images/sec",
        "batch": batch,
        "use_pallas": cfg.use_pallas,
        "steps_per_call": k,
        "sec_per_step": round(batch / images_per_sec, 6),
        "flops_per_step": flops,
        "mfu": mfu(images_per_sec),
        **({"single_step_images_per_sec": round(single, 2),
            "single_step_mfu": mfu(single)} if single is not None else {}),
        "device": name,
    }))
    return 0


def cmd_bench_sample(argv: List[str]) -> int:
    """`bench-sample PRESET [overrides] [--batch N] [--steps N] [--device D]`:
    serving throughput, images/sec generating in `train.compute_dtype`,
    device compute and the uint8 copy to the host included; on the card
    each batch is one replay of a CUDA graph of the latent draw, the
    forward and the uint8 conversion (`train/graph.py:SampleGraph`). Times
    freshly initialized weights (throughput does not depend on their
    values)."""
    import torch

    from locate_tpu_torch.device import device_name, resolve_device
    from locate_tpu_torch.io.sampling import generate_samples
    from locate_tpu_torch.models.gan import model_config
    from locate_tpu_torch.models.generator import build_generator
    from locate_tpu_torch.train.graph import SampleGraph

    preset = argv[0] if argv else "cifar10_32"
    flags, bare = _split_args(argv[1:])
    overrides = parse_cli_overrides(bare)
    if flags.get("dp"):
        raise SystemExit("--dp: data-parallel serving waits for the parallel "
                         "slice of the port (ROADMAP.md Queue 1)")
    if flags.get("checkpoint"):
        raise SystemExit("--checkpoint: orbax checkpoints wait for the "
                         "checkpoint slice of the port (ROADMAP.md Queue 1)")
    cfg = get_config(preset, overrides)
    batch = int(_str_flag(flags, "batch", "64"))
    steps = int(_str_flag(flags, "steps", "20"))
    if batch < 1 or steps < 1:
        raise SystemExit("usage: --batch and --steps must be >= 1")
    device = resolve_device(_str_flag(flags, "device"))
    model = build_generator(model_config(cfg), cfg.train.compute_dtype, device).eval()
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    if device.type == "cuda":  # one captured graph (its warm-up builds the kernels)
        sample = SampleGraph(model, gen, batch)
    else:
        def sample():
            return generate_samples(model, gen, batch)
        sample()  # warm-up
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(steps):
            sample()
        best = min(best, time.perf_counter() - t0)
    print(json.dumps({
        "metric": (
            f"generator sampling images/sec ({cfg.model.resolution}px, "
            f"batch {batch}, {cfg.train.compute_dtype}, incl. host transfer, "
            f"{device_name(device)})"
        ),
        "value": round(steps * batch / best, 2),
        "unit": "images/sec",
        "sec_per_batch": round(best / steps, 5),
        "cuda_graph": device.type == "cuda",
        "devices": 1,
        "weights": "init",
    }))
    return 0


def cmd_sample(argv: List[str]) -> int:
    """`sample PRESET [overrides] --generator=PATH.npz [--count N]
    [--seed S] [--truncation T] [--label L] [--out PNG] [--device D]`:
    an image grid from a generator exported by `locate-tpu export`. The
    preset gives the compute dtype and `use_pallas`; the export gives the
    model. Orbax checkpoints wait for the checkpoint slice."""
    import torch

    from locate_tpu_torch.device import resolve_device
    from locate_tpu_torch.io.export import load_generator
    from locate_tpu_torch.io.sampling import generate_samples, save_image_grid

    preset = argv[0] if argv else "cifar10_32"
    flags, bare = _split_args(argv[1:])
    overrides = parse_cli_overrides(bare)
    path = _str_flag(flags, "generator")
    if not path:
        raise SystemExit("sample needs --generator=PATH.npz (an export of "
                         "`locate-tpu export`); orbax checkpoints wait for the "
                         "checkpoint slice of the port (ROADMAP.md Queue 1)")
    cfg = get_config(preset, overrides)
    device = resolve_device(_str_flag(flags, "device"))
    model = load_generator(path, device, cfg.train.compute_dtype,
                           use_pallas=cfg.use_pallas or cfg.model.use_pallas).eval()
    count = int(_str_flag(flags, "count", "64"))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(_str_flag(flags, "seed", "0")))
    labels = None
    label = _str_flag(flags, "label")
    if label is not None:
        if not model.config.num_classes:
            raise SystemExit("--label needs model.num_classes > 0")
        labels = torch.full((count,), int(label), device=device)
    imgs = generate_samples(model, gen, count, labels=labels,
                            truncation=float(_str_flag(flags, "truncation", "0.0")))
    out = _str_flag(flags, "out") or f"{cfg.workdir}/samples/torch_samples.png"
    save_image_grid(imgs, out)
    print(f"[locate-tpu-torch] wrote {count} samples to {out}")
    return 0


COMMANDS = {
    "bench": cmd_bench,
    "bench-sample": cmd_bench_sample,
    "sample": cmd_sample,
}


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help") or argv[0] not in COMMANDS:
        print(__doc__)
        print(f"commands: {sorted(COMMANDS)}")
        return 0 if argv and argv[0] in ("-h", "--help") else 1
    return COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    raise SystemExit(main())
