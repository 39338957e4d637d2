"""Command line of the PyTorch port, counterpart of `locate_tpu/cli.py`.

    python -m locate_tpu_torch bench-sample lsun_bedroom_128 use_pallas=true --batch=64
    python -m locate_tpu_torch sample lsun_bedroom_128 --generator=PATH.npz --out=grid.png

Both run on the card; `--device=cpu` asks for the CPU.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time
from typing import List, Optional

from locate_tpu_torch.config import get_config, parse_cli_overrides


def _split_args(argv: List[str]):
    """--key=value / --key value flags; bare key=value args are config
    overrides."""
    flags = {}
    overrides = []
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
            overrides.append(a)
        i += 1
    return flags, parse_cli_overrides(overrides)


def _str_flag(flags, key: str, default: Optional[str] = None) -> Optional[str]:
    val = flags.get(key, default)
    if val is True:
        raise SystemExit(f"--{key} requires a value (use --{key}=VALUE or --{key} VALUE)")
    return val


def _model_config(cfg):
    """The model config the generator is built from: the top-level
    `use_pallas` switches the model's on (`models/gan.py:build_gan`)."""
    if cfg.use_pallas and not cfg.model.use_pallas:
        return dataclasses.replace(cfg.model, use_pallas=True)
    return cfg.model


def cmd_bench_sample(argv: List[str]) -> int:
    """`bench-sample PRESET [overrides] [--batch N] [--steps N] [--device D]`:
    serving throughput, images/sec generating in `train.compute_dtype`,
    device compute and the uint8 copy to the host included. Times freshly
    initialized weights (throughput does not depend on their values)."""
    import torch

    from locate_tpu_torch.device import device_name, resolve_device
    from locate_tpu_torch.io.sampling import generate_samples
    from locate_tpu_torch.models.generator import build_generator

    preset = argv[0] if argv else "cifar10_32"
    flags, overrides = _split_args(argv[1:])
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
    model = build_generator(_model_config(cfg), cfg.train.compute_dtype, device).eval()
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    generate_samples(model, gen, batch)  # warm-up: kernel build, cuDNN plans
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(steps):
            generate_samples(model, gen, batch)
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
    flags, overrides = _split_args(argv[1:])
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
