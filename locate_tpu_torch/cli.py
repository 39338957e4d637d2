"""Command line of the PyTorch port, counterpart of `locate_tpu/cli.py`.

    python -m locate_tpu_torch train lsun_bedroom_128 use_pallas=true [--no-resume] [--profile[=DIR]] [--debug-nans]
    python -m locate_tpu_torch sample lsun_bedroom_128 [--checkpoint=DIR | --generator=PATH.npz] [--interpolate] [--truncation-psi=P]
    python -m locate_tpu_torch project celeba_64 model.arch=style --images=DIR_or_NPY [--space=z|w|w+] [--steps=N] [--recon=PNG]
    python -m locate_tpu_torch export lsun_bedroom_128 [--checkpoint=DIR] [--out=BASE] [--torch=PATH.pt]
    python -m locate_tpu_torch info ffhq_512
    python -m locate_tpu_torch bench [batch] [steps] [xla|e2e] [spc=N] [key=value ...] [--device=D]
    python -m locate_tpu_torch bench-sample lsun_bedroom_128 use_pallas=true --batch=64 [--checkpoint=DIR]
    python -m locate_tpu_torch pack lsun_bedroom_128 data.dataset=folder data.path=DIR --out=PACKED
    python -m locate_tpu_torch bench-input lsun_bedroom_128 data.dataset=packed data.path=PACKED
    python -m locate_tpu_torch lsun-export LMDB_DIR OUT_DIR [--limit N]
    python -m locate_tpu_torch eval lsun_bedroom_128 [--checkpoint=DIR] [--samples=N] [--swd] [--prdc-k=K] [--extractor=PATH.npz] [--ref-stats=PATH.npz]
    python -m locate_tpu_torch compare --a=PATH --b=PATH [--resolution=R] [--samples=N] [--swd] [--prdc-k=K]

`train`, `export`, `bench`, `project`, `eval`, `compare` and the sampling
commands run on the card; `--device=cpu` asks for the CPU. `info`, `pack`,
`bench-input` and `lsun-export` are host work.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import sys
import tempfile
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


def bench_pack(cfg: Config, batch: int, path: Optional[str] = None) -> Config:
    """`cfg` reading a packed synthetic set of max(4 batch, 2048) images at
    `data.resolution` (bench.py:146-170), packed by the port's
    `pack_dataset` into `path` (by default a directory of the port's own
    under the temp dir) unless a pack is there already."""
    from locate_tpu_torch.data.datasets import SyntheticImages
    from locate_tpu_torch.data.packed import pack_dataset

    res = cfg.data.resolution
    length = max(4 * batch, 2048)
    path = path or os.path.join(tempfile.gettempdir(), f"ltpu_torch_bench_pack_{res}_{length}")
    if not os.path.exists(os.path.join(path, "meta.json")):
        pack_dataset(SyntheticImages(res, 3, length=length), path)
    return dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, dataset="packed",
                                                             path=path))


def bench_e2e(cfg: Config, device, batch: int, steps: int, device_only: float) -> dict:
    """The e2e mode's keys (bench.py:222-268, 295-380): images/sec of the
    step fed through `make_input_pipeline` (k = `train.steps_per_call`
    steps a call, `make_multi_step` on the prefetched [k, ...] batches),
    best of 3 windows of max(max(3, steps // k), 6 q_depth) calls, each
    after q_depth untimed calls that drain the primed queue (q_depth = 2
    prefetch + 2: the producer's queue and the device stage); the input
    path alone, timed before and after those windows; the reconciliation
    e2e <= 1.15 min(input path, device only); the host's load; and the
    input path split into host assembly and the device stage."""
    import numpy as np
    import torch

    from locate_tpu_torch.data.datasets import make_dataset
    from locate_tpu_torch.data.pipeline import device_prefetch, make_input_pipeline
    from locate_tpu_torch.models.gan import build_gan
    from locate_tpu_torch.train.state import create_train_state
    from locate_tpu_torch.train.step import make_multi_step, make_train_step

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    k = cfg.train.steps_per_call
    gan = build_gan(cfg, device)
    step = make_multi_step(make_train_step(cfg, gan), k)
    state = create_train_state(cfg, gan)
    q_depth = 2 * cfg.data.prefetch + 2
    load_before = os.getloadavg()
    with make_input_pipeline(cfg.data, batch, device=device, seed=0,
                             steps_per_call=k) as batches:
        def input_path(n_calls):
            for _ in range(q_depth):
                next(batches)
            sync()
            t0 = time.perf_counter()
            for _ in range(n_calls):
                next(batches)
            sync()
            return n_calls * k * batch / (time.perf_counter() - t0)

        for _ in range(-(-10 // k)):
            state, metrics = step(state, next(batches))
        sync()
        calls = max(3, steps // k)
        windows = [input_path(2 * calls)]
        calls = max(calls, 6 * q_depth)
        best = float("inf")
        for _ in range(3):
            for _ in range(q_depth):
                state, metrics = step(state, next(batches))
            sync()
            t0 = time.perf_counter()
            for _ in range(calls):
                state, metrics = step(state, next(batches))
            sync()
            best = min(best, time.perf_counter() - t0)
        windows.append(input_path(2 * calls))
    load_after = os.getloadavg()
    metrics = {name: float(v) for name, v in metrics.items()}
    if not all(math.isfinite(v) for v in metrics.values()):
        raise RuntimeError(f"bench e2e: non-finite metrics {metrics}")
    e2e = calls * k * batch / best
    input_ips = max(windows)
    ok = e2e <= 1.15 * min(input_ips, device_only)

    # the input path's two halves, each alone on the same batches
    ds = make_dataset(cfg.data)
    rng = np.random.default_rng(1)
    nb = 20
    idxs = rng.integers(0, len(ds), (nb, batch))
    flips = rng.random((nb, batch)) < 0.5
    ds.batch_fast(idxs[0], flips[0])
    t0 = time.perf_counter()
    for i in range(nb):
        imgs, labels = ds.batch_fast(idxs[i], flips[i])
    assembly = nb * batch / (time.perf_counter() - t0)
    host = {"image": imgs, "label": labels}
    for _ in device_prefetch(iter([host] * 2), device, cfg.data.prefetch):
        pass
    sync()
    t0 = time.perf_counter()
    for _ in device_prefetch(iter([host] * nb), device, cfg.data.prefetch):
        pass
    sync()
    transfer = nb * batch / (time.perf_counter() - t0)
    return {
        "measures": "end_to_end",
        "e2e_images_per_sec": round(e2e, 2),
        "device_only_images_per_sec": round(device_only, 2),
        "input_path_images_per_sec": round(input_ips, 2),
        "input_path_windows": [round(x, 2) for x in windows],
        "reconciliation": {
            "model": "e2e <= 1.15 * min(input_path, device_only)",
            "device_only": round(device_only, 2),
            "input_path": round(input_ips, 2),
            "e2e": round(e2e, 2),
            "ok": bool(ok),
        },
        "host": {
            "cpu_count": os.cpu_count(),
            "loadavg_before_e2e": [round(x, 2) for x in load_before],
            "loadavg_after_e2e": [round(x, 2) for x in load_after],
            "pipeline": f"{cfg.data.dataset} (producer thread + device prefetch)",
            "producer_threads": 1,
            "pack": cfg.data.path,
        },
        "input_path_split": {
            "host_assembly_images_per_sec": round(assembly, 1),
            "device_stage_images_per_sec": round(transfer, 1),
            "note": "input_path ~ the pipelined min of the two; the device stage "
                    "(pinned copy, side-stream copy, events) timed alone on one "
                    "assembled batch",
        },
    }


def cmd_bench(argv: List[str]) -> int:
    """`bench [batch] [steps] [xla|fused|e2e|spc=N] [key=value ...] [--device D]
    [--pack DIR]`: training throughput of the lsun_bedroom_128 train step,
    the counterpart of `locate-tpu bench` (bench.py): k = spc (16 by
    default) steps a call, timed as `bench_images_per_sec` says; for k > 1
    also one step a call (eager), as `single_step_images_per_sec`. `e2e`
    (k = 1 unless spc=N says otherwise) feeds the step through the input
    pipeline from a packed synthetic set (`bench_pack`, `--pack` names its
    directory) and adds `bench_e2e`'s keys; its `value` is the e2e rate.
    `key=value` arguments override the config (for example
    `model.attention.kind=self model.attention_stages=4,8,16,32,64`). One
    JSON line: images/sec, flops per step, MFU."""
    import torch

    from locate_tpu_torch.device import device_name, resolve_device

    flags, bare = _split_args(argv)
    pairs = [a for a in bare if "=" in a and not a.startswith("spc=")]
    batch, steps, modes = bench_modes([a for a in bare if a not in pairs])
    overrides = parse_cli_overrides(pairs)
    cfg = bench_config(batch, modes, overrides)
    device = resolve_device(_str_flag(flags, "device"))
    e2e = "e2e" in modes
    if e2e:
        cfg = bench_pack(cfg, batch, _str_flag(flags, "pack"))
    flops = step_flops(cfg, device, batch)
    k = cfg.train.steps_per_call
    images_per_sec = bench_images_per_sec(cfg, device, batch, steps)
    single = None
    extra = {}
    if e2e:
        extra = bench_e2e(cfg, device, batch, steps, images_per_sec)
    elif k > 1:
        if device.type == "cuda":
            torch.cuda.empty_cache()
        one = bench_config(batch, [m for m in modes if not m.startswith("spc=")] + ["spc=1"],
                           overrides)
        single = bench_images_per_sec(one, device, batch, steps)
    res = cfg.data.resolution
    name = device_name(device)

    def mfu(ips):  # a CPU run has no tensor-core peak to hold its rate against
        return round(flops * ips / batch / PEAK_BF16_FLOPS, 4) if device.type == "cuda" else None

    value = extra["e2e_images_per_sec"] if e2e else round(images_per_sec, 2)
    label = "e2e (host pipeline + transfer + step)" if e2e else "device step"
    print(json.dumps({
        "metric": (f"images/sec @ {res}x{res} GAN train step (bf16, batch {batch}, "
                   f"{label}, {name})"),
        "value": value,
        "unit": "images/sec",
        "batch": batch,
        "use_pallas": cfg.use_pallas,
        "steps_per_call": k,
        "sec_per_step": round(batch / value, 6),
        "flops_per_step": flops,
        "mfu": mfu(value),
        **({"single_step_images_per_sec": round(single, 2),
            "single_step_mfu": mfu(single)} if single is not None else {}),
        **extra,
        "device": name,
    }))
    return 0


def _restore(cfg: Config, ckpt_dir: str, device):
    """(gan, state) of `cfg` on `device` with the latest checkpoint in
    `ckpt_dir` restored (`io/checkpoint.py`)."""
    from locate_tpu_torch.io.checkpoint import CheckpointManager
    from locate_tpu_torch.models.gan import build_gan
    from locate_tpu_torch.train.state import create_train_state

    if not os.path.isdir(ckpt_dir):
        raise FileNotFoundError(f"no checkpoint directory {ckpt_dir}")
    gan = build_gan(cfg, device, seed=cfg.train.seed)
    state = create_train_state(cfg, gan, seed=cfg.train.seed)
    CheckpointManager(ckpt_dir, keep=cfg.train.keep_checkpoints).restore(state)
    return gan, state


def _join_group(flags) -> bool:
    """`parallel/distributed.py:initialize_from_env` with the backend of the
    command's device: gloo for `--device=cpu`, else NCCL on a card."""
    from locate_tpu_torch.parallel.distributed import initialize_from_env

    cpu = str(flags.get("device") or "").startswith("cpu")
    return initialize_from_env(backend="gloo" if cpu else None)


def _weights(state) -> str:
    return "ema" if state.ema_params is not None else "g"


def cmd_train(argv: List[str]) -> int:
    """`train PRESET [overrides] [--no-resume] [--profile[=DIR]]
    [--debug-nans] [--device D]`: run or resume training in the preset's
    workdir (`train/loop.py`). `--profile` writes a Chrome trace of the
    run (to <workdir>/trace without a DIR). `--debug-nans` runs under
    `torch.autograd.detect_anomaly(check_nan=True)`, which raises at the
    backward that made a NaN; a CUDA graph cannot run in that mode, so on
    the card it needs `train.steps_per_call=1`. Launched as several
    processes (`torchrun --nproc_per_node=N -m locate_tpu_torch train ...`,
    or with the JAX package's COORDINATOR_ADDRESS, NUM_PROCESSES and
    PROCESS_ID) the processes join one group first and train data-parallel
    (`parallel/distributed.py`, `train/loop.py`)."""
    import contextlib

    import torch

    from locate_tpu_torch.device import resolve_device
    from locate_tpu_torch.train.loop import train
    from locate_tpu_torch.utils.profiling import profiler_trace

    preset = argv[0] if argv else "cifar10_32"
    flags, bare = _split_args(argv[1:])
    _join_group(flags)  # a no-op in one process; launchers set the environment
    cfg = get_config(preset, parse_cli_overrides(bare))
    device = resolve_device(_str_flag(flags, "device"))
    anomaly = contextlib.nullcontext()
    if flags.get("debug-nans"):
        if device.type == "cuda" and cfg.train.steps_per_call > 1:
            raise SystemExit(
                f"--debug-nans: anomaly mode cannot run inside a CUDA graph, and "
                f"train.steps_per_call={cfg.train.steps_per_call} captures one on the card; "
                "pass train.steps_per_call=1 (or --device=cpu)")
        anomaly = torch.autograd.detect_anomaly(check_nan=True)
    trace_dir = flags.get("profile")
    with profiler_trace(os.path.join(cfg.workdir, "trace") if trace_dir is True
                        else trace_dir), anomaly:
        train(cfg, resume=not flags.get("no-resume"), device=device)
    return 0


def cmd_bench_sample(argv: List[str]) -> int:
    """`bench-sample PRESET [overrides] [--batch N] [--steps N]
    [--checkpoint DIR] [--device D] [--dp]`: serving throughput, images/sec
    generating in `train.compute_dtype`, device compute and the uint8 copy
    to the host included; on the card each batch is one replay of a CUDA
    graph of the latent draw, the forward and the uint8 conversion
    (`train/graph.py:SampleGraph`). Serves the latest checkpoint's EMA
    generator (of `--checkpoint`, by default <workdir>/checkpoints) when
    there is one, else freshly initialized weights (throughput does not
    depend on their values). `--dp` splits each request batch over the
    process group's ranks (`io/sampling.py:ShardedSampler`, eager
    forwards; one rank without a group), and rank 0 prints."""
    import torch

    from locate_tpu_torch.device import device_name, resolve_device
    from locate_tpu_torch.io.checkpoint import CheckpointManager
    from locate_tpu_torch.io.sampling import (ShardedSampler, generate_samples,
                                              serving_generator)
    from locate_tpu_torch.parallel.distributed import local_device
    from locate_tpu_torch.parallel.mesh import make_mesh
    from locate_tpu_torch.models.gan import model_config
    from locate_tpu_torch.models.generator import build_generator
    from locate_tpu_torch.train.graph import SampleGraph

    preset = argv[0] if argv else "cifar10_32"
    flags, bare = _split_args(argv[1:])
    overrides = parse_cli_overrides(bare)
    cfg = get_config(preset, overrides)
    dp = bool(flags.get("dp"))
    mesh = None
    if dp:
        _join_group(flags)
        mesh = make_mesh(cfg.parallel)
    batch = int(_str_flag(flags, "batch", "64"))
    steps = int(_str_flag(flags, "steps", "20"))
    if batch < 1 or steps < 1:
        raise SystemExit("usage: --batch and --steps must be >= 1")
    device = local_device(resolve_device(_str_flag(flags, "device")))
    ckpt_dir = _str_flag(flags, "checkpoint") or os.path.join(cfg.workdir, "checkpoints")
    weights = "init"
    # no manager without a directory: it would create one
    if os.path.isdir(ckpt_dir) and CheckpointManager(ckpt_dir).latest_step() is not None:
        gan, state = _restore(cfg, ckpt_dir, device)
        model, weights = serving_generator(gan, state), _weights(state)
        del gan, state
    else:
        model = build_generator(model_config(cfg), cfg.train.compute_dtype, device).eval()
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    if dp:
        sampler = ShardedSampler(model, None, mesh)

        def sample():
            return sampler(gen, batch)
        sample()  # warm-up
    elif device.type == "cuda":  # one captured graph (its warm-up builds the kernels)
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
    if mesh is not None and not mesh.primary:
        return 0
    print(json.dumps({
        "metric": (
            f"generator sampling images/sec ({cfg.model.resolution}px, "
            f"batch {batch}, {cfg.train.compute_dtype}, incl. host transfer, "
            f"{device_name(device)})"
        ),
        "value": round(steps * batch / best, 2),
        "unit": "images/sec",
        "sec_per_batch": round(best / steps, 5),
        "cuda_graph": device.type == "cuda" and not dp,
        "devices": mesh.world if dp else 1,
        "weights": weights,
    }))
    return 0


def cmd_sample(argv: List[str]) -> int:
    """`sample PRESET [overrides] [--generator=PATH.npz | --checkpoint DIR]
    [--count N] [--seed S] [--truncation T] [--truncation-psi P] [--label L]
    [--interpolate [--rows R] [--cols C]] [--out PNG] [--device D]`: an
    image grid from a generator exported by `export` (or `locate-tpu
    export`), else from the latest checkpoint's EMA generator (of
    `--checkpoint`, by default <workdir>/checkpoints). `--truncation`
    truncates the z draw (either family), `--truncation-psi` applies
    w-space truncation (model.arch=style). `--interpolate` renders a slerp
    interpolation sheet, `rows` latent pairs across `cols` steps. The
    preset gives the compute dtype and `use_pallas`."""
    import torch

    from locate_tpu_torch.device import resolve_device
    from locate_tpu_torch.io.export import load_generator
    from locate_tpu_torch.io.sampling import (generate_samples, interpolation_grid,
                                              save_image_grid, serving_generator)

    preset = argv[0] if argv else "cifar10_32"
    flags, bare = _split_args(argv[1:])
    overrides = parse_cli_overrides(bare)
    cfg = get_config(preset, overrides)
    device = resolve_device(_str_flag(flags, "device"))
    path = _str_flag(flags, "generator")
    if path:
        model = load_generator(path, device, cfg.train.compute_dtype,
                               use_pallas=cfg.use_pallas or cfg.model.use_pallas).eval()
        default_out = f"{cfg.workdir}/samples/torch_samples.png"
        source = path
    else:
        ckpt_dir = _str_flag(flags, "checkpoint") or os.path.join(cfg.workdir, "checkpoints")
        gan, state = _restore(cfg, ckpt_dir, device)
        model = serving_generator(gan, state)
        default_out = f"{cfg.workdir}/samples/cli_step_{state.step}.png"
        source = f"step {state.step}"
        del gan, state
    gen = torch.Generator(device=device)
    gen.manual_seed(int(_str_flag(flags, "seed", "0")))
    grid_cols = None
    if flags.get("interpolate"):
        rows = int(_str_flag(flags, "rows", "4"))
        grid_cols = int(_str_flag(flags, "cols", "8"))
        imgs = interpolation_grid(model, gen, rows, grid_cols)
        count = rows * grid_cols
    else:
        count = int(_str_flag(flags, "count", "64"))
        labels = None
        label = _str_flag(flags, "label")
        if label is not None:
            if not model.config.num_classes:
                raise SystemExit("--label needs model.num_classes > 0")
            labels = torch.full((count,), int(label), device=device)
        try:
            imgs = generate_samples(
                model, gen, count, labels=labels,
                truncation=float(_str_flag(flags, "truncation", "0.0")),
                truncation_psi=float(_str_flag(flags, "truncation-psi", "0.0")))
        except ValueError as e:
            raise SystemExit(f"--truncation-psi: {e}")
    out = _str_flag(flags, "out") or default_out
    save_image_grid(imgs, out, cols=grid_cols)
    print(f"[locate-tpu-torch] wrote {count} samples ({source}) to {out}")
    return 0


def cmd_export(argv: List[str]) -> int:
    """`export PRESET [overrides] [--checkpoint DIR] [--out BASE]
    [--compiled-batch N] [--torch PATH.pt] [--device D]`: the latest
    checkpoint's EMA generator as the `.npz` + `.json` pair `locate-tpu
    export` writes (both packages' `load_generator` read it);
    `--compiled-batch N` also writes the compiled serving artifact at batch
    N beside it (`<base>.pt2` + `<base>.pt2.json`, `io/export.py:
    export_compiled`, in `train.compute_dtype`); `--torch` also writes the
    port generator's state_dict."""
    import torch

    from locate_tpu_torch.device import resolve_device
    from locate_tpu_torch.io.export import export_compiled, export_generator
    from locate_tpu_torch.io.sampling import serving_weights

    preset = argv[0] if argv else "cifar10_32"
    flags, bare = _split_args(argv[1:])
    cfg = get_config(preset, parse_cli_overrides(bare))
    device = resolve_device(_str_flag(flags, "device"))
    ckpt_dir = _str_flag(flags, "checkpoint") or os.path.join(cfg.workdir, "checkpoints")
    gan, state = _restore(cfg, ckpt_dir, device)
    params = serving_weights(state)
    out = _str_flag(flags, "out") or f"{cfg.workdir}/export/generator_{state.step}"
    path = export_generator(gan.config, params, out)
    print(f"[locate-tpu-torch] exported generator (step {state.step}, {_weights(state)}) "
          f"to {path}")
    compiled_batch = _str_flag(flags, "compiled-batch")
    if compiled_batch:
        cpath = export_compiled(gan.config, params, out, batch=int(compiled_batch),
                                compute_dtype=cfg.train.compute_dtype, device=device)
        print(f"[locate-tpu-torch] exported compiled serving artifact to {cpath}")
    torch_out = _str_flag(flags, "torch")
    if torch_out:
        os.makedirs(os.path.dirname(torch_out) or ".", exist_ok=True)
        torch.save({k: v.detach().cpu().clone() for k, v in params.items()}, torch_out)
        print(f"[locate-tpu-torch] exported torch state_dict to {torch_out}")
    return 0


def state_bytes_per_device(n_g: int, n_d: int, tcfg, dp: int, zero_stage: int) -> float:
    """The f32 training state a rank keeps: both nets' parameters and Adam
    moments and G's EMA shadow. ZeRO-1 and ZeRO-3 shard the moments and
    the EMA over the data axis; the parameters stay whole on every rank at
    either stage (`parallel/sharding.py`; `locate-tpu info` divides them
    at stage 3, which the port does not do yet: ROADMAP.md Queue 1 item
    15). The port's slices are these sizes, each rounded up to a whole
    element a rank."""
    n_total = n_g + n_d
    ema_bytes = n_g * (2 if tcfg.ema_dtype == "bfloat16" else 4)
    param_bytes = n_total * 4
    opt_bytes = (n_total * 2 * 4 + (ema_bytes if tcfg.ema_decay > 0 else 0)) / (
        dp if zero_stage >= 1 else 1)
    return param_bytes + opt_bytes


def cmd_info(argv: List[str]) -> int:
    """`info PRESET [overrides]`: model and memory planning without a
    device: stage shapes, parameter counts (G, D, total) and the training
    state's bytes a device (params, Adam moments and the EMA shadow, split
    as the ZeRO stage and the data-parallel width say). Both nets are
    built on `torch.device("meta")`, which allocates nothing, so ffhq_512
    answers at once. The JSON has the keys and values of `locate-tpu
    info`; `parallel.data_parallel=-1` counts the job's processes, one a
    device (`parallel/distributed.py:world_size`: the group's, or the
    launcher's WORLD_SIZE, 1 in a single process)."""
    import torch

    from locate_tpu_torch.models.discriminator import Discriminator
    from locate_tpu_torch.models.gan import model_config
    from locate_tpu_torch.models.generator import as_dtype, generator_of
    from locate_tpu_torch.parallel.distributed import world_size

    preset = argv[0] if argv else "cifar10_32"
    _, bare = _split_args(argv[1:])
    cfg = get_config(preset, parse_cli_overrides(bare))
    mcfg, cd = model_config(cfg), as_dtype(cfg.train.compute_dtype)
    with torch.device("meta"):
        g = generator_of(mcfg, cd)
        n_g = sum(p.numel() for p in g.parameters())
        n_d = sum(p.numel() for p in Discriminator(mcfg, cd).parameters())
    n_total = n_g + n_d
    dp = cfg.parallel.data_parallel
    dp = world_size() if dp == -1 else dp
    z = cfg.parallel.zero_stage
    state_bytes = state_bytes_per_device(n_g, n_d, cfg.train, dp, z)
    batch_bytes = (cfg.train.global_batch * cfg.model.resolution ** 2
                   * cfg.model.img_channels) // max(dp, 1)
    info = {
        "preset": cfg.name,
        "arch": cfg.model.arch,
        "resolution": cfg.model.resolution,
        "stage_resolutions": list(cfg.model.stage_resolutions()),
        "stage_channels": list(cfg.model.stage_channels()),
        "g_rgb": cfg.model.g_rgb,
        "params_g": n_g,
        "params_d": n_d,
        "params_total": n_total,
        "zero_stage": z,
        "data_parallel": dp,
        "state_bytes_per_device": int(state_bytes),
        "state_mib_per_device": round(state_bytes / 2**20, 1),
        "input_bytes_per_device_per_step": int(batch_bytes),
        "global_batch": cfg.train.global_batch,
        "compute_dtype": cfg.train.compute_dtype,
    }
    if cfg.model.arch == "style":
        info["num_ws"] = g.num_ws
    print(json.dumps(info))
    return 0


def cmd_project(argv: List[str]) -> int:
    """`project PRESET [overrides] --images DIR_or_NPY [--count N] [--steps N]
    [--lr F] [--prior-weight F] [--space z|w|w+] [--seed S] [--out z.npz]
    [--recon grid.png] [--raw] [--checkpoint DIR] [--device D]`: invert
    images into the latent space of the latest checkpoint's EMA generator
    (`--raw`: G's own weights) by `io/projection.py:project`. `--images`
    is a folder of images (center-cropped and resized to the model's
    resolution; class subfolders give a class-conditional model its
    labels) or a .npy of uint8 or float NHWC images. `--space w` / `w+`
    (model.arch=style) optimize the intermediate latent(s). Writes the
    latents, the loss history and the space to `--out` (.npz), and with
    `--recon` a [target | reconstruction] grid."""
    import numpy as np
    import torch

    from locate_tpu_torch.data.datasets import ImageFolder
    from locate_tpu_torch.device import resolve_device
    from locate_tpu_torch.io.projection import project, reconstruction_grid
    from locate_tpu_torch.io.sampling import save_image_grid, serving_generator

    preset = argv[0] if argv else "cifar10_32"
    flags, bare = _split_args(argv[1:])
    cfg = get_config(preset, parse_cli_overrides(bare))
    device = resolve_device(_str_flag(flags, "device"))
    ckpt_dir = _str_flag(flags, "checkpoint") or os.path.join(cfg.workdir, "checkpoints")
    gan, state = _restore(cfg, ckpt_dir, device)
    model = serving_generator(gan, state)
    if flags.get("raw"):
        model.load_state_dict(state.g_params.named(state.g_params.flat))
    step = state.step
    del gan, state
    src = _str_flag(flags, "images")
    if not src:
        raise SystemExit("project needs --images=DIR_or_NPY")
    count = int(_str_flag(flags, "count", "16"))
    labels = None
    if src.endswith(".npy"):
        imgs = np.asarray(np.load(src)[:count], np.float32)
        if imgs.max() > 2.0:  # uint8 range -> [-1, 1]
            imgs = imgs / 127.5 - 1.0
    else:
        ds = ImageFolder(src, cfg.model.resolution, cfg.model.img_channels)
        pairs = [ds.example(i) for i in range(min(count, len(ds)))]
        imgs = np.stack([p[0] for p in pairs]).astype(np.float32) / 127.5 - 1.0
        if cfg.model.num_classes:
            labels = np.asarray([p[1] for p in pairs], np.int32)
    if cfg.model.num_classes and labels is None:
        labels = np.zeros((imgs.shape[0],), np.int32)
    steps = int(_str_flag(flags, "steps", "400"))
    space = _str_flag(flags, "space", "z")
    gen = torch.Generator(device=device)
    gen.manual_seed(int(_str_flag(flags, "seed", "0")))
    try:
        z, hist = project(model, imgs, labels=labels, steps=steps,
                          lr=float(_str_flag(flags, "lr", "0.05")),
                          prior_weight=float(_str_flag(flags, "prior-weight", "1e-3")),
                          space=space, gen=gen)
    except ValueError as e:
        raise SystemExit(f"project: {e}")
    out = _str_flag(flags, "out") or f"{cfg.workdir}/projected_z.npz"
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    np.savez(out, z=z, loss_history=hist, space=space,
             **({} if labels is None else {"labels": labels}))
    print(f"[locate-tpu-torch] projected {imgs.shape[0]} images in {steps} steps "
          f"(step {step}, {space}): loss {float(hist[0]):.4f} -> {float(hist[-1]):.4f}; "
          f"z -> {out}")
    recon = _str_flag(flags, "recon")
    if recon:
        grid = reconstruction_grid(model, imgs, z, labels, space=space)
        save_image_grid(grid, recon, cols=2)
        print(f"[locate-tpu-torch] wrote [target|recon] grid to {recon}")
    return 0


def cmd_pack(argv: List[str]) -> int:
    """`pack PRESET [overrides] [--out DIR] [--shard-size N] [--batch N]`:
    one-time offline pack of the config's dataset into pre-decoded,
    pre-resized uint8 memmap shards, the format `locate-tpu pack` writes.
    Training then reads `data.dataset=packed data.path=DIR`, and the host
    input path is page-cache memcpy (no decode an epoch)."""
    from locate_tpu_torch.data.datasets import make_dataset
    from locate_tpu_torch.data.packed import pack_dataset

    preset = argv[0] if argv else "cifar10_32"
    flags, bare = _split_args(argv[1:])
    cfg = get_config(preset, parse_cli_overrides(bare))
    src = make_dataset(cfg.data)
    out = _str_flag(flags, "out") or (
        (cfg.data.path.rstrip("/") or cfg.workdir) + f"_packed{cfg.data.resolution}")
    path = pack_dataset(src, out, shard_size=int(_str_flag(flags, "shard-size", "4096")),
                        batch_size=int(_str_flag(flags, "batch", "64")), progress=True)
    print(f"[locate-tpu-torch] packed {len(src)} examples @ {cfg.data.resolution}px "
          f"to {path} — train with data.dataset=packed data.path={path}")
    return 0


def cmd_lsun_export(argv: List[str]) -> int:
    """`lsun-export <lmdb_dir> <out_dir> [--limit N]`: an LSUN LMDB
    archive as an image folder, which then feeds `data.dataset=folder` or
    `pack`; `data.dataset=lsun` reads the archive directly, so the export
    is optional."""
    from locate_tpu_torch.data.lsun import lsun_to_folder

    if len(argv) < 2:
        print("usage: lsun-export <lmdb_dir> <out_dir> [--limit N]")
        return 1
    flags, _ = _split_args(argv[2:])
    limit = _str_flag(flags, "limit")
    n = lsun_to_folder(argv[0], argv[1], limit=int(limit) if limit else None,
                       progress=True)
    print(f"[locate-tpu-torch] exported {n} LSUN records to {argv[1]}")
    return 0


def cmd_bench_input(argv: List[str]) -> int:
    """`bench-input PRESET [overrides] [--batches N]`: the host input
    path's throughput (images/sec, no device): the producer thread at
    `train.global_batch`, decode and flips included, after one batch of
    warm-up."""
    from locate_tpu_torch.data.datasets import make_dataset
    from locate_tpu_torch.data.pipeline import BatchProducer

    preset = argv[0] if argv else "cifar10_32"
    flags, bare = _split_args(argv[1:])
    cfg = get_config(preset, parse_cli_overrides(bare))
    batches = int(_str_flag(flags, "batches", "20"))
    prod = BatchProducer(make_dataset(cfg.data), cfg.train.global_batch,
                         random_flip=cfg.data.random_flip, seed=0)
    it = iter(prod)
    next(it)
    t0 = time.perf_counter()
    for _ in range(batches):
        next(it)
    dt = time.perf_counter() - t0
    prod.close()
    print(json.dumps({
        "metric": f"input pipeline images/sec ({cfg.data.dataset}, {cfg.data.resolution}px)",
        "value": round(batches * cfg.train.global_batch / dt, 2),
        "unit": "images/sec",
    }))
    return 0


def cmd_eval(argv: List[str]) -> int:
    """`eval PRESET [overrides] [--checkpoint DIR] [--device D] [flags]`:
    FID / KID of the latest checkpoint's EMA generator against the
    config's dataset (`io/fid.py:evaluate_generator`; rFID / rKID with the
    default random-conv extractor, on the card unless `--device=cpu`).
    The JSON line has `locate-tpu eval`'s keys, and `seconds`: the time
    of generation, feature extraction, the real images and the metrics.

      --samples=N            images a side (default 1024)
      --extractor=PATH.npz   an extractor archive: `w0..wK` conv kernels,
                             or InceptionV3 converted by
                             scripts/convert_inception.py (true FID)
      --ref-stats=PATH.npz   the real side's (mu, sigma), computed
                             elsewhere (pytorch-fid's keys): no dataset
                             is read, and KID is null
      --stats-out=PATH.npz   write the generated side's (mu, sigma)
      --real-stats-out=PATH.npz  write the real side's (mu, sigma)
      --features-out=PATH.npz    write the raw feature matrices
      --prdc-k=K             precision / recall / density / coverage at
                             kNN size K (needs the dataset)
      --per-class            conditional models: FID / KID a class and
                             the worst and mean over classes
      --inception-score[=S]  Inception Score over S splits (default 10);
                             needs an Inception archive with its fc head
      --swd                  sliced Wasserstein distance over Laplacian-
                             pyramid patches (swd_<res> x1e3, swd_avg;
                             needs the dataset)
      --dp                   split generation and feature extraction over
                             the process group's ranks (one rank without
                             a group); rank 0 prints and writes
    """
    import numpy as np

    from locate_tpu_torch.data.datasets import make_dataset
    from locate_tpu_torch.device import resolve_device
    from locate_tpu_torch.io.fid import (NpzFeatureExtractor, RandomConvFeatures,
                                         evaluate_generator, load_stats, save_stats)
    from locate_tpu_torch.io.sampling import serving_generator
    from locate_tpu_torch.parallel.distributed import local_device
    from locate_tpu_torch.parallel.mesh import make_mesh

    preset = argv[0] if argv else "cifar10_32"
    flags, bare = _split_args(argv[1:])
    cfg = get_config(preset, parse_cli_overrides(bare))
    mesh = None
    if flags.get("dp"):
        _join_group(flags)
        mesh = make_mesh(cfg.parallel)
    primary = mesh is None or mesh.primary
    ref_stats_path = _str_flag(flags, "ref-stats")
    stats_out = _str_flag(flags, "stats-out")
    real_stats_out = _str_flag(flags, "real-stats-out")
    features_out = _str_flag(flags, "features-out")
    if real_stats_out and ref_stats_path:
        raise SystemExit(
            "--real-stats-out needs the dataset path (it computes the real "
            "side); drop --ref-stats"
        )
    if flags.get("per-class"):
        if not cfg.model.num_classes:
            raise SystemExit("--per-class needs a conditional model "
                             "(model.num_classes > 0)")
        if ref_stats_path:
            raise SystemExit("--per-class needs the dataset, not --ref-stats")
    if flags.get("swd") and ref_stats_path:
        raise SystemExit("--swd compares raw images — it needs the "
                         "dataset, not --ref-stats")
    n_samples = int(_str_flag(flags, "samples", "1024"))
    prdc_k = _str_flag(flags, "prdc-k")
    is_flag = flags.get("inception-score")
    device = local_device(resolve_device(_str_flag(flags, "device")))
    ckpt_dir = _str_flag(flags, "checkpoint") or os.path.join(cfg.workdir, "checkpoints")
    gan, state = _restore(cfg, ckpt_dir, device)
    model, step = serving_generator(gan, state), state.step
    del gan, state
    extractor_path = _str_flag(flags, "extractor")
    extractor = (NpzFeatureExtractor(extractor_path, device=device) if extractor_path
                 else RandomConvFeatures(device=device))
    dataset = None if ref_stats_path else make_dataset(cfg.data)
    arrays: dict = {}
    seconds: dict = {}
    result = evaluate_generator(
        model, dataset, n_samples=n_samples, extractor=extractor,
        ref_stats=load_stats(ref_stats_path) if ref_stats_path else None,
        out=arrays if (stats_out or real_stats_out or features_out) else None,
        prdc_k=int(prdc_k) if prdc_k else None,
        is_splits=(10 if is_flag is True else int(is_flag)) if is_flag else None,
        seconds=seconds, mesh=mesh,
    )
    if flags.get("per-class"):
        # per-class FID shows class dropping that the aggregate hides
        per = {}
        for cls in range(cfg.model.num_classes):
            r = evaluate_generator(model, dataset, n_samples=n_samples, extractor=extractor,
                                   label=cls, mesh=mesh)
            per[cls] = {"fid": r["fid"], "kid": r["kid"], "n_real": r["n_real"]}
        result["per_class"] = per
        fids = [v["fid"] for v in per.values()]
        result["per_class_fid_worst"] = max(fids)
        result["per_class_fid_mean"] = float(np.mean(fids))
    if not primary:
        return 0
    if stats_out:
        save_stats(stats_out, arrays["fake_mu"], arrays["fake_sigma"],
                   n=np.int64(result["n_fake"]))
        result["stats_out"] = stats_out
    if real_stats_out:
        save_stats(real_stats_out, arrays["real_mu"], arrays["real_sigma"],
                   n=np.int64(result["n_real"]))
        result["real_stats_out"] = real_stats_out
    if features_out:
        feats = {"fake_features": arrays["fake_features"]}
        if "real_features" in arrays:
            feats["real_features"] = arrays["real_features"]
        np.savez(features_out, **feats)
        result["features_out"] = features_out
    if flags.get("swd"):
        from locate_tpu_torch.io.swd import swd_generator

        t0 = time.perf_counter()
        result.update(swd_generator(model, dataset, n_samples=n_samples,
                                    seed=cfg.train.seed))
        seconds["swd"] = time.perf_counter() - t0
    result["step"] = int(step)
    result["seconds"] = seconds
    print(json.dumps(result))
    return 0


def _infer_dataset_kind(path: str) -> str:
    """The `data.dataset` kind that reads `path`: .zip archives, LMDB
    environments (data.mdb / .mdb), TFRecord shards, packed directories
    (meta.json), else an image folder."""
    low = path.lower()
    if low.endswith(".zip"):
        return "zip"
    if low.endswith(".mdb") or os.path.isfile(os.path.join(path, "data.mdb")):
        return "lsun"
    if low.endswith((".tfrecord", ".tfrecords")):
        return "tfrecord"
    if os.path.isfile(os.path.join(path, "meta.json")):
        return "packed"
    return "folder"


def cmd_compare(argv: List[str]) -> int:
    """`compare --a=PATH --b=PATH [--resolution=R] [--samples=N]
    [--extractor=npz] [--swd] [--prdc-k=K] [--seed=S] [--device D]`:
    FID / KID between two image sources with no model (folder, zip, LMDB,
    TFRecord or packed, from the path), and optionally SWD and precision
    / recall / density / coverage. Identical sources score zero (KID near
    it); the features and SWD run on the card unless `--device=cpu`."""
    import numpy as np

    from locate_tpu_torch.config import DataConfig
    from locate_tpu_torch.data.datasets import make_dataset
    from locate_tpu_torch.device import resolve_device
    from locate_tpu_torch.io.fid import (NpzFeatureExtractor, RandomConvFeatures,
                                         feature_stats, features_in_batches,
                                         frechet_distance, kid, prdc)

    flags, overrides = _split_args(argv)
    if overrides:
        raise SystemExit(f"compare takes flags only, got {overrides}")
    a_path, b_path = _str_flag(flags, "a"), _str_flag(flags, "b")
    if not a_path or not b_path:
        raise SystemExit("compare needs --a=PATH and --b=PATH")
    res = int(_str_flag(flags, "resolution", "256"))
    n = int(_str_flag(flags, "samples", "1024"))
    seed = int(_str_flag(flags, "seed", "0"))
    device = resolve_device(_str_flag(flags, "device"))
    extractor_path = _str_flag(flags, "extractor")
    extractor = (NpzFeatureExtractor(extractor_path, device=device) if extractor_path
                 else RandomConvFeatures(device=device))

    def load(path):
        kind = _infer_dataset_kind(path)
        ds = make_dataset(DataConfig(dataset=kind, path=path, resolution=res))
        rng = np.random.default_rng(seed)
        idx = rng.choice(len(ds), min(n, len(ds)), replace=False)
        return kind, np.stack([ds.example(int(i))[0] for i in idx])

    kind_a, imgs_a = load(a_path)
    kind_b, imgs_b = load(b_path)
    m = min(len(imgs_a), len(imgs_b))
    imgs_a, imgs_b = imgs_a[:m], imgs_b[:m]
    fa = features_in_batches(imgs_a, extractor)
    fb = features_in_batches(imgs_b, extractor)
    result = {
        "a": {"path": a_path, "kind": kind_a, "n": int(m)},
        "b": {"path": b_path, "kind": kind_b, "n": int(m)},
        "fid": frechet_distance(*feature_stats(fa), *feature_stats(fb)),
        "kid": kid(fa, fb),
        "extractor": "npz" if extractor_path else "random-conv (rFID)",
    }
    k_prdc = _str_flag(flags, "prdc-k")
    if k_prdc:
        result.update(prdc(fa, fb, k=int(k_prdc)))
    if flags.get("swd"):
        from locate_tpu_torch.io.swd import swd

        result.update(swd(imgs_a, imgs_b, seed=seed, device=device))
    print(json.dumps(result))
    return 0


COMMANDS = {
    "bench": cmd_bench,
    "bench-input": cmd_bench_input,
    "bench-sample": cmd_bench_sample,
    "compare": cmd_compare,
    "eval": cmd_eval,
    "export": cmd_export,
    "info": cmd_info,
    "lsun-export": cmd_lsun_export,
    "pack": cmd_pack,
    "project": cmd_project,
    "sample": cmd_sample,
    "train": cmd_train,
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
