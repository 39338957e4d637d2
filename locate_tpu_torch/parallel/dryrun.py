"""`dryrun_multichip(n)`, counterpart of `__graft_entry__.py:dryrun_multichip`:
n gloo ranks on the CPU (`torch.multiprocessing`), each running two steps
of both backends at tiny shapes on its rows of one global batch (R1
firing at step 0; "gspmd" with ZeRO-1), every metric held against the
one-process run of the same program (rtol 1e-3: the order of reductions
only). Run it as `python -m locate_tpu_torch.parallel.dryrun [N]`."""

from __future__ import annotations

import json
import os
import socket
import sys
import tempfile
from typing import Dict, List

import numpy as np
import torch

BACKENDS = (("shard_map", 0), ("gspmd", 1))  # (parallel.backend, zero_stage)
STEPS = 2


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dryrun_config(world: int, backend: str = "gspmd", zero_stage: int = 0):
    """lsun_bedroom_128 cut to 16x16 and thin channels, f32, two images a
    rank."""
    from locate_tpu_torch.config import get_config

    return get_config("lsun_bedroom_128", {
        "model.resolution": 16, "model.base_channels": 32, "model.max_channels": 32,
        "model.min_channels": 16, "model.latent_dim": 16, "data.resolution": 16,
        "train.global_batch": 2 * world, "train.compute_dtype": "float32",
        "parallel.backend": backend, "parallel.zero_stage": zero_stage})


def global_batch(cfg, seed: int = 0) -> np.ndarray:
    res, n = cfg.model.resolution, cfg.train.global_batch
    return np.random.default_rng(seed).integers(0, 256, (n, res, res, 3), dtype=np.uint8)


def run_steps(cfg, mesh, images: np.ndarray, steps: int = STEPS) -> List[Dict[str, float]]:
    """`steps` steps of `cfg`'s step on `mesh` from the seed's fresh state,
    on this rank's rows of `images`; each step's metrics."""
    from locate_tpu_torch.models.gan import build_gan
    from locate_tpu_torch.parallel.sharding import make_step_for, place_train_state
    from locate_tpu_torch.train.state import create_train_state

    gan = build_gan(cfg, "cpu", seed=cfg.train.seed)
    state = create_train_state(cfg, gan, seed=cfg.train.seed,
                               mesh=mesh if mesh.group is not None else None)
    place_train_state(state, mesh, cfg.parallel.zero_stage)
    step = make_step_for(cfg, gan, mesh)
    n = len(images) // mesh.world
    rows = {"image": torch.from_numpy(images[mesh.rank * n:(mesh.rank + 1) * n])}
    out = []
    for _ in range(steps):
        state, metrics = step(state, rows)
        out.append({k: float(v) for k, v in metrics.items()})
    return out


def _worker(rank: int, world: int, port: int, out_dir: str) -> None:
    from locate_tpu_torch.parallel.distributed import initialize_from_env
    from locate_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    initialize_from_env(f"localhost:{port}", world, rank, backend="gloo")
    try:
        results = {}
        for backend, zero in BACKENDS:
            cfg = dryrun_config(world, backend, zero)
            results[backend] = run_steps(cfg, make_mesh(cfg.parallel), global_batch(cfg))
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(results, f)
    finally:
        torch.distributed.destroy_process_group()


def dryrun_multichip(n_devices: int = 2) -> Dict[str, List[Dict[str, float]]]:
    """Spawn `n_devices` gloo ranks, run both backends on them, and raise
    unless every rank's metrics are rank 0's and rank 0's equal the
    one-process run's within rtol 1e-3 (atol 1e-5). Returns rank 0's."""
    import torch.multiprocessing as mp

    from locate_tpu_torch.parallel.mesh import Mesh

    with tempfile.TemporaryDirectory() as out_dir:
        mp.spawn(_worker, args=(n_devices, free_port(), out_dir), nprocs=n_devices, join=True)
        ranks = []
        for r in range(n_devices):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    for r, res in enumerate(ranks[1:], 1):
        if res != ranks[0]:
            raise AssertionError(f"rank {r}'s metrics differ from rank 0's")
    for backend, zero in BACKENDS:
        cfg = dryrun_config(n_devices, backend, zero)
        ref = run_steps(cfg, Mesh(), global_batch(cfg))
        for i, (got, want) in enumerate(zip(ranks[0][backend], ref)):
            for k, v in want.items():
                np.testing.assert_allclose(got[k], v, rtol=1e-3, atol=1e-5,
                                           err_msg=f"{backend} step {i} {k}")
    return ranks[0]


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    out = dryrun_multichip(n)
    print(json.dumps({"dryrun_multichip": n, "ok": True,
                      "backends": {b: out[b][-1]["d_loss"] for b, _ in BACKENDS}}))
