"""One gloo rank of tests/test_torch_dp.py's data-parallel runs and
tests/test_torch_tp.py's tensor-parallel ones (CPU, no JAX).
`python tests/torch_dp_worker.py INPUTS OUT_DIR` joins the group from
MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK, runs every case of INPUTS
(a torch.save'd dict of the port's configs, each on the mesh its
`parallel` names, start states, global batches and JAX's draws, each
either the global batch, of which the rank takes its data row's rows, or
a list of every data rank's own) and saves what it saw to
OUT_DIR/rank<r>.pt."""

import os
import subprocess
import sys

import numpy as np
import torch

from locate_tpu_torch.io.checkpoint import CheckpointManager
from locate_tpu_torch.io.fid import RandomConvFeatures, evaluate_generator
from locate_tpu_torch.io.sampling import ShardedSampler
from locate_tpu_torch.models.gan import build_gan
from locate_tpu_torch.parallel.distributed import initialize_from_env
from locate_tpu_torch.parallel.dryrun import free_port
from locate_tpu_torch.parallel.mesh import make_mesh
from locate_tpu_torch.parallel.sharding import (gathered_tensors, make_step_for,
                                                place_train_state)
from locate_tpu_torch.train.state import create_train_state, state_tensors


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def start_ranks(inputs, tmp, world=2):
    """Save `inputs` under `tmp` and start `world` ranks of this script on
    them (gloo over a free localhost port); returns the processes."""
    torch.save(inputs, os.path.join(tmp, "inputs.pt"))
    port = free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   WORLD_SIZE=str(world), RANK=str(rank), OMP_NUM_THREADS="2")
        env["PYTHONPATH"] = os.pathsep.join([REPO, os.path.join(REPO, "tests"),
                                             env.get("PYTHONPATH", "")])
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), os.path.join(tmp, "inputs.pt"),
             str(tmp)], env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    return procs


def finish_ranks(procs, tmp):
    """Wait for the ranks (each must exit 0) and load what each saved."""
    logs = [p.communicate(timeout=900)[0].decode(errors="replace") for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(len(procs))]


def start(cfg, mesh, tensors=None):
    """(gan, state, step) of `cfg` on `mesh`, the state holding `tensors`
    (a one-process state's, by name) when given, then sharded."""
    gan = build_gan(cfg, "cpu", seed=cfg.train.seed)
    state = create_train_state(cfg, gan, seed=cfg.train.seed, mesh=mesh)
    if tensors is not None:
        with torch.no_grad():
            for k, t in state_tensors(state).items():
                t.copy_(tensors[k])
    place_train_state(state, mesh, cfg.parallel.zero_stage)
    return gan, state, make_step_for(cfg, gan, mesh)


def rows(x, mesh):
    """The rank's data row's rows of a global batch, or its own entry of a
    list."""
    i = mesh.data_index
    if isinstance(x, (list, tuple)):
        return torch.as_tensor(np.asarray(x[i]))
    n = len(x) // mesh.dp
    return torch.as_tensor(np.asarray(x)[i * n:(i + 1) * n])


def steps(state, step, images, mesh, count, draws=None, labels=None):
    batch = {"image": rows(images, mesh)}
    if labels is not None:
        batch["label"] = rows(labels, mesh)
    out = []
    for i in range(count):
        given = {k: rows(v, mesh) for k, v in draws[i].items()} if draws else {}
        state, m = step(state, batch, **given)
        out.append({k: float(v) for k, v in m.items()})
    return out


def full(state):
    return {k: t.clone() for k, t in gathered_tensors(state).items()}


def main(inputs_path, out_dir):
    torch.set_num_threads(2)
    initialize_from_env(backend="gloo")
    inp = torch.load(inputs_path, weights_only=False)
    mesh = make_mesh(next(iter(inp["runs"].values()))["cfg"].parallel)
    res = {"world": mesh.world}
    # step runs: metrics a step and the final state's full tensors
    for name, run in inp["runs"].items():
        cfg = run["cfg"]
        run_mesh = make_mesh(cfg.parallel)
        _, state, step = start(cfg, run_mesh, run.get("tensors"))
        res[name] = {"metrics": steps(state, step, run["images"], run_mesh, run["steps"],
                                      run.get("draws"), run.get("labels")),
                     "state": full(state),
                     "bytes": {k: t.numel() * t.element_size()
                               for k, t in state_tensors(state).items()},
                     "index": (run_mesh.data_index, run_mesh.model_index)}
        if "checkpoint" in run:  # the final state, saved by rank 0
            ckpt = CheckpointManager(run["checkpoint"], keep=1, mesh=run_mesh)
            ckpt.save(state)
            ckpt.close()
    if "resume" in inp:
        extras(inp, mesh, res)
    if "tp_checkpoints" in inp:
        tp_checkpoints(inp["tp_checkpoints"], res)
    torch.save(res, os.path.join(out_dir, f"rank{mesh.rank}.pt"))
    torch.distributed.destroy_process_group()


def extras(inp, mesh, res):
    """A ZeRO-1 resume, serving, the eval and the loop."""
    # ZeRO-1: 2 steps, a checkpoint, a fresh state restored, 2 more steps
    run = inp["resume"]
    cfg = run["cfg"]
    _, state, step = start(cfg, mesh, run["tensors"])
    straight = steps(state, step, run["images"], mesh, 4)
    _, state, step = start(cfg, mesh, run["tensors"])
    first = steps(state, step, run["images"], mesh, 2)
    ckpt = CheckpointManager(run["dir"], keep=2, mesh=mesh)
    ckpt.save(state)
    ckpt.close()
    torch.distributed.barrier()  # rank 0's write is on disk
    at_save = full(state)
    _, state, step = start(cfg, mesh)
    ckpt = CheckpointManager(run["dir"], keep=2, mesh=mesh)
    ckpt.restore(state)
    restored = full(state)
    res["resume"] = {"straight": straight, "first": first, "at_save": at_save, "restored": restored,
                     "then": steps(state, step, run["images"], mesh, 2), "final": full(state)}
    # serving and the eval, on the gspmd run's start weights
    cfg = inp["runs"]["gspmd"]["cfg"]
    gan, _, _ = start(cfg, mesh, inp["runs"]["gspmd"]["tensors"])
    gen = torch.Generator().manual_seed(3)
    sampler = ShardedSampler(gan, None, mesh)
    res["samples"] = [sampler(gen, count) for count in inp["sample_counts"]]
    from locate_tpu_torch.data.datasets import make_dataset

    arrays = {}
    res["eval"] = evaluate_generator(
        gan.generator, make_dataset(cfg.data), extractor=RandomConvFeatures(width=8, device="cpu"),
        mesh=mesh, out=arrays, **inp["eval"])
    res["eval_arrays"] = arrays
    # the loop, in one workdir
    from locate_tpu_torch.train.loop import train

    train(inp["loop"], device="cpu")


def tp_checkpoints(run, res):
    """The one-process checkpoint in run["one_dir"] restored on the mesh of
    run["cfg"]; a step run's checkpoint (run["dir"]) restored at (1, 2)
    by ranks 0 and 1 (the model group of a pair made for it)."""
    import torch.distributed as dist

    from locate_tpu_torch.parallel.mesh import Mesh

    dist.barrier()  # rank 0's writes are on disk
    cfg = run["cfg"]
    mesh = make_mesh(cfg.parallel)
    _, state, _ = start(cfg, mesh)
    CheckpointManager(run["one_dir"], mesh=mesh).restore(state)
    out = {"one_restored": full(state)}
    pair = dist.new_group([0, 1])  # every rank makes it
    if mesh.rank < 2:
        m12 = Mesh(dp=1, mp=2, rank=mesh.rank, world=2, group=pair, model_group=pair)
        cfg12 = run["cfg12"]
        _, state, _ = start(cfg12, m12)
        CheckpointManager(run["dir"], mesh=m12).restore(state)
        out["restored_12"] = full(state)
    res["tp_checkpoints"] = out


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
