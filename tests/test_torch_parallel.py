"""The port's parallel layer without a second process: the mesh's shapes
and errors against the JAX package's `make_mesh` (8 fake CPU devices),
the TP slot's raise, ZeRO's slices and stages on one rank, the backend
dispatch, `initialize_from_env`'s environment, and a gloo group of one
rank, under which the step, `eval --dp` and `bench-sample --dp` run the
group's code and give the one-process results."""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from locate_tpu.config import ParallelConfig as JaxParallelConfig
from locate_tpu.parallel.mesh import make_mesh as jax_make_mesh
from locate_tpu_torch import cli
from locate_tpu_torch.config import ParallelConfig
from locate_tpu_torch.models.gan import build_gan
from locate_tpu_torch.parallel import distributed
from locate_tpu_torch.parallel.dryrun import free_port
from locate_tpu_torch.parallel.mesh import TP_TODO, Mesh, make_mesh, single_device_mesh
from locate_tpu_torch.parallel.sharding import (Shard, gathered_tensors, make_step_for,
                                                place_train_state, sharded_tensors)
from locate_tpu_torch.train.state import create_train_state, state_tensors
from torch_step_draws import batch, configs

ENV = ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID", "MASTER_ADDR", "MASTER_PORT",
       "WORLD_SIZE", "RANK", "LOCAL_RANK")


@pytest.fixture
def clean_env(monkeypatch):
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


@pytest.mark.parametrize("dp, mp", [(-1, 1), (8, 1), (3, 2), (-1, 3), (4, 1), (-1, 16)])
def test_mesh_shapes_and_errors_are_the_jax_words(dp, mp):
    """make_mesh over 8 ranks: JAX's data axis, or JAX's ValueError word
    for word; a model axis that divides raises the TP slot's error."""
    try:
        want = jax_make_mesh(JaxParallelConfig(data_parallel=dp, model_parallel=mp))
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            make_mesh(ParallelConfig(data_parallel=dp, model_parallel=mp), world=8)
        assert str(got.value) == str(e)
        return
    if mp > 1:
        with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 14"):
            make_mesh(ParallelConfig(data_parallel=dp, model_parallel=mp), world=8)
        return
    mesh = make_mesh(ParallelConfig(data_parallel=dp, model_parallel=mp), world=8)
    assert (mesh.dp, mesh.mp, mesh.world, mesh.rank) == (want.shape["data"],
                                                        want.shape["model"], 8, 0)


def test_model_parallel_cites_the_tp_item():
    with pytest.raises(NotImplementedError) as err:
        make_mesh(ParallelConfig(data_parallel=4, model_parallel=2), world=8)
    assert TP_TODO in str(err.value) and "mesh 4x2" in str(err.value)
    assert single_device_mesh() == Mesh() and make_mesh(ParallelConfig()) == Mesh()


@pytest.mark.parametrize("n, world", [(10, 4), (12, 4), (7, 1), (3, 4)])
def test_zero_slices(n, world):
    """Rank r owns [r s, (r + 1) s) of the vector padded to world s, s =
    ceil(n / world); a slice past the end is zeros."""
    vec = torch.arange(1, n + 1, dtype=torch.float32)
    size = -(-n // world)
    got = []
    for r in range(world):
        shard = Shard(n, Mesh(world=world, rank=r))
        assert (shard.size, shard.lo, shard.hi, shard.padded) == (size, r * size,
                                                                   (r + 1) * size, size * world)
        got.append(shard.take(vec))
        assert got[-1].shape == (size,)
    joined = torch.cat(got)
    assert torch.equal(joined[:n], vec) and not joined[n:].any()
    if world == 1:
        assert Shard(n, Mesh()).gather(got[0]).data_ptr() != vec.data_ptr()
        assert torch.equal(Shard(n, Mesh()).gather(got[0]), vec)


def _steps(tcfg, stage, n_steps=2, mesh=None):
    mesh = mesh or Mesh()
    cfg = dataclasses.replace(tcfg, parallel=ParallelConfig(zero_stage=stage))
    gan = build_gan(cfg, "cpu")
    state = create_train_state(cfg, gan, mesh=mesh if mesh.group is not None else None)
    place_train_state(state, mesh, stage)
    step = make_step_for(cfg, gan, mesh)
    b = {k: torch.from_numpy(v) for k, v in batch(tcfg).items()}
    metrics = []
    for _ in range(n_steps):
        state, m = step(state, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


@pytest.fixture(scope="module")
def tiny(tiny_config):
    return configs(tiny_config, train=dict(r1_gamma=1.0, r1_interval=2))[1]


@pytest.fixture(scope="module")
def stage_zero(tiny):
    """Two one-process steps of `tiny` at zero_stage 0: (state, metrics)."""
    return _steps(tiny, 0)


@pytest.mark.parametrize("stage", [1, 3])
def test_zero_on_one_rank_is_stage_zero(tiny, stage_zero, stage):
    """On one rank a slice is the whole vector: ZeRO keeps stage 0's
    trajectory bit for bit; both stages slice the moments and the EMA
    shadow, and keep the parameters whole (ZeRO-3's parameter sharding
    is not ported)."""
    s0, m0 = stage_zero
    sz, mz = _steps(tiny, stage)
    assert mz == m0
    full = gathered_tensors(sz)
    for k, t in state_tensors(s0).items():
        assert torch.equal(full[k], t), k
    names = set(sharded_tensors(sz))
    assert {"g_opt.mu", "g_opt.nu", "d_opt.mu", "d_opt.nu", "ema_params"} <= names
    assert not {"g_params", "d_params"} & names and sz.zero_stage == stage
    assert sz.g_params.flat.data_ptr() == sz.g_params.padded.data_ptr()
    with pytest.raises(ValueError, match="already sharded"):
        place_train_state(sz, Mesh(), stage)


def test_backend_dispatch(tiny):
    gan = build_gan(tiny, "cpu")
    with pytest.raises(ValueError, match="unknown parallel.backend 'xla'; expected 'gspmd' or "
                                         "'shard_map'"):
        make_step_for(dataclasses.replace(tiny, parallel=ParallelConfig(backend="xla")), gan,
                      Mesh())
    shard_map = dataclasses.replace(tiny, parallel=ParallelConfig(backend="shard_map"))
    with pytest.raises(ValueError, match="shard_map step is DP-only"):
        make_step_for(shard_map, gan, Mesh(mp=2))
    assert make_step_for(shard_map, gan, Mesh()).per_replica
    assert not make_step_for(tiny, gan, Mesh()).per_replica
    with pytest.raises(ValueError, match="zero_stage"):
        ParallelConfig(backend="shard_map", zero_stage=1)
    with pytest.raises(ValueError, match="needs a process group"):
        make_step_for(tiny, gan, Mesh(dp=2, world=2))


@pytest.mark.parametrize("env", [{}, {"NUM_PROCESSES": "1"}, {"WORLD_SIZE": "1"}])
def test_initialize_from_env_is_a_no_op_in_one_process(clean_env, env):
    for k, v in env.items():
        clean_env.setenv(k, v)
    assert distributed.initialize_from_env() is False
    assert not dist.is_initialized()
    assert distributed.world_size() == 1


@pytest.mark.parametrize("env, want", [
    ({"COORDINATOR_ADDRESS": "h:1", "NUM_PROCESSES": "2", "PROCESS_ID": "1"},
     ("tcp://h:1", 2, 1)),
    ({"MASTER_ADDR": "h", "MASTER_PORT": "5", "WORLD_SIZE": "3", "RANK": "2"},
     ("tcp://h:5", 3, 2)),
])
def test_initialize_from_env_reads_both_launchers(clean_env, env, want):
    for k, v in env.items():
        clean_env.setenv(k, v)
    calls = []
    clean_env.setattr(dist, "init_process_group",
                      lambda backend, init_method, world_size, rank: calls.append(
                          (backend, init_method, world_size, rank)))
    assert distributed.initialize_from_env(backend="gloo") is True
    assert calls == [("gloo",) + want]
    assert distributed.world_size() == want[1]  # the launcher's, without a group


def test_initialize_from_env_refuses_what_it_cannot_run(clean_env):
    clean_env.setenv("MASTER_ADDR", "h")
    clean_env.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="this process's index"):
        distributed.initialize_from_env(backend="gloo")
    clean_env.setenv("RANK", "0")
    clean_env.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="backend 'nccl' needs a card"):
        distributed.initialize_from_env(backend="nccl")


@pytest.fixture
def group_of_one(clean_env):
    clean_env.setenv("COORDINATOR_ADDRESS", f"localhost:{free_port()}")
    clean_env.setenv("NUM_PROCESSES", "1")
    clean_env.setenv("PROCESS_ID", "0")
    assert distributed.initialize_from_env(backend="gloo") is True
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_a_group_of_one_runs_the_one_process_step(tiny, stage_zero, group_of_one, tmp_path,
                                                  capsys):
    """Under a gloo group of one rank every collective runs, and the step
    (ZeRO-3 too), `eval --dp` (a narrow conv extractor) and `bench-sample
    --dp` give the one-process results."""
    mesh = make_mesh(ParallelConfig())
    assert mesh.group is not None and (mesh.world, mesh.rank) == (1, 0)
    assert distributed.world_size() == 1
    m0 = stage_zero[1]
    for stage in (0, 3):
        assert _steps(tiny, stage, mesh=mesh)[1] == m0
    tiny_args = ["cifar10_32", "model.base_channels=32", "model.max_channels=32",
                 "model.min_channels=16", "model.latent_dim=16", "model.resolution=16",
                 "data.resolution=16", "data.dataset=synthetic", "train.global_batch=4",
                 "train.compute_dtype=float32", "train.total_steps=2", "train.log_every=2",
                 "train.sample_every=0", "train.checkpoint_every=2", f"workdir={tmp_path}",
                 "--device=cpu"]
    assert cli.main(["train"] + tiny_args) == 0
    capsys.readouterr()
    extractor = str(tmp_path / "convs.npz")
    rng = np.random.default_rng(0)
    np.savez(extractor, w0=rng.normal(size=(3, 3, 3, 8)).astype(np.float32),
             w1=rng.normal(size=(3, 3, 8, 8)).astype(np.float32))
    outs = []
    for flag in ([], ["--dp"]):
        assert cli.main(["eval"] + tiny_args + ["--samples=12", "--prdc-k=2",
                                                f"--extractor={extractor}"] + flag) == 0
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        out.pop("seconds")
        outs.append(out)
    assert outs[0] == outs[1]
    assert cli.main(["bench-sample"] + tiny_args + ["--batch=3", "--steps=1", "--dp"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["devices"] == 1 and line["cuda_graph"] is False


@pytest.mark.parametrize("world, batch, group, match", [
    (3, 8, 0, "global_batch 8 not divisible by 3 hosts"),
    (2, 12, 4, r"minibatch_stddev: batch 6 not divisible by group 4 \(pick mbstd_group "
               "dividing the per-replica batch\\)"),
])
def test_the_loop_refuses_a_batch_the_ranks_cannot_split(tiny, world, batch, group, match):
    """`global_batch % world` and an mbstd group that does not divide a
    rank's batch raise with the JAX package's words (its pipeline's and
    `ops/norm.py:minibatch_stddev`'s) before anything runs."""
    from locate_tpu_torch.train.loop import check_batch

    cfg = dataclasses.replace(
        tiny, model=dataclasses.replace(tiny.model, mbstd_group=group),
        train=dataclasses.replace(tiny.train, global_batch=batch))
    with pytest.raises(ValueError, match=match):
        check_batch(cfg, Mesh(dp=world, world=world))
    check_batch(cfg, Mesh())


def test_sharded_sampler_serves_given_weights(tiny):
    """`ShardedSampler(gan, weights)` serves a copy holding `weights` (the
    live G untouched): one rank's images are `generate_samples`' of a
    serving generator with those weights."""
    from locate_tpu_torch.io.sampling import (ShardedSampler, generate_samples,
                                              serving_generator, serving_weights)

    gan = build_gan(tiny, "cpu")
    state = create_train_state(tiny, gan)
    with torch.no_grad():
        state.ema_params.mul_(0.5)  # the serving weights differ from G's
    live = {k: v.clone() for k, v in gan.generator.state_dict().items()}
    sampler = ShardedSampler(gan, serving_weights(state), Mesh())
    got = sampler(torch.Generator().manual_seed(4), 3)
    want = generate_samples(serving_generator(gan, state), torch.Generator().manual_seed(4), 3)
    assert np.array_equal(got, want)
    assert all(torch.equal(v, gan.generator.state_dict()[k]) for k, v in live.items())
