"""The port's data parallelism on two gloo CPU ranks (tests/torch_dp_worker.py,
two subprocesses started once for the module): the "gspmd" step against
the one-process port, the "shard_map" step (and top-k G training) against
the JAX package's `make_shardmap_train_step` on a 2-device CPU mesh with
the same weights (`state_from_jax`) and JAX's draws, ZeRO-1 and ZeRO-3
against stage 0, a ZeRO-1 resume against the straight run and a 2-rank
checkpoint restored at world size 1, `ShardedSampler` against
`generate_samples`, the data-parallel eval against the one-process eval,
and `train()` on two ranks against the one-process loop."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from locate_tpu.config import ParallelConfig as JaxParallelConfig
from locate_tpu.models.gan import build_gan as jax_build_gan
from locate_tpu.parallel.mesh import make_mesh as jax_make_mesh
from locate_tpu.parallel.sharding import make_shardmap_train_step
from locate_tpu.parallel.sharding import place_train_state as jax_place_train_state
from locate_tpu_torch.cli import state_bytes_per_device
from locate_tpu_torch.config import ParallelConfig
from locate_tpu_torch.data.datasets import make_dataset
from locate_tpu_torch.io.checkpoint import CheckpointManager
from locate_tpu_torch.io.fid import RandomConvFeatures, evaluate_generator
from locate_tpu_torch.io.sampling import generate_samples
from locate_tpu_torch.models.gan import build_gan
from locate_tpu_torch.train.loop import train
from locate_tpu_torch.train.state import create_train_state, state_from_jax, state_tensors
from locate_tpu_torch.train.step import make_train_step
from torch_port_parity import rel_err
from torch_dp_worker import finish_ranks, start_ranks
from torch_step_draws import compare_params, configs, jax_draws, jax_state

WORLD, N, STEPS = 2, 4, 2
TRAIN = dict(r1_gamma=1.0, r1_interval=2)  # R1 fires at step 0
EVAL = dict(n_samples=13, batch=8, seed=3, prdc_k=3)
SAMPLE_COUNTS = (5, 4)  # 5 pads a row on two ranks
TIMING = ("images_per_sec", "sec_per_step")


def _parallel(cfg, **kw):
    return dataclasses.replace(cfg, parallel=ParallelConfig(**kw))


def one_process(tcfg, tensors, images, steps, draws=None):
    """`steps` steps of the port's one-process step from `tensors`."""
    gan = build_gan(tcfg, "cpu", seed=tcfg.train.seed)
    state = create_train_state(tcfg, gan, seed=tcfg.train.seed)
    with torch.no_grad():
        for k, t in state_tensors(state).items():
            t.copy_(tensors[k])
    step = make_train_step(tcfg, gan)
    out = []
    for i in range(steps):
        given = {k: torch.as_tensor(v) for k, v in draws[i].items()} if draws else {}
        state, m = step(state, {"image": torch.from_numpy(images)}, **given)
        out.append({k: float(v) for k, v in m.items()})
    return gan, state, out


def jax_shard_map(jcfg, jstate, images, steps):
    """The JAX package's shard_map step on a 2-device CPU mesh: each step's
    metrics and the final state."""
    jcfg = dataclasses.replace(jcfg, parallel=JaxParallelConfig(data_parallel=WORLD,
                                                                backend="shard_map"))
    lead = (jcfg.train.d_steps,) if jcfg.train.d_steps > 1 else ()
    mesh = jax_make_mesh(jcfg.parallel, devices=jax.devices()[:WORLD])
    jgan = jax_build_gan(jcfg)
    with mesh:
        step_for, shardings_for, b_shard = make_shardmap_train_step(jcfg, jgan, mesh)
        # a copy: the step donates its input state's buffers
        jstate = jax.tree.map(lambda x: jnp.array(x, copy=True), jstate)
        state = jax_place_train_state(jstate, shardings_for(jstate))
        step = step_for(state)
        batch = jax.device_put({"image": jnp.asarray(images),
                                "label": jnp.zeros(images.shape[:len(lead) + 1], jnp.int32)},
                               {"image": b_shard, "label": b_shard})
        out = []
        for _ in range(steps):
            state, m = step(state, batch)
            out.append({k: float(v) for k, v in m.items()})
    return jax.device_get(state), out


@pytest.fixture(scope="module")
def dp(tiny_config, tmp_path_factory):
    """Start both ranks on every case, compute the JAX and one-process
    references meanwhile, and return everything."""
    tmp = tmp_path_factory.mktemp("dp")
    jcfg, tcfg = configs(tiny_config, train=TRAIN)
    jcfg_k, tcfg_k = configs(tiny_config, train=dict(TRAIN, topk_fraction=0.5))
    jgan = jax_build_gan(jcfg)
    jstate = jax_state(jcfg, jgan)
    gan = build_gan(tcfg, "cpu")
    pstate = state_from_jax(jstate, tcfg, gan)
    tensors = {k: t.clone() for k, t in state_tensors(pstate).items()}
    res = tcfg.model.resolution
    images = np.random.default_rng(0).integers(0, 256, (N, res, res, 3), dtype=np.uint8)
    # JAX's draws of the shard_map step (the global batch's latents; the
    # replicated key moves by one split a step)
    draws, s = [], jstate
    for _ in range(STEPS):
        draws.append({k: v.numpy() for k, v in jax_draws(jcfg, jgan, s, pstate,
                                                          images.shape).items()})
        s = s.replace(rng=jax.random.split(s.rng, 1)[0])
    runs = {name: dict(cfg=_parallel(cfg, backend=backend, zero_stage=zero), tensors=tensors,
                       images=images, steps=STEPS, draws=d)
            for name, cfg, backend, zero, d in (
                ("gspmd", tcfg, "gspmd", 0, None), ("zero1", tcfg, "gspmd", 1, None),
                ("zero3", tcfg, "gspmd", 3, None), ("shard_map", tcfg, "shard_map", 0, draws),
                ("topk", tcfg_k, "shard_map", 0, draws))}
    loop_cfg = dataclasses.replace(
        tcfg, workdir=str(tmp / "loop_dp"),
        data=dataclasses.replace(tcfg.data, dataset="synthetic", random_flip=False),
        train=dataclasses.replace(tcfg.train, total_steps=4, log_every=2, sample_every=0,
                                  checkpoint_every=0))
    inputs = dict(runs=runs, loop=loop_cfg, sample_counts=SAMPLE_COUNTS, eval=EVAL,
                  resume=dict(cfg=_parallel(tcfg, zero_stage=1), tensors=tensors,
                              images=images, dir=str(tmp / "ckpt")))
    procs = start_ranks(inputs, tmp, WORLD)
    try:
        ref = dict(
            jax={name: jax_shard_map(j, jstate, images, STEPS)
                 for name, j in (("shard_map", jcfg), ("topk", jcfg_k))},
            one=one_process(tcfg, tensors, images, STEPS),
            loop_cfg=dataclasses.replace(loop_cfg, workdir=str(tmp / "loop_one")))
        train(ref["loop_cfg"], device="cpu")
    finally:
        ranks = finish_ranks(procs, tmp)
    return dict(ranks=ranks, ref=ref, inputs=inputs, tcfg=tcfg, jstate=jstate, gan=gan)


def _close(got, want, rtol, atol, what):
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w), (what, sorted(g), sorted(w))
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=atol,
                                       err_msg=f"{what} step {i} {k}")


def test_gspmd_equals_one_process_on_every_rank(dp):
    r0, r1 = (r["gspmd"] for r in dp["ranks"])
    assert dp["ranks"][0]["world"] == WORLD
    assert r0["metrics"] == r1["metrics"]  # every metric bitwise on both ranks
    assert r0["metrics"][0]["r1"] > 0 and r0["metrics"][1]["r1"] == 0
    _, one, want = dp["ref"]["one"]
    _close(r0["metrics"], want, 2e-4, 2e-5, "gspmd")
    for net, flat in (("g", one.g_params), ("d", one.d_params)):
        got, ref = flat.named(r0["state"][f"{net}_params"]), flat.named(flat.flat)
        for name, w in ref.items():
            if name.endswith("to_logits.b"):
                # a softmax gate's logit bias: its gradient is rounding noise
                # around 0, which Adam (beta1 0) turns into moves of up to
                # lr sqrt(t) a step
                bound = 2 * dp["tcfg"].train.g_opt.lr * (1 + 2 ** 0.5)
                assert (got[name] - w).abs().max() <= bound * 1.01, (net, name)
            else:
                assert rel_err(got[name].numpy(), w.numpy()) < 1e-3, (net, name)


@pytest.mark.parametrize("name", ["shard_map", "topk"])
def test_shard_map_equals_the_jax_shard_map_step(dp, name):
    """Two steps with R1 at step 0 against `make_shardmap_train_step` on a
    2-device mesh (top-k at topk_fraction 0.5: the threshold from every
    rank's gathered fake logits, the mask count summed), metrics at the
    model-parity tolerance, parameters as the one-process parity does."""
    jfinal, want = dp["ref"]["jax"][name]
    got = dp["ranks"][0][name]
    assert got["metrics"] == dp["ranks"][1][name]["metrics"]
    _close(got["metrics"], want, 2e-4, 1e-5, name)
    cfg = dp["inputs"]["runs"][name]["cfg"]
    gan = build_gan(cfg, "cpu")
    pstate = create_train_state(cfg, gan)
    with torch.no_grad():
        for k, t in state_tensors(pstate).items():
            t.copy_(got["state"][k])
    compare_params(pstate, jfinal, steps=STEPS)


@pytest.mark.parametrize("stage", [1, 3])
def test_zero_equals_stage_zero(dp, stage):
    """ZeRO splits stage 0's arithmetic elementwise: the same metrics and
    the same (gathered) state, bit for bit; the slices are info's sizes."""
    base = dp["ranks"][0]["gspmd"]
    for rank in dp["ranks"]:
        run = rank[f"zero{stage}"]
        assert run["metrics"] == base["metrics"]
        for k, t in base["state"].items():
            assert torch.equal(run["state"][k], t), k
    sizes = dp["ranks"][0][f"zero{stage}"]["bytes"]
    kept = sum(v for k, v in sizes.items() if k.endswith(("params", ".mu", ".nu")))
    n_g, n_d = (p.flat.numel() for p in (create_train_state(dp["tcfg"], dp["gan"]).g_params,
                                         create_train_state(dp["tcfg"], dp["gan"]).d_params))
    want = state_bytes_per_device(n_g, n_d, dp["tcfg"].train, WORLD, stage)
    assert abs(kept - want) <= 4 * 7 * (WORLD - 1)  # each slice rounds up to whole elements


def test_zero1_resume_is_bitwise(dp):
    for rank in dp["ranks"]:
        run = rank["resume"]
        assert run["first"] + run["then"] == run["straight"]
        for k, t in run["at_save"].items():
            assert torch.equal(run["restored"][k], t), k


def test_two_rank_checkpoint_restores_at_world_one(dp, tmp_path):
    tcfg = dp["tcfg"]
    gan = build_gan(tcfg, "cpu")
    state = create_train_state(tcfg, gan)
    CheckpointManager(dp["inputs"]["resume"]["dir"]).restore(state)
    assert state.step == 2
    for k, t in state_tensors(state).items():
        assert torch.equal(t, dp["ranks"][0]["resume"]["at_save"][k]), k


def test_sharded_sampler_equals_generate_samples(dp):
    gan = build_gan(dp["tcfg"], "cpu")
    with torch.no_grad():
        gan.generator.load_state_dict(dp["gan"].generator.state_dict())
    gen = torch.Generator().manual_seed(3)
    for count, got, other in zip(SAMPLE_COUNTS, dp["ranks"][0]["samples"],
                                 dp["ranks"][1]["samples"]):
        want = generate_samples(gan.generator, gen, count)
        assert other is None and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_dp_eval_equals_one_process(dp):
    arrays = {}
    want = evaluate_generator(dp["gan"].generator, make_dataset(dp["tcfg"].data),
                              extractor=RandomConvFeatures(width=8, device="cpu"), out=arrays,
                              **EVAL)
    got = dp["ranks"][0]["eval"]
    assert dp["ranks"][1]["eval"] == got
    for k in ("fake_features", "real_features"):
        np.testing.assert_allclose(dp["ranks"][0]["eval_arrays"][k], arrays[k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(got["fid"], want["fid"], rtol=1e-3)
    np.testing.assert_allclose(got["kid"], want["kid"], rtol=1e-2, atol=1e-4)
    for k in ("precision", "recall", "density", "coverage"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-6)


def test_loop_writes_on_rank_zero_and_equals_one_process(dp):
    def records(workdir):
        with open(os.path.join(workdir, "metrics.jsonl")) as f:
            return [{k: v for k, v in json.loads(line).items() if k not in TIMING}
                    for line in f]

    got = records(dp["inputs"]["loop"].workdir)
    want = records(dp["ref"]["loop_cfg"].workdir)
    assert [r["step"] for r in got] == [2, 4]  # one writer: no record twice
    assert os.path.exists(os.path.join(dp["inputs"]["loop"].workdir, "config.json"))
    _close(got, want, 2e-4, 2e-5, "loop")
