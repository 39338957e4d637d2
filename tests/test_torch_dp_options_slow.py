"""The train step's options under data parallelism on two gloo CPU ranks
(slow: one JAX shard_map compile a case; `python -m pytest -m slow
tests/test_torch_dp_options_slow.py`). Each "shard_map" case runs two
steps with R1 at step 0 on both ranks (tests/torch_dp_worker.py, one pair
of processes for every case) from a JAX state carried over, with the JAX
shard_map step's own draws handed to each rank: the global batch's rows
of the latents, labels, GP's eps and style mixing's draws, each
replica's own augmentation, bCR and style-noise draws (the key folded
with its axis index), PL's noise and the EMA's bits as every replica
draws them; metrics and parameters are held to the JAX package's
`make_shardmap_train_step` on a 2-device CPU mesh. `r1_batch_fraction`
also runs under "gspmd", held to the one-process port (the global
batch's leading rows, which only rank 0 holds)."""

import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

import torch_step_draws
from locate_tpu.config import StyleConfig as JaxStyleConfig
from locate_tpu.models.gan import build_gan as jax_build_gan
from locate_tpu_torch.config import ParallelConfig
from locate_tpu_torch.models.gan import build_gan
from locate_tpu_torch.train.state import create_train_state, state_from_jax, state_tensors
from test_torch_dp import jax_shard_map, one_process
from torch_dp_worker import finish_ranks, start_ranks
from torch_step_draws import (ADA_TAG, NOISE_TAG, SHIFT_INVARIANT, compare_params, configs,
                              jax_draws, jax_state)

pytestmark = pytest.mark.slow

WORLD, N, STEPS = 2, 4, 2
BASE = dict(r1_gamma=1.0, r1_interval=2)
STYLE = JaxStyleConfig(mapping_layers=2, mixing_prob=0.9, noise="random")
# (name, train overrides, model overrides)
CASES = [
    ("ada", dict(augment_p=0.3, ada_target=0.6), None),
    ("bcr", dict(bcr_gamma=1.0), None),
    ("lecam", dict(lecam_gamma=0.1), None),
    ("feature_matching", dict(feature_matching=1.0), None),
    ("d_steps", dict(d_steps=2), None),
    ("fused", dict(fused_step=True, augment_p=0.2), None),
    ("mbstd", {}, dict(mbstd_group=2)),
    ("ragan", dict(loss="ragan"), None),
    ("r1_batch_fraction", dict(r1_batch_fraction=0.5), None),
    ("style", dict(pl_gamma=2.0, pl_interval=1), dict(arch="style", style=STYLE)),
]
# drawn for the global batch, each rank taking its rows
GLOBAL = ("z_d", "labels_d", "z_g", "labels_g", "gp_eps", "mix_z2_d", "mix_cut_d",
          "mix_z2_g", "mix_cut_g")
CRITIC = ("z_d", "labels_d", "gp_eps", "mix_z2_d", "mix_cut_d")


def noisy_strengths(state):
    """Every `noise_strength` leaf of G at 0.3, so that the noise counts."""
    def put(path, leaf):
        return (jax.numpy.full_like(leaf, 0.3)
                if getattr(path[-1], "key", None) == "noise_strength" else leaf)
    return state.replace(g_params=jax.tree_util.tree_map_with_path(put, state.g_params))


def replica_noise(jcfg, key, n, side, replica):
    """The style noise planes of one replica: the shard_map step folds the
    axis index into the noise key."""
    m, out = jcfg.model, {}
    kn = jax.random.fold_in(jax.random.fold_in(key, NOISE_TAG), replica)
    for i, r in enumerate(m.stage_resolutions()):
        ki = jax.random.fold_in(kn, i)
        for j in range(m.blocks_per_stage):
            out[f"g_noise_{side}.{i}.{j}"] = np.asarray(jax.random.normal(
                jax.random.fold_in(ki, j), (n, r, r, 1), jax.numpy.float32))
    return out


def shard_map_draws(jcfg, jgan, jstate, pstate, local_shape):
    """Each rank's draws of one shard_map step: rows of the global draw,
    the replica's own augmentation (and noise), the rest as drawn."""
    n = local_shape[0]
    whole = jax_draws(jcfg, jgan, jstate, pstate, (n * WORLD,) + tuple(local_shape[1:]))
    d_steps = jcfg.train.d_steps > 1
    out = []
    for r in range(WORLD):
        saved = torch_step_draws._aug_keys
        torch_step_draws._aug_keys = lambda rng, count, r=r: jax.random.split(
            jax.random.fold_in(jax.random.fold_in(rng, ADA_TAG), r), count)
        try:
            local = jax_draws(jcfg, jgan, jstate, pstate, local_shape)
        finally:
            torch_step_draws._aug_keys = saved
        mine = {}
        for k, v in whole.items():
            if k in GLOBAL:
                axis = 1 if d_steps and k in CRITIC else 0
                mine[k] = v.narrow(axis, r * n, n).numpy()
            elif not k.startswith("g_noise_"):
                mine[k] = local[k].numpy()
        if jcfg.model.arch == "style" and jcfg.model.style.noise == "random":
            k_zd, k_zg = jax.random.split(jstate.rng, 5)[1:3]
            mine.update(replica_noise(jcfg, k_zd, n, "d", r))
            mine.update(replica_noise(jcfg, k_zg, n, "g", r))
        out.append(mine)
    return out


def per_rank(images, d_steps):
    axis = 1 if d_steps else 0
    n = images.shape[axis] // WORLD
    return [np.take(images, range(r * n, (r + 1) * n), axis=axis) for r in range(WORLD)]


@pytest.fixture(scope="module")
def cases(tiny_config, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_options")
    runs, refs = {}, {}
    for name, train, model in CASES:
        jcfg, tcfg = configs(tiny_config, train={**BASE, **train}, model=model)
        jgan = jax_build_gan(jcfg)
        jstate = jax_state(jcfg, jgan)
        if name == "style":
            jstate = noisy_strengths(jstate)
        pstate = state_from_jax(jstate, tcfg, build_gan(tcfg, "cpu"))
        tensors = {k: t.clone() for k, t in state_tensors(pstate).items()}
        res = tcfg.model.resolution
        lead = (tcfg.train.d_steps,) if tcfg.train.d_steps > 1 else ()
        images = np.random.default_rng(0).integers(0, 256, lead + (N, res, res, 3),
                                                   dtype=np.uint8)
        draws, s = [[] for _ in range(WORLD)], jstate
        for _ in range(STEPS):
            for r, d in enumerate(shard_map_draws(jcfg, jgan, s, pstate,
                                                  (N // WORLD, res, res, 3))):
                draws[r].append(d)
            s = s.replace(rng=jax.random.split(s.rng, 1)[0])
        # the worker takes list entries as a rank's own: one list a step
        rank_draws = [{k: [draws[r][i][k] for r in range(WORLD)] for k in draws[0][i]}
                      for i in range(STEPS)]
        runs[name] = dict(cfg=dataclasses.replace(tcfg, parallel=ParallelConfig(
            backend="shard_map")), tensors=tensors, images=per_rank(images, lead),
            steps=STEPS, draws=rank_draws)
        refs[name] = (jcfg, jstate, images)
        if name == "r1_batch_fraction":
            runs["gspmd_r1_batch_fraction"] = dict(cfg=tcfg, tensors=tensors, images=images,
                                                   steps=STEPS)
            refs["gspmd_r1_batch_fraction"] = (tcfg, tensors, images)
    procs = start_ranks(dict(runs=runs), tmp, WORLD)
    try:
        want = {}
        for name, ref in refs.items():
            if name.startswith("gspmd"):
                want[name] = one_process(*ref, STEPS)[1:]
            else:
                want[name] = jax_shard_map(ref[0], ref[1], ref[2], STEPS)
    finally:
        ranks = finish_ranks(procs, tmp)
    return dict(ranks=ranks, want=want, runs=runs, refs=refs)


def _metrics_close(got, want, jcfg, rtol=2e-4, atol=1e-5):
    t = jcfg.train
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w), (sorted(g), sorted(w))
        for k in w:
            tol = atol
            if k in ("real_logits", "fake_logits") and t.loss in SHIFT_INVARIANT:
                # D's head bias takes Adam moves of up to lr sqrt(t) at random
                tol += 2 * t.d_opt.lr * sum(math.sqrt(u) for u in range(1, i * t.d_steps + 1))
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=tol,
                                       err_msg=f"step {i} {k}")


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_shard_map_option_equals_the_jax_shard_map_step(cases, name):
    got = [r[name] for r in cases["ranks"]]
    assert got[0]["metrics"] == got[1]["metrics"]
    jcfg, _, _ = cases["refs"][name]
    jfinal, want = cases["want"][name]
    _metrics_close(got[0]["metrics"], want, jcfg)
    cfg = cases["runs"][name]["cfg"]
    pstate = create_train_state(cfg, build_gan(cfg, "cpu"))
    with torch.no_grad():
        for k, t in state_tensors(pstate).items():
            t.copy_(got[0]["state"][k])
    compare_params(pstate, jfinal, steps=STEPS, d_steps=jcfg.train.d_steps,
                   loss=jcfg.train.loss)
    for opt in ("ada_p", "pl_mean", "lecam"):
        w = getattr(jfinal, opt)
        if w is not None:
            np.testing.assert_allclose(got[0]["state"][opt].numpy(), np.asarray(w),
                                       rtol=2e-4, atol=1e-5, err_msg=opt)


def test_gspmd_r1_batch_fraction_takes_the_global_leading_rows(cases):
    """Under "gspmd" R1's rows are the global batch's leading half, all on
    rank 0: the run equals the one-process port."""
    got = [r["gspmd_r1_batch_fraction"] for r in cases["ranks"]]
    assert got[0]["metrics"] == got[1]["metrics"]
    _, want = cases["want"]["gspmd_r1_batch_fraction"]
    jcfg = cases["refs"]["r1_batch_fraction"][0]
    _metrics_close(got[0]["metrics"], want, jcfg, atol=2e-5)
    assert got[0]["metrics"][0]["r1"] > 0


def test_dryrun_multichip_on_two_ranks():
    """`python -m locate_tpu_torch.parallel.dryrun`'s function: two gloo
    ranks, both backends, every metric the one-process run's."""
    from locate_tpu_torch.parallel.dryrun import BACKENDS, dryrun_multichip

    out = dryrun_multichip(2)
    assert set(out) == {b for b, _ in BACKENDS} and all(len(v) == 2 for v in out.values())
