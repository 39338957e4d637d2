"""The port's in-training eval against the JAX loop's, on the CPU at the
`tiny_config` widths in float32 (slow: the JAX step's jit compile and
the JAX eval on the 8 test devices' mesh). Both loops start from one JAX
init (the port resumes from it saved as a port checkpoint at step 0,
through `state_from_jax`) and take JAX's latents at each step, as in
tests/test_torch_loop_parity.py; with `eval_every=2`, each eval's
eval_rfid and eval_rkid agree within 1e-3, and best.json names the same
step."""

import dataclasses
import json
import os

import numpy as np
import jax
import pytest

from locate_tpu.models.gan import build_gan as jax_build_gan
from locate_tpu.train.loop import train as jax_train
from locate_tpu.train.state import create_train_state as jax_create_train_state
from locate_tpu_torch.io.checkpoint import CheckpointManager
from locate_tpu_torch.models.gan import build_gan
from locate_tpu_torch.train import loop
from locate_tpu_torch.train.state import state_from_jax
from locate_tpu_torch.train.step import make_train_step
from test_torch_loop_parity import LOOP_BATCH, JaxDraws, two_threads  # noqa: F401
from test_torch_train_step import configs

STEPS = 4


@pytest.mark.slow
def test_in_training_eval_matches_the_jax_loop(tiny_config, tmp_path, monkeypatch):
    jcfg, tcfg = configs(tiny_config, False)
    tr = dict(log_every=2, sample_every=0, checkpoint_every=0, total_steps=STEPS,
              global_batch=LOOP_BATCH, eval_every=2, eval_samples=64)
    jcfg = dataclasses.replace(jcfg, workdir=str(tmp_path / "jax"),
                               train=dataclasses.replace(jcfg.train, **tr))
    tcfg = dataclasses.replace(tcfg, use_pallas=True, workdir=str(tmp_path / "port"),
                               train=dataclasses.replace(tcfg.train, **tr))

    jgan = jax_build_gan(jcfg)
    init = jax_create_train_state(jcfg, jgan, jax.random.PRNGKey(jcfg.train.seed))
    draws, rng = [], init.rng
    for _ in range(STEPS):
        _, k_zd, k_zg, _, _ = jax.random.split(rng, 5)
        draws.append([np.asarray(jgan.sample_latents(k, LOOP_BATCH)) for k in (k_zd, k_zg)])
        rng = jax.random.split(rng, 1)[0]
    jax_scores = {}
    jax_train(jcfg, hooks={"on_eval": lambda s, sc: jax_scores.setdefault(s, sc)})

    gan = build_gan(tcfg, device="cpu")
    CheckpointManager(os.path.join(tcfg.workdir, "checkpoints")).save(
        state_from_jax(init, tcfg, gan))
    monkeypatch.setattr(loop, "make_train_step",
                        lambda cfg, gan: JaxDraws(make_train_step(cfg, gan), draws))
    port_scores = {}
    loop.train(tcfg, hooks={"on_eval": lambda s, sc: port_scores.setdefault(s, sc)},
               device="cpu")

    assert sorted(port_scores) == sorted(jax_scores) == [2, 4]
    for step, want in jax_scores.items():
        got = port_scores[step]
        for k in ("fid", "kid"):
            assert abs(got[k] - want[k]) <= 1e-3 * abs(want[k]), (step, k, got[k], want[k])
    bests = []
    for cfg in (jcfg, tcfg):
        with open(os.path.join(cfg.workdir, "best.json")) as f:
            bests.append(json.load(f))
    assert bests[0]["step"] == bests[1]["step"]
    np.testing.assert_allclose(bests[1]["fid"], bests[0]["fid"], rtol=1e-3)
