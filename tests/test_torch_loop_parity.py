"""The port's train loop and checkpoints against the JAX package's, on the
CPU at the `tiny_config` widths in float32 (slow: each test jit-compiles
the JAX step, 15-30 s on one host core).

Four loop steps: both loops start from one JAX init (the JAX loop's own;
the port resumes from it saved as a port checkpoint at step 0 through
`state_from_jax`), take their batches from their own input pipelines
(equal since the data slice) and the port's step takes JAX's latents (a
test-only wrapper draws them as the JAX step does: `split(rng, 5)`, then
`rng = split(rng, 1)[0]`). Params and the logged metrics agree within
2e-4. A JAX orbax checkpoint, restored by the JAX package and carried
over, continues in the port as the JAX step does."""

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from locate_tpu.io.checkpoint import CheckpointManager as JaxCheckpointManager
from locate_tpu.models.gan import build_gan as jax_build_gan
from locate_tpu.train.loop import train as jax_train
from locate_tpu.train.state import create_train_state as jax_create_train_state
from locate_tpu.train.step import make_train_step as jax_make_train_step
from locate_tpu_torch.io.checkpoint import CheckpointManager
from locate_tpu_torch.models.gan import build_gan
from locate_tpu_torch.train import loop
from locate_tpu_torch.train.state import create_train_state, state_from_jax
from locate_tpu_torch.train.step import make_train_step
from test_torch_train_step import batch, compare_params, configs, jax_latents
from torch_port_parity import as_state_dict, rel_err

TIMING = ("images_per_sec", "sec_per_step")
STEPS = 4
LOOP_BATCH = 8


@pytest.fixture(autouse=True)
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


class JaxDraws:
    """The port's step fed the latents the JAX step draws at each step."""

    def __init__(self, step, draws):
        self.step, self.draws = step, draws

    def __call__(self, state, batch):
        z_d, z_g = self.draws[state.step]
        return self.step(state, batch, z_d=torch.tensor(z_d), z_g=torch.tensor(z_g))


@pytest.mark.slow
def test_four_loop_steps_match_the_jax_loop(tiny_config, tmp_path, monkeypatch):
    jcfg, tcfg = configs(tiny_config, False)
    # one batch row a device of the JAX loop's mesh (the 8 test devices)
    tr = dict(log_every=2, sample_every=0, checkpoint_every=0, total_steps=STEPS,
              global_batch=LOOP_BATCH)
    jcfg = dataclasses.replace(jcfg, workdir=str(tmp_path / "jax"),
                               train=dataclasses.replace(jcfg.train, **tr))
    tcfg = dataclasses.replace(tcfg, use_pallas=True, workdir=str(tmp_path / "port"),
                               train=dataclasses.replace(tcfg.train, **tr))
    assert jcfg.data.dataset == "synthetic"

    jgan = jax_build_gan(jcfg)
    init = jax_create_train_state(jcfg, jgan, jax.random.PRNGKey(jcfg.train.seed))
    draws, rng = [], init.rng
    for _ in range(STEPS):
        _, k_zd, k_zg, _, _ = jax.random.split(rng, 5)
        draws.append([np.asarray(jgan.sample_latents(k, LOOP_BATCH)) for k in (k_zd, k_zg)])
        rng = jax.random.split(rng, 1)[0]
    jax_logged = {}
    jstate = jax_train(jcfg, hooks={"on_metrics": lambda s, m: jax_logged.setdefault(s, m)})

    gan = build_gan(tcfg, device="cpu")
    CheckpointManager(os.path.join(tcfg.workdir, "checkpoints")).save(
        state_from_jax(init, tcfg, gan))
    monkeypatch.setattr(loop, "make_train_step",
                        lambda cfg, gan: JaxDraws(make_train_step(cfg, gan), draws))
    port_logged = {}
    pstate = loop.train(tcfg, hooks={"on_metrics": lambda s, m: port_logged.setdefault(s, m)},
                        device="cpu")

    assert pstate.step == int(jstate.step) == STEPS
    assert sorted(port_logged) == sorted(jax_logged) == [2, 4]
    for step, want in jax_logged.items():
        got = port_logged[step]
        assert set(got) == set(want)
        for k in set(want) - set(TIMING):
            np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=2e-4,
                                       err_msg=f"step {step} {k}")
    assert jax_logged[2]["r1_last_fire"] > 0  # R1 fired at step 0
    for part, flat, tree in (("g", pstate.g_params.flat, jstate.g_params),
                             ("d", pstate.d_params.flat, jstate.d_params),
                             ("ema", pstate.ema_params, jstate.ema_params)):
        params = pstate.d_params if part == "d" else pstate.g_params
        got = params.named(flat)
        for name, want in as_state_dict(tree).items():
            if name.endswith("to_logits.b"):
                # a softmax gate's logit-bias gradient is rounding noise
                # around 0: Adam moves it by about +-lr a step either way
                assert np.abs(got[name].numpy() - want).max() <= 2 * 2e-4 * STEPS * 1.01
            else:
                assert rel_err(got[name].numpy(), want) < 2e-4, (part, name)


@pytest.mark.slow
def test_jax_orbax_checkpoint_continues_in_the_port(tiny_config, tmp_path):
    """A JAX state saved by orbax and restored by the JAX package, carried
    over by `state_from_jax` and through a port checkpoint: the port's
    next step on JAX's draws matches the JAX step from the restored state
    (the tolerances of tests/test_torch_train_step.py; R1 off, which that
    file covers, to keep the jit compile short)."""
    jcfg, tcfg = configs(tiny_config, False)
    jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(jcfg.train, r1_gamma=0.0))
    tcfg = dataclasses.replace(tcfg, use_pallas=True,
                               train=dataclasses.replace(tcfg.train, r1_gamma=0.0))
    jgan = jax_build_gan(jcfg)
    mgr = JaxCheckpointManager(str(tmp_path / "orbax"))
    mgr.save(jax_create_train_state(jcfg, jgan, jax.random.PRNGKey(0)), step=3)
    mgr.wait()
    restored = jax.device_get(mgr.restore(jax_create_train_state(jcfg, jgan,
                                                                 jax.random.PRNGKey(9))))
    mgr.close()

    gan = build_gan(tcfg, device="cpu")
    pstate = state_from_jax(restored, tcfg, gan)
    port_mgr = CheckpointManager(str(tmp_path / "port"))
    port_mgr.save(pstate, step=3)
    pstate = create_train_state(tcfg, gan, seed=3)
    port_mgr.restore(pstate)
    assert pstate.step == 0 and port_mgr.latest_step() == 3
    z_d, z_g = jax_latents(jgan, restored)
    host_batch = {k: torch.from_numpy(v) for k, v in batch().items()}
    jnext, jm = jax.jit(jax_make_train_step(jcfg, jgan))(
        restored, {k: jnp.asarray(v) for k, v in batch().items()})
    pnext, pm = make_train_step(tcfg, gan)(pstate, host_batch, z_d=torch.tensor(z_d),
                                          z_g=torch.tensor(z_g))
    for k in jm:
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-4, atol=1e-5, err_msg=k)
    assert pnext.step == int(jnext.step) == 1
    compare_params(pnext, jnext, steps=1)
