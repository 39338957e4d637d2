"""The port's alternating train step against the JAX package's, on the CPU
in float32 at the `tiny_config` widths with the flagship recipe's guards
(R1 gamma 1 firing at step 0, grad_norm_limit 1e6, non-finite skips 200).

Both start from one JAX `create_train_state` (zero-init leaves filled so
the gates and biases move), carried over by `state_from_jax`; the port
takes JAX's latents, which the test draws as the JAX step does
(`jax.random.split(state.rng, 5)`, `gan.sample_latents`). Two steps.
Metrics agree to 1e-4 relative (1e-5 absolute); G, D and EMA params after
each step to 1e-3 norm-relative per leaf: Adam's first steps are close to
lr * sign(g), so an element whose |g| sits near eps may flip, and only
whole leaves compare meaningfully. The softmax gates' logit biases have a
gradient that is rounding noise around 0 (the softmax is shift
invariant), so theirs is held to the Adam moves instead: at most 2 lr
per step apart."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from locate_tpu.models.gan import build_gan as jax_build_gan
from locate_tpu.objectives.ema import ema_init as jax_ema_init
from locate_tpu.train.state import create_train_state as jax_create_train_state
from locate_tpu.train.step import make_train_step as jax_make_train_step
from locate_tpu_torch.models.gan import build_gan
from locate_tpu_torch.train.state import create_train_state, state_from_jax
from locate_tpu_torch.train.step import make_train_step
from torch_port_parity import as_state_dict, port_config, randomize_zero_init, rel_err

BATCH = 4


def configs(tiny_config, use_pallas):
    attn = dataclasses.replace(tiny_config.model.attention, gate_max=16.0)
    jcfg = dataclasses.replace(
        tiny_config, use_pallas=use_pallas,
        model=dataclasses.replace(tiny_config.model, attention=attn, blocks_per_stage=2),
        train=dataclasses.replace(tiny_config.train, global_batch=BATCH, r1_gamma=1.0,
                                  grad_norm_limit=1e6, max_nonfinite_skips=200))
    return jcfg, port_config(jcfg)


def jax_state(jcfg, jgan):
    state = jax_create_train_state(jcfg, jgan, jax.random.PRNGKey(0))
    g = randomize_zero_init(state.g_params, jax.random.PRNGKey(1))
    d = randomize_zero_init(state.d_params, jax.random.PRNGKey(2))
    return state.replace(g_params=g, d_params=d, ema_params=jax_ema_init(g))


def batch():
    rng = np.random.default_rng(0)
    return {"image": rng.integers(0, 256, (BATCH, 16, 16, 3), dtype=np.uint8),
            "label": np.zeros(BATCH, np.int32)}


def jax_latents(jgan, state):
    """z_d and z_g exactly as the JAX alternating step draws them."""
    _, k_zd, k_zg, _, _ = jax.random.split(state.rng, 5)
    return (np.asarray(jgan.sample_latents(k_zd, BATCH)),
            np.asarray(jgan.sample_latents(k_zg, BATCH)))


def compare_params(port_state, jstate, steps, lr=2e-4):
    for part, port, want in (("g", port_state.g_params.named(port_state.g_params.flat),
                              jstate.g_params),
                             ("d", port_state.d_params.named(port_state.d_params.flat),
                              jstate.d_params),
                             ("ema", port_state.g_params.named(port_state.ema_params),
                              jstate.ema_params)):
        want = as_state_dict(want)
        assert set(port) == set(want), part
        for name, w in want.items():
            got = port[name].numpy()
            if name.endswith("to_logits.b"):
                # a softmax gate's logit-bias gradient is ~0 up to rounding
                # noise, so Adam moves each element by about +-lr at random:
                # bound the difference by those moves instead
                assert np.abs(got - w).max() <= 2 * lr * steps * 1.01, (part, name)
            else:
                assert rel_err(got, w) < 1e-3, (part, name)


def jax_steps(jcfg, steps=2):
    """The jitted JAX step's states (the first one `jax_state`'s) and
    metrics over `steps` steps on `batch()`, with the latents it drew at
    each."""
    jgan = jax_build_gan(jcfg)
    states, metrics, latents = [jax_state(jcfg, jgan)], [], []
    jstep = jax.jit(jax_make_train_step(jcfg, jgan))
    b = {k: jnp.asarray(v) for k, v in batch().items()}
    for _ in range(steps):
        latents.append(jax_latents(jgan, states[-1]))
        jstate, jm = jstep(states[-1], b)
        states.append(jstate)
        metrics.append(jm)
    return states, metrics, latents


@pytest.fixture(scope="module")
def xla_steps(tiny_config):
    """Two steps of the JAX step on its XLA composition, one compile for
    the tests that hold the port to it."""
    return jax_steps(configs(tiny_config, False)[0])


def run_parity(tiny_config, use_pallas, jax_interpret, xla=None):
    """Two port steps on JAX's draws against two JAX steps: the XLA
    composition's (`xla`, from the `xla_steps` fixture) or, with
    `jax_interpret`, the Pallas kernels' in interpret mode."""
    jcfg, tcfg = configs(tiny_config, jax_interpret)
    states, metrics, latents = jax_steps(jcfg) if xla is None else xla
    tcfg = dataclasses.replace(tcfg, use_pallas=use_pallas)
    gan = build_gan(tcfg, device="cpu")
    pstate = state_from_jax(states[0], tcfg, gan)
    step = make_train_step(tcfg, gan)
    tb = {k: torch.from_numpy(v) for k, v in batch().items()}
    for i in range(2):
        (z_d, z_g), jstate, jm = latents[i], states[i + 1], metrics[i]
        pstate, pm = step(pstate, tb, z_d=torch.from_numpy(z_d), z_g=torch.from_numpy(z_g))
        assert set(pm) == set(jm), (sorted(pm), sorted(jm))
        for k in jm:
            np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-4, atol=1e-5,
                                       err_msg=f"step {i} {k}")
        assert pstate.step == int(jstate.step) == i + 1
        compare_params(pstate, jstate, steps=i + 1)
    assert float(jm["r1"]) == 0.0  # lazy R1 fired at step 0 only
    return pm


def test_two_steps_match_jax(tiny_config, xla_steps):
    """The port with its gate Function (use_pallas) and the JAX step on its
    XLA composition (use_pallas=False)."""
    metrics = run_parity(tiny_config, use_pallas=True, jax_interpret=False, xla=xla_steps)
    assert float(metrics["d_grad_limit_count"]) == 0.0


@pytest.mark.slow
def test_two_steps_match_jax_pallas_interpret(tiny_config):
    """Both on their kernel paths: the JAX step runs its Pallas kernels in
    interpret mode (several minutes of compile on the CPU, hence slow)."""
    run_parity(tiny_config, use_pallas=True, jax_interpret=True)


def test_state_from_jax_carries_the_whole_state(tiny_config, xla_steps):
    _, tcfg = configs(tiny_config, False)
    jstate = xla_steps[0][1]
    pstate = state_from_jax(jstate, tcfg, build_gan(tcfg, device="cpu"))
    assert pstate.step == 1
    compare_params(pstate, jstate, steps=0)
    adam = jstate.d_opt_state.inner_state.inner_state[0]
    named = pstate.d_params.named(pstate.d_opt_state.nu)
    for name, want in as_state_dict(adam.nu).items():
        np.testing.assert_array_equal(named[name].numpy(), want)
    assert int(pstate.d_opt_state.count) == int(adam.count) == 1
    assert int(pstate.g_opt_state.toolarge_count) == int(jstate.g_opt_state.toolarge_count)


def test_step_is_deterministic(tiny_config):
    _, tcfg = configs(tiny_config, True)
    out = []
    for _ in range(2):
        gan = build_gan(tcfg, device="cpu", seed=3)
        state = create_train_state(tcfg, gan, seed=4)
        state, metrics = make_train_step(tcfg, gan)(
            state, {k: torch.from_numpy(v) for k, v in batch().items()})
        out.append((state.g_params.flat, state.d_params.flat, state.ema_params,
                    metrics["d_loss"]))
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_ema_and_params_move(tiny_config):
    _, tcfg = configs(tiny_config, True)
    gan = build_gan(tcfg, device="cpu")
    state = create_train_state(tcfg, gan)
    g0, d0, e0 = (t.clone() for t in (state.g_params.flat, state.d_params.flat,
                                      state.ema_params))
    state, metrics = make_train_step(tcfg, gan)(
        state, {k: torch.from_numpy(v) for k, v in batch().items()})
    for before, after in ((g0, state.g_params.flat), (d0, state.d_params.flat),
                          (e0, state.ema_params)):
        assert float((after - before).abs().max()) > 0
    assert float(metrics["r1"]) > 0
    # the modules read the updated buffers
    assert gan.generator.seed.w.data_ptr() == state.g_params.flat.data_ptr()
