"""The port's several-steps-a-call train step (`train/step.py:make_multi_step`,
the counterpart of the JAX package's) on the CPU, in float32 at the
`tiny_config` widths with the flagship recipe's guards.

On the CPU a call runs its k steps one by one (on the card they are
replays of a CUDA graph of one step, `train/graph.py`; chip_smoke.py holds
that against eager steps). Here: k steps in one call equal k single calls
bit for bit (params, both optimizer states with the guard counters, EMA,
step, the generator's state), with lazy R1 falling inside a call too; the
call's metrics reduce as `_LAST_METRICS` says; a k = 2 call fed JAX's
latents matches `jax.jit(make_multi_step(step, 2))` to the tolerances of
tests/test_torch_train_step.py; and the body a graph captures keeps every
state tensor at its address and equals the plain step bit for bit."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from locate_tpu.models.gan import build_gan as jax_build_gan
from locate_tpu.train.step import _LAST_METRICS as JAX_LAST_METRICS
from locate_tpu.train.step import make_multi_step as jax_make_multi_step
from locate_tpu.train.step import make_train_step as jax_make_train_step
from locate_tpu_torch.models.gan import build_gan
from locate_tpu_torch.train.graph import StepGraphs
from locate_tpu_torch.train.state import (create_train_state, restore, snapshot,
                                          state_from_jax, state_tensors)
from locate_tpu_torch.train.step import (_LAST_METRICS, MultiStep, make_multi_step,
                                         make_train_step, reduce_metrics)
from test_torch_train_step import (BATCH, batch, compare_params, configs, jax_latents,
                                   jax_state)

K = 3


@pytest.fixture(autouse=True)
def two_threads():
    """Tiny steps on the CPU, beside other test workers: two threads each
    keep the workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def stacked_batches(k, seed=0):
    rng = np.random.default_rng(seed)
    return {"image": rng.integers(0, 256, (k, BATCH, 16, 16, 3), dtype=np.uint8),
            "label": np.zeros((k, BATCH), np.int32)}


def port(tiny_config, **train):
    _, tcfg = configs(tiny_config, False)
    tcfg = dataclasses.replace(tcfg, use_pallas=True,
                               train=dataclasses.replace(tcfg.train, **train))
    gan = build_gan(tcfg, device="cpu", seed=3)
    return gan, create_train_state(tcfg, gan, seed=4), make_train_step(tcfg, gan)


def values(state):
    return ({k: t.clone() for k, t in state_tensors(state).items()}, state.step,
            state.rng.get_state())


def assert_same(a, b):
    assert a[0].keys() == b[0].keys()
    for k in a[0]:
        assert torch.equal(a[0][k], b[0][k]), k
    assert a[1] == b[1] and torch.equal(a[2], b[2])


@pytest.mark.parametrize("r1_interval", [16, 2])
def test_k_steps_in_one_call_equal_k_calls(tiny_config, r1_interval):
    """k = 3 in one call against 3 single calls from one state; with R1
    every 2 steps it fires at steps 0 and 2, inside the call."""
    _, state, step = port(tiny_config, r1_interval=r1_interval)
    batches = {k: torch.from_numpy(v) for k, v in stacked_batches(K).items()}
    saved = snapshot(state)
    state, metrics = make_multi_step(step, K)(state, batches)
    multi = values(state)
    restore(state, saved)
    history = []
    for i in range(K):
        state, m = step(state, {k: v[i] for k, v in batches.items()})
        history.append(m)
    assert_same(multi, values(state))
    assert state.step == K
    r1 = [float(m["r1"]) for m in history]
    assert [v > 0 for v in r1] == [i % r1_interval == 0 for i in range(K)]
    want = reduce_metrics({k: torch.stack([m[k] for m in history]) for k in history[0]})
    assert metrics.keys() == want.keys()
    for k in want:
        assert torch.equal(metrics[k], want[k]), k


def test_metrics_reduce_as_last_metrics_says(tiny_config):
    """The guards' running counters report the call's last step, every
    other metric the mean of its steps; the port's list is the JAX
    package's."""
    assert _LAST_METRICS == JAX_LAST_METRICS
    per_step = {"d_grad_limit_count": torch.tensor([0, 1, 2], dtype=torch.int32),
                "g_nonfinite_streak": torch.tensor([3, 0, 1], dtype=torch.int32),
                "d_loss": torch.tensor([1.0, 2.0, 6.0])}
    out = reduce_metrics(per_step)
    assert int(out["d_grad_limit_count"]) == 2 and int(out["g_nonfinite_streak"]) == 1
    assert float(out["d_loss"]) == 3.0
    # a guard that skips every update: the count moves within the call,
    # the call reports where it ends
    _, state, step = port(tiny_config, grad_norm_limit=1e-6)
    batches = {k: torch.from_numpy(v) for k, v in stacked_batches(K).items()}
    state, metrics = make_multi_step(step, K)(state, batches)
    assert int(metrics["d_grad_limit_count"]) == int(metrics["d_grad_limit_streak"]) == K
    assert int(state.d_opt_state.toolarge_count) == K


def test_one_step_a_call_is_the_step(tiny_config):
    _, _, step = port(tiny_config)
    assert make_multi_step(step, 1) is step
    assert isinstance(make_multi_step(step, 2), MultiStep)


def test_two_steps_a_call_match_jax(tiny_config):
    """The port's k = 2 call with JAX's draws (stacked [2, ...]) against
    `jax.jit(make_multi_step(step, 2))` from one state, on
    tests/test_torch_train_step.py's batch at both steps: the call's metrics
    to 1e-4 relative, G, D and EMA params to 1e-3 per leaf (that file's
    tolerances; Adam's first step moves an element whose |g| sits near eps
    either way, so a second step's gradient norms can part by more on
    other batches)."""
    jcfg, tcfg = configs(tiny_config, False)
    jgan = jax_build_gan(jcfg)
    jstate = jax_state(jcfg, jgan)
    jstep = jax_make_train_step(jcfg, jgan)
    b = {k: np.stack([v, v]) for k, v in batch().items()}
    # each step's latents from the rng of the state that step starts from
    z0 = jax_latents(jgan, jstate)
    z1 = jax_latents(jgan, jstate.replace(rng=jax.random.split(jstate.rng, 1)[0]))
    jstate2, jm = jax.jit(jax_make_multi_step(jstep, 2))(
        jstate, {k: jnp.asarray(v) for k, v in b.items()})
    tcfg = dataclasses.replace(tcfg, use_pallas=True)
    gan = build_gan(tcfg, device="cpu")
    pstate = state_from_jax(jstate, tcfg, gan)
    pstate, pm = make_multi_step(make_train_step(tcfg, gan), 2)(
        pstate, {k: torch.from_numpy(v) for k, v in b.items()},
        z_d=torch.from_numpy(np.stack([z0[0], z1[0]])),
        z_g=torch.from_numpy(np.stack([z0[1], z1[1]])))
    assert set(pm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    assert pstate.step == int(jstate2.step) == 2
    compare_params(pstate, jstate2, steps=2)


@pytest.mark.parametrize("r1", [True, False])
def test_captured_body_keeps_addresses_and_equals_the_step(tiny_config, r1):
    """The step body a graph captures (`StepGraphs.body`, run here eagerly
    on the CPU) writes every state tensor in place, at its address, and
    leaves the state bit for bit where the plain step leaves it; it files
    its metrics under row 0 and moves the row index on."""
    _, state, step = port(tiny_config)
    batches = {k: torch.from_numpy(v) for k, v in stacked_batches(2).items()}
    saved = snapshot(state)
    addresses = {k: t.data_ptr() for k, t in state_tensors(state).items()}
    graphs = StepGraphs(step, 2, state, batches, {})
    graphs.load(batches, {})
    graphs.body(r1)
    assert {k: t.data_ptr() for k, t in state_tensors(state).items()} == addresses
    body = values(state)
    restore(state, saved)
    first = {k: v[0] for k, v in batches.items()}
    metrics = step.update(state, *step.prepare(state, first), r1=r1)
    assert_same(body, values(state))
    assert int(graphs.idx) == 1
    for k, v in metrics.items():
        assert torch.equal(graphs.out[k][0], v), k
    assert (float(metrics["r1"]) > 0) == r1


def test_graphs_refuse_another_state_or_shape(tiny_config):
    _, state, step = port(tiny_config)
    batches = {k: torch.from_numpy(v) for k, v in stacked_batches(2).items()}
    graphs = StepGraphs(step, 2, state, batches, {})
    other = create_train_state(configs(tiny_config, False)[1], step.gan)
    with pytest.raises(ValueError, match="state it was captured for"):
        graphs(other, batches, {})
    with pytest.raises(ValueError, match="shape"):
        graphs.load({k: v[:1] for k, v in batches.items()}, {})
    with pytest.raises(ValueError, match="steps_per_call"):
        StepGraphs(step, 3, state, batches, {})
