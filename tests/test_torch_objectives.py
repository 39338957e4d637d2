"""The port's losses, optimizer with its update guards, and EMA against the
JAX package's, on the CPU in float32, from the same numpy inputs.

Tolerances: losses 1e-6 relative; the R1 penalty of the tiny
discriminator 1e-4 and its parameter gradient (a gradient of a gradient)
1e-3 norm-relative per leaf; Adam updates 1e-6 relative (the same f32
formula; the bias correction's power may differ by an ulp); the guards'
counters exactly; EMA 1e-7."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from locate_tpu.config import OptimConfig as JaxOptimConfig
from locate_tpu.models.discriminator import build_discriminator as jax_build_discriminator
from locate_tpu.objectives import ema as jema
from locate_tpu.objectives import losses as jlosses
from locate_tpu.objectives import optim as joptim
from locate_tpu_torch import config as tconfig
from locate_tpu_torch.models.discriminator import build_discriminator
from locate_tpu_torch.objectives import ema, losses, optim
from torch_port_parity import as_state_dict, port_config, randomize_zero_init, rel_err


def test_nonsat_losses_match_jax():
    rng = np.random.default_rng(0)
    real, fake = (rng.standard_normal(16).astype(np.float32) * 4 for _ in range(2))
    np.testing.assert_allclose(float(losses.g_nonsat_loss(torch.from_numpy(fake))),
                               float(jlosses.g_nonsat_loss(jnp.asarray(fake))), rtol=1e-6)
    np.testing.assert_allclose(
        float(losses.d_nonsat_loss(torch.from_numpy(real), torch.from_numpy(fake))),
        float(jlosses.d_nonsat_loss(jnp.asarray(real), jnp.asarray(fake))), rtol=1e-6)
    # bf16 logits are upcast before the softplus, as in JAX
    half = torch.from_numpy(fake).to(torch.bfloat16)
    np.testing.assert_allclose(float(losses.g_nonsat_loss(half)),
                               float(jlosses.g_nonsat_loss(jnp.asarray(fake, jnp.bfloat16))),
                               rtol=1e-6)


@pytest.mark.parametrize("kind", ["hinge", "wgan", "lsgan", "ragan", "rahinge", "rpgan"])
def test_unported_loss_families_raise(kind):
    with pytest.raises(NotImplementedError, match=kind):
        losses.get_losses(kind)


def test_r1_penalty_and_its_gradient_match_jax(tiny_config):
    jcfg = dataclasses.replace(tiny_config.model, num_classes=3)
    jd = jax_build_discriminator(jcfg)
    params = randomize_zero_init(jd.init(jax.random.PRNGKey(0)), jax.random.PRNGKey(1))
    rng = np.random.default_rng(3)
    real = rng.uniform(-1, 1, (4, 16, 16, 3)).astype(np.float32)
    labels = np.array([2, 0, 1, 1])

    def r1(p):
        return jlosses.r1_penalty(jd.apply, p, jnp.asarray(real), jnp.asarray(labels))

    want, want_grads = jax.value_and_grad(r1)(params)
    model = build_discriminator(port_config(jcfg), "float32", device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in as_state_dict(params).items()})
    got = losses.r1_penalty(model, torch.from_numpy(real), torch.from_numpy(labels))
    got.backward()
    assert float(want) > 1e-4
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-4)
    grads = as_state_dict(want_grads)
    for name, p in model.named_parameters():
        if np.linalg.norm(grads[name]) > 1e-6:
            assert rel_err(p.grad.numpy(), grads[name]) < 1e-3, name


# --- Adam and its guards ------------------------------------------------------


def jax_optimizer(limit=0.0, skips=0, clip=0.0, lr=2e-4):
    return joptim.make_optimizer(JaxOptimConfig(lr=lr, clip_grad_norm=clip), skips,
                                 None, limit)


def port_optimizer(limit=0.0, skips=0, clip=0.0, lr=2e-4):
    return optim.Optimizer(tconfig.OptimConfig(lr=lr, clip_grad_norm=clip), skips, limit)


def run_both(grads_seq, **kw):
    """Feed the same gradient sequence to both; yield (port updates, port
    state, JAX updates, JAX state) after each update. JAX params are
    {"b": (2,), "w": (4,)}, the port's flat vector is [b, w] (the order of
    jax.tree.leaves)."""
    jopt, topt = jax_optimizer(**kw), port_optimizer(**kw)
    jparams = {"b": jnp.zeros(2), "w": jnp.ones(4)}
    jstate = jopt.init(jparams)
    tstate = topt.init(torch.zeros(6))
    for g in grads_seq:
        jg = {"b": jnp.asarray(g[:2]), "w": jnp.asarray(g[2:])}
        jupd, jstate = jopt.update(jg, jstate, jparams)
        tupd, tstate = topt.update(torch.from_numpy(g), tstate)
        yield tupd, tstate, np.concatenate([np.asarray(l) for l in jax.tree.leaves(jupd)]), jstate


def test_adam_updates_match_optax():
    rng = np.random.default_rng(4)
    seq = [rng.standard_normal(6).astype(np.float32) * s for s in (1.0, 3.0, 0.01, 1e-9)]
    for tupd, tstate, jupd, jstate in run_both(seq):
        np.testing.assert_allclose(tupd.numpy(), jupd, rtol=1e-6, atol=1e-12)
        np.testing.assert_allclose(tstate.nu.numpy(), np.concatenate(
            [np.asarray(l) for l in jax.tree.leaves(jstate[0].nu)]), rtol=1e-6)
    assert int(tstate.count) == 4


def test_clip_grad_norm_matches_optax():
    rng = np.random.default_rng(5)
    seq = [rng.standard_normal(6).astype(np.float32) * s for s in (10.0, 0.1)]
    for tupd, _, jupd, _ in run_both(seq, clip=1.0, lr=0.1):
        np.testing.assert_allclose(tupd.numpy(), jupd, rtol=1e-6, atol=1e-12)


def _guard(jstate):
    """(toolarge_count, toolarge_streak, notfinite_count, adam count) of
    skip_if_too_large(apply_if_finite(adam))'s state."""
    inner = jstate.inner_state
    return (int(jstate.toolarge_count), int(jstate.toolarge_streak),
            int(inner.notfinite_count), int(inner.inner_state[0].count))


def test_guards_match_optax_on_the_guardrail_cases():
    """tests/test_guardrails.py's cases in one sequence: a healthy update,
    two over the limit (a streak), a healthy one (the streak resets, the
    count stays), two non-finite ones (the non-finite streak, not the
    limit's), then a healthy one."""
    small = np.ones(6, np.float32)
    huge = np.full(6, 1e6, np.float32)
    nan = np.full(6, np.nan, np.float32)
    inf = np.array([1, 1, np.inf, 1, 1, 1], np.float32)
    seq = [small, huge, huge, small, nan, inf, small]
    want = [(0, 0, 0, 1), (1, 1, 0, 1), (2, 2, 0, 1), (2, 0, 0, 2), (2, 0, 1, 2),
            (2, 0, 2, 2), (2, 0, 0, 3)]
    for i, (tupd, ts, jupd, js) in enumerate(run_both(seq, limit=10.0, skips=200,
                                                      lr=0.1)):
        got = (int(ts.toolarge_count), int(ts.toolarge_streak), int(ts.notfinite_count),
               int(ts.count))
        assert got == _guard(js) == want[i], (i, got, _guard(js))
        np.testing.assert_allclose(tupd.numpy(), jupd, rtol=1e-6, atol=1e-12)
        assert np.isfinite(ts.mu.numpy()).all() and np.isfinite(ts.nu.numpy()).all()
    assert float(ts.grad_norm) == pytest.approx(np.sqrt(6.0), rel=1e-6)


def test_size_guard_reads_the_raw_gradient_norm():
    """grad_norm_limit reads the norm before the clip, as in JAX (the
    limit wraps the clipping chain)."""
    g = np.full(6, 100.0, np.float32)
    for tupd, ts, jupd, js in run_both([g], limit=50.0, clip=1.0):
        assert int(ts.toolarge_count) == int(js.toolarge_count) == 1
        assert float(tupd.abs().max()) == 0.0 == float(np.abs(jupd).max())


def test_guard_stats_names(tiny_config):
    tcfg = port_config(dataclasses.replace(tiny_config.train, grad_norm_limit=1e6,
                                           max_nonfinite_skips=200))
    state = port_optimizer().init(torch.zeros(3))
    assert set(optim.guard_stats(state, tcfg)) == {
        "grad_limit_count", "grad_limit_streak", "grad_norm_guard", "nonfinite_streak"}
    assert optim.guard_stats(state, port_config(tiny_config.train)) == {}


@pytest.mark.parametrize("scale", [1.0, 1e17, 1e25])
def test_safe_global_norm_matches_jax(scale):
    """At 1e17 and 1e25 the squares overflow f32; the scaled norm does not."""
    g = (np.random.default_rng(6).standard_normal(1000) * scale).astype(np.float32)
    want = float(joptim.safe_global_norm({"a": jnp.asarray(g[:400]), "b": jnp.asarray(g[400:])}))
    got = float(optim.safe_global_norm(torch.from_numpy(g)))
    assert np.isfinite(got) and got == pytest.approx(want, rel=1e-5)
    assert float(optim.safe_global_norm(torch.zeros(0))) == 0.0
    assert float(optim.safe_global_norm(torch.zeros(5))) == 0.0


@pytest.mark.parametrize("bad", [np.nan, np.inf])
def test_safe_global_norm_propagates_nonfinite(bad):
    g = np.ones(8, np.float32)
    g[3] = bad
    assert not np.isfinite(float(optim.safe_global_norm(torch.from_numpy(g))))


def test_unported_optimizer_options_raise(tiny_config):
    with pytest.raises(NotImplementedError, match="lr_schedule"):
        optim.Optimizer(tconfig.OptimConfig(), lr_schedule="cosine")
    with pytest.raises(NotImplementedError, match="grad_accum"):
        optim.make_optimizers(port_config(dataclasses.replace(tiny_config.train,
                                                              grad_accum=2)))


# --- EMA ----------------------------------------------------------------------


def test_ema_matches_jax():
    rng = np.random.default_rng(7)
    e, p = (rng.standard_normal(1000).astype(np.float32) for _ in range(2))
    for decay in (0.999, 0.99, 0.0):
        want = np.asarray(jema.ema_update({"x": jnp.asarray(e)}, {"x": jnp.asarray(p)},
                                          decay)["x"])
        got = ema.ema_update(torch.from_numpy(e), torch.from_numpy(p), decay).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-7, atol=1e-7)


def test_ema_init_copies_and_bf16_raises():
    p = torch.ones(4)
    shadow = ema.ema_init(p)
    assert shadow.data_ptr() != p.data_ptr()
    p.add_(1.0)
    assert float(shadow.max()) == 1.0
    with pytest.raises(NotImplementedError, match="ema_dtype"):
        ema.ema_init(p, "bfloat16")


def test_optax_is_the_reference_here():
    """Guard against a silent optax change under the JAX side: its Adam is
    mu_hat / (sqrt(nu_hat) + eps), scaled by -lr."""
    opt = optax.adam(0.5, b1=0.0, b2=0.99, eps=1e-8)
    upd, _ = opt.update({"x": jnp.asarray([2.0])}, opt.init({"x": jnp.zeros(1)}))
    assert float(upd["x"][0]) == pytest.approx(-0.5 * 2.0 / (2.0 + 1e-8), rel=1e-6)
