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


@pytest.mark.parametrize("kind", ["nonsat", "hinge", "wgan", "lsgan", "ragan", "rahinge",
                                  "rpgan"])
def test_loss_family_matches_jax(kind):
    """Both losses of each family and their gradients in the logits, 1e-6."""
    rng = np.random.default_rng(1)
    real, fake = (rng.standard_normal(16).astype(np.float32) * 2 for _ in range(2))
    jg, jd = jlosses.get_losses(kind)
    tg, td = losses.get_losses(kind)
    rel = kind in losses.RELATIVISTIC

    def jax_pair(r, f):
        return (jg(f, r) if rel else jg(f)), jd(r, f)

    want = jax_pair(jnp.asarray(real), jnp.asarray(fake))
    wgrads = [jax.grad(lambda r, f, i=i: jax_pair(r, f)[i], argnums=(0, 1))(
        jnp.asarray(real), jnp.asarray(fake)) for i in range(2)]
    r, f = (torch.from_numpy(a).requires_grad_(True) for a in (real, fake))
    got = ((tg(f, r) if rel else tg(f)), td(r, f))
    for i in range(2):
        np.testing.assert_allclose(float(got[i].detach()), float(want[i]), rtol=1e-6,
                                   atol=1e-7)
        gr, gf = torch.autograd.grad(got[i], (r, f), allow_unused=True)
        for g, w in ((gr, wgrads[i][0]), (gf, wgrads[i][1])):
            g = np.zeros(16, np.float32) if g is None else g.numpy()
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6, atol=1e-8)
    with pytest.raises(ValueError, match="unknown"):
        losses.get_losses("bogus")


@pytest.mark.parametrize("kind", ["nonsat", "hinge", "wgan", "lsgan"])
def test_per_sample_g_losses_match_jax(kind):
    f = np.random.default_rng(2).standard_normal(8).astype(np.float32)
    np.testing.assert_allclose(losses.g_per_sample(kind)(torch.from_numpy(f)).numpy(),
                               np.asarray(jlosses.g_per_sample(kind)(jnp.asarray(f))),
                               rtol=1e-6)
    assert float(losses.g_per_sample(kind)(torch.from_numpy(f)).mean()) == pytest.approx(
        float(losses.get_losses(kind)[0](torch.from_numpy(f))), rel=1e-6)


def test_per_sample_refuses_relativistic_losses():
    with pytest.raises(ValueError, match="per-sample"):
        losses.g_per_sample("ragan")


def test_lecam_penalty_matches_jax():
    rng = np.random.default_rng(3)
    real, fake = (rng.standard_normal(12).astype(np.float32) for _ in range(2))
    want, wg = jax.value_and_grad(
        lambda r, f: jlosses.lecam_penalty(r, f, 0.3, -0.2), argnums=(0, 1))(
        jnp.asarray(real), jnp.asarray(fake))
    r, f = (torch.from_numpy(a).requires_grad_(True) for a in (real, fake))
    got = losses.lecam_penalty(r, f, torch.tensor(0.3), torch.tensor(-0.2))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    for g, w in zip(torch.autograd.grad(got, (r, f)), wg):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-8)


def test_orthogonal_penalty_matches_jax_in_the_flat_layout(tiny_config):
    """The port's OIHW kernels, [in, out] dense weights, and the class
    embedding left out, against the JAX HWIO pytree: value 1e-5, every
    parameter's gradient 1e-5 norm-relative (sums of a few hundred
    products of O(1) weights)."""
    from locate_tpu.models.generator import build_generator as jax_build_generator
    from locate_tpu_torch.models.generator import build_generator

    jcfg = dataclasses.replace(tiny_config.model, num_classes=3)
    jgen = jax_build_generator(jcfg)
    params = randomize_zero_init(jgen.init(jax.random.PRNGKey(0)), jax.random.PRNGKey(1))
    want, wgrads = jax.jit(jax.value_and_grad(jlosses.orthogonal_penalty))(params)
    model = build_generator(port_config(jcfg), "float32", device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in as_state_dict(params).items()})
    named = list(model.named_parameters())
    weights = losses.ortho_weights([n for n, _ in named], [p for _, p in named])
    assert not any(p is model.class_embed for p in weights)
    got = losses.orthogonal_penalty(weights)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    grads = as_state_dict(wgrads)
    for name, p in named:
        g = np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
        if np.linalg.norm(grads[name]) == 0.0:
            assert not g.any(), name
        else:
            assert rel_err(g, grads[name]) < 1e-5, name


def test_gradient_penalty_and_its_gradient_match_jax(tiny_config):
    """WGAN-GP of the tiny conditional D at given interpolation weights:
    value 1e-4, parameter gradients (second order) 1e-3 norm-relative."""
    jcfg = dataclasses.replace(tiny_config.model, num_classes=3, resolution=8)
    jd = jax_build_discriminator(jcfg)
    params = randomize_zero_init(jd.init(jax.random.PRNGKey(0)), jax.random.PRNGKey(1))
    rng = np.random.default_rng(3)
    real, fake = (rng.uniform(-1, 1, (4, 8, 8, 3)).astype(np.float32) for _ in range(2))
    eps = rng.uniform(0, 1, (4, 1, 1, 1)).astype(np.float32)
    labels = np.array([2, 0, 1, 1])

    def gp(p):
        return jlosses.gradient_penalty(jd.apply, p, jnp.asarray(real), jnp.asarray(fake),
                                        jnp.asarray(eps), jnp.asarray(labels))

    want, want_grads = jax.jit(jax.value_and_grad(gp))(params)
    model = build_discriminator(port_config(jcfg), "float32", device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in as_state_dict(params).items()})
    got = losses.gradient_penalty(model, *(torch.from_numpy(a) for a in (real, fake, eps)),
                                  torch.from_numpy(labels))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-4)
    grads = as_state_dict(want_grads)
    for name, p in model.named_parameters():
        if np.linalg.norm(grads[name]) > 1e-6:
            assert rel_err(p.grad.numpy(), grads[name]) < 1e-3, name


def test_path_lengths_and_their_gradient_match_jax(tiny_config):
    """Path lengths of the tiny G at given noise: values 1e-4, the mean's
    parameter gradients (second order) 1e-3 norm-relative."""
    from locate_tpu.models.generator import build_generator as jax_build_generator
    from locate_tpu_torch.models.generator import build_generator

    jcfg = dataclasses.replace(tiny_config.model, resolution=8)
    jgen = jax_build_generator(jcfg)
    params = randomize_zero_init(jgen.init(jax.random.PRNGKey(0)), jax.random.PRNGKey(1))
    z = np.random.default_rng(5).standard_normal((3, jcfg.latent_dim)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    y = jax.random.normal(key, (3, 8, 8, 3), jnp.float32) / 8.0

    def mean_len(p):
        return jnp.mean(jlosses.path_lengths(jgen.apply, p, jnp.asarray(z), None, key))

    want_lens = jax.jit(lambda p: jlosses.path_lengths(jgen.apply, p, jnp.asarray(z), None,
                                                       key))(params)
    want_grads = jax.jit(jax.grad(mean_len))(params)
    model = build_generator(port_config(jcfg), "float32", device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in as_state_dict(params).items()})
    lens = losses.path_lengths(model, torch.from_numpy(z), None,
                               torch.from_numpy(np.asarray(y)))
    np.testing.assert_allclose(lens.detach().numpy(), np.asarray(want_lens), rtol=1e-4)
    lens.mean().backward()
    grads = as_state_dict(want_grads)
    for name, p in model.named_parameters():
        if np.linalg.norm(grads[name]) > 1e-6:
            assert rel_err(p.grad.numpy(), grads[name]) < 1e-3, name


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


def _schedule_cfg(tiny_config, kind, **kw):
    return dataclasses.replace(tiny_config.train, lr_schedule=kind, **kw)


@pytest.mark.parametrize("kind,kw", [
    ("cosine", dict(total_steps=10)),
    ("linear_warmup_cosine", dict(total_steps=12, warmup_steps=4)),
    ("linear_warmup_cosine", dict(total_steps=24, warmup_steps=8, grad_accum=2)),
])
def test_lr_schedule_matches_optax(tiny_config, kind, kw):
    """The schedule of each count (past the horizon too) against the JAX
    package's optax schedule, horizons in updates under grad_accum, as an
    f32 device tensor of an int32 count tensor (1e-6)."""
    jcfg = _schedule_cfg(tiny_config, kind, **kw)
    want = joptim.make_schedule(2e-4, jcfg)
    got = optim.make_schedule(2e-4, port_config(jcfg))
    for count in range(0, 16):
        value = got(torch.tensor(count, dtype=torch.int32))
        assert value.dtype == torch.float32 and value.dim() == 0
        np.testing.assert_allclose(float(value), float(want(jnp.asarray(count, jnp.int32))),
                                   rtol=1e-6, atol=1e-12, err_msg=str(count))
    assert optim.make_schedule(2e-4, port_config(tiny_config.train)) is None


def test_scheduled_adam_matches_optax(tiny_config):
    """make_optimizers' Adam with linear_warmup_cosine and both guards over
    a skipped update: the lr follows Adam's count, not the call count."""
    jcfg = dataclasses.replace(_schedule_cfg(tiny_config, "linear_warmup_cosine",
                                             total_steps=8, warmup_steps=2),
                               grad_norm_limit=10.0, max_nonfinite_skips=200)
    jopt = joptim.make_optimizers(jcfg)[0]
    topt = optim.make_optimizers(port_config(jcfg))[0]
    jparams = {"b": jnp.zeros(2), "w": jnp.ones(4)}
    js, ts = jopt.init(jparams), topt.init(torch.zeros(6))
    rng = np.random.default_rng(8)
    for scale in (1.0, 100.0, 1.0, 0.5, 2.0):
        g = (rng.standard_normal(6) * scale).astype(np.float32)
        jupd, js = jopt.update({"b": jnp.asarray(g[:2]), "w": jnp.asarray(g[2:])}, js, jparams)
        tupd, ts = topt.update(torch.from_numpy(g), ts)
        np.testing.assert_allclose(tupd.numpy(), np.concatenate(
            [np.asarray(l) for l in jax.tree.leaves(jupd)]), rtol=1e-6, atol=1e-12)
    assert int(ts.count) == 4 and int(ts.toolarge_count) == 1


@pytest.mark.parametrize("accum", [2, 3])
def test_grad_accum_matches_optax_multisteps(tiny_config, accum):
    """grad_accum = optax.MultiSteps around the guarded chain: updates on
    every call (zero until an emit), the running mean, mini_step and
    gradient_step, the inner state kept until an emit, and guard_stats
    reading the inner guards. A non-finite gradient inside a window
    poisons the running mean for good, in both (MultiSteps zeroes the
    accumulator as 0 * acc): every later emit is skipped and counted.""" 
    jcfg = dataclasses.replace(tiny_config.train, grad_accum=accum, grad_norm_limit=1e3,
                               max_nonfinite_skips=200)
    tcfg = port_config(jcfg)
    jopt, topt = joptim.make_optimizers(jcfg)[1], optim.make_optimizers(tcfg)[1]
    jparams = {"b": jnp.zeros(2), "w": jnp.ones(4)}
    js, ts = jopt.init(jparams), topt.init(torch.zeros(6))
    rng = np.random.default_rng(9)
    seq = [rng.standard_normal(6).astype(np.float32) for _ in range(2 * accum)]
    seq.append(np.full(6, np.nan, np.float32))
    seq += [rng.standard_normal(6).astype(np.float32) for _ in range(2 * accum)]
    for i, g in enumerate(seq):
        jupd, js = jopt.update({"b": jnp.asarray(g[:2]), "w": jnp.asarray(g[2:])}, js, jparams)
        tupd, ts = topt.update(torch.from_numpy(g), ts)
        np.testing.assert_allclose(tupd.numpy(), np.concatenate(
            [np.asarray(l) for l in jax.tree.leaves(jupd)]), rtol=1e-6, atol=1e-12,
            err_msg=str(i))
        assert int(ts.mini_step) == int(js.mini_step), i
        assert int(ts.gradient_step) == int(js.gradient_step), i
        np.testing.assert_allclose(ts.acc_grads.numpy(), np.concatenate(
            [np.asarray(l) for l in jax.tree.leaves(js.acc_grads)]), rtol=1e-6)
        want = {k: int(v) for k, v in joptim.guard_stats(js, jcfg).items()
                if k != "grad_norm_guard"}
        got = {k: int(v) for k, v in optim.guard_stats(ts, tcfg).items()
               if k != "grad_norm_guard"}
        assert got == want, (i, got, want)
        assert bool(topt.emitted(ts)) == (int(js.mini_step) == 0)
    assert int(ts.notfinite_count) == int(ts.total_notfinite) >= 2
    assert torch.isnan(ts.acc_grads).all()


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
    """A shadow is a copy in its dtype; a bf16 shadow's update raises
    without random bits for its rounding (as the JAX update does without
    a key), and an unknown dtype raises."""
    p = torch.ones(4)
    shadow = ema.ema_init(p)
    assert shadow.data_ptr() != p.data_ptr()
    p.add_(1.0)
    assert float(shadow.max()) == 1.0
    half = ema.ema_init(p, "bfloat16")
    assert half.dtype == torch.bfloat16 and float(half.max()) == 2.0
    with pytest.raises(ValueError, match="random bits"):
        ema.ema_update(half, p, 0.99)
    with pytest.raises(ValueError, match="ema_dtype"):
        ema.ema_init(p, "float16")


def _sr_inputs():
    rng = np.random.default_rng(11)
    x = (rng.standard_normal(4096) * np.exp2(rng.integers(-20, 20, 4096))).astype(np.float32)
    special = np.array([np.inf, -np.inf, np.nan, 3.39e38, -3.39e38, 3.4e38, -3.4e38,
                        np.finfo(np.float32).max, 0.0, -0.0, 1e-45, 1.0 - 2**-24],
                       np.float32)
    return np.concatenate([x, special])


def test_stochastic_round_bf16_is_bitwise_jax_given_the_bits():
    """The same f32 values and random bits round to the same bf16 bits, the
    non-finite values and f32's top binade passed through a plain cast."""
    x = _sr_inputs()
    key = jax.random.PRNGKey(3)
    bits = np.asarray(jax.random.bits(key, x.shape, jnp.uint32) & jnp.uint32(0xFFFF))
    want = np.asarray(jema.stochastic_round_bf16(jnp.asarray(x), key)).view(np.uint16)
    got = ema.stochastic_round_bf16(torch.from_numpy(x),
                                    torch.from_numpy(bits.astype(np.int32)))
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16), want)


def test_bf16_ema_update_is_bitwise_jax_given_the_bits():
    rng = np.random.default_rng(12)
    e = rng.standard_normal(777).astype(np.float32).astype(jnp.bfloat16)
    p = rng.standard_normal(777).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = jema.ema_update({"x": jnp.asarray(e)}, {"x": jnp.asarray(p)}, 0.999, key)["x"]
    bits = np.asarray(jax.random.bits(jax.random.split(key, 1)[0], (777,), jnp.uint32)
                      & jnp.uint32(0xFFFF)).astype(np.int32)
    got = ema.ema_update(torch.from_numpy(np.asarray(e, np.float32)).to(torch.bfloat16),
                         torch.from_numpy(p), 0.999, torch.from_numpy(bits))
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16),
                                  np.asarray(want).view(np.uint16))


def test_ema_rampup_decay_matches_jax():
    """`rampup_decay` against the JAX step's formula (jnp.minimum of the
    half-lives, exp2), 1e-6, from 0 past the target half-life."""
    import math

    for step in (0, 1, 5, 100, 20_000, 10**6):
        hl_target = math.log(0.5) / math.log(0.999)
        want = jnp.exp2(-1.0 / jnp.minimum(hl_target, (jnp.float32(step) + 1.0) * 0.05))
        got = ema.rampup_decay(torch.tensor(step, dtype=torch.int32), 0.999, 0.05)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6, err_msg=str(step))


def test_optax_is_the_reference_here():
    """Guard against a silent optax change under the JAX side: its Adam is
    mu_hat / (sqrt(nu_hat) + eps), scaled by -lr."""
    opt = optax.adam(0.5, b1=0.0, b2=0.99, eps=1e-8)
    upd, _ = opt.update({"x": jnp.asarray([2.0])}, opt.init({"x": jnp.zeros(1)}))
    assert float(upd["x"][0]) == pytest.approx(-0.5 * 2.0 / (2.0 + 1e-8), rel=1e-6)
