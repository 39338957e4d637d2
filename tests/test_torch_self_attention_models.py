"""Self-attention (`attention.kind="self"`) inside the models and the train
step, on the CPU in float32: the lsun_bedroom_128 family (two conv blocks
a stage, R1 gamma 1 firing at step 0, both update guards, EMA) cut to
16x16 and widths 32..16, a self-attention layer at every stage.

The same weights (JAX init, zero-init leaves filled and every `gamma` set
to 0.7 so that the blocks attend, carried across by `params_from_jax` /
`state_from_jax`; the He-normal q/k kernels give scores of a few units, so
no softmax is flat; tripling them, as the layer's own test does, makes the
whole model's f32 gradient move by 1e-3 against an f64 run in both
packages) and inputs (numpy, seeded) go
through both packages. With use_pallas the JAX models run their flash
kernels in interpret mode and the port `FlashAttention` on the kernels'
plain versions. Outputs, input gradients and parameter gradients agree to
2e-4 (tests/test_model_parity_torch.py's tolerance); two train steps to the
tolerances of tests/test_torch_train_step.py."""

import dataclasses
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from locate_tpu import config as jconfig
from locate_tpu.models.discriminator import build_discriminator as jax_build_discriminator
from locate_tpu.models.gan import build_gan as jax_build_gan
from locate_tpu.models.generator import build_generator as jax_build_generator
from locate_tpu.objectives.ema import ema_init as jax_ema_init
from locate_tpu.train.state import create_train_state as jax_create_train_state
from locate_tpu.train.step import make_train_step as jax_make_train_step
from locate_tpu_torch import cli
from locate_tpu_torch.models.discriminator import build_discriminator
from locate_tpu_torch.models.gan import build_gan
from locate_tpu_torch.models.generator import build_generator
from locate_tpu_torch.nn import blocks
from locate_tpu_torch.ops import flash_attention as tfa
from locate_tpu_torch.ops.self_attention import SelfAttention
from locate_tpu_torch.train.state import state_from_jax
from locate_tpu_torch.train.step import make_train_step, plain_twin
from torch_port_parity import as_state_dict, port_config, randomize_zero_init, rel_err

TOL = 2e-4
BATCH = 2
SMALL = {"model.resolution": "16", "data.resolution": "16", "model.base_channels": "32",
         "model.max_channels": "32", "model.min_channels": "16", "model.latent_dim": "16",
         "train.global_batch": str(BATCH), "train.compute_dtype": "float32",
         "model.attention.kind": "self", "model.attention.sa_qk_bottleneck": "4"}


def configs(use_pallas=True, **more):
    """(JAX config, the port's) of the small self-attention GAN."""
    jcfg = jconfig.get_config("lsun_bedroom_128",
                              {**SMALL, "use_pallas": str(use_pallas).lower(), **more})
    assert jcfg.model.attention.kind == "self" and jcfg.model.attention_stages == "all"
    jcfg = dataclasses.replace(jcfg, model=dataclasses.replace(jcfg.model,
                                                               use_pallas=use_pallas))
    return jcfg, port_config(jcfg)


def attending(params, key):
    """`params` with the zero-init leaves filled and every gamma at 0.7:
    each block attends."""
    params = randomize_zero_init(params, key)

    def visit(path, leaf):
        if getattr(path[-1], "key", None) == "gamma":
            return jnp.asarray(0.7, leaf.dtype)
        return leaf

    return jax.tree_util.tree_map_with_path(visit, params)


def load(model, params):
    model.load_state_dict({k: torch.from_numpy(v) for k, v in as_state_dict(params).items()})
    gammas = [p for n, p in model.named_parameters() if n.endswith("gamma")]
    assert gammas and all(float(g.detach()) == pytest.approx(0.7) for g in gammas)
    return model


def assert_params_close(got, want):
    assert set(got) == set(want)
    for name, w in want.items():
        scale = np.abs(w).max()
        if name.endswith(".k.b"):
            # exactly zero but for rounding (a shift of every key's score):
            # noise on the scale of the key weights' gradient
            scale = np.abs(want[name[:-1] + "w"]).max()
        np.testing.assert_allclose(got[name], w, rtol=TOL, atol=TOL * max(1e-3, scale),
                                   err_msg=name)


@pytest.fixture
def flash_calls(monkeypatch):
    """Counts the port's `FlashAttention` forwards."""
    calls = []
    original = tfa.FlashAttention.apply
    monkeypatch.setattr(tfa.FlashAttention, "apply",
                        lambda *a: calls.append(a[0].shape) or original(*a))
    return calls


@pytest.mark.parametrize("use_pallas", [True, False])
def test_generator_matches_jax(use_pallas, flash_calls):
    jcfg, tcfg = configs(use_pallas)
    g = jax_build_generator(jcfg.model)
    params = attending(g.init(jax.random.PRNGKey(0)), jax.random.PRNGKey(1))
    rng = np.random.default_rng(2)
    z = rng.standard_normal((BATCH, jcfg.model.latent_dim)).astype(np.float32)
    dy = rng.standard_normal((BATCH, 16, 16, 3)).astype(np.float32)
    want = np.asarray(g.apply(params, jnp.asarray(z)))
    gp, gz = jax.grad(lambda p, zz: jnp.sum(g.apply(p, zz) * dy), argnums=(0, 1))(
        params, jnp.asarray(z))

    model = load(build_generator(tcfg.model, "float32", device="cpu"), params)
    zt = torch.from_numpy(z).requires_grad_(True)
    y = model(zt)
    (y * torch.from_numpy(dy)).sum().backward()
    assert len(flash_calls) == (3 if use_pallas else 0)  # stages 4^2, 8^2, 16^2
    np.testing.assert_allclose(y.detach().numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(gz), rtol=TOL,
                               atol=TOL * np.abs(np.asarray(gz)).max())
    assert_params_close({n: p.grad.numpy() for n, p in model.named_parameters()},
                        as_state_dict(gp))


@pytest.mark.parametrize("use_pallas", [True, False])
def test_discriminator_matches_jax(use_pallas, flash_calls):
    jcfg, tcfg = configs(use_pallas)
    d = jax_build_discriminator(jcfg.model)
    params = attending(d.init(jax.random.PRNGKey(3)), jax.random.PRNGKey(4))
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, (BATCH, 16, 16, 3)).astype(np.float32)
    coef = rng.standard_normal(BATCH).astype(np.float32)
    want = np.asarray(d.apply(params, jnp.asarray(x)))
    gp, gx = jax.grad(lambda p, xx: jnp.sum(d.apply(p, xx) * coef), argnums=(0, 1))(
        params, jnp.asarray(x))

    model = load(build_discriminator(tcfg.model, "float32", device="cpu"), params)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = model(xt)
    (out * torch.from_numpy(coef)).sum().backward()
    assert len(flash_calls) == (3 if use_pallas else 0)
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=TOL,
                               atol=TOL * np.abs(np.asarray(gx)).max())
    assert_params_close({n: p.grad.numpy() for n, p in model.named_parameters()},
                        as_state_dict(gp))


def test_stage_fusion_never_claims_a_self_attention_layer(monkeypatch):
    """With every stage flavor forced to fuse (FUSE_MIN_LOCATIONS = 0) a conv
    block before a self-attention layer fuses alone (as a `conv` or
    `up_conv` stage, never a pair), and the layer runs itself: the model's
    output is what it is without fusion."""
    _, tcfg = configs(True, **{"model.blocks_per_stage": "1"})
    assert blocks.stage_fusable(tcfg.model)
    model = build_generator(tcfg.model, "float32", device="cpu")
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("gamma"):
                p.fill_(0.7)
    z = torch.from_numpy(np.random.default_rng(6).standard_normal((BATCH, 16))
                         .astype(np.float32))
    with torch.no_grad():
        want = model(z)
    fused, attended = [], []
    original = blocks._apply_fused_stage
    monkeypatch.setattr(blocks, "_apply_fused_stage",
                        lambda cfg, block, attn, *a: fused.append(attn) or original(
                            cfg, block, attn, *a))
    hooks = [m.register_forward_hook(lambda *a: attended.append(1))
             for m in model.modules() if isinstance(m, SelfAttention)]
    monkeypatch.setattr(blocks, "FUSE_MIN_LOCATIONS", 0)
    with torch.no_grad():
        got = model(z)
    for h in hooks:
        h.remove()
    assert fused == [None, None, None] and len(attended) == 3
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL, atol=TOL)


def test_plain_twin_shares_the_self_attention_parameters():
    """R1's kernel-free twin of D runs `attention_reference` on D's own
    tensors, the 0-d gamma and the four 1x1 convs included."""
    _, tcfg = configs(True)
    disc = build_discriminator(tcfg.model, "float32", device="cpu")
    twin = plain_twin(disc)
    layers = [m for m in disc.modules() if isinstance(m, SelfAttention)]
    twins = [m for m in twin.modules() if isinstance(m, SelfAttention)]
    assert len(layers) == len(twins) == 3
    for a, b in zip(layers, twins):
        assert a.use_pallas and not b.use_pallas
        for (na, pa), (nb, pb) in zip(a.named_parameters(), b.named_parameters()):
            assert na == nb and pa is pb


def jax_state(jcfg, jgan):
    state = jax_create_train_state(jcfg, jgan, jax.random.PRNGKey(0))
    g = attending(state.g_params, jax.random.PRNGKey(1))
    d = attending(state.d_params, jax.random.PRNGKey(2))
    return state.replace(g_params=g, d_params=d, ema_params=jax_ema_init(g))


def jax_latents(jgan, state):
    """z_d and z_g exactly as the JAX alternating step draws them."""
    _, k_zd, k_zg, _, _ = jax.random.split(state.rng, 5)
    return (np.asarray(jgan.sample_latents(k_zd, BATCH)),
            np.asarray(jgan.sample_latents(k_zg, BATCH)))


def batch():
    rng = np.random.default_rng(0)
    return {"image": rng.integers(0, 256, (BATCH, 16, 16, 3), dtype=np.uint8),
            "label": np.zeros(BATCH, np.int32)}


def compare_params(port_state, jstate, steps, lr):
    """G, D and EMA params per leaf to 1e-3 norm-relative, as
    tests/test_torch_train_step.py. A key bias's gradient is rounding noise
    around 0 (the softmax ignores a shift of every key's score), so Adam
    moves each of its elements by about +-lr at random: those leaves are
    held to the moves instead, at most 2 lr a step apart."""
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
            if name.endswith(".k.b"):
                assert np.abs(got - w).max() <= 2 * lr * steps * 1.01, (part, name)
            else:
                assert rel_err(got, w) < 1e-3, (part, name)


def run_train_parity(jax_use_pallas, flash_calls):
    jcfg, tcfg = configs(True)
    assert tcfg.train.r1_gamma == 1.0 and tcfg.train.grad_norm_limit == 1e6
    if not jax_use_pallas:  # the jitted XLA composition: the exact reference
        jcfg = dataclasses.replace(jcfg, use_pallas=False,
                                   model=dataclasses.replace(jcfg.model, use_pallas=False))
    jgan = jax_build_gan(jcfg)
    jstate = jax_state(jcfg, jgan)
    jstep = jax.jit(jax_make_train_step(jcfg, jgan))
    gan = build_gan(tcfg, device="cpu")
    pstate = state_from_jax(jstate, tcfg, gan)
    step = make_train_step(tcfg, gan)
    b = batch()
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    for i in range(2):
        z_d, z_g = jax_latents(jgan, jstate)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        pstate, pm = step(pstate, tb, z_d=torch.from_numpy(z_d.copy()),
                          z_g=torch.from_numpy(z_g.copy()))
        assert set(pm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-4, atol=1e-5,
                                       err_msg=f"step {i} {k}")
        compare_params(pstate, jstate, steps=i + 1, lr=tcfg.train.g_opt.lr)
    assert float(jm["r1"]) == 0.0 < float(pm["d_loss"])
    # per step: G twice and D three times through the Function, three layers
    # each; R1's twin runs none
    assert len(flash_calls) == 2 * 5 * 3
    return pstate


def test_two_train_steps_match_jax(flash_calls):
    pstate = run_train_parity(False, flash_calls)
    named = pstate.g_params.named(pstate.g_params.flat)
    gammas = [v for k, v in named.items() if k.endswith("gamma")]
    assert len(gammas) == 3 and all(g.shape == () for g in gammas)
    assert all(abs(float(g) - 0.7) > 1e-5 for g in gammas)  # Adam moved each gamma


@pytest.mark.slow
def test_two_train_steps_match_jax_pallas_interpret(flash_calls):
    """Both on their kernel paths: the JAX step compiles its flash kernels in
    interpret mode (minutes on the CPU, hence slow)."""
    run_train_parity(True, flash_calls)


def test_state_from_jax_carries_the_scalar_gamma():
    """After one JAX step: gamma's value, Adam moments and EMA arrive as 0-d
    views of the flat buffers, equal to JAX's."""
    jcfg, tcfg = configs(False)
    jgan = jax_build_gan(jcfg)
    jstate = jax_state(jcfg, jgan)
    jstate, _ = jax.jit(jax_make_train_step(jcfg, jgan))(
        jstate, {k: jnp.asarray(v) for k, v in batch().items()})
    pstate = state_from_jax(jstate, tcfg, build_gan(tcfg, device="cpu"))
    adam = jstate.g_opt_state.inner_state.inner_state[0]
    key = "trunk.0.2.gamma"
    for flat, tree in ((pstate.g_params.flat, jstate.g_params), (pstate.ema_params,
                                                                 jstate.ema_params),
                       (pstate.g_opt_state.mu, adam.mu), (pstate.g_opt_state.nu, adam.nu)):
        got, want = pstate.g_params.named(flat)[key], as_state_dict(tree)[key]
        assert got.shape == () and want.shape == ()
        assert float(got) == float(want) != 0.0
    for part, tree in (("g", jstate.g_params), ("d", jstate.d_params)):
        params = getattr(pstate, f"{part}_params")
        for name, want in as_state_dict(tree).items():
            assert rel_err(params.named(params.flat)[name].numpy(), want) == 0.0, name


TINY = ["model.base_channels=32", "model.max_channels=32", "model.min_channels=16",
        "model.latent_dim=16", "model.resolution=16", "data.resolution=16",
        "train.compute_dtype=float32", "model.attention.kind=self"]


def test_bench_sample_cli_serves_self_attention(capsys, flash_calls):
    rc = cli.main(["bench-sample", "lsun_bedroom_128", *TINY, "use_pallas=true",
                   "--batch", "2", "--steps", "1", "--device=cpu"])
    assert rc == 0
    d = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert d["unit"] == "images/sec" and d["value"] > 0 and "cpu" in d["metric"]
    assert len(flash_calls) == 3 * 4  # a warm-up and three timed forwards


def test_bench_cli_trains_self_attention(capsys, flash_calls):
    rc = cli.main(["bench", "2", "1", "spc=1", *TINY, "model.attention_stages=4,8",
                   "--device=cpu"])
    assert rc == 0
    d = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert d["unit"] == "images/sec" and d["value"] > 0 and d["use_pallas"] is True
    # 10 warm-up steps and 3 windows of max(3, steps) one-step calls, two layers
    assert len(flash_calls) == (10 + 3 * 3) * 5 * 2
    cfg = cli.bench_config(2, [], {"model.attention.kind": "self"})
    assert cfg.model.attention.kind == "self" and cfg.train.r1_gamma == 0.0
