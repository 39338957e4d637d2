"""Spectral normalization (`ops/spectral.py`, `model.spectral_norm`) on the
port against the JAX package's `locate_tpu/ops/spectral.py`, on the CPU in
f32: the start vector is JAX's draw bit for bit; sigma and its gradient
for conv kernels (OIHW here, HWIO there) and dense weights; the
normalized discriminator's logits, input gradient and parameter
gradients at the tiny widths, 2e-4 as tests/test_torch_discriminator.py;
and, `slow` (its JAX step's compile is about 30 s), two steps of the style
family's train step with R1 on a spectrally normalized D, the port on its
gate Function and through R1's plain twin:
`python -m pytest -m slow tests/test_torch_spectral.py`."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from locate_tpu.models.discriminator import build_discriminator as jax_build_discriminator
from locate_tpu.ops import spectral as jsp
from locate_tpu_torch.models.discriminator import build_discriminator
from locate_tpu_torch.ops import spectral
from torch_port_parity import as_state_dict, port_config, randomize_zero_init, rel_err
from torch_step_draws import configs, run_parity


@pytest.mark.parametrize("cols", [1, 3, 32, 512])
def test_start_vector_is_jax(cols):
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (cols,), jnp.float32))
    np.testing.assert_array_equal(spectral.start_vector(cols, "cpu").numpy(), want)


@pytest.mark.parametrize("shape", [(3, 3, 16, 32), (1, 3, 16, 32), (3, 1, 32, 32),
                                   (1, 1, 3, 64), (20, 7), (33, 1)])
def test_sigma_and_its_gradient_match_jax(shape):
    """sigma in f32 within 1e-6 relative, d sigma / dW within 1e-5
    norm-relative, on a port weight in the port's layout (conv OIHW)."""
    w = np.random.default_rng(len(shape) + shape[-1]).standard_normal(shape).astype(np.float32)
    want, want_grad = jax.value_and_grad(lambda m: jsp.spectral_sigma(m, 9))(jnp.asarray(w))
    port = torch.from_numpy(np.transpose(w, (3, 2, 0, 1)).copy() if w.ndim == 4 else w)
    port.requires_grad_(True)
    got = spectral.spectral_sigma(port, 9)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    grad = port.grad.numpy()
    if w.ndim == 4:
        grad = np.transpose(grad, (2, 3, 1, 0))
    assert rel_err(grad, np.asarray(want_grad)) < 1e-5
    # the largest singular value, within power iteration's reach
    top = np.linalg.svd(w.reshape(-1, w.shape[-1]), compute_uv=False)[0]
    assert abs(got.item() - top) / top < 0.05


def test_normalized_leaves(tiny_config):
    """Every leaf named `w` of two or more dimensions, and nothing else
    (biases, norms, the class projection pass)."""
    tcfg = port_config(dataclasses.replace(tiny_config.model, num_classes=3,
                                           spectral_norm=True))
    model = build_discriminator(tcfg, "float32", device="cpu")
    named = dict(model.named_parameters())
    out = spectral.spectral_normalize(named)
    assert set(out) == {n for n, p in named.items() if n.endswith(".w") and p.ndim >= 2}
    assert "head.w" in out and "class_proj" not in out and "stem.b" not in out


def test_spectral_norm_discriminator_matches_jax(tiny_config):
    attn = dataclasses.replace(tiny_config.model.attention, gate_max=16.0)
    jcfg = dataclasses.replace(tiny_config.model, blocks_per_stage=2, attention=attn,
                               spectral_norm=True, sn_iters=5, num_classes=3)
    jd = jax_build_discriminator(jcfg)
    params = randomize_zero_init(jd.init(jax.random.PRNGKey(0)), jax.random.PRNGKey(1))
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (4, 16, 16, 3)).astype(np.float32)
    labels = np.array([0, 2, 1, 2])
    coef = rng.standard_normal(4).astype(np.float32)

    def loss(p, xx):
        return jnp.sum(jd.apply(p, xx, jnp.asarray(labels)) * coef)

    both = jax.jit(lambda p, xx: (jd.apply(p, xx, jnp.asarray(labels)),
                                  jax.grad(loss, argnums=(0, 1))(p, xx)))
    logits, (gp, gx) = both(params, jnp.asarray(x))
    logits, gp = np.asarray(logits), as_state_dict(gp)
    model = build_discriminator(port_config(jcfg), "float32", device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in as_state_dict(params).items()})
    xt = torch.from_numpy(x).requires_grad_(True)
    out = model(xt, torch.from_numpy(labels))
    (out * torch.from_numpy(coef)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), logits, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=2e-4,
                               atol=2e-4 * np.abs(np.asarray(gx)).max())
    for name, p in model.named_parameters():
        want = gp[name]
        scale = np.abs(want).max()
        if name.endswith("to_logits.b"):  # a softmax gate's bias: noise around 0
            scale = max(scale, np.abs(gp[name[:-1] + "w"]).max())
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=2e-4,
                                   atol=2e-4 * max(1e-3, scale), err_msg=name)
    # the parameters stay the raw weights: the optimizer's and the checkpoint's
    assert all(torch.equal(v, torch.from_numpy(as_state_dict(params)[k]))
               for k, v in model.state_dict().items())


@pytest.mark.slow
def test_spectral_norm_train_steps_match_jax(tiny_config):
    """Two alternating steps of the style family with R1 at every step and
    a spectrally normalized D (3 power iterations) against the jitted JAX
    step, JAX's draws passed in: every metric and parameter within
    `run_parity`'s tolerances, R1 fired on both sides, and D's weights were
    normalized (sigma far from 1 on some leaf)."""
    from locate_tpu.config import StyleConfig as JaxStyleConfig

    jcfg, tcfg = configs(tiny_config, train=dict(r1_gamma=0.1, r1_interval=1),
                         model=dict(arch="style", style=JaxStyleConfig(mapping_layers=2),
                                    spectral_norm=True, sn_iters=3))
    pm, jm, pstate, _ = run_parity(jcfg, tcfg, use_pallas=True)
    assert float(jm["r1"]) > 0.0 and float(pm["r1"]) > 0.0
    named = pstate.d_params.named(pstate.d_params.flat)
    sigmas = [float(spectral.spectral_sigma(w, 3)) for k, w in named.items()
              if spectral.normalized(k, w)]
    assert max(abs(s - 1.0) for s in sigmas) > 0.1, sigmas
