"""The sigmoid gate inside the models, on the CPU in float32: the ffhq_512
family with `model.attention.mode=sigmoid` (use_pallas, remat, a gate at
every stage, pos_features 8, bottleneck 4) cut to 16x16 and widths 32..16.

With `FUSE_MIN_LOCATIONS = 0` every stage fuses (the `stage_sigmoid` pass
and its backward chain); without it every stage is at most 16x16, so each
runs its layers one by one and, on a profile holding the JAX layer's
bound (the one-pass kernel at H*W <= 256), its gate through `SigmoidGate`. The JAX models run their Pallas
kernels in interpret mode, the port its kernels' plain versions; the same
weights (JAX init with the zero-init leaves filled, carried across by
`params_from_jax`) and inputs (numpy, seeded) go through both. Outputs,
input gradients and parameter gradients agree to 2e-4, the tolerance of
tests/test_model_parity_torch.py."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from locate_tpu import config as jconfig
from locate_tpu.models.discriminator import build_discriminator as jax_build_discriminator
from locate_tpu.models.generator import build_generator as jax_build_generator
from locate_tpu.nn import blocks as jblocks
from locate_tpu_torch.models.discriminator import build_discriminator
from locate_tpu_torch.models.generator import build_generator
from locate_tpu_torch.nn import blocks
from locate_tpu_torch.ops import fused_attention as fa
from locate_tpu_torch.ops import fused_stage as fs
from torch_port_parity import (as_state_dict, port_config, randomize_zero_init,
                               use_jax_sigmoid_bound)

TOL = 2e-4
SMALL = {"model.resolution": "16", "data.resolution": "16", "model.base_channels": "32",
         "model.max_channels": "32", "model.min_channels": "16", "model.latent_dim": "16",
         "train.global_batch": "2", "train.compute_dtype": "float32",
         "model.attention.mode": "sigmoid"}


def model_configs():
    """(JAX model config, the port's), use_pallas on."""
    jcfg = jconfig.get_config("ffhq_512", SMALL)
    assert jcfg.model.attention.mode == "sigmoid" and jcfg.model.remat
    mcfg = dataclasses.replace(jcfg.model, use_pallas=True)
    return mcfg, port_config(mcfg)


@pytest.fixture(params=["fused", "standalone_gate"])
def path(request, monkeypatch, tmp_path):
    """Every stage fused, or none (the gate through SigmoidGate, at the JAX
    layer's bound); the spy records which of the port's sigmoid functions
    ran."""
    use_jax_sigmoid_bound(monkeypatch, tmp_path)
    if request.param == "fused":
        monkeypatch.setattr(jblocks, "FUSE_MIN_LOCATIONS", 0)
        monkeypatch.setattr(blocks, "FUSE_MIN_LOCATIONS", 0)
    ran = set()
    for module, name in ((fs, "stage_sigmoid"), (fa, "sigmoid_gate"),
                         (fa, "sigmoid_gate_backward")):
        original = getattr(module, name)
        monkeypatch.setattr(module, name,
                            lambda *a, _n=name, _f=original, **kw: ran.add(_n) or _f(*a, **kw))
    return request.param, ran


def assert_params_close(got, want):
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=TOL,
                                   atol=TOL * max(1e-3, np.abs(w).max()), err_msg=name)


def expected_ran(kind):
    if kind == "fused":
        return {"stage_sigmoid", "sigmoid_gate_backward"}
    return {"sigmoid_gate", "sigmoid_gate_backward"}


def test_generator_matches_jax(path):
    kind, ran = path
    jcfg, tcfg = model_configs()
    g = jax_build_generator(jcfg)
    params = randomize_zero_init(g.init(jax.random.PRNGKey(0)), jax.random.PRNGKey(1))
    rng = np.random.default_rng(2)
    z = rng.standard_normal((2, jcfg.latent_dim)).astype(np.float32)
    dy = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    want = np.asarray(g.apply(params, jnp.asarray(z)))
    gp, gz = jax.grad(lambda p, zz: jnp.sum(g.apply(p, zz) * dy), argnums=(0, 1))(
        params, jnp.asarray(z))

    model = build_generator(tcfg, "float32", device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in as_state_dict(params).items()})
    zt = torch.from_numpy(z).requires_grad_(True)
    y = model(zt)
    (y * torch.from_numpy(dy)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(gz), rtol=TOL,
                               atol=TOL * np.abs(np.asarray(gz)).max())
    assert_params_close({n: p.grad.numpy() for n, p in model.named_parameters()},
                        as_state_dict(gp))
    assert ran == expected_ran(kind)


def test_discriminator_matches_jax(path):
    kind, ran = path
    jcfg, tcfg = model_configs()
    d = jax_build_discriminator(jcfg)
    params = randomize_zero_init(d.init(jax.random.PRNGKey(3)), jax.random.PRNGKey(4))
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    coef = rng.standard_normal(2).astype(np.float32)
    want = np.asarray(d.apply(params, jnp.asarray(x)))
    gp, gx = jax.grad(lambda p, xx: jnp.sum(d.apply(p, xx) * coef), argnums=(0, 1))(
        params, jnp.asarray(x))

    model = build_discriminator(tcfg, "float32", device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in as_state_dict(params).items()})
    xt = torch.from_numpy(x).requires_grad_(True)
    out = model(xt)
    (out * torch.from_numpy(coef)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=TOL,
                               atol=TOL * np.abs(np.asarray(gx)).max())
    assert_params_close({n: p.grad.numpy() for n, p in model.named_parameters()},
                        as_state_dict(gp))
    assert ran == expected_ran(kind)
