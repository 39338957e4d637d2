"""The port's discriminator against the JAX package's, on the CPU in float32
at the `tiny_config` widths (two conv blocks per stage, gate clamp 16):
the same weights (JAX init with the zero-init leaves filled, carried
across by `params_from_jax`), the same images and labels (numpy, seeded).
Logits, input gradients and parameter gradients agree to 2e-4, as in
tests/test_model_parity_torch.py. With use_pallas the JAX side runs its
Pallas kernels in interpret mode and the port its gate Function."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from locate_tpu.models.discriminator import build_discriminator as jax_build_discriminator
from locate_tpu_torch import config as tconfig
from locate_tpu_torch.models.discriminator import build_discriminator
from locate_tpu_torch.nn.blocks import ConvBlock, discriminator_stage, generator_stage
from locate_tpu_torch.ops.conv import downsample_avg, global_avg_pool
from locate_tpu_torch.ops.norm import minibatch_stddev
from torch_port_parity import as_state_dict, port_config, randomize_zero_init

TOL = dict(rtol=2e-4, atol=2e-4)
CASES = {
    "plain": dict(use_pallas=False),
    "pallas_classes": dict(use_pallas=True, num_classes=3),
    "plain_classes_mbstd_remat": dict(use_pallas=False, num_classes=3, mbstd_group=2,
                                      remat=True),
}


def model_configs(tiny_config, case):
    attn = dataclasses.replace(tiny_config.model.attention, gate_max=16.0)
    jcfg = dataclasses.replace(tiny_config.model, blocks_per_stage=2, attention=attn,
                               **CASES[case])
    return jcfg, port_config(jcfg)


def run_both(tiny_config, case):
    jcfg, tcfg = model_configs(tiny_config, case)
    jd = jax_build_discriminator(jcfg)
    params = randomize_zero_init(jd.init(jax.random.PRNGKey(0)), jax.random.PRNGKey(1))
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (4, 16, 16, 3)).astype(np.float32)
    labels = np.array([0, 2, 1, 2]) if jcfg.num_classes else None
    coef = rng.standard_normal(4).astype(np.float32)   # a loss that weighs each logit
    jl = None if labels is None else jnp.asarray(labels)

    def loss(p, xx):
        return jnp.sum(jd.apply(p, xx, jl) * coef)

    logits = np.asarray(jd.apply(params, jnp.asarray(x), jl))
    gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))

    model = build_discriminator(tcfg, "float32", device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in as_state_dict(params).items()})
    xt = torch.from_numpy(x).requires_grad_(True)
    out = model(xt, None if labels is None else torch.from_numpy(labels))
    (out * torch.from_numpy(coef)).sum().backward()
    return (logits, np.asarray(gx), as_state_dict(gp)), (out, xt, model)


@pytest.mark.parametrize("case", sorted(CASES))
def test_discriminator_matches_jax(tiny_config, case):
    (logits, gx, gp), (out, xt, model) = run_both(tiny_config, case)
    assert out.shape == (4,) and out.dtype == torch.float32
    assert np.abs(logits).max() > 1e-3  # not a trivially zero head
    np.testing.assert_allclose(out.detach().numpy(), logits, **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), gx, rtol=2e-4, atol=2e-4 * np.abs(gx).max())
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    assert set(grads) == set(gp)
    for name, want in gp.items():
        scale = np.abs(want).max()
        if name.endswith("to_logits.b"):
            # a softmax gate's logit bias gradient cancels to ~0: its noise
            # scales with the logit weights' gradient, which sums the same terms
            scale = max(scale, np.abs(gp[name[:-1] + "w"]).max())
        np.testing.assert_allclose(grads[name], want, rtol=2e-4,
                                   atol=2e-4 * max(1e-3, scale), err_msg=name)


def test_state_dict_keys_are_the_jax_paths(tiny_config):
    _, tcfg = model_configs(tiny_config, "pallas_classes")
    keys = set(build_discriminator(tcfg, "float32", device="cpu").state_dict())
    for key in ("stem.w", "trunk.0.0.main.2.row.w", "trunk.0.2.to_hidden.w",
                "neck.0.scale", "head.w", "class_proj"):
        assert key in keys, key


def test_return_features(tiny_config):
    _, tcfg = model_configs(tiny_config, "plain")
    model = build_discriminator(tcfg, "float32", device="cpu")
    logit, feats = model(torch.zeros(2, 16, 16, 3), return_features=True)
    assert logit.shape == (2,) and feats.shape == (2, tcfg.stage_channels()[0])


def test_pool_ops_and_mbstd_match_jax():
    """downsample_avg, global_avg_pool and minibatch_stddev against the JAX
    ops; the pools round their f32 mean to bf16 as jnp.mean does."""
    from locate_tpu.ops.conv import downsample_avg as jdown, global_avg_pool as jpool
    from locate_tpu.ops.norm import minibatch_stddev as jmbstd

    x = np.random.default_rng(5).standard_normal((4, 8, 8, 6)).astype(np.float32)
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        xt, xj = torch.from_numpy(x).to(dtype), jnp.asarray(x, jdtype)
        got = downsample_avg(xt).float().numpy()
        want = np.asarray(jdown(2).apply((), xj).astype(jnp.float32))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        got = global_avg_pool(xt).float().numpy()
        want = np.asarray(jpool().apply((), xj).astype(jnp.float32))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(minibatch_stddev(torch.from_numpy(x), 2).numpy(),
                               np.asarray(jmbstd(jnp.asarray(x), 2)), rtol=1e-6)
    with pytest.raises(ValueError, match="divisible"):
        minibatch_stddev(torch.from_numpy(x[:3]), 2)


def test_blocks_build_without_a_generator(tiny_config):
    """Every block takes `gen=None` (torch's default generator on the CPU)."""
    _, tcfg = model_configs(tiny_config, "plain")
    x = torch.zeros(1, 8, 8, 32)
    assert ConvBlock(32, 16, tcfg)(x).shape == (1, 8, 8, 16)
    assert generator_stage(32, 16, 16, tcfg, first=False)(x).shape == (1, 16, 16, 16)
    assert discriminator_stage(32, 16, 8, tcfg, last=False)(x).shape == (1, 4, 4, 16)


def test_unported_discriminator_options_raise(tiny_config):
    _, tcfg = model_configs(tiny_config, "plain")
    with pytest.raises(NotImplementedError, match="spectral_norm"):
        build_discriminator(dataclasses.replace(tcfg, spectral_norm=True), "float32", "cpu")
    with pytest.raises(NotImplementedError, match="self"):
        build_discriminator(dataclasses.replace(
            tcfg, attention=dataclasses.replace(tcfg.attention, kind="self")),
            "float32", "cpu")
