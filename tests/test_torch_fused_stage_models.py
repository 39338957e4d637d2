"""The port's fused-stage dispatch (`FusableStage`, the port of
`_maybe_fused_stage`) inside the models and the train step, on the CPU in
float32.

The config is the ffhq_512 family (use_pallas, remat, softmax gates at
every stage, pos_features 8, bottleneck 4) cut to 16x16 and widths 32..16,
with one and two conv blocks per stage (two puts a bare conv block, the
conv-only flavor, in front of each pair). `FUSE_MIN_LOCATIONS = 0` forces
fusion at every stage on both sides, as tests/test_fused_stage.py does:
the JAX models run their Pallas kernels in interpret mode, the port its
kernels' plain versions. The same weights (JAX init with the zero-init
leaves filled, carried across by `params_from_jax`) and inputs (numpy,
seeded) go through both: outputs, input gradients and parameter gradients
agree to 2e-4, the tolerance of tests/test_model_parity_torch.py."""

import dataclasses
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from locate_tpu import config as jconfig
from locate_tpu.models.discriminator import build_discriminator as jax_build_discriminator
from locate_tpu.models.generator import build_generator as jax_build_generator
from locate_tpu.nn import blocks as jblocks
from locate_tpu_torch import config as tconfig
from locate_tpu_torch.models.discriminator import build_discriminator
from locate_tpu_torch.models.gan import build_gan
from locate_tpu_torch.models.generator import build_generator
from locate_tpu_torch.nn import blocks
from locate_tpu_torch.ops import gate_profile
from locate_tpu_torch.train.state import create_train_state
from locate_tpu_torch.train.step import make_train_step
from torch_port_parity import as_state_dict, port_config, randomize_zero_init

TOL = 2e-4
SMALL = {"model.resolution": "16", "data.resolution": "16", "model.base_channels": "32",
         "model.max_channels": "32", "model.min_channels": "16", "model.latent_dim": "16",
         "train.global_batch": "2", "train.compute_dtype": "float32"}


def configs(blocks_per_stage):
    jcfg = jconfig.get_config("ffhq_512", {**SMALL,
                                           "model.blocks_per_stage": str(blocks_per_stage)})
    mcfg = dataclasses.replace(jcfg.model, use_pallas=True)
    return mcfg, port_config(mcfg), port_config(jcfg)


@pytest.fixture
def force_fusion(monkeypatch):
    monkeypatch.setattr(jblocks, "FUSE_MIN_LOCATIONS", 0)
    monkeypatch.setattr(blocks, "FUSE_MIN_LOCATIONS", 0)


@pytest.fixture
def fused_calls(monkeypatch):
    """How many times the port's stages call `fused_stage`, by flavor."""
    calls = []
    original = blocks.fused_stage

    def spy(x, *args, **kw):
        calls.append(("up_" if kw["upsample"] else "down_" if kw["downsample"] else "")
                     + ("pair" if kw.get("mode") else "conv"))
        return original(x, *args, **kw)

    monkeypatch.setattr(blocks, "fused_stage", spy)
    return calls


def assert_params_close(got, want):
    assert set(got) == set(want)
    for name, w in want.items():
        scale = np.abs(w).max()
        if name.endswith("to_logits.b"):
            # a softmax gate's logit-bias gradient cancels to ~0: its noise
            # scales with the logit weights' gradient
            scale = max(scale, np.abs(want[name[:-1] + "w"]).max())
        np.testing.assert_allclose(got[name], w, rtol=TOL, atol=TOL * max(1e-3, scale),
                                   err_msg=name)


@pytest.mark.parametrize("blocks_per_stage", [1, 2])
def test_generator_matches_jax_with_fusion_forced(force_fusion, fused_calls,
                                                  blocks_per_stage):
    jcfg, tcfg, _ = configs(blocks_per_stage)
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
    # stages 8 and 16 fuse their upsample into the first conv block (with
    # the gate when it is the only block); the 4x4 stage has no upsample;
    # with two blocks the first runs conv-only ahead of the pair
    want_flavors = {"up_pair", "pair"} if blocks_per_stage == 1 else {"up_conv", "conv", "pair"}
    assert set(fused_calls) == want_flavors


@pytest.mark.parametrize("blocks_per_stage", [1, 2])
def test_discriminator_matches_jax_with_fusion_forced(force_fusion, fused_calls,
                                                      blocks_per_stage):
    jcfg, tcfg, _ = configs(blocks_per_stage)
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
    # the last (4x4) stage has no pool; with two blocks the first runs conv-only
    want_flavors = {"down_pair", "pair"} | ({"conv"} if blocks_per_stage == 2 else set())
    assert set(fused_calls) == want_flavors


@pytest.mark.parametrize("blocks_per_stage", [1, 2])
def test_state_dict_keys_do_not_depend_on_use_pallas(blocks_per_stage):
    _, tcfg, _ = configs(blocks_per_stage)
    plain = dataclasses.replace(tcfg, use_pallas=False)
    for build in (build_generator, build_discriminator):
        fused_sd = build(tcfg, "float32", device="cpu").state_dict()
        plain_sd = build(plain, "float32", device="cpu").state_dict()
        assert list(fused_sd) == list(plain_sd)
        assert all(fused_sd[k].shape == plain_sd[k].shape for k in fused_sd)
    assert isinstance(build_generator(tcfg, "float32", device="cpu").trunk[1],
                      blocks.FusableStage)


def test_default_thresholds_keep_small_stages_unfused(fused_calls):
    """At the card profile's thresholds (64^2 locations and more for every
    flavor, read from ops/gate_profile.json) a 16x16 stage runs its layers
    one by one: bitwise the plain sequence (tests/test_fused_stage.py:302)."""
    assert blocks.FUSE_MIN_LOCATIONS is None
    assert all(blocks.fuse_threshold(f) == gate_profile.min_locations(f) >= 64 * 64
               for f in gate_profile.FLAVORS)
    _, tcfg, _ = configs(2)
    for stage, shape in ((blocks.generator_stage(32, 16, 16, tcfg, first=False), (2, 8, 8, 32)),
                         (blocks.discriminator_stage(32, 16, 16, tcfg, last=False),
                          (2, 16, 16, 32))):
        x = torch.from_numpy(np.random.default_rng(6).standard_normal(shape)
                             .astype(np.float32))
        with torch.no_grad():
            assert torch.equal(stage(x), torch.nn.Sequential.forward(stage, x))
    assert fused_calls == []


def test_thresholds_dispatch_per_flavor(monkeypatch, tmp_path, fused_calls):
    """A profile (LOCATE_TPU_TORCH_GATE_PROFILE) opening the down_pair flavor
    alone fuses the discriminator's stage and leaves the generator's
    (up_pair) unfused."""
    path = tmp_path / "gate_profile.json"
    mins = {f: 1 << 40 for f in gate_profile.FLAVORS}
    path.write_text(json.dumps(dict(gate_profile.load(),
                                    min_locations=dict(mins, down_pair=1))))
    monkeypatch.setenv(gate_profile.ENV, str(path))
    _, tcfg, _ = configs(1)
    x = torch.zeros(2, 16, 16, 32)
    with torch.no_grad():
        blocks.discriminator_stage(32, 16, 16, tcfg, last=False)(x)
        assert fused_calls == ["down_pair"]
        blocks.generator_stage(32, 16, 32, tcfg, first=False)(x)
    assert fused_calls == ["down_pair"]


def test_train_step_with_r1_fused_matches_unfused(monkeypatch):
    """One alternating step from step 0 (lazy R1 fires, through the plain
    twin of D; every stage checkpointed under remat), with every stage
    fused against the same step with none fused: metrics to 1e-4 and the
    updated parameters to 1e-3 of each leaf (Adam's first step is close to
    lr * sign(g), so only whole leaves compare). A softmax gate's logit
    bias has a gradient that is rounding noise around 0, so Adam moves each
    element by about +-lr either way: its two runs are held within 2 lr."""
    _, _, cfg = configs(1)
    assert cfg.use_pallas and cfg.model.remat and cfg.train.r1_gamma > 0
    images = np.random.default_rng(7).integers(0, 256, (2, 16, 16, 3), dtype=np.uint8)
    z = np.random.default_rng(8).standard_normal((2, 2, cfg.model.latent_dim))
    runs = []
    for threshold in (0, None):
        monkeypatch.setattr(blocks, "FUSE_MIN_LOCATIONS", threshold)
        gan = build_gan(cfg, device="cpu")
        state = create_train_state(cfg, gan)
        batch = {"image": torch.from_numpy(images), "label": torch.zeros(2, dtype=torch.long)}
        state, metrics = make_train_step(cfg, gan)(
            state, batch, z_d=torch.from_numpy(z[0]).float(), z_g=torch.from_numpy(z[1]).float())
        runs.append((state, {k: float(v) for k, v in metrics.items()}))
    (fused, fm), (plain, pm) = runs
    assert fm["r1"] > 0.0
    for k in pm:
        np.testing.assert_allclose(fm[k], pm[k], rtol=1e-4, atol=1e-6, err_msg=k)
    for part in ("g_params", "d_params"):
        got = getattr(fused, part).named(getattr(fused, part).flat)
        want = getattr(plain, part).named(getattr(plain, part).flat)
        for name, w in want.items():
            if name.endswith("to_logits.b"):
                lr = getattr(cfg.train, part[0] + "_opt").lr
                assert float((got[name] - w).abs().max()) <= 2 * lr * 1.01, name
                continue
            err = float((got[name] - w).norm() / w.norm().clamp_min(1e-12))
            assert err < 1e-3, (part, name, err)
