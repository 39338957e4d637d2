"""The port's style generator family (`models/style_generator.py`) against
the JAX package's, on the CPU in f32 at 16x16 (three stages, base 32
channels, mapping 2 layers): the same weights through `params_from_jax`
(zero-init leaves filled, noise strengths at 0.3), the same numpy
latents, JAX's noise planes, crossovers and w_avg passed in. Tolerance
2e-4 norm-relative. The forward with both heads, every noise mode,
demodulation on and off, class-conditional, and the `use_pallas` model
(JAX's gate in its plain form at these sizes, the port's on its gate
Function); `apply_mixed`; `w_average` and `apply_truncated`; the const
planes; sampling with `truncation_psi`; export round trips both ways."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from locate_tpu.config import AttentionConfig as JaxAttentionConfig
from locate_tpu.config import ModelConfig as JaxModelConfig
from locate_tpu.config import StyleConfig as JaxStyleConfig
from locate_tpu.io.export import export_generator as jax_export_generator
from locate_tpu.io.export import load_generator as jax_load_generator
from locate_tpu.models import style_generator as jsg
from locate_tpu.models.generator import build_generator as jax_build_generator
from locate_tpu_torch.io.export import export_generator, load_generator
from locate_tpu_torch.io.sampling import generate_samples
from locate_tpu_torch.models import style_generator as sg
from locate_tpu_torch.models.generator import build_generator
from torch_port_parity import as_state_dict, port_config, randomize_zero_init, rel_err

TOL = 2e-4
BASE = dict(resolution=16, base_channels=32, max_channels=32, min_channels=16,
            latent_dim=12, arch="style")
ATTN = JaxAttentionConfig(pos_features=4, bottleneck=2, gate_max=16.0)
CASES = {
    "last": dict(),
    "skip": dict(g_rgb="skip"),
    "const_noise": dict(style=dict(noise="const")),
    "skip_const_nodemod": dict(g_rgb="skip", style=dict(noise="const", demodulate=False)),
    "random_noise_fallback": dict(style=dict(noise="random")),
    "classes": dict(num_classes=3, class_embed_dim=6),
    "pallas": dict(use_pallas=True, style=dict(noise="const")),
    "pallas_skip": dict(use_pallas=True, g_rgb="skip"),
}
N = 3
_cache = {}


def jax_config(**kw):
    kw = dict(kw)
    style = JaxStyleConfig(mapping_layers=2, **kw.pop("style", {}))
    return JaxModelConfig(**BASE, attention=ATTN, style=style, **kw)


def strengths(params, value=0.3):
    """`params` with every 0-d leaf (the noise strengths) at `value`."""
    return jax.tree.map(lambda l: jnp.full_like(l, value) if l.ndim == 0 else l, params)


def jax_model(case):
    """(config, generator, params) of a case, made once."""
    if case not in _cache:
        jcfg = jax_config(**CASES[case])
        g = jax_build_generator(jcfg)
        params = strengths(randomize_zero_init(g.init(jax.random.PRNGKey(0)),
                                               jax.random.PRNGKey(5)))
        _cache[case] = (jcfg, g, params)
    return _cache[case]


def port_model(jcfg, params, dtype="float32"):
    model = build_generator(port_config(jcfg), dtype, device="cpu").eval()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in as_state_dict(params).items()})
    return model


def inputs(jcfg, seed=0):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((N, jcfg.latent_dim)).astype(np.float32)
    labels = np.array([0, 2, 1]) if jcfg.num_classes else None
    return z, labels


def t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("case", sorted(CASES))
def test_style_forward_matches_jax(case):
    jcfg, g, params = jax_model(case)
    model = port_model(jcfg, params)
    assert set(model.state_dict()) == set(as_state_dict(params))
    assert model.num_ws == g.num_ws
    z, labels = inputs(jcfg)
    want = np.asarray(g.apply(params, j(z), j(labels)))
    with torch.no_grad():
        got = model(t(z), t(labels)).numpy()
    assert got.shape == want.shape == (N, 16, 16, 3)
    assert rel_err(got, want) < TOL, rel_err(got, want)


@pytest.mark.parametrize("case", ["last", "skip"])
def test_apply_mixed_with_jax_draws(case):
    """`apply_mixed` on JAX's second latent and crossovers (one sample
    unmixed, cut = num_ws) and, under noise="random", JAX's per-sample
    planes (`fold_in(fold_in(key, stage), conv)`) passed in."""
    jcfg = jax_config(**{**CASES[case], "style": dict(noise="random", mixing_prob=0.9)})
    g = jax_build_generator(jcfg)
    params = strengths(randomize_zero_init(g.init(jax.random.PRNGKey(0)),
                                           jax.random.PRNGKey(5)))
    model = port_model(jcfg, params)
    z1, _ = inputs(jcfg, 0)
    z2, _ = inputs(jcfg, 1)
    cut = np.array([1, g.num_ws - 1, g.num_ws], np.int32)
    key = jax.random.PRNGKey(7)
    want = np.asarray(g.apply_mixed(params, j(z1), j(z2), j(cut), noise_rng=key))
    noise = [[t(jax.random.normal(jax.random.fold_in(jax.random.fold_in(key, i), k),
                                  shape, jnp.float32)) for k, shape in enumerate(shapes)]
             for i, shapes in enumerate(model.noise_shapes(N))]
    with torch.no_grad():
        got = model.apply_mixed(t(z1), t(z2), t(cut), noise=noise).numpy()
        unmixed = model(t(z1), noise=[[p[:1] for p in s] for s in noise]).numpy()
    assert rel_err(got, want) < TOL
    # the sample whose crossover is num_ws takes z1's style everywhere
    np.testing.assert_allclose(got[2], model(t(z1[2:]), noise=[[p[2:] for p in s]
                                                               for s in noise])[0].detach(),
                               rtol=1e-5, atol=1e-6)
    assert not np.allclose(got[0], unmixed[0])


def test_truncation_matches_jax():
    """`w_average` over JAX's latents, and `apply_truncated` with that
    w_avg passed at psi 0.7 and 0 (every image the mean image)."""
    jcfg, g, params = jax_model("const_noise")
    model = port_model(jcfg, params)
    key = jax.random.PRNGKey(3)
    want_avg = np.asarray(jsg.w_average(jcfg, params, key, n=256))
    zs = np.asarray(jax.random.normal(key, (256, jcfg.latent_dim), jnp.float32))
    with torch.no_grad():
        got_avg = sg.w_average(model, z=t(zs)).numpy()
    assert rel_err(got_avg, want_avg) < 1e-5
    z, _ = inputs(jcfg)
    for psi in (0.7, 0.0):
        want = np.asarray(jsg.apply_truncated(jcfg, params, j(z), psi=psi,
                                              w_avg=j(want_avg)))
        with torch.no_grad():
            got = sg.apply_truncated(model, t(z), psi=psi, w_avg=t(want_avg)).numpy()
        assert rel_err(got, want) < TOL, (psi, rel_err(got, want))
    np.testing.assert_allclose(got[0], got[1], atol=1e-6)


def test_sampling_with_truncation_psi():
    """`generate_samples(truncation_psi=...)`: uint8 images, psi 0 the mean
    image for every latent; the locate family refuses with JAX's message."""
    jcfg, _, params = jax_model("last")
    model = port_model(jcfg, params)
    gen = torch.Generator()
    gen.manual_seed(0)
    imgs = generate_samples(model, gen, 4, truncation_psi=0.7)
    assert imgs.shape == (4, 16, 16, 3) and imgs.dtype == np.uint8
    assert len({imgs[i].tobytes() for i in range(4)}) == 4
    flat = generate_samples(model, gen, 3, truncation_psi=1e-9)
    assert np.abs(flat[0].astype(int) - flat[1].astype(int)).max() <= 1
    locate = build_generator(dataclasses.replace(port_config(jcfg), arch="locate"),
                             "float32", device="cpu")
    with pytest.raises(ValueError, match="w-space truncation"):
        generate_samples(locate, gen, 2, truncation_psi=0.7)


def test_const_noise_planes_are_jax():
    """Each styled conv's const plane is JAX's `_const_noise_plane` of its
    layer index, bit for bit, and lives outside the state_dict."""
    jcfg, _, params = jax_model("skip_const_nodemod")
    model = port_model(jcfg, params)
    for i, stage in enumerate(model.stages):
        for k, conv in enumerate(stage.convs):
            li = model.li_conv(i, k)
            res = model.resolutions[i]
            np.testing.assert_array_equal(conv.noise_const.numpy(),
                                          np.asarray(jsg._const_noise_plane(li, res, res)))
    assert not any("noise_const" in k for k in model.state_dict())


@pytest.mark.parametrize("case", ["last", "skip_const_nodemod", "classes"])
def test_export_round_trips(case, tmp_path):
    """A JAX export loads into the port (the same images), a port export
    into the JAX package (the same images), and back into the port
    bitwise."""
    jcfg, g, params = jax_model(case)
    z, labels = inputs(jcfg, 2)
    want = np.asarray(g.apply(params, j(z), j(labels)))
    path = jax_export_generator(jcfg, params, str(tmp_path / "jax_gen"))
    model = load_generator(path, "cpu")
    with torch.no_grad():
        got = model(t(z), t(labels)).numpy()
    assert rel_err(got, want) < TOL
    back = export_generator(model.config, model.state_dict(), str(tmp_path / "port_gen"))
    jgen, jparams = jax_load_generator(back)
    assert jgen.num_ws == model.num_ws
    assert rel_err(np.asarray(jgen.apply(jparams, j(z), j(labels))), want) < TOL
    again = load_generator(back, "cpu")
    assert all(torch.equal(v, model.state_dict()[k]) for k, v in again.state_dict().items())


def test_port_state_dicts_read_back_through_the_torch_bridge(tiny_config):
    """The reverse direction of `locate_tpu/io/torch_bridge.py`: a port
    module's state_dict is the bridge's layout (dotted names, OIHW), so the
    JAX package's `params_from_state_dict` rebuilds the params of a port
    style generator (skip head, const noise) and of a spectrally normalized,
    class-conditional discriminator, which compute the port's outputs."""
    from locate_tpu.io.torch_bridge import params_from_state_dict
    from locate_tpu.models.discriminator import build_discriminator as jax_build_d
    from locate_tpu_torch.models.discriminator import build_discriminator

    jcfg, g, params = jax_model("skip_const_nodemod")
    model = build_generator(port_config(jcfg), "float32", device="cpu", seed=3)
    z, _ = inputs(jcfg, 4)
    back = params_from_state_dict(model.state_dict(), params)
    with torch.no_grad():
        got = model(t(z)).numpy()
    assert rel_err(np.asarray(g.apply(back, j(z))), got) < TOL
    dcfg = dataclasses.replace(tiny_config.model, spectral_norm=True, num_classes=3)
    jd = jax_build_d(dcfg)
    d = build_discriminator(port_config(dcfg), "float32", device="cpu", seed=4)
    x = np.random.default_rng(5).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    labels = np.array([2, 0])
    dparams = params_from_state_dict(d.state_dict(), jd.init(jax.random.PRNGKey(0)))
    with torch.no_grad():
        got = d(t(x), t(labels)).numpy()
    np.testing.assert_allclose(np.asarray(jax.jit(jd.apply)(dparams, j(x), j(labels))), got,
                               rtol=2e-4, atol=2e-4)
