"""The style family's train step on the port against the jitted JAX step:
two alternating steps with R1 and path-length regularization, style
mixing at probability 0.9 and random noise, the port on its gate
Function, from one state (the noise strengths set to 0.3 so the planes
matter) with JAX's draws passed in (`tests/torch_step_draws.py`
`style_draws`: the second latent, the crossover and every noise plane of
both G forwards). The options run together in one two-step run (one JAX
jit compile); each case holds its own option's part of that run.
Tolerances as the other step tests: metrics and the path-length mean
2e-4 relative (1e-5 absolute), params 1e-3 norm-relative per leaf. Then
the draw names the port makes itself, and the flavors that share one
forward's draws. Spectral norm's two steps with R1 are
tests/test_torch_spectral.py's."""

import jax
import jax.numpy as jnp
import pytest
import torch

from locate_tpu.config import StyleConfig as JaxStyleConfig
from locate_tpu.models.gan import build_gan as jax_build_gan
from locate_tpu_torch.models.gan import build_gan
from locate_tpu_torch.train.state import create_train_state
from locate_tpu_torch.train.step import make_train_step
from torch_step_draws import configs, run_parity

STYLE = JaxStyleConfig(mapping_layers=2, mixing_prob=0.9, noise="random")
TRAIN = dict(r1_gamma=0.1, r1_interval=1, pl_gamma=2.0, pl_interval=1)


def noisy_strengths(state):
    """The JAX state with every `noise_strength` leaf at 0.3."""
    def set_strength(path, leaf):
        last = path[-1]
        return (jnp.full_like(leaf, 0.3)
                if getattr(last, "key", None) == "noise_strength" else leaf)
    return state.replace(g_params=jax.tree_util.tree_map_with_path(set_strength,
                                                                   state.g_params))


@pytest.fixture(scope="module")
def two_steps(tiny_config):
    jcfg, tcfg = configs(tiny_config, train=TRAIN, model=dict(arch="style", style=STYLE))
    draws = []
    pm, jm, pstate, _ = run_parity(jcfg, tcfg, use_pallas=True, state_fn=noisy_strengths,
                                   record=draws)
    return jcfg, pm, jm, pstate, draws


@pytest.mark.parametrize("part", ["r1", "pl", "mixing", "random_noise"])
def test_style_train_step_matches_jax(two_steps, part):
    """`run_parity` held every metric and parameter of both steps. Each
    case then shows its option took part: R1 and PL fired in both
    nets' matched metrics (PL's mean moved); the crossovers fed to both G
    forwards of each step lay in [1, num_ws] and crossed below num_ws on
    some sample; each G forward got a fresh plane a styled conv, at its
    stage's resolution, and the strengths stayed non-zero."""
    jcfg, pm, jm, pstate, draws = two_steps
    n = jcfg.train.global_batch
    if part in ("r1", "pl"):
        assert float(jm[part]) != 0.0 and float(pm[part]) != 0.0
        if part == "pl":
            assert float(pstate.pl_mean) != 0.0
    elif part == "mixing":
        num_ws = jax_build_gan(jcfg).generator.num_ws
        for step in draws:
            for side in ("d", "g"):
                cut = step[f"mix_cut_{side}"]
                assert tuple(step[f"mix_z2_{side}"].shape) == (n, jcfg.model.latent_dim)
                assert int(cut.min()) >= 1 and int(cut.max()) <= num_ws
                assert bool((cut < num_ws).any()), (side, cut)
    else:
        m = jcfg.model
        for step in draws:
            for side in ("d", "g"):
                for i, r in enumerate(m.stage_resolutions()):
                    for k in range(m.blocks_per_stage):
                        assert tuple(step[f"g_noise_{side}.{i}.{k}"].shape) == (n, r, r, 1)
        assert all(float(v) != 0.0
                   for k, v in pstate.g_params.named(pstate.g_params.flat).items()
                   if k.endswith("noise_strength"))


def _port_step(tiny_config, **train):
    jcfg, tcfg = configs(tiny_config, train={**TRAIN, **train},
                         model=dict(arch="style", style=STYLE))
    gan = build_gan(tcfg, device="cpu")
    return tcfg, gan, create_train_state(tcfg, gan), make_train_step(tcfg, gan)


@pytest.mark.parametrize("flavor,names,absent", [
    ({}, {"mix_z2_d", "mix_cut_d", "g_noise_d.1.0", "mix_z2_g", "mix_cut_g", "g_noise_g.0.0"},
     set()),
    ({"share_latents": True}, {"mix_z2_d", "mix_cut_d", "g_noise_d.0.0"},
     {"mix_z2_g", "mix_cut_g", "g_noise_g.0.0"}),
    ({"fused_step": True}, {"mix_z2_d", "mix_cut_d", "g_noise_d.1.0"},
     {"mix_z2_g", "g_noise_g.0.0"}),
    ({"d_steps": 2}, {"mix_z2_d", "g_noise_d.0.0", "mix_z2_g", "g_noise_g.1.0"}, set()),
])
def test_style_draw_names(tiny_config, flavor, names, absent):
    """The step draws each style draw by name from the state's generator:
    two G forwards' draws in the alternating flavor, one forward's where
    JAX reuses the forward's key (share_latents, fused), the critics'
    stacked under d_steps; a crossover lies in [1, num_ws]."""
    tcfg, gan, state, step = _port_step(tiny_config, **flavor)
    n = tcfg.train.global_batch
    draws = step.draw(state, (n, 8, 8, 3), (True, True), {})
    assert names <= set(draws) and not absent & set(draws)
    cut = draws["mix_cut_d"]
    assert cut.dtype == torch.int32 and int(cut.min()) >= 1 and int(cut.max()) <= gan.num_ws
    lead = (2,) if "d_steps" in flavor else ()
    assert tuple(draws["g_noise_d.1.0"].shape) == lead + (n, 8, 8, 1)
