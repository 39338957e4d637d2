"""The six GAN loss families beside nonsat, each held on the port against
the jitted JAX step: two steps from one state with the same draws, the
port on its gate Function, f32 on the CPU. Tolerances as in
`test_torch_step_options.py` (under wgan, ragan, rahinge and rpgan, which
a shift of every logit leaves unchanged, D's head bias has a rounding-
noise gradient: it and the mean logits are held within its Adam moves)."""

import pytest

from torch_step_draws import configs, run_parity


@pytest.mark.parametrize("kind", ["hinge", "wgan", "lsgan", "ragan", "rahinge", "rpgan"])
def test_loss_family_matches_jax(tiny_config, kind):
    jcfg, tcfg = configs(tiny_config, train={"loss": kind})
    run_parity(jcfg, tcfg, use_pallas=True)
