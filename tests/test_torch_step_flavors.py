"""The multi-critic and the fused simultaneous flavors of the train step,
each with R1 gamma 1 firing at step 0 (a regularizer through the plain
twin beside the gate Functions: under d_steps in every critic update, in
the fused flavor two backward passes through D's Functions on one
forward), held on the port against the jitted JAX step: two steps from
one state with the same draws (the critics' key families under d_steps),
f32 on the CPU. Tolerances as in `test_torch_step_options.py`. The
multi-option combinations are slow (`test_torch_recipes_slow.py`)."""

import pytest

from torch_step_draws import configs, run_parity


@pytest.mark.parametrize("override", [dict(d_steps=2), dict(fused_step=True)],
                         ids=["d_steps=2", "fused_step"])
def test_flavor_matches_jax(tiny_config, override):
    jcfg, tcfg = configs(tiny_config, train={"r1_gamma": 1.0, **override})
    pm, jm, _, _ = run_parity(jcfg, tcfg, use_pallas=True)
    assert float(jm["r1"]) == 0.0
