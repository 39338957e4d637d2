"""The options of the JAX train step that act on the optimizers and the
EMA (grad_accum, the LR schedules, the bf16 shadow with its stochastic
rounding, ema_rampup), held on the port against the jitted JAX step as
`test_torch_step_options.py` holds D's options: two steps with the same
draws (the bf16 EMA's random bits the JAX step's, in the port's parameter
order), the port on its gate Function, the four options together in one
step (`JOINT`, one JAX jit compile), each case holding its own option's
part. Tolerances as there; the bf16 shadow within 1e-3 norm-relative per
leaf given the same bits."""

import pytest

from torch_step_draws import configs, run_parity

OPTIONS = [
    dict(grad_accum=2),
    dict(lr_schedule="cosine", total_steps=4),
    dict(ema_dtype="bfloat16"),
    dict(ema_rampup=0.05),
]
JOINT = {k: v for o in OPTIONS for k, v in o.items()}


@pytest.fixture(scope="module")
def joint(tiny_config):
    """(JAX config, the port state) of two steps with every option of
    `OPTIONS` on."""
    jcfg, tcfg = configs(tiny_config, train=JOINT)
    _, _, pstate, _ = run_parity(jcfg, tcfg, use_pallas=True)
    return jcfg, pstate


@pytest.mark.parametrize("override", OPTIONS,
                         ids=lambda o: ",".join(f"{k}={v}" for k, v in o.items()))
def test_optimizer_and_ema_option_matches_jax(joint, override):
    jcfg, pstate = joint
    assert all(getattr(jcfg.train, k) == v for k, v in override.items())
    if "grad_accum" in override:  # step 1 emitted: the optimizers' counts moved once
        assert int(pstate.g_opt_state.count) == 1 and int(pstate.g_opt_state.mini_step) == 0
    if "ema_dtype" in override:
        assert str(pstate.ema_params.dtype) == "torch.bfloat16"
