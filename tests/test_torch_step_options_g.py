"""Each option of the JAX train step that acts on G's update, held on the
port against the jitted JAX step as `test_torch_step_options.py` holds
D's: two steps, the same draws (PL's noise is the JAX step's), the port
on its gate Function, the five options together in one step (`JOINT`,
one JAX jit compile), each case holding its own option's part. PL's
interval is 4: it fires at step 0. Tolerances as there: metrics and the
path-length mean 2e-4 relative (1e-5 absolute), params 1e-3
norm-relative per leaf."""

import pytest

from torch_step_draws import configs, run_parity

OPTIONS = [
    dict(pl_gamma=2.0),
    dict(ortho_gamma=1e-4),
    dict(feature_matching=1.0),
    dict(topk_fraction=0.5),
    dict(share_latents=True),
]
JOINT = {k: v for o in OPTIONS for k, v in o.items()}


@pytest.fixture(scope="module")
def joint(tiny_config):
    """(JAX config, the last step's JAX metrics, the port state) of two
    steps with every option of `OPTIONS` on."""
    jcfg, tcfg = configs(tiny_config, train=JOINT)
    _, jm, pstate, _ = run_parity(jcfg, tcfg, use_pallas=True)
    return jcfg, jm, pstate


@pytest.mark.parametrize("override", OPTIONS,
                         ids=lambda o: ",".join(f"{k}={v}" for k, v in o.items()))
def test_g_option_matches_jax(joint, override):
    jcfg, jm, pstate = joint
    assert all(getattr(jcfg.train, k) == v for k, v in override.items())
    if "pl_gamma" in override:  # fired at step 0 (pl_interval 4): the mean moved
        assert float(pstate.pl_mean) != 0.0 and float(jm["pl"]) == 0.0
    if "ortho_gamma" in override:
        assert float(jm["ortho"]) > 0.0
    if "feature_matching" in override:
        assert float(jm["fm"]) > 0.0
