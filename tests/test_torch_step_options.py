"""Each option of the JAX train step that acts on D's update, held on the
port against the jitted JAX step: two steps from one JAX state (carried
over by `state_from_jax`) with the same draws (`torch_step_draws.py`
makes the JAX step's, augmentation parameters and GP's eps included), on
the CPU in float32 at the tiny widths (8x8: two stages a net, a gate in
each), with the flagship's guards, the port on its gate Function
(use_pallas), the JAX step on its XLA composition. The seven options run
together in one step (`JOINT`: one JAX jit compile of about 15 s for the
file), and each case holds its own option's part of that run.

Tolerances: every metric 2e-4 relative (1e-5 absolute); ADA's p, LeCam's
trackers and the path-length mean alike; G, D and EMA params per leaf
1e-3 norm-relative (Adam's first steps are close to lr * sign(g), so an
element whose gradient sits near 0 may flip; the softmax gates' logit
biases, whose gradients are rounding noise, within their Adam moves)."""

import pytest

from torch_step_draws import configs, run_parity

OPTIONS = [
    dict(augment_p=0.2),
    dict(bcr_gamma=1.0),
    dict(lecam_gamma=0.1),
    dict(gp_gamma=10.0),
    dict(r2_gamma=1.0),
    dict(logit_penalty=1e-3),
    dict(r1_gamma=1.0, r1_batch_fraction=0.5),
]
JOINT = {k: v for o in OPTIONS for k, v in o.items()}


@pytest.fixture(scope="module")
def joint(tiny_config):
    """(JAX config, the last step's port and JAX metrics, the port state)
    of two steps with every option of `OPTIONS` on."""
    jcfg, tcfg = configs(tiny_config, train=JOINT)
    pm, jm, pstate, _ = run_parity(jcfg, tcfg, use_pallas=True)
    return jcfg, pm, jm, pstate


@pytest.mark.parametrize("override", OPTIONS,
                         ids=lambda o: ",".join(f"{k}={v}" for k, v in o.items()))
def test_d_option_matches_jax(joint, override):
    jcfg, pm, jm, pstate = joint
    assert all(getattr(jcfg.train, k) == v for k, v in override.items())
    # lazy R1 and R2 fired at step 0 only
    assert float(jm["r1"]) == float(jm["r2"]) == 0.0
    metric = {"bcr_gamma": "bcr", "lecam_gamma": "lecam", "gp_gamma": "gp",
              "logit_penalty": "drift"}
    for key in override:
        if key in metric:
            assert float(jm[metric[key]]) != 0.0, key
    if "augment_p" in override:
        assert float(pm["augment_p"]) == pytest.approx(0.2)
    if "lecam_gamma" in override:
        assert pstate.lecam is not None and float(pstate.lecam.abs().max()) > 0.0
