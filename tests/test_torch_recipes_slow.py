"""Slow parity cases of the train step's options (`python -m pytest -m slow
tests/test_torch_recipes_slow.py`): multi-option combinations of each
flavor; the six recipes that chip_smoke.py trains at lsun_bedroom_128's
full width, here at the tiny widths, each
two steps against the jitted JAX step with the same draws (f32, CPU,
the tolerances of `test_torch_step_options.py`); and both packages on
their kernel paths, the JAX step's Pallas kernels in interpret mode
(minutes of compile), for the two compositions new to the gate
Functions: the fused flavor's two backward passes through one forward,
and G's backward through ADA's augmentation."""

import pytest
import torch

from torch_step_draws import BATCH, configs, run_noise_parity, run_parity

RECIPES = {
    "limited_data": dict(ada_target=0.6, bcr_gamma=10.0, lecam_gamma=0.3, r1_gamma=1.0),
    "r3gan": dict(loss="rpgan", r1_gamma=0.1, r2_gamma=0.1),
    "wgan_gp": dict(loss="wgan", gp_gamma=10.0, d_steps=5),
    "fused": dict(fused_step=True, r1_gamma=1.0),
    "pl_ortho": dict(pl_gamma=2.0, ortho_gamma=1e-4, r1_gamma=1.0),
    "accum_bf16_schedule": dict(grad_accum=2, ema_dtype="bfloat16",
                                lr_schedule="linear_warmup_cosine", warmup_steps=2,
                                total_steps=8, ema_rampup=0.05, r1_gamma=1.0),
}


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(RECIPES))
def test_recipe_matches_jax(tiny_config, name):
    """WGAN-GP with 5 critic steps holds its second step within ten times
    the JAX step's own move under 1e-7 weight noise (`run_noise_parity`):
    there the port's g_loss (-0.0547, the mean of logits that nearly
    cancel) differs from the JAX step's by 6.2e-4 on PyTorch's default
    threads, and the JAX step's own moves by as much under one of three
    noise draws (`torch_step_gaps.py`, ROADMAP.md Queue 3)."""
    jcfg, tcfg = configs(tiny_config, train=RECIPES[name])
    if name == "wgan_gp":
        run_noise_parity(jcfg, tcfg, n=BATCH, scale=0.2)
    else:
        run_parity(jcfg, tcfg, use_pallas=True)


@pytest.mark.slow
def test_wgan_gp_two_steps_match_jax_on_one_thread(tiny_config):
    """WGAN-GP with 5 critic steps, two steps (10 D updates), the port on
    one CPU thread, where its step 2 lands on the JAX step's outcome:
    every metric of both steps within 2e-4 (1e-5 absolute), params as
    `compare_params` says."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        jcfg, tcfg = configs(tiny_config, train=RECIPES["wgan_gp"])
        run_parity(jcfg, tcfg, steps=2, use_pallas=True)
    finally:
        torch.set_num_threads(threads)


@pytest.mark.slow
@pytest.mark.parametrize("override", [
    dict(fused_step=True, augment_p=0.3, pl_gamma=2.0, pl_interval=1, bcr_gamma=1.0,
         r1_gamma=1.0),
    dict(d_steps=2, gp_gamma=10.0, ada_target=0.6, lecam_gamma=0.1, r1_gamma=1.0),
    dict(lr_schedule="linear_warmup_cosine", warmup_steps=2, total_steps=8, grad_accum=2,
         r1_gamma=1.0),
], ids=["fused_ada_pl_bcr", "d_steps_gp_ada_lecam", "schedule_grad_accum"])
def test_combination_matches_jax(tiny_config, override):
    """Options together in one step, each flavor with several regularizers
    (the schedule's count is the inner Adam count, which moves on
    MultiSteps' emits only: three steps)."""
    jcfg, tcfg = configs(tiny_config, train=override)
    run_parity(jcfg, tcfg, steps=3 if "grad_accum" in override else 2, use_pallas=True)


@pytest.mark.slow
@pytest.mark.parametrize("override", [dict(fused_step=True, r1_gamma=1.0),
                                      dict(augment_p=0.5, ada_target=0.6, r1_gamma=1.0)],
                         ids=["fused", "ada"])
def test_kernel_paths_match_jax_pallas_interpret(tiny_config, override):
    jcfg, tcfg = configs(tiny_config, train=override, use_pallas=True)
    run_parity(jcfg, tcfg, use_pallas=True)
