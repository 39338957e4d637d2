"""How far apart the port's train step and the jitted JAX step drift over
two steps, beside how far each moves on its own, at the tiny widths on
the CPU (f32, 8x8, batch 4, `torch_step_draws.configs`):

    python tests/torch_step_gaps.py ['{"loss": "wgan", "d_steps": 5}' ...]

For each train override (default: WGAN-GP with 5 critic steps, and the
same with one of its three parts left out) it prints, a step and a
metric (d_grad_norm, g_grad_norm, d_loss, g_loss), the relative
difference from the jitted JAX step of: the port on PyTorch's default
CPU threads and on one thread (same state, same draws, the gate
Function); the port's two thread counts from each other; the JAX step
from weights moved by 1e-7 relative noise (the largest of three draws);
and the JAX step run op by op."""

import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import torch_step_draws as sd  # noqa: E402
from conftest import tiny_config  # noqa: E402
from locate_tpu.models.gan import build_gan as jax_build_gan  # noqa: E402
from locate_tpu.train.step import make_train_step as jax_make_train_step  # noqa: E402
from locate_tpu_torch.models.gan import build_gan  # noqa: E402
from locate_tpu_torch.train.state import state_from_jax  # noqa: E402
from locate_tpu_torch.train.step import make_train_step  # noqa: E402

KEYS = ("d_grad_norm", "g_grad_norm", "d_loss", "g_loss")
WGAN_GP = {"loss": "wgan", "gp_gamma": 10.0, "d_steps": 5}


def gaps(override, steps=2):
    jcfg, tcfg = sd.configs(tiny_config.__wrapped__(), train=override)
    tcfg = dataclasses.replace(tcfg, use_pallas=True)
    jgan = jax_build_gan(jcfg)
    start = sd.jax_state(jcfg, jgan)
    raw = jax_make_train_step(jcfg, jgan)
    jstep = jax.jit(raw)
    b = sd.batch(jcfg)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}

    def jax_run(step, state):
        out = []
        for _ in range(steps):
            state, m = step(state, jb)
            out.append({k: float(m[k]) for k in KEYS})
        return out

    ref = jax_run(jstep, start)
    with jax.disable_jit():
        op_by_op = jax_run(raw, start)
    noisy = [jax_run(jstep, sd.perturbed(start, jax.random.PRNGKey(s))) for s in (11, 12, 13)]
    layout = state_from_jax(start, tcfg, build_gan(tcfg, device="cpu"))
    draws, state = [], start
    for _ in range(steps):
        draws.append(sd.jax_draws(jcfg, jgan, state, layout, b["image"].shape[-4:]))
        state, _ = jstep(state, jb)

    def port_run(threads):
        before = torch.get_num_threads()
        torch.set_num_threads(threads)
        try:
            gan = build_gan(tcfg, device="cpu")
            pstate, step, out = state_from_jax(start, tcfg, gan), make_train_step(tcfg, gan), []
            for d in draws:
                pstate, m = step(pstate, tb, **d)
                out.append({k: float(m[k]) for k in KEYS})
            return out
        finally:
            torch.set_num_threads(before)

    default, one = port_run(torch.get_num_threads()), port_run(1)

    def rel(a, b):
        return abs(a - b) / max(abs(b), 1e-30)

    return [{k: {"port_threads_vs_jax": rel(default[i][k], ref[i][k]),
                 "port_one_thread_vs_jax": rel(one[i][k], ref[i][k]),
                 "port_threads_vs_one_thread": rel(default[i][k], one[i][k]),
                 "jax_under_1e-7_noise": max(rel(n[i][k], ref[i][k]) for n in noisy),
                 "jax_op_by_op_vs_jit": rel(op_by_op[i][k], ref[i][k]),
                 "jax_value": ref[i][k]} for k in KEYS} for i in range(steps)]


def main(argv):
    overrides = [json.loads(a) for a in argv] or [
        WGAN_GP, {"loss": "wgan", "gp_gamma": 10.0, "d_steps": 1},
        {"loss": "wgan", "d_steps": 5}, {"gp_gamma": 10.0, "d_steps": 5}]
    print(json.dumps({"torch_threads": torch.get_num_threads()}))
    for override in overrides:
        print(json.dumps({"override": override, "steps": gaps(override)}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
