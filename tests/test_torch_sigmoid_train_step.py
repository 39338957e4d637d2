"""The port's alternating train step with the sigmoid gate against the JAX
package's, on the CPU in float32: the ffhq_512 recipe (lazy R1 gamma 0.1
firing at step 0, remat, grad_norm_limit 1e6, non-finite skips 200) with
`model.attention.mode=sigmoid`, cut to 16x16 and widths 32..16.

Both start from one JAX `create_train_state` (zero-init leaves filled),
carried over by `state_from_jax`; the port takes JAX's latents. The JAX
step runs jitted on its XLA composition (use_pallas off), the exact
reference; the port runs use_pallas: its gates through `SigmoidGate` (on a
profile holding the JAX layer's bound, the kernel at H*W <= 256), or
with `FUSE_MIN_LOCATIONS = 0` every stage through `FusedStage`, and R1
through the kernel-free twin of D either way. Two steps; metrics and
parameters to the tolerances of tests/test_torch_train_step.py."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from locate_tpu import config as jconfig
from locate_tpu.models.gan import build_gan as jax_build_gan
from locate_tpu.train.step import make_train_step as jax_make_train_step
from locate_tpu_torch.models.gan import build_gan
from locate_tpu_torch.nn import blocks
from locate_tpu_torch.ops import fused_attention as fa
from locate_tpu_torch.ops import fused_stage as fs
from locate_tpu_torch.train.state import state_from_jax
from locate_tpu_torch.train.step import make_train_step
from test_torch_train_step import compare_params, jax_state
from torch_port_parity import port_config, use_jax_sigmoid_bound

BATCH = 2
SMALL = {"model.resolution": "16", "data.resolution": "16", "model.base_channels": "32",
         "model.max_channels": "32", "model.min_channels": "16", "model.latent_dim": "16",
         "train.global_batch": str(BATCH), "train.compute_dtype": "float32",
         "model.attention.mode": "sigmoid"}


def jax_latents(jgan, state):
    """z_d and z_g exactly as the JAX alternating step draws them."""
    _, k_zd, k_zg, _, _ = jax.random.split(state.rng, 5)
    return (np.asarray(jgan.sample_latents(k_zd, BATCH)),
            np.asarray(jgan.sample_latents(k_zg, BATCH)))


@pytest.mark.parametrize("fuse", [False, True])
def test_two_steps_match_jax(monkeypatch, tmp_path, fuse):
    use_jax_sigmoid_bound(monkeypatch, tmp_path)
    jcfg = jconfig.get_config("ffhq_512", SMALL)
    tcfg = port_config(jcfg)
    assert tcfg.use_pallas and tcfg.model.remat and tcfg.train.r1_gamma == 0.1
    jcfg = dataclasses.replace(jcfg, use_pallas=False,
                               model=dataclasses.replace(jcfg.model, use_pallas=False))
    jgan = jax_build_gan(jcfg)
    jstate = jax_state(jcfg, jgan)
    jstep = jax.jit(jax_make_train_step(jcfg, jgan))
    if fuse:
        monkeypatch.setattr(blocks, "FUSE_MIN_LOCATIONS", 0)
    ran = set()
    for module, name in ((fs, "stage_sigmoid"), (fa, "sigmoid_gate"),
                         (fa, "sigmoid_gate_backward")):
        original = getattr(module, name)
        monkeypatch.setattr(module, name,
                            lambda *a, _n=name, _f=original, **kw: ran.add(_n) or _f(*a, **kw))
    gan = build_gan(tcfg, device="cpu")
    pstate = state_from_jax(jstate, tcfg, gan)
    step = make_train_step(tcfg, gan)
    rng = np.random.default_rng(0)
    b = {"image": rng.integers(0, 256, (BATCH, 16, 16, 3), dtype=np.uint8),
         "label": np.zeros(BATCH, np.int32)}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    for i in range(2):
        z_d, z_g = jax_latents(jgan, jstate)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        pstate, pm = step(pstate, tb, z_d=torch.from_numpy(z_d.copy()),
                          z_g=torch.from_numpy(z_g.copy()))
        assert set(pm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-4, atol=1e-5,
                                       err_msg=f"step {i} {k}")
        compare_params(pstate, jstate, steps=i + 1, lr=tcfg.train.g_opt.lr)
    assert float(jm["r1"]) == 0.0 < float(pm["d_loss"])
    want = {"stage_sigmoid"} if fuse else {"sigmoid_gate"}
    assert ran == want | {"sigmoid_gate_backward"}
