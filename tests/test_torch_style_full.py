"""The style family at celeba_64's full width and depth (channels 512 down
to 64, five stages to 64x64, attention at every stage, mapping 8 layers:
docs/GUIDE.md's recipe) in f32 on the CPU against the JAX package: the
generator's forward on the same weights with both heads, and one train
step with PL, R1, style mixing and random noise, JAX's draws passed in.
Slow (minutes of JAX compile and a few GiB):
`python -m pytest -m slow tests/test_torch_style_full.py`. The
norm-relative params tolerance is 2e-3 at these widths, as
tests/test_torch_presets_full.py."""

import numpy as np
import jax
import pytest
import torch

from locate_tpu.config import get_config
from locate_tpu.models.generator import build_generator as jax_build_generator
from locate_tpu_torch.models.generator import build_generator
from test_torch_presets import SCALE
from torch_port_parity import as_state_dict, port_config, randomize_zero_init, rel_err
from torch_step_draws import run_parity

RECIPE = {"model.arch": "style", "model.style.mapping_layers": "8",
          "train.pl_gamma": "2.0", "train.r1_gamma": "0.1", "train.compute_dtype": "float32",
          "train.global_batch": "2"}


@pytest.mark.slow
@pytest.mark.parametrize("head", ["last", "skip"])
def test_celeba_64_style_forward_matches_jax(head):
    jcfg = get_config("celeba_64", {**RECIPE, "model.g_rgb": head,
                                    "model.style.noise": "const", "use_pallas": "true"})
    g = jax_build_generator(jcfg.model)
    params = randomize_zero_init(g.init(jax.random.PRNGKey(0)), jax.random.PRNGKey(5), SCALE)
    model = build_generator(port_config(jcfg.model), "float32", device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in as_state_dict(params).items()})
    z = np.random.default_rng(0).standard_normal((2, jcfg.model.latent_dim)).astype(np.float32)
    want = np.asarray(jax.jit(g.apply)(params, z))
    with torch.no_grad():
        got = model(torch.from_numpy(z)).numpy()
    assert got.shape == (2, 64, 64, 3) and rel_err(got, want) < 2e-4


@pytest.mark.slow
def test_celeba_64_style_train_step_matches_jax():
    jcfg = get_config("celeba_64", {**RECIPE, "model.style.mixing_prob": "0.9",
                                    "model.style.noise": "random", "model.g_rgb": "skip"})
    run_parity(jcfg, port_config(jcfg), steps=1, use_pallas=True, n=2, param_tol=2e-3,
               scale=SCALE)
