"""Projection (`io/projection.py`) on the port against the JAX package's
`locate_tpu/io/projection.py`, on the CPU in f32 at 16x16: a few Adam
steps of the style family in the z space (the path of either family:
the generator's forward) and in the w and w+ spaces, from the same start
(JAX's latent draw, JAX's w_avg), to the same latents and loss history
within 2e-4; the
reconstruction grid within one uint8 step; the CLI's `project`, `sample
--truncation-psi` and `info` at a cut size."""

import contextlib
import dataclasses
import io
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from locate_tpu import cli as jax_cli
from locate_tpu.config import StyleConfig as JaxStyleConfig
from locate_tpu.io.projection import project as jax_project
from locate_tpu.io.projection import reconstruction_grid as jax_reconstruction_grid
from locate_tpu.models.gan import build_gan as jax_build_gan
from locate_tpu.models.style_generator import w_average as jax_w_average
from locate_tpu_torch import cli
from locate_tpu_torch.io.projection import _pyramid_mse, project, reconstruction_grid
from locate_tpu_torch.models.generator import build_generator
from torch_port_parity import as_state_dict, port_config, randomize_zero_init, rel_err

STEPS = 4
STYLE = dict(arch="style", style=JaxStyleConfig(mapping_layers=2, noise="const"))
TINY = ["model.base_channels=32", "model.max_channels=32", "model.min_channels=16",
        "model.latent_dim=16", "model.resolution=16", "data.resolution=16",
        "data.dataset=synthetic", "train.global_batch=4", "train.compute_dtype=float32",
        "train.log_every=2", "train.sample_every=0", "train.checkpoint_every=2",
        "model.arch=style", "model.style.mapping_layers=2"]


def jax_setup(tiny_config, **model):
    jcfg = dataclasses.replace(tiny_config, model=dataclasses.replace(tiny_config.model,
                                                                      **model))
    jgan = jax_build_gan(jcfg)
    params = randomize_zero_init(jgan.generator.init(jax.random.PRNGKey(0)),
                                 jax.random.PRNGKey(5))
    params = jax.tree.map(lambda l: jnp.full_like(l, 0.3) if l.ndim == 0 else l, params)
    model = build_generator(port_config(jcfg.model), "float32", device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in as_state_dict(params).items()})
    targets = np.random.default_rng(4).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    return jgan, params, model, targets


def test_pyramid_mse_matches_jax():
    from locate_tpu.io.projection import _pyramid_mse as jax_pyramid_mse

    rng = np.random.default_rng(0)
    a, b = rng.standard_normal((2, 2, 16, 16, 3)).astype(np.float32)
    np.testing.assert_allclose(float(_pyramid_mse(torch.from_numpy(a), torch.from_numpy(b))),
                               float(jax_pyramid_mse(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-6)


@pytest.mark.parametrize("space", ["z", "w", "w+"])
def test_project_matches_jax(tiny_config, space):
    jgan, params, model, targets = jax_setup(tiny_config, **STYLE)
    key = jax.random.PRNGKey(0)
    want_z, want_hist = jax_project(jgan, params, targets, steps=STEPS, space=space, key=key)
    kw = {}
    if space == "z":
        kw["z0"] = torch.from_numpy(np.array(jgan.sample_latents(key, 2), np.float32))
    else:
        kw["w_avg"] = torch.from_numpy(np.array(
            jax_w_average(jgan.config, params, jax.random.fold_in(key, 1))))
    got_z, got_hist = project(model, targets, steps=STEPS, space=space, **kw)
    assert got_z.shape == want_z.shape and got_hist.shape == (STEPS,)
    assert got_hist[-1] < got_hist[0]
    np.testing.assert_allclose(got_hist, want_hist, rtol=2e-4)
    assert rel_err(got_z, want_z) < 2e-4
    grid = reconstruction_grid(model, targets, got_z, space=space)
    want_grid = jax_reconstruction_grid(jgan, params, targets, want_z, space=space)
    assert grid.shape == want_grid.shape == (4, 16, 16, 3) and grid.dtype == np.uint8
    assert np.abs(grid.astype(int) - want_grid.astype(int)).max() <= 1


def test_w_space_needs_the_style_family(tiny_config):
    model = build_generator(port_config(tiny_config.model), "float32", device="cpu")
    targets = np.zeros((2, 16, 16, 3), np.float32)
    with pytest.raises(ValueError, match="needs model.arch='style'"):
        project(model, targets, steps=1, space="w+")


def run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return out.getvalue()


def test_cli_project_sample_and_info(tmp_path):
    """`train` two steps of the style family, then `project` in the w+ space
    from a .npy (the loss falls, the latents have num_ws styles, the
    reconstruction grid is written), `sample --truncation-psi`, and
    `info`'s num_ws beside the JAX command's JSON."""
    work = tmp_path / "run"
    args = ["cifar10_32", *TINY, "train.total_steps=2", f"workdir={work}", "--device=cpu"]
    run(cli.main, ["train", *args])
    imgs = np.random.default_rng(0).integers(0, 256, (3, 16, 16, 3), dtype=np.uint8)
    np.save(tmp_path / "imgs.npy", imgs)
    out, recon = tmp_path / "z.npz", tmp_path / "recon.png"
    text = run(cli.main, ["project", *[a for a in args if not a.startswith("train.total")],
                          f"--images={tmp_path / 'imgs.npy'}", "--steps=5", "--space=w+",
                          f"--out={out}", f"--recon={recon}"])
    assert "projected 3 images in 5 steps" in text and recon.is_file()
    with np.load(out) as npz:
        z, hist = npz["z"], npz["loss_history"]
        assert str(npz["space"]) == "w+"
    cfg_ws = json.loads(run(cli.main, ["info", "cifar10_32", *TINY[:5],
                                       "model.arch=style", "model.style.mapping_layers=2"]))
    assert z.shape == (3, cfg_ws["num_ws"], 16) and hist[-1] < hist[0]
    grid = tmp_path / "grid.png"
    run(cli.main, ["sample", *[a for a in args if not a.startswith("train.total")],
                   "--count=4", "--truncation-psi=0.7", f"--out={grid}"])
    assert grid.is_file()
    argv = ["info", "celeba_64", "model.arch=style", "model.style.mapping_layers=8",
            "model.g_rgb=skip", "parallel.data_parallel=1"]
    port, want = json.loads(run(cli.main, argv)), json.loads(run(jax_cli.main, argv))
    assert port == want and port["num_ws"] == 10  # five stages, a conv and a to-RGB each
