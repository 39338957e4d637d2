"""The port's CLI for training and serving from checkpoints, on the CPU at
16x16: `train` (twice on one workdir: the second resumes), `sample
--checkpoint`, `sample --interpolate`, `export` (with `--torch`) and
`bench-sample --checkpoint` through `cli.main`; `info`'s JSON against the
JAX command's for the five presets; the port's export read by the JAX
package's `load_generator` and by the port's own; `slerp` and
`interpolation_grid`, `stability_digest` and `MetricsLogger` against the
JAX modules on the same inputs."""

import contextlib
import dataclasses
import io
import json
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from locate_tpu import cli as jax_cli
from locate_tpu.io.export import load_generator as jax_load_generator
from locate_tpu.io.sampling import interpolation_grid as jax_interpolation_grid
from locate_tpu.io.sampling import slerp as jax_slerp
from locate_tpu.models.gan import build_gan as jax_build_gan
from locate_tpu.utils import digest as jax_digest
from locate_tpu.utils.metrics import MetricsLogger as JaxMetricsLogger
from locate_tpu_torch import cli
from locate_tpu_torch.io.export import export_generator, load_generator, params_to_jax
from locate_tpu_torch.io.sampling import interpolation_grid, slerp
from locate_tpu_torch.models.generator import build_generator
from locate_tpu_torch.utils import digest
from locate_tpu_torch.utils.metrics import MetricsLogger
from torch_port_parity import as_state_dict, port_config

TINY = ["model.base_channels=32", "model.max_channels=32", "model.min_channels=16",
        "model.latent_dim=16", "model.resolution=16", "data.resolution=16",
        "data.dataset=synthetic", "train.global_batch=4", "train.compute_dtype=float32",
        "train.log_every=2", "train.sample_every=4", "train.checkpoint_every=4"]
PRESETS = ["cifar10_32", "celeba_64", "lsun_bedroom_128", "ffhq_256", "ffhq_512"]


@pytest.fixture(autouse=True)
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return out.getvalue()


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A workdir trained 4 steps by `train`, then resumed to 8."""
    workdir = str(tmp_path_factory.mktemp("cli") / "run")
    args = ["cifar10_32", *TINY, f"workdir={workdir}", "--device=cpu"]
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    try:
        first = run(cli.main, ["train", *args, "train.total_steps=4"])
        second = run(cli.main, ["train", *args, "train.total_steps=8"])
    finally:
        torch.set_num_threads(threads)
    return workdir, args, first, second


def test_train_runs_and_resumes(trained):
    workdir, _, first, second = trained
    assert "[locate-tpu-torch] step 4 " in first and "resumed" not in first
    assert "resumed from step 4" in second and "[locate-tpu-torch] step 8 " in second
    assert "run stability digest" in second
    assert sorted(os.listdir(os.path.join(workdir, "checkpoints"))) == ["4", "8"]
    assert sorted(os.listdir(os.path.join(workdir, "samples"))) == [
        "step_00000004.png", "step_00000008.png"]
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        assert [json.loads(line)["step"] for line in f] == [2, 4, 6, 8]
    with open(os.path.join(workdir, "config.json")) as f:
        assert json.load(f)["train"]["global_batch"] == 4


def test_sample_from_the_checkpoint_and_from_its_export(trained, tmp_path):
    """`sample --checkpoint` and `sample --generator` on its export write
    the same PNG for one seed; `--interpolate` writes a rows x cols sheet."""
    workdir, args, _, _ = trained
    out = run(cli.main, ["sample", *args, "--seed=3", "--count=6", f"--out={tmp_path}/a.png"])
    assert "step 8" in out
    run(cli.main, ["export", *args, f"--out={tmp_path}/gen", f"--torch={tmp_path}/gen.pt"])
    run(cli.main, ["sample", *args, f"--generator={tmp_path}/gen.npz", "--seed=3", "--count=6",
                   f"--out={tmp_path}/b.png"])
    assert (tmp_path / "a.png").read_bytes() == (tmp_path / "b.png").read_bytes()
    run(cli.main, ["sample", *args, "--interpolate", "--rows=2", "--cols=3",
                   f"--out={tmp_path}/i.png"])
    assert Image.open(tmp_path / "i.png").size == (3 * 16, 2 * 16)
    # the torch state_dict is the EMA generator's
    model = load_generator(f"{tmp_path}/gen.npz", "cpu")
    sd = torch.load(tmp_path / "gen.pt", weights_only=True)
    assert sd.keys() == model.state_dict().keys()
    assert all(torch.equal(sd[k], v) for k, v in model.state_dict().items())


def test_export_refuses_the_compiled_artifact(trained):
    _, args, _, _ = trained
    with pytest.raises(SystemExit, match="item 11"):
        cli.main(["export", *args, "--compiled-batch=8"])


def test_bench_sample_serves_the_checkpoint(trained):
    _, args, _, _ = trained
    out = json.loads(run(cli.main, ["bench-sample", *args, "--batch=2", "--steps=1"]))
    assert out["weights"] == "ema" and out["value"] > 0
    dp = json.loads(run(cli.main, ["bench-sample", *args, "--batch=3", "--steps=1", "--dp"]))
    assert dp["weights"] == "ema" and dp["value"] > 0 and dp["devices"] == 1
    assert dp["cuda_graph"] is False


def test_debug_nans(trained, tmp_path, monkeypatch):
    """Anomaly mode runs the CPU loop; on the card a graph call cannot
    run in it, so spc > 1 there exits before any work."""
    _, args, _, _ = trained
    out = run(cli.main, ["train", *args, f"workdir={tmp_path}/nan", "train.total_steps=2",
                         "--debug-nans"])
    assert "[locate-tpu-torch] step 2 " in out
    from locate_tpu_torch import device

    monkeypatch.setattr(device, "resolve_device", lambda d=None: torch.device("cuda"))
    with pytest.raises(SystemExit, match="cannot run inside a CUDA graph"):
        cli.main(["train", *args[:-1], "train.steps_per_call=2", "train.total_steps=4",
                  "--debug-nans"])


@pytest.mark.parametrize("command", ["train", "export"])
def test_needs_a_card_or_cpu(monkeypatch, tmp_path, command):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main([command, "cifar10_32", f"workdir={tmp_path}"])
    assert not os.path.exists(tmp_path / "metrics.jsonl")


@pytest.mark.parametrize("preset", PRESETS)
def test_info_matches_the_jax_command(preset):
    argv = ["info", preset, "parallel.data_parallel=1"]
    assert json.loads(run(cli.main, argv)) == json.loads(run(jax_cli.main, argv))


def test_info_counts_the_cards(monkeypatch):
    """`parallel.data_parallel=-1` counts the job's processes, one a card:
    1 in a single process, the launcher's WORLD_SIZE under torchrun."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.delenv("NUM_PROCESSES", raising=False)
    assert json.loads(run(cli.main, ["info", "cifar10_32"]))["data_parallel"] == 1
    monkeypatch.setenv("WORLD_SIZE", "4")
    info = json.loads(run(cli.main, ["info", "cifar10_32", "parallel.zero_stage=1"]))
    assert info["data_parallel"] == 4
    argv = ["info", "cifar10_32", "parallel.data_parallel=4", "parallel.zero_stage=1"]
    assert info == json.loads(run(jax_cli.main, argv))


def test_info_stage_three_keeps_the_parameters_whole():
    """ZeRO-3 keeps the parameters whole on every rank, as ZeRO-1 does
    (only the moments and the EMA shadow are sliced), and `info` says so:
    its bytes a device at stage 3 are stage 1's, above JAX's stage-3
    figure by the parameters the port does not shard."""
    argv = ["info", "cifar10_32", "parallel.data_parallel=4"]
    one, three = (json.loads(run(cli.main, [*argv, f"parallel.zero_stage={z}"]))
                  for z in (1, 3))
    jax_three = json.loads(run(jax_cli.main, [*argv, "parallel.zero_stage=3"]))
    assert three["state_bytes_per_device"] == one["state_bytes_per_device"]
    n = three["params_total"]
    gap = three["state_bytes_per_device"] - jax_three["state_bytes_per_device"]
    assert abs(gap - (n * 4 - n)) <= 1  # both round the bytes down to an int


@pytest.fixture(scope="module")
def jax_generator(tiny_config):
    """A class-conditional JAX GAN at the tiny widths and its G's params."""
    jcfg = dataclasses.replace(tiny_config, model=dataclasses.replace(tiny_config.model,
                                                                      num_classes=3))
    jgan = jax_build_gan(jcfg)
    return jgan, jgan.generator.init(jax.random.PRNGKey(0))


def port_generator(jgan, params):
    model = build_generator(port_config(jgan.config), device="cpu").eval()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in as_state_dict(params).items()})
    return model


def test_export_loads_in_both_packages(jax_generator, tmp_path):
    """A port export of a class-conditional generator: the JAX package's
    `load_generator` gives the same images within 2e-4 on the same
    latents, the port's reads it back bitwise."""
    jgan, params = jax_generator
    model = port_generator(jgan, params)
    path = export_generator(model.config, model.state_dict(), str(tmp_path / "gen"))
    with np.load(path) as npz:
        assert sorted(npz.files) == sorted(params_to_jax(model.state_dict()))
    jgen, jparams = jax_load_generator(path)
    z = np.random.default_rng(0).standard_normal((3, 16)).astype(np.float32)
    labels = np.array([0, 2, 1])
    want = np.asarray(jax.jit(jgen.apply)(jparams, jnp.asarray(z), jnp.asarray(labels)),
                      np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(z), torch.from_numpy(labels)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)
    back = load_generator(path, "cpu")
    assert all(torch.equal(v, model.state_dict()[k]) for k, v in back.state_dict().items())
    assert back.config == model.config


def test_slerp_matches_jax():
    rng = np.random.default_rng(1)
    a, b = rng.standard_normal((2, 5, 16)).astype(np.float32)
    t = np.linspace(0, 1, 5).astype(np.float32)
    got = slerp(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_slerp(a, b, t)), atol=1e-6)
    # parallel vectors take the linear path
    got = slerp(torch.from_numpy(a), torch.from_numpy(2 * a), torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_slerp(a, 2 * a, t)), atol=1e-6)


def test_interpolation_grid_matches_jax(jax_generator):
    """The same latent pairs (JAX's draws from one key) through the same
    weights: the sheets agree within one uint8 step, class r on row r."""
    jgan, params = jax_generator
    key = jax.random.PRNGKey(4)
    want = jax_interpolation_grid(jgan, params, key, rows=4, cols=3)
    ka, kb = jax.random.split(key)
    latents = tuple(torch.from_numpy(np.asarray(jgan.sample_latents(k, 4), np.float32))
                    for k in (ka, kb))
    gen = torch.Generator()
    got = interpolation_grid(port_generator(jgan, params), gen, rows=4, cols=3,
                             latents=latents)
    assert got.shape == want.shape == (12, 16, 16, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_metrics_logger_and_digest_match_jax(tmp_path, capsys):
    """The same rows through both loggers: the same stdout (but the
    prefix) and metrics.jsonl bytes, a torn last line dropped on the
    rewind; the same digest."""
    rows = [(2, {"d_loss": 1.5, "g_loss": 0.7, "d_grad_norm": 3.0, "g_grad_norm": 1e9,
                 "real_logits": 1.2, "fake_logits": -1.0}),
            (4, {"d_loss": float("nan"), "g_loss": 0.6, "d_grad_norm": float("inf"),
                 "g_grad_norm": 2.0, "real_logits": 0.05, "fake_logits": 0.01,
                 "d_grad_limit_count": 3.0, "g_nonfinite_streak": 1.0}),
            (6, {"d_loss": 1.1, "g_loss": 0.8, "d_grad_norm": 2.0, "g_grad_norm": 2.5,
                 "real_logits": 0.02, "fake_logits": 0.0})]
    out = {}
    for name, cls in (("port", MetricsLogger), ("jax", JaxMetricsLogger)):
        path = str(tmp_path / name / "metrics.jsonl")
        logger = cls(None, jsonl_path=path, append=False)
        for step, scalars in rows:
            logger.log_scalars(step, scalars)
        logger.close()
        with open(path, "a") as f:
            f.write('{"step": 8, "d_lo')  # a crash mid-write
        cls(None, jsonl_path=path, append=True, resume_step=4).close()
        out[name] = (capsys.readouterr().out, open(path).read())
    assert out["port"][0].replace("[locate-tpu-torch]", "[locate-tpu]") == out["jax"][0]
    assert out["port"][1] == out["jax"][1]
    assert [json.loads(line)["step"] for line in out["port"][1].splitlines()] == [2, 4]
    recs = [{"step": s, **r} for s, r in rows]
    assert digest.stability_digest(recs) == jax_digest.stability_digest(recs)
    assert (digest.format_digest(digest.stability_digest(recs))
            == jax_digest.format_digest(jax_digest.stability_digest(recs)))


def test_tensorboard_needs_its_package(tmp_path, monkeypatch):
    """The card's machine has no tensorboard package: asking for it fails
    loudly (the import error goes through), and leaves no file open."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    with pytest.raises(ImportError):
        MetricsLogger(str(tmp_path / "tb"), jsonl_path=str(tmp_path / "m.jsonl"))
    assert not os.path.exists(tmp_path / "m.jsonl")
