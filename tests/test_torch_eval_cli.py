"""The port's `eval` and `compare` commands (`locate_tpu_torch/cli.py`) on
the CPU at a cut size, against the JAX package's commands: `eval` of a
port checkpoint writes stats files that `locate_tpu.io.fid.load_stats`
reads and features matching its JSON line, prints the JAX command's keys,
and its `--ref-stats` hatch; `compare` gives the JAX command's scores on
the same image folders, zero for a source against itself, and infers
the reader from the path; both commands' usage errors mirror the JAX
ones (tests/test_compare_cli.py)."""

import contextlib
import io
import json
import zipfile

import numpy as np
import pytest
from PIL import Image

from locate_tpu import cli as jax_cli
from locate_tpu.io.fid import load_stats as jax_load_stats
from locate_tpu_torch import cli
from torch_threads import few_threads

TINY = ["model.base_channels=32", "model.max_channels=32", "model.min_channels=16",
        "model.latent_dim=16", "model.resolution=16", "data.resolution=16",
        "data.dataset=synthetic", "train.global_batch=4", "train.compute_dtype=float32",
        "train.log_every=2", "train.sample_every=0", "train.checkpoint_every=2",
        "train.total_steps=2"]
EVAL_KEYS = {"fid", "kid", "n_fake", "n_real", "precision", "recall", "density", "coverage",
             "stats_out", "real_stats_out", "features_out", "swd_16", "swd_avg", "step"}


@pytest.fixture(autouse=True)
def two_threads():
    with few_threads(2):
        yield


def run(main, argv) -> dict:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """A port run of two steps, checkpointed at step 2."""
    root = str(tmp_path_factory.mktemp("eval_cli") / "run")
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli.main(["train", "cifar10_32", *TINY, f"workdir={root}", "--device=cpu"]) == 0
    return root


def test_eval_writes_what_the_jax_package_reads(workdir, tmp_path):
    out = {k: str(tmp_path / f"{k}.npz") for k in ("fake", "real", "feats")}
    r = run(cli.main, ["eval", "cifar10_32", *TINY, f"workdir={workdir}", "--device=cpu",
                       "--samples=16", "--prdc-k=2", "--swd", f"--stats-out={out['fake']}",
                       f"--real-stats-out={out['real']}", f"--features-out={out['feats']}"])
    assert EVAL_KEYS <= set(r) and set(r) - EVAL_KEYS == {"seconds"}
    assert r["step"] == 2 and r["n_fake"] == r["n_real"] == 16
    assert np.isfinite(r["fid"]) and r["fid"] > 0 and r["swd_avg"] > 0
    assert {"generate", "features", "data", "metrics", "swd"} == set(r["seconds"])
    feats = np.load(out["feats"])
    assert feats["fake_features"].shape == feats["real_features"].shape == (16, 1024)
    for side in ("fake", "real"):
        mu, sigma = jax_load_stats(out[side])
        np.testing.assert_allclose(mu, feats[f"{side}_features"].astype(np.float64).mean(0),
                                   rtol=1e-12, atol=1e-12)
        assert sigma.shape == (1024, 1024)
        assert int(np.load(out[side])["n"]) == 16

    # the real side's stats stand in for the dataset: the same FID, no KID
    r2 = run(cli.main, ["eval", "cifar10_32", *TINY, f"workdir={workdir}", "--device=cpu",
                        "--samples=16", f"--ref-stats={out['real']}"])
    assert r2["real_side"] == "ref_stats" and r2["kid"] is None and r2["n_real"] is None
    np.testing.assert_allclose(r2["fid"], r["fid"], rtol=1e-9)


def test_eval_usage_errors(workdir, tmp_path):
    base = ["eval", "cifar10_32", *TINY, f"workdir={workdir}", "--device=cpu", "--samples=8"]
    stats = str(tmp_path / "s.npz")
    np.savez(stats, mu=np.zeros(1024), sigma=np.eye(1024))
    for flags, match in (
            ([f"--ref-stats={stats}", "--real-stats-out=x.npz"], "--real-stats-out needs"),
            (["--per-class"], "--per-class needs a conditional model"),
            ([f"--ref-stats={stats}", "--per-class", "model.num_classes=2"],
             "--per-class needs the dataset"),
            ([f"--ref-stats={stats}", "--swd"], "--swd compares raw images"),
            (["--stats-out"], "--stats-out requires a value")):
        with pytest.raises(SystemExit, match=match):
            cli.main(base + flags)
    with pytest.raises(ValueError, match="classifier head"):
        cli.main(base + ["--inception-score=2"])
    with pytest.raises(FileNotFoundError, match="no checkpoint directory"):
        cli.main(base + [f"--checkpoint={tmp_path / 'none'}"])


def folder(root, n, key, size=24):
    rng = np.random.default_rng(key)
    root.mkdir(exist_ok=True)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (size, size, 3), dtype=np.uint8)).save(
            root / f"im{i:03d}.png")
    return str(root)


def striped_zip(path, n=12):
    rng = np.random.default_rng(7)
    with zipfile.ZipFile(path, "w") as zf:
        for i in range(n):
            arr = np.zeros((24, 24, 3), np.uint8)
            arr[:, ::2, :] = rng.integers(200, 256)
            buf = io.BytesIO()
            Image.fromarray(arr).save(buf, format="PNG")
            zf.writestr(f"im{i:03d}.png", buf.getvalue())
    return str(path)


def test_compare_matches_the_jax_command(tmp_path):
    a = folder(tmp_path / "a", 12, key=0)
    b = striped_zip(tmp_path / "b.zip")
    args = [f"--a={a}", f"--b={b}", "--resolution=16", "--samples=8", "--swd", "--prdc-k=2"]
    got = run(cli.main, ["compare", *args, "--device=cpu"])
    want = run(jax_cli.main, ["compare", *args])
    assert got.keys() == want.keys()
    assert got["a"] == want["a"] and got["b"] == want["b"] and got["b"]["kind"] == "zip"
    assert got["extractor"] == want["extractor"] == "random-conv (rFID)"
    for k in ("fid", "kid", "swd_16", "swd_avg"):
        assert abs(got[k] - want[k]) <= 1e-3 * abs(want[k]), (k, got[k], want[k])
    for k in ("precision", "recall", "density", "coverage"):
        assert got[k] == want[k], k
    assert got["fid"] > 1.0 and got["swd_avg"] > 1.0

    same = run(cli.main, ["compare", f"--a={a}", f"--b={a}", "--resolution=16", "--samples=8",
                          "--swd", "--device=cpu"])
    assert abs(same["fid"]) < 1e-3 and abs(same["kid"]) < 0.05 and same["swd_avg"] == 0.0
    assert same["a"] == {"path": a, "kind": "folder", "n": 8}


def test_infer_dataset_kind_and_usage_errors(tmp_path):
    (tmp_path / "packed").mkdir()
    (tmp_path / "packed" / "meta.json").write_text("{}")
    for path in ("x/ds.zip", "x/data.tfrecords", "x/env.mdb", str(tmp_path / "packed"),
                 str(tmp_path)):
        assert cli._infer_dataset_kind(path) == jax_cli._infer_dataset_kind(path)
    with pytest.raises(SystemExit, match="compare needs --a=PATH and --b=PATH"):
        cli.main(["compare", "--a=x"])
    with pytest.raises(SystemExit, match="compare takes flags only"):
        cli.main(["compare", "--a=x", "--b=y", "train.seed=1"])


def test_commands_are_the_jax_packages():
    assert sorted(cli.COMMANDS) == sorted(jax_cli.COMMANDS)
