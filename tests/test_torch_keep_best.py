"""The port's in-training eval (`locate_tpu_torch/train/loop.py`) on the CPU
at the `tiny_config` widths in float32, the JAX package's
`tests/test_keep_best.py` cases and more: keep_best tracks the least
rFID (best.json, one best checkpoint at its step), a resume never
demotes the incumbent, keep_best off writes neither; the regress
warning; eval_swd's scalars; and a run SIGKILLed and resumed with the
eval on still equals an uninterrupted one bit for bit, and equals a run
without the eval (the eval draws nothing from the state's generators).

But in the eval_swd case, the loop's random-conv extractor is narrowed to
width 8 (`narrow`): keep_best's logic does not depend on it, and the
default width's 1024x1024 sqrtm would take most of each test's time. The
default extractor runs in the eval_swd case here, in the CLI's tests, in
the slow parity file against the JAX loop and in chip_smoke.py's loop."""

import functools
import json
import os
import pickle
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from locate_tpu_torch.io.checkpoint import CheckpointManager
from locate_tpu_torch.train.loop import train
from locate_tpu_torch.train.state import state_tensors
from test_torch_loop import _KILLED_RUN, REPO, THREADS, loop_config, records, without_timing
from torch_threads import few_threads

EVAL = dict(eval_every=2, eval_samples=16, log_every=2, sample_every=0, checkpoint_every=4)
NARROW = ("import functools\n"
          "from locate_tpu_torch.io import fid\n"
          "fid.RandomConvFeatures = functools.partial(fid.RandomConvFeatures, width=8)\n")


@pytest.fixture(autouse=True)
def two_threads():
    with few_threads(THREADS):
        yield


@pytest.fixture
def narrow(monkeypatch):
    """The loop's extractor at width 8 (128 features)."""
    from locate_tpu_torch.io import fid

    monkeypatch.setattr(fid, "RandomConvFeatures",
                        functools.partial(fid.RandomConvFeatures, width=8))


def best(workdir):
    with open(os.path.join(workdir, "best.json")) as f:
        return json.load(f)


def eval_records(workdir):
    return [r for r in records(workdir) if "eval_rfid" in r]


def test_keep_best_tracks_min_rfid(tiny_config, narrow, tmp_path):
    cfg = loop_config(tiny_config, tmp_path / "run", **EVAL)
    scores = []
    train(cfg, hooks={"on_eval": lambda s, sc: scores.append((s, sc))}, device="cpu")
    assert [s for s, _ in scores] == [2, 4, 6, 8]
    b = best(cfg.workdir)
    fids = {s: sc["fid"] for s, sc in scores}
    assert b["fid"] == min(fids.values()) and fids[b["step"]] == b["fid"]
    assert b["kid"] == dict(scores)[b["step"]]["kid"]
    mgr = CheckpointManager(os.path.join(cfg.workdir, "checkpoints_best"), keep=1)
    assert mgr.all_steps() == [b["step"]]
    # the logged scalars are the hook's scores
    assert [(r["step"], r["eval_rfid"], r["eval_rkid"]) for r in eval_records(cfg.workdir)] == [
        (s, sc["fid"], sc["kid"]) for s, sc in scores]


def test_keep_best_survives_resume(tiny_config, narrow, tmp_path, capsys):
    """A resumed run reads best.json back: an unbeatable incumbent stays,
    and with regress_warn_evals=1 the next eval warns."""
    cfg = loop_config(tiny_config, tmp_path / "run", regress_warn_evals=1, **EVAL)
    train(cfg, total_steps=4, device="cpu")
    first = best(cfg.workdir)
    with open(os.path.join(cfg.workdir, "best.json"), "w") as f:
        json.dump({**first, "fid": -1.0}, f)
    capsys.readouterr()
    train(cfg, total_steps=6, device="cpu")
    assert best(cfg.workdir) == {**first, "fid": -1.0}
    assert (f"WARNING step 6: quality regressing — best rFID -1.00 was at step "
            f"{first['step']}, 1 evals ago") in capsys.readouterr().out


def test_keep_best_disabled(tiny_config, narrow, tmp_path):
    cfg = loop_config(tiny_config, tmp_path / "run", keep_best=False, **EVAL)
    scores = []
    train(cfg, total_steps=4, hooks={"on_eval": lambda s, sc: scores.append(s)}, device="cpu")
    assert scores == [2, 4]
    assert not os.path.exists(os.path.join(cfg.workdir, "best.json"))
    assert not os.path.exists(os.path.join(cfg.workdir, "checkpoints_best"))


def test_eval_swd_logged(tiny_config, tmp_path):
    cfg = loop_config(tiny_config, tmp_path / "run", eval_swd=True, **EVAL)
    train(cfg, total_steps=2, device="cpu")
    (rec,) = eval_records(cfg.workdir)
    assert rec["step"] == 2 and {"eval_swd_16", "eval_swd_avg"} <= set(rec)
    assert np.isfinite(rec["eval_swd_avg"]) and rec["eval_swd_avg"] > 0


def test_sigkilled_and_resumed_run_with_eval_equals_an_uninterrupted_one(tiny_config, narrow,
                                                                         tmp_path, capsys):
    """Evals at 4 (between calls, before the step-4 checkpoint) and 8:
    the resumed run's state, generator, records (the eval records
    included) and best checkpoint equal the uninterrupted run's; the
    state equals a run without the eval."""
    kw = dict(EVAL, steps_per_call=2, eval_every=4)
    plain = train(loop_config(tiny_config, tmp_path / "plain", **dict(kw, eval_every=0)),
                  device="cpu")
    whole = loop_config(tiny_config, tmp_path / "whole", **kw)
    want = train(whole, device="cpu")

    cut = loop_config(tiny_config, tmp_path / "cut", **kw)
    (tmp_path / "cfg.pkl").write_bytes(pickle.dumps(cut))
    (tmp_path / "run.py").write_text(_KILLED_RUN.replace(
        "from locate_tpu_torch.train.loop import train\n",
        "from locate_tpu_torch.train.loop import train\n" + NARROW))
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OPENBLAS_NUM_THREADS=str(THREADS))
    proc = subprocess.run([sys.executable, str(tmp_path / "run.py"), str(tmp_path / "cfg.pkl"),
                           str(THREADS), "6"], capture_output=True, text=True, timeout=300,
                          env=env)
    assert "KILLED_AT 6" in proc.stdout, proc.stdout + proc.stderr
    assert proc.returncode == -signal.SIGKILL, (proc.returncode, proc.stderr)
    capsys.readouterr()
    got = train(cut, device="cpu")
    assert "resumed from step 4" in capsys.readouterr().out
    a, b, c = state_tensors(want), state_tensors(got), state_tensors(plain)
    for k in a:
        assert torch.equal(a[k], b[k]) and torch.equal(a[k], c[k]), k
    assert torch.equal(got.rng.get_state(), want.rng.get_state())
    assert torch.equal(plain.rng.get_state(), want.rng.get_state())
    assert without_timing(records(cut.workdir)) == without_timing(records(whole.workdir))
    assert [r["step"] for r in eval_records(cut.workdir)] == [4, 8]
    assert best(cut.workdir) == best(whole.workdir)
    step = best(whole.workdir)["step"]
    for run in (cut, whole):
        assert CheckpointManager(os.path.join(run.workdir, "checkpoints_best")).all_steps() == [
            step]
    pa, pb = (torch.load(os.path.join(run.workdir, "checkpoints_best", str(step), "state.pt"),
                         weights_only=True) for run in (cut, whole))
    for k, t in pa["tensors"].items():
        assert torch.equal(t, pb["tensors"][k]), k
