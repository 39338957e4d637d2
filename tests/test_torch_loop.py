"""The port's train loop (`locate_tpu_torch/train/loop.py`) on the CPU at the
`tiny_config` widths in float32, with the flagship recipe's guards and
lazy R1 every 4 steps: a run SIGKILLed in a subprocess after a
checkpoint and resumed ends bitwise equal to an uninterrupted one (every
state tensor, the generator's state, the sample grids and the
metrics.jsonl records but their two timing fields), at steps_per_call 1
and 2; the resumed metrics.jsonl drops the records past the checkpoint;
the non-finite and grad-limit aborts and the grad-limit warning;
r1_last_fire; config.json; the run lock; and the parallel settings that
raise (the port trains on one device)."""

import dataclasses
import json
import math
import os
import pickle
import signal
import subprocess
import sys

import pytest
import torch

from locate_tpu_torch.train.loop import train
from locate_tpu_torch.train.state import state_tensors
from locate_tpu_torch.utils.runlock import RunLock
from test_torch_train_step import configs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
THREADS = 2
TIMING = ("images_per_sec", "sec_per_step")


@pytest.fixture(autouse=True)
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(threads)


def loop_config(tiny_config, workdir, **train_overrides):
    """The port's tiny config (batch 4, R1 gamma 1 every 4 steps, both
    guards) training on synthetic 16x16 images in `workdir`."""
    _, tcfg = configs(tiny_config, False)
    tr = dict(r1_interval=4, log_every=2, checkpoint_every=4, sample_every=4,
              total_steps=8, keep_checkpoints=3)
    tr.update(train_overrides)
    return dataclasses.replace(tcfg, use_pallas=True, workdir=str(workdir),
                               data=dataclasses.replace(tcfg.data, dataset="synthetic"),
                               train=dataclasses.replace(tcfg.train, **tr))


def records(workdir):
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def without_timing(recs):
    return [{k: v for k, v in r.items() if k not in TIMING} for r in recs]


# Subprocess body of the drill: train, and SIGKILL the process at the log
# boundary of step `kill_at` (checkpoints before it are complete on disk)
_KILLED_RUN = r'''
import os, pickle, signal, sys
import torch
torch.set_num_threads(int(sys.argv[2]))
from locate_tpu_torch.train.loop import train

with open(sys.argv[1], "rb") as f:
    cfg = pickle.load(f)
kill_at = int(sys.argv[3])

def on_metrics(step, metrics):
    if step == kill_at:
        print("KILLED_AT", step, flush=True)
        os.kill(os.getpid(), signal.SIGKILL)

train(cfg, hooks={"on_metrics": on_metrics}, device="cpu")
'''


@pytest.mark.parametrize("spc", [1, 2])
def test_sigkilled_and_resumed_run_equals_an_uninterrupted_one(tiny_config, tmp_path, capsys,
                                                               spc):
    whole = loop_config(tiny_config, tmp_path / "whole", steps_per_call=spc)
    want = train(whole, device="cpu")

    cut = loop_config(tiny_config, tmp_path / "cut", steps_per_call=spc)
    (tmp_path / "cfg.pkl").write_bytes(pickle.dumps(cut))
    (tmp_path / "run.py").write_text(_KILLED_RUN)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, str(tmp_path / "run.py"), str(tmp_path / "cfg.pkl"),
                           str(THREADS), "6"], capture_output=True, text=True, timeout=300,
                          env=env)
    assert "KILLED_AT 6" in proc.stdout, proc.stdout + proc.stderr
    assert proc.returncode == -signal.SIGKILL, (proc.returncode, proc.stderr)
    assert sorted(os.listdir(tmp_path / "cut" / "checkpoints")) == ["4"]
    assert [r["step"] for r in records(cut.workdir)] == [2, 4, 6]

    capsys.readouterr()
    got = train(cut, device="cpu")
    assert "resumed from step 4" in capsys.readouterr().out
    assert got.step == want.step == 8
    a, b = state_tensors(want), state_tensors(got)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert torch.equal(got.rng.get_state(), want.rng.get_state())
    # one monotone trajectory, the killed process's step-6 record replaced
    assert [r["step"] for r in records(cut.workdir)] == [2, 4, 6, 8]
    assert without_timing(records(cut.workdir)) == without_timing(records(whole.workdir))
    for name in ("step_00000004.png", "step_00000008.png"):
        assert ((tmp_path / "cut" / "samples" / name).read_bytes()
                == (tmp_path / "whole" / "samples" / name).read_bytes()), name


def test_resume_appends_and_total_steps_must_divide(tiny_config, tmp_path, capsys):
    cfg = loop_config(tiny_config, tmp_path / "run", steps_per_call=2, sample_every=0)
    train(cfg, total_steps=4, device="cpu")
    state = train(cfg, total_steps=6, device="cpu")
    assert "resumed from step 4" in capsys.readouterr().out
    assert state.step == 6 and [r["step"] for r in records(cfg.workdir)] == [2, 4, 6]
    with pytest.raises(ValueError, match="multiples of train.steps_per_call=2"):
        train(cfg, total_steps=9, device="cpu")
    # a fresh run truncates the trajectory
    train(cfg, total_steps=2, resume=False, device="cpu")
    assert [r["step"] for r in records(cfg.workdir)] == [2]


def test_nonfinite_streak_aborts(tiny_config, tmp_path):
    """A NaN learning rate: G's first update (of finite gradients) is NaN,
    as optax's apply_if_finite, which reads the gradients, lets it be;
    every later gradient is non-finite and skipped, and the loop aborts
    when the streak reaches the limit."""
    cfg = loop_config(tiny_config, tmp_path / "run", max_nonfinite_skips=3, log_every=1,
                      sample_every=0, checkpoint_every=0, total_steps=10)
    _, tcfg = configs(tiny_config, False)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, g_opt=dataclasses.replace(tcfg.train.g_opt, lr=float("nan"))))
    with pytest.raises(RuntimeError, match="aborting at step 4: 3 consecutive non-finite "
                                           r"gradient steps \(limit 3\)"):
        train(cfg, device="cpu")
    assert [r["step"] for r in records(cfg.workdir)] == [1, 2, 3, 4]


@pytest.mark.parametrize("skips", [0, 3])
def test_grad_limit_warns_at_onset_and_aborts_on_a_streak(tiny_config, tmp_path, capsys, skips):
    """A limit below every gradient norm skips every update: the first log
    boundary warns once for the skips so far, the next for the new ones;
    with max_nonfinite_skips the streak aborts the run."""
    cfg = loop_config(tiny_config, tmp_path / "run", grad_norm_limit=1e-3,
                      max_nonfinite_skips=skips, log_every=2, sample_every=0,
                      checkpoint_every=0, total_steps=6)
    if skips:
        with pytest.raises(RuntimeError, match="aborting at step 4: 4 consecutive updates "
                                               "over grad_norm_limit=0.001"):
            train(cfg, device="cpu")
    else:
        train(cfg, device="cpu")
    out = capsys.readouterr().out
    assert "WARNING step 2: 4 update(s) skipped for |grad| > 0.001 (4 total;" in out
    assert "WARNING step 4: 4 update(s) skipped for |grad| > 0.001 (8 total;" in out
    assert ("WARNING step 6" in out) == (not skips)


@pytest.mark.parametrize("spc", [1, 2])
def test_r1_last_fire(tiny_config, tmp_path, spc):
    """R1 fires at steps 0 and 4: a log boundary reports the latest call
    with a fire step as r1_last_fire (with 2 steps a call, the call's mean:
    half the penalty)."""
    logged = {}
    cfg = loop_config(tiny_config, tmp_path / "run", steps_per_call=spc, log_every=spc,
                      sample_every=0, checkpoint_every=0, total_steps=6)
    train(cfg, hooks={"on_metrics": lambda step, m: logged.setdefault(step, m)}, device="cpu")
    fires = {1: 1, 5: 5} if spc == 1 else {2: 2, 6: 6}
    for step, m in logged.items():
        fired = max(s for s in fires if s <= step)
        assert m["r1_last_fire"] == logged[fired]["r1"] > 0, step
        assert (m["r1"] > 0) == (step in fires), step


def test_config_json_and_sample_hook(tiny_config, tmp_path):
    cfg = loop_config(tiny_config, tmp_path / "run", sample_every=2, checkpoint_every=0,
                      total_steps=2)
    grids = []
    train(cfg, hooks={"on_samples": lambda step, imgs: grids.append((step, imgs.shape))},
          device="cpu")
    with open(tmp_path / "run" / "config.json") as f:
        assert json.load(f) == json.loads(json.dumps(dataclasses.asdict(cfg), default=str))
    assert grids == [(2, (4, 16, 16, 3))]
    assert os.path.exists(tmp_path / "run" / "samples" / "step_00000002.png")


def test_run_lock_refuses_a_second_train(tiny_config, tmp_path):
    cfg = loop_config(tiny_config, tmp_path / "run", total_steps=2)
    lock = RunLock.acquire(cfg.workdir)
    try:
        with pytest.raises(RuntimeError, match="locked by a live training"):
            train(cfg, device="cpu")
    finally:
        lock.release()
    assert not os.path.exists(tmp_path / "run" / "metrics.jsonl")


@pytest.mark.parametrize("option, match", [
    ({"data_parallel": 4}, r"mesh 4x1 != 1 devices \(data_parallel=4\)"),
    ({"model_parallel": 2}, "1 devices not divisible by model_parallel=2"),
    ({"data_parallel": 4, "model_parallel": 2, "zero_stage": 3}, "1 devices not divisible"),
], ids=["data_parallel", "model_parallel", "dp_mp_zero3"])
def test_unported_options_raise(tiny_config, tmp_path, option, match):
    """Parallel settings that ask for more ranks than the run has (one
    process, no group) raise with the JAX mesh's words, before anything
    is written (a one-rank zero_stage trains: see
    test_one_device_zero_stage_trains; the TP slot's raise on a mesh that
    divides: tests/test_torch_parallel.py)."""
    cfg = loop_config(tiny_config, tmp_path / "run")
    cfg = dataclasses.replace(cfg, parallel=dataclasses.replace(cfg.parallel, **option))
    with pytest.raises(ValueError, match=match):
        train(cfg, device="cpu")
    assert not os.path.exists(tmp_path / "run")


def test_one_device_zero_stage_trains(tiny_config, tmp_path):
    cfg = loop_config(tiny_config, tmp_path / "run", total_steps=2, sample_every=0,
                      checkpoint_every=0)
    cfg = dataclasses.replace(cfg, parallel=dataclasses.replace(cfg.parallel, data_parallel=1,
                                                                zero_stage=1))
    assert train(cfg, device="cpu").step == 2


@pytest.mark.parametrize("option", [
    dict(lecam_gamma=0.1, ada_target=0.6, pl_gamma=2.0, pl_interval=2, r2_gamma=1.0),
    dict(d_steps=2, gp_gamma=10.0, fused_step=False),
    dict(fused_step=True, augment_p=0.2, grad_accum=2, ema_dtype="bfloat16"),
], ids=["lecam_ada_pl_r2", "d_steps", "fused_accum_bf16"])
def test_loop_trains_every_flavor_and_logs_the_options(tiny_config, tmp_path, option):
    """The loop runs the options the step ports (the lecam_gamma that
    raised before this slice among them): d_steps batches a step, counted
    in the rate's images; ADA's augment_p, LeCam's lecam, the path-length
    mean and each lazy term's <name>_last_fire in the records; a resume
    from the step-4 checkpoint carries the option tensors."""
    cfg = loop_config(tiny_config, tmp_path / "run", **option)
    state = train(cfg, device="cpu")
    assert state.step == 8
    recs = records(cfg.workdir)
    assert [r["step"] for r in recs] == [2, 4, 6, 8]
    last = recs[-1]
    assert all(math.isfinite(v) for v in last.values() if isinstance(v, float))
    if "lecam_gamma" in option:
        for key in ("lecam", "augment_p", "pl_mean", "r1_last_fire", "r2_last_fire",
                    "pl_last_fire"):
            assert key in last, key
        assert last["pl_mean"] != 0.0 and float(state.pl_mean) == last["pl_mean"]
        assert float(state.ada_p) == pytest.approx(last["augment_p"])
    if "augment_p" in option:
        assert "augment_p" in last
    cfg2 = loop_config(tiny_config, tmp_path / "run", total_steps=10, **option)
    assert train(cfg2, device="cpu").step == 10
