"""The port's checkpoints (`locate_tpu_torch/io/checkpoint.py`) on the CPU,
at the `tiny_config` widths in float32: a save and restore round trip is
bitwise (every state tensor, the step and the generator) and keeps every
tensor at its address; keep-K; the missing-checkpoint and layout errors;
the EMA backfill from the restored G and the refusal to drop an EMA; an
async save taken while steps go on equals a sync save of the same step
byte for byte; a failed background save raises at the next save; a
process SIGKILLed during an async save leaves only complete steps. (A JAX
orbax checkpoint carried over into the port: tests/test_torch_loop_parity.py,
slow.)"""

import dataclasses
import os
import runpy
import signal
import subprocess
import sys

import pytest
import torch

from locate_tpu_torch.io.checkpoint import FORMAT, CheckpointManager
from locate_tpu_torch.models.gan import build_gan
from locate_tpu_torch.train.state import create_train_state, state_tensors
from locate_tpu_torch.train.step import make_train_step
from test_torch_train_step import batch, configs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def port(tiny_config, seed=0, **train):
    _, tcfg = configs(tiny_config, False)
    tcfg = dataclasses.replace(tcfg, use_pallas=True,
                               train=dataclasses.replace(tcfg.train, **train))
    gan = build_gan(tcfg, device="cpu", seed=seed)
    return tcfg, gan, create_train_state(tcfg, gan, seed=seed + 1), make_train_step(tcfg, gan)


def host_batch():
    return {k: torch.from_numpy(v) for k, v in batch().items()}


def trained(tiny_config, steps=2, seed=0, **train):
    """A state `steps` steps in, with R1 at step 0 and the guards on."""
    tcfg, gan, state, step = port(tiny_config, seed, **train)
    for _ in range(steps):
        state, _ = step(state, host_batch())
    return tcfg, gan, state, step


def values(state):
    return ({k: t.clone() for k, t in state_tensors(state).items()}, state.step,
            state.rng.get_state())


def assert_same(a, b):
    assert a[0].keys() == b[0].keys()
    for k in a[0]:
        assert torch.equal(a[0][k], b[0][k]), k
    assert a[1] == b[1]
    assert torch.equal(a[2], b[2])


@pytest.mark.parametrize("ema", [True, False])
def test_round_trip_is_bitwise(tiny_config, tmp_path, ema):
    decay = tiny_config.train.ema_decay if ema else 0.0
    _, _, state, _ = trained(tiny_config, ema_decay=decay)
    want = values(state)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(state)
    assert mgr.latest_step() == 2 and os.listdir(tmp_path / "ck" / "2") == ["state.pt"]
    payload = torch.load(tmp_path / "ck" / "2" / "state.pt", weights_only=True)
    assert payload["format"] == FORMAT
    assert ("ema_params" in payload["tensors"]) == ema
    # a fresh state from other weights and another seed takes every value back
    _, _, other, _ = port(tiny_config, seed=5, ema_decay=decay)
    assert not torch.equal(other.g_params.flat, state.g_params.flat)
    assert mgr.restore(other) is other
    assert_same(values(other), want)


def test_restore_keeps_every_address(tiny_config, tmp_path):
    _, _, state, _ = trained(tiny_config)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(state)
    _, gan, other, _ = port(tiny_config, seed=5)
    before = {k: t.data_ptr() for k, t in state_tensors(other).items()}
    module_params = [p.data_ptr() for p in gan.generator.parameters()]
    mgr.restore(other)
    assert {k: t.data_ptr() for k, t in state_tensors(other).items()} == before
    # the module's parameters are still views of the restored flat buffer
    assert [p.data_ptr() for p in gan.generator.parameters()] == module_params
    assert torch.equal(gan.generator.seed.w.reshape(-1),
                       state.g_params.named(state.g_params.flat)["seed.w"].reshape(-1))


def test_keep_last_k(tiny_config, tmp_path):
    _, _, state, _ = port(tiny_config)
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(state, step=s)
    assert mgr.all_steps() == [3, 4] and mgr.latest_step() == 4
    state.step = 9
    mgr.restore(state, step=3)
    assert state.step == 0  # the state's own step, whatever the label


def test_missing_checkpoint_raises(tiny_config, tmp_path):
    _, _, state, _ = port(tiny_config)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError, match="no checkpoint to restore"):
        mgr.restore(state)
    mgr.save(state, step=1)
    with pytest.raises(FileNotFoundError, match="step 7"):
        mgr.restore(state, step=7)


def layout(params):
    return list(zip(params.names, [list(p.shape) for p in params.params]))


@pytest.mark.parametrize("override", [
    {"latent_dim": 8},         # a shape differs (seed.w)
    {"blocks_per_stage": 1},   # the names differ
])
def test_layout_mismatch_names_the_parameter(tiny_config, tmp_path, override):
    _, _, state, _ = port(tiny_config)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(state)
    _, tcfg = configs(tiny_config, False)
    tcfg = dataclasses.replace(tcfg, model=dataclasses.replace(tcfg.model, **override))
    other = create_train_state(tcfg, build_gan(tcfg, device="cpu"))
    g_before = other.g_params.flat.clone()
    saved, live = layout(state.g_params), layout(other.g_params)
    i = next(i for i, (a, b) in enumerate(zip(saved, live)) if a != b)
    with pytest.raises(ValueError, match="layout of G differs") as err:
        mgr.restore(other)
    assert (f"at parameter {i}: checkpoint {saved[i][0]} {saved[i][1]}, "
            f"model {live[i][0]} {live[i][1]}") in str(err.value)
    assert torch.equal(other.g_params.flat, g_before)  # nothing written


def test_ema_enabled_on_resume_is_seeded_from_the_restored_g(tiny_config, tmp_path):
    _, _, state, _ = trained(tiny_config, ema_decay=0.0)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(state)
    _, _, other, _ = port(tiny_config, seed=5)  # EMA on, from its own init
    assert other.ema_params is not None
    ema_address = other.ema_params.data_ptr()
    mgr.restore(other)
    assert torch.equal(other.ema_params, state.g_params.flat)
    assert other.ema_params.data_ptr() == ema_address


def test_ema_disabled_on_resume_raises(tiny_config, tmp_path):
    _, _, state, _ = trained(tiny_config)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(state)
    _, _, other, _ = port(tiny_config, seed=5, ema_decay=0.0)
    with pytest.raises(ValueError, match="EMA shadow"):
        mgr.restore(other)


def test_async_save_during_steps_equals_a_sync_save(tiny_config, tmp_path):
    """The async save of step 2 is taken, then three more steps write the
    state in place while the writer runs: its file equals a sync save of
    step 2 byte for byte, and a second async save reuses the buffers."""
    _, _, state, step = trained(tiny_config)
    CheckpointManager(str(tmp_path / "sync")).save(state)
    mgr = CheckpointManager(str(tmp_path / "async"), async_save=True)
    mgr.save(state)
    for _ in range(3):
        state, _ = step(state, host_batch())
    mgr.save(state)
    mgr.wait()
    a = (tmp_path / "sync" / "2" / "state.pt").read_bytes()
    b = (tmp_path / "async" / "2" / "state.pt").read_bytes()
    assert a == b
    CheckpointManager(str(tmp_path / "sync5")).save(state)
    assert ((tmp_path / "sync5" / "5" / "state.pt").read_bytes()
            == (tmp_path / "async" / "5" / "state.pt").read_bytes())
    mgr.close()


def test_failed_background_save_raises_at_the_next_save(tiny_config, tmp_path, monkeypatch):
    _, _, state, _ = port(tiny_config)
    mgr = CheckpointManager(str(tmp_path / "ck"), async_save=True)

    def full_disk(*args):
        raise OSError("no space left on device")

    monkeypatch.setattr(mgr, "_write", full_disk)
    mgr.save(state, step=1)
    with pytest.raises(RuntimeError, match="background checkpoint save") as err:
        mgr.save(state, step=2)
    assert isinstance(err.value.__cause__, OSError)
    monkeypatch.undo()
    mgr.save(state, step=3)  # the error is reported once, the manager works on
    mgr.close()
    assert mgr.all_steps() == [3]


# Subprocess body of the drill below: a sync step-0 save, then an async
# step-1 save of a ~117 MB state, and a SIGKILL the moment save() returns:
# the writer thread dies mid-flight, leaving what a real crash would.
_CRASH_SCRIPT = r'''
import os, signal, sys
import torch
from torch import nn
from locate_tpu_torch.config import TrainConfig
from locate_tpu_torch.objectives.optim import make_optimizers
from locate_tpu_torch.train.state import FlatParams, TrainState

def big_state(fill):
    """7 tensors of 2048 x 2048 f32 (G, D, their Adam moments, the EMA)."""
    g, d = (FlatParams(nn.Linear(2048, 2048, bias=False)) for _ in range(2))
    g.flat.fill_(fill)
    d.flat.fill_(fill + 1)
    g_opt, d_opt = make_optimizers(TrainConfig())
    rng = torch.Generator()
    rng.manual_seed(int(fill))
    return TrainState(step=int(fill), rng=rng, g_params=g, d_params=d,
                      g_opt_state=g_opt.init(g.flat), d_opt_state=d_opt.init(d.flat),
                      ema_params=g.flat + 2)

if __name__ == "__main__":
    from locate_tpu_torch.io.checkpoint import CheckpointManager
    mgr = CheckpointManager(sys.argv[1], keep=3, async_save=True)
    mgr.save(big_state(0.0))
    mgr.wait()  # step 0 is complete on disk
    print("SYNC0_DONE", flush=True)
    mgr.save(big_state(1.0))  # returns with the write in flight
    os.kill(os.getpid(), signal.SIGKILL)
'''


def test_sigkill_during_an_async_save_leaves_the_last_complete_step(tmp_path):
    ckdir = str(tmp_path / "ck")
    script = tmp_path / "crash.py"
    script.write_text(_CRASH_SCRIPT)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, str(script), ckdir], capture_output=True,
                          text=True, timeout=300, env=env)
    assert "SYNC0_DONE" in proc.stdout, proc.stdout + proc.stderr
    assert proc.returncode == -signal.SIGKILL, (proc.returncode, proc.stderr)

    big_state = runpy.run_path(str(script))["big_state"]
    mgr = CheckpointManager(ckdir, keep=3, async_save=True)
    assert mgr.latest_step() == 0, f"a torn save surfaced: {os.listdir(ckdir)}"
    state = big_state(5.0)
    mgr.restore(state)
    want = big_state(0.0)
    for k, t in state_tensors(want).items():
        assert torch.equal(state_tensors(state)[k], t), k
    assert state.step == 0 and torch.equal(state.rng.get_state(), want.rng.get_state())
    # the store works on: a save at the torn step completes and clears the .tmp
    state.step = 1
    mgr.save(state)
    mgr.wait()
    assert mgr.all_steps() == [0, 1]
    assert sorted(os.listdir(ckdir)) == ["0", "1"]


def test_torn_tmp_is_never_offered(tiny_config, tmp_path):
    _, _, state, _ = port(tiny_config)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(state, step=4)
    torn = tmp_path / "ck" / "8.tmp"
    torn.mkdir()
    (torn / "state.pt").write_bytes(b"PK\x03\x04 torn")
    (tmp_path / "ck" / "9").mkdir()  # a step directory with no payload
    assert mgr.latest_step() == 4
    mgr.save(state, step=5)
    assert not torn.exists() and mgr.all_steps() == [4, 5]


OPTIONS = dict(ada_target=0.6, lecam_gamma=0.1, pl_gamma=2.0, pl_interval=2,
               ema_rampup=0.05, grad_accum=2, ema_dtype="bfloat16",
               lr_schedule="cosine", total_steps=8)


def test_option_tensors_round_trip_and_resume_bitwise(tiny_config, tmp_path):
    """ADA's p, LeCam's trackers, the path-length mean, the device step,
    MultiSteps' fields and the bf16 shadow are saved and restored; a step
    after a restore into a fresh state equals the step after the save,
    bit for bit."""
    tcfg, _, state, step = trained(tiny_config, steps=3, **OPTIONS)
    names = set(state_tensors(state))
    assert {"ada_p", "lecam", "pl_mean", "step_tensor", "g_opt.mini_step",
            "g_opt.acc_grads", "d_opt.gradient_step"} <= names
    assert state.ema_params.dtype == torch.bfloat16 and int(state.step_tensor) == 3
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(state)
    state, _ = step(state, host_batch())
    want = values(state)
    _, gan2, fresh, step2 = port(tiny_config, seed=5, **OPTIONS)
    mgr.restore(fresh)
    fresh, _ = step2(fresh, host_batch())
    assert_same(values(fresh), want)


def test_options_turned_on_at_resume_start_fresh(tiny_config, tmp_path):
    """A checkpoint of a run without ADA, LeCam, PL and ema_rampup restored
    into one with them: the other tensors restored, the new ones at their
    fresh values (p = augment_p, zero trackers and mean, the device step
    the restored step)."""
    _, _, state, _ = trained(tiny_config, steps=2)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(state)
    _, _, fresh, _ = port(tiny_config, seed=3, augment_p=0.25, lecam_gamma=0.1,
                          pl_gamma=2.0, ema_rampup=0.05)
    mgr.restore(fresh)
    assert torch.equal(fresh.g_params.flat, state.g_params.flat) and fresh.step == 2
    assert float(fresh.ada_p) == 0.25 and not fresh.lecam.any() and float(fresh.pl_mean) == 0
    assert int(fresh.step_tensor) == 2
    # and the other way round: a tensor the state lacks would be dropped
    with pytest.raises(ValueError, match="holds tensors the state has not"):
        CheckpointManager(str(tmp_path / "ck2")).save(fresh) or CheckpointManager(
            str(tmp_path / "ck2")).restore(port(tiny_config)[2])
