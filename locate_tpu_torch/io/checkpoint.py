"""Checkpoint and resume, counterpart of `locate_tpu/io/checkpoint.py`, in
the port's own format (no orbax): keep the last K steps, and resume
restores the step count, the step's random generator, both networks,
both optimizer states and the EMA shadow, so that a resumed run continues
bit for bit.

Layout: one directory a step, `<directory>/<step>/state.pt`, a
`torch.save` payload holding every tensor of `train/state.py:state_tensors`
(on the host), the step, the generator's state, both networks' parameter
names and shapes (checked on restore) and the format tag. A save writes
`<step>.tmp/`, fsyncs it and renames it to `<step>/`, so a crash leaves at
most a torn `.tmp` that no reader is offered and the next save clears;
then the oldest steps beyond `keep` go.

Restore writes into the state's own tensors with `copy_`: a captured
step graph (`train/graph.py`) is bound to their addresses.

`async_save=True`: `save` enqueues the device-to-host copies of every
state tensor into pinned host buffers on the current stream (the step's),
records an event and returns; a writer thread waits for the event, then
writes and renames. Ordered on the step's stream, the copies read the
state before any later step writes it in place. The host buffers are
reused, so the next `save` first waits for the writer to release them;
a failed background write raises there (or at `wait` / `close`).

In a process group (`mesh`) the format stays the same and does not depend
on the world size or the mesh's shape: a save all-gathers the ZeRO slices
and the model slices of the state (`parallel/sharding.py:
gathered_tensors`, a collective every rank joins) and rank 0 alone
writes; a restore reads the file on every rank and keeps each rank's
model slice and ZeRO slice (`own_tensor`), so a run resumes on another
mesh.
"""

from __future__ import annotations

import os
import re
import shutil
import threading
from typing import Dict, List, Optional

import torch

from locate_tpu_torch.objectives.ema import ema_init
from locate_tpu_torch.train.state import OPTIONAL, FlatParams, TrainState, state_tensors

FORMAT = "locate-tpu-torch/ckpt-v1"
PAYLOAD = "state.pt"
_TORN = re.compile(r"^\d+\.tmp$")


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _layout(params: FlatParams):
    """Names and whole (one-process) shapes of a network's parameters."""
    return params.names, [list(s) for s in params.full_shapes]


def _check_layout(net: str, params: FlatParams, names: List[str], shapes: List[list]):
    """Raise naming the first parameter where the checkpoint's layout and
    the model's differ."""
    want = list(zip(*_layout(params)))
    got = list(zip(names, shapes))
    for i in range(max(len(want), len(got))):
        a = got[i] if i < len(got) else ("(none)", None)
        b = want[i] if i < len(want) else ("(none)", None)
        if a != b:
            raise ValueError(
                f"checkpoint layout of {net} differs from the model's at parameter {i}: "
                f"checkpoint {a[0]} {a[1]}, model {b[0]} {b[1]}")


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = False, mesh=None):
        self.directory = os.path.abspath(directory)
        self.primary = mesh is None or mesh.primary
        os.makedirs(self.directory, exist_ok=True)
        self.keep = keep
        self._async = async_save
        self._host: Dict[str, torch.Tensor] = {}  # reused host copies (pinned on the card)
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ----------------------------------------------------------------- save
    def save(self, state: TrainState, step: Optional[int] = None) -> None:
        """Save `state` as checkpoint `step` (by default its own step; the
        payload keeps the state's step either way). In a group every rank
        calls it and rank 0 writes."""
        from locate_tpu_torch.parallel.sharding import gathered_tensors

        full = gathered_tensors(state)
        if not self.primary:
            return
        self.wait()  # the host buffers are free; a failed background write raises
        step = state.step if step is None else int(step)
        for name in os.listdir(self.directory):
            if _TORN.match(name):
                shutil.rmtree(os.path.join(self.directory, name), ignore_errors=True)
        tensors, ready = self._to_host(state, full)
        (g_names, g_shapes), (d_names, d_shapes) = _layout(state.g_params), _layout(state.d_params)
        payload = {"format": FORMAT, "step": state.step, "rng": state.rng.get_state(),
                   "g_names": g_names, "g_shapes": g_shapes,
                   "d_names": d_names, "d_shapes": d_shapes, "tensors": tensors}
        if not self._async:
            if ready is not None:
                ready.synchronize()
            self._write(step, payload)
            return
        self._writer = threading.Thread(target=self._write_when_ready,
                                        args=(step, payload, ready),
                                        name=f"checkpoint-{step}")
        self._writer.start()

    def _to_host(self, state: TrainState, full: Dict[str, torch.Tensor]):
        """Copies of the state's (gathered) tensors in the reused host
        buffers, and the event after the copies on the card (None on the
        CPU, where the copies are done when this returns)."""
        device = state.g_params.flat.device
        on_card = device.type == "cuda"
        out = {}
        with torch.no_grad():
            for name, t in full.items():
                buf = self._host.get(name)
                if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
                    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=on_card)
                    self._host[name] = buf
                buf.copy_(t, non_blocking=on_card)
                out[name] = buf
        if not on_card:
            return out, None
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(device))
        return out, ready

    def _write_when_ready(self, step: int, payload: dict, ready) -> None:
        try:
            if ready is not None:
                ready.synchronize()
            self._write(step, payload)
        except Exception as e:  # surfaced by the next save, wait or close
            self._error = e

    def _write(self, step: int, payload: dict) -> None:
        tmp = os.path.join(self.directory, f"{step}.tmp")
        final = os.path.join(self.directory, str(step))
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        with open(os.path.join(tmp, PAYLOAD), "wb") as f:
            torch.save(payload, f)
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(tmp)
        if os.path.exists(final):  # saving a step again replaces it
            shutil.rmtree(final)
        os.rename(tmp, final)
        _fsync_dir(self.directory)
        if self.keep > 0:
            for old in self.all_steps()[:-self.keep]:
                shutil.rmtree(os.path.join(self.directory, str(old)), ignore_errors=True)

    # -------------------------------------------------------------- restore
    def all_steps(self) -> List[int]:
        """The complete checkpoints' steps, in order."""
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.isfile(os.path.join(self.directory, n, PAYLOAD)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, state: TrainState, step: Optional[int] = None) -> TrainState:
        """Write checkpoint `step` (the latest by default) into `state`'s own
        tensors, step and generator; returns `state`. Nothing is written
        unless the checkpoint fits the state. An option turned on at resume
        keeps its fresh tensor (ADA's p, the path-length mean, LeCam's
        trackers), an EMA enabled on resume is seeded from the restored G;
        a checkpoint with a tensor the state lacks raises (an EMA
        restored into a state without one would drop its shadow)."""
        step = self.latest_step() if step is None else int(step)
        if step is None:
            raise FileNotFoundError(f"no checkpoint to restore in {self.directory}")
        path = os.path.join(self.directory, str(step), PAYLOAD)
        if not os.path.isfile(path):
            raise FileNotFoundError(f"no checkpoint of step {step} in {self.directory}")
        payload = torch.load(path, map_location="cpu", weights_only=True)
        if payload.get("format") != FORMAT:
            raise ValueError(f"{path}: format {payload.get('format')!r}, want {FORMAT!r}")
        _check_layout("G", state.g_params, payload["g_names"], payload["g_shapes"])
        _check_layout("D", state.d_params, payload["d_names"], payload["d_shapes"])
        from locate_tpu_torch.parallel.sharding import full_shape, own_tensor

        saved, live = payload["tensors"], state_tensors(state)
        if "ema_params" in saved and "ema_params" not in live:
            raise ValueError(
                f"{path} holds an EMA shadow but the run has none (train.ema_decay = 0): "
                "restoring would drop it")
        # an option turned on at resume: its tensor keeps the fresh value
        # the state was made with (the EMA from the restored G, the device
        # step from the restored step)
        backfill = {n for n in OPTIONAL if n in live and n not in saved}
        for name, t in live.items():
            if name in backfill:
                continue
            if name not in saved:
                raise ValueError(f"{path} has no tensor {name!r}")
            src = saved[name]
            shape = full_shape(state, name, t)
            if tuple(src.shape) != shape or src.dtype != t.dtype:
                raise ValueError(f"{path}: {name} is {src.dtype} {tuple(src.shape)}, the "
                                 f"state's {t.dtype} {tuple(shape)}")
        extra = sorted(set(saved) - set(live))
        if extra:
            raise ValueError(f"{path} holds tensors the state has not: {extra}")
        with torch.no_grad():
            for name, t in live.items():
                if name in saved:
                    t.copy_(own_tensor(state, name, saved[name]))
            if "ema_params" in backfill:
                dtype = str(state.ema_params.dtype).removeprefix("torch.")
                state.ema_params.copy_(state.g_params.local(ema_init(state.g_params.flat,
                                                                     dtype)))
            if "step_tensor" in backfill:
                state.step_tensor.fill_(int(payload["step"]))
        state.step = int(payload["step"])
        state.rng.set_state(payload["rng"])
        return state

    # ------------------------------------------------------------ lifetime
    def wait(self) -> None:
        """Wait for a background save; raise if it failed."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"a background checkpoint save in {self.directory} "
                               "failed") from err

    def close(self) -> None:
        self.wait()
