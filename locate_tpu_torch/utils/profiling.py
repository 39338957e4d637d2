"""Profiling and step timing, counterpart of `locate_tpu/utils/profiling.py`:
trace annotations (`torch.profiler.record_function`), a profiler trace of
a block of work, and a step timer for images/sec that waits for the device
only while warming up."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


def trace_annotation(name: str):
    """A named range in a profiler trace (no cost when nothing profiles)."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def profiler_trace(logdir: Optional[str]):
    """Profile the block over the CPU (and CUDA, where there is a card) and
    write a Chrome trace to `<logdir>/trace.json` when `logdir` is set."""
    if not logdir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _wait_for(result) -> None:
    """Wait for the device work that produced `result` (a tensor or a dict
    of them): the current stream of each CUDA device it lies on."""
    tensors = result.values() if isinstance(result, dict) else [result]
    for dev in {t.device for t in tensors if isinstance(t, torch.Tensor)}:
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()


class StepTimer:
    """Throughput meter: call `tick(result)` each step; the first `warmup`
    ticks (kernel builds, graph captures) are excluded from the rate."""

    def __init__(self, batch_size: int, warmup: int = 2):
        self.batch_size = batch_size
        self.warmup = warmup
        self._count = 0
        # warmup=0: the clock starts at once (tick's count == warmup
        # trigger can never fire after the increment)
        self._t0 = time.perf_counter() if warmup == 0 else None
        self._timed_steps = 0

    def tick(self, result=None):
        if result is not None:
            _wait_for(result)
        self._count += 1
        if self._count == self.warmup:
            self._t0 = time.perf_counter()
            self._timed_steps = 0
        elif self._count > self.warmup:
            self._timed_steps += 1

    @contextlib.contextmanager
    def paused(self, result=None):
        """Leave the block's time out of the rate (the train loop's
        in-training eval): the device work that produced `result` is
        waited for first, so the queued steps count as training."""
        if result is not None:
            _wait_for(result)
        t = time.perf_counter()
        try:
            yield
        finally:
            if self._t0 is not None:
                self._t0 += time.perf_counter() - t

    @property
    def warming_up(self) -> bool:
        """True until the tick that starts the clock. A caller passes
        `result` only while this holds (the clock then starts from a
        synchronized point, and the steady state stays asynchronous) and
        reads the rates only after something waited for the device, such
        as the train loop's metrics read at a log boundary."""
        return self._count < self.warmup

    @property
    def images_per_sec(self) -> float:
        if not self._t0 or not self._timed_steps:
            return 0.0
        dt = time.perf_counter() - self._t0
        return self._timed_steps * self.batch_size / dt

    @property
    def sec_per_step(self) -> float:
        if not self._t0 or not self._timed_steps:
            return 0.0
        return (time.perf_counter() - self._t0) / self._timed_steps
