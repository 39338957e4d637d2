"""Metrics logging, counterpart of `locate_tpu/utils/metrics.py`: scalar
lines on stdout, a machine-readable metrics.jsonl in the workdir, and
optional TensorBoard scalars and image grids through
`torch.utils.tensorboard`, imported only when asked for (a missing
`tensorboard` package then raises: it is never skipped quietly)."""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np

PREFIX = "[locate-tpu-torch]"


class MetricsLogger:
    """stdout + metrics.jsonl (when `jsonl_path` is set) + optional
    TensorBoard under `logdir`. `log_images` is a no-op without `logdir`."""

    def __init__(self, logdir: Optional[str] = None,
                 jsonl_path: Optional[str] = None, append: bool = True,
                 resume_step: Optional[int] = None):
        self._writer = None
        self._jsonl = None
        if logdir:
            # before the jsonl open, so an ImportError leaks no file handle
            from torch.utils.tensorboard import SummaryWriter

            self._writer = SummaryWriter(logdir)
        if jsonl_path:
            os.makedirs(os.path.dirname(jsonl_path) or ".", exist_ok=True)
            if append and resume_step is not None and os.path.exists(jsonl_path):
                # Resume rewinds to the last checkpoint, which may predate
                # the last logged step; the replayed steps are logged again,
                # so records past `resume_step` go first (and a torn last
                # line, which a crash mid-write leaves): the file stays one
                # monotone trajectory.
                kept = []
                with open(jsonl_path) as f:
                    for line in f:
                        try:
                            rec = json.loads(line)
                        except json.JSONDecodeError:
                            continue
                        if rec.get("step", 0) <= resume_step:
                            kept.append(line)
                with open(jsonl_path, "w") as f:
                    f.writelines(kept)
            # append on resume; a fresh run truncates
            self._jsonl = open(jsonl_path, "a" if append else "w", buffering=1)

    def log_scalars(self, step: int, scalars: Dict[str, float]) -> None:
        parts = " ".join(
            f"{k}={v:.4g}" for k, v in sorted(scalars.items()) if np.isfinite(v)
        )
        bad = [k for k, v in scalars.items() if not np.isfinite(v)]
        suffix = f" NONFINITE={bad}" if bad else ""
        print(f"{PREFIX} step {step} {parts}{suffix}", flush=True)
        if self._jsonl is not None:
            # json.dumps would write bare NaN / Infinity (not JSON): null
            record = {k: (float(v) if np.isfinite(v) else None) for k, v in scalars.items()}
            self._jsonl.write(json.dumps({"step": step, **record}) + "\n")
        if self._writer is not None:
            for k, v in scalars.items():
                self._writer.add_scalar(k, v, step)

    def log_images(self, step: int, tag: str, images_u8: np.ndarray) -> None:
        if self._writer is None:
            return
        self._writer.add_images(tag, images_u8[:16], step, dataformats="NHWC")

    def flush(self) -> None:
        if self._jsonl is not None:
            self._jsonl.flush()
        if self._writer is not None:
            self._writer.flush()

    def close(self) -> None:
        self.flush()
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
        if self._writer is not None:
            self._writer.close()
            self._writer = None
