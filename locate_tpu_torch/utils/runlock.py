"""Workdir run lock, a copy of `locate_tpu/utils/runlock.py`: refuse to
start a second trainer on a workdir that a live run already owns.

Two trainers sharing one workdir is silent corruption, not a crash: the
second run's fresh-start MetricsLogger truncates the metrics.jsonl the
first is appending to (torn/merged records), and both race checkpoint
saves on the same step directories.

The lock is `flock(2)` on `<workdir>/.run.lock`, held for the process
lifetime. The kernel releases it on ANY process death (including
SIGKILL), so a crashed run never wedges its workdir — resume needs no
stale-lock cleanup. On Linux a second `open()` of the same file gets an
independent lock even within one process, so sequential `train()` calls
in one test process must (and do) release explicitly.
"""

from __future__ import annotations

import fcntl
import json
import os
import time


class RunLock:
    """Exclusive, non-blocking advisory lock on a workdir."""

    def __init__(self, path: str, fh):
        self._path = path
        self._fh = fh

    @classmethod
    def acquire(cls, workdir: str) -> "RunLock":
        """Take the lock or raise RuntimeError naming the live holder."""
        os.makedirs(workdir, exist_ok=True)
        path = os.path.join(workdir, ".run.lock")
        fh = open(path, "a+")
        try:
            # Only BlockingIOError means "another live process holds it".
            # Any other OSError (ENOLCK/EIO on network filesystems where
            # flock may not even give real exclusion) propagates as-is
            # rather than being misreported as a live holder.
            fcntl.flock(fh.fileno(), fcntl.LOCK_EX | fcntl.LOCK_NB)
        except BlockingIOError:
            fh.seek(0)
            holder = fh.read().strip()
            fh.close()
            raise RuntimeError(
                f"workdir {workdir!r} is locked by a live training process"
                f"{' (' + holder + ')' if holder else ''}: two trainers on "
                "one workdir corrupt metrics.jsonl and race checkpoint "
                "writes. Stop the other run or use a fresh workdir."
            ) from None
        # Diagnostics for the error message above; the lock itself is
        # kernel state, this content is advisory.
        fh.seek(0)
        fh.truncate(0)
        fh.write(json.dumps({"pid": os.getpid(), "started": time.time()}))
        fh.flush()
        return cls(path, fh)

    def release(self) -> None:
        if self._fh is None:
            return
        fcntl.flock(self._fh.fileno(), fcntl.LOCK_UN)
        self._fh.close()
        self._fh = None
        # The file stays behind (unlinking would race a concurrent
        # acquire on the same path); lock state lives in the kernel.
