"""Build the port's CUDA sources with `nvcc` and load them with `ctypes`.

Each `csrc/<name>.cu` exposes a plain C interface and compiles on its own
into `.build/kernels/lib<name>-<digest>.so` beside the package, at first
use: the digest covers the sources and the flags, so an edited source is
rebuilt and a stale library is never loaded. No PyTorch headers are
included, which keeps a build to seconds. `nvcc` is found through
`CUDA_HOME`, `/usr/local/cuda` or `PATH`. A failed build raises with the
compiler's output; nothing falls back to a plain version.

`ptxas_report(name)` returns the `-Xptxas -v` lines (registers, shared
memory and spills of each kernel) of the last build of a library.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List

PACKAGE_DIR = Path(__file__).resolve().parents[2]
SOURCE_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / ".build" / "kernels"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


def nvcc_path() -> str:
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path):
            return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's "
            "CUDA kernels are built from csrc/ at first use"
        )
    return found


def _sources(name: str) -> List[Path]:
    src = SOURCE_DIR / f"{name}.cu"
    if not src.is_file():
        raise FileNotFoundError(src)
    return [src] + sorted(SOURCE_DIR.glob("*.cuh"))


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources(name):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile `csrc/<name>.cu` unless its library is already built.
    Concurrent builders each write a private file and rename it into
    place, so a reader never sees a half-written library."""
    out = library_path(name)
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(_sources(name)[0])]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) on {name}.cu:\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    return ctypes.CDLL(str(build(name)))


def ptxas_report(name: str) -> str:
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.is_file() else ""
