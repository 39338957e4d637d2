"""ctypes bindings for the port's native C++ batch loader
(`data/_native/loader.cc`, a copy of the JAX package's source).

Host code, not a device kernel: it decodes, crops, resizes and flips
JPEG/PNG batches in a C++ thread pool with the GIL released. It is built
with g++ at first use into `<repo>/.build/torch_loader/`, under a name
keyed by a digest of the port's copy of the source, and never loads a
library that the JAX package built. Every caller handles
`available() == False` (no g++, no libjpeg or libpng headers, a failed
build) and falls back to PIL or numpy: nothing requires the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "_native", "loader.cc")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), ".build", "torch_loader")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False
_load_error: Optional[str] = None


def _build_and_load() -> Optional[ctypes.CDLL]:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    so_path = os.path.join(_BUILD_DIR, f"libltpu_loader_{digest}.so")
    if not os.path.exists(so_path):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = so_path + f".tmp{os.getpid()}"
        cmd = [
            "g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
            _SRC, "-ljpeg", "-lpng", "-o", tmp,
        ]
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, so_path)
    lib = ctypes.CDLL(so_path)
    lib.ltpu_decode_batch.restype = ctypes.c_int
    lib.ltpu_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int, ctypes.POINTER(ctypes.c_int),
    ]
    lib.ltpu_resize_batch.restype = ctypes.c_int
    lib.ltpu_resize_batch.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
    ]
    lib.ltpu_flip_horizontal.restype = ctypes.c_int
    lib.ltpu_flip_horizontal.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_long, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
    ]
    lib.ltpu_version.restype = ctypes.c_int
    if lib.ltpu_version() != 2:
        # not assert: must survive python -O, else a stale .so with a
        # changed ABI would be called with mismatched signatures
        raise RuntimeError(f"native loader ABI mismatch: {lib.ltpu_version()}")
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed, _load_error
    if _lib is not None or _load_failed:
        return _lib
    with _lock:
        if _lib is None and not _load_failed:
            try:
                _lib = _build_and_load()
            except Exception as e:
                _load_failed = True
                stderr = getattr(e, "stderr", None) or b""
                _load_error = (f"{type(e).__name__}: {e} "
                               f"{stderr.decode(errors='replace')[-400:]}").strip()
    return _lib


def available() -> bool:
    return get_lib() is not None


def load_error() -> Optional[str]:
    """Why the library did not build or load (None when it did, or before
    the first use)."""
    return _load_error


def default_threads() -> int:
    return max(1, (os.cpu_count() or 1))


def decode_batch(
    paths: Sequence[str],
    resolution: int,
    flips: Optional[Sequence[bool]] = None,
    threads: int = 0,
) -> np.ndarray:
    """Decode+crop+resize+flip+collate `paths` into an (N, res, res, 3)
    uint8 array using the C++ thread pool (GIL released for the call)."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native loader unavailable")
    n = len(paths)
    out = np.empty((n, resolution, resolution, 3), np.uint8)
    # os.fsencode: non-UTF-8 (surrogateescape) filenames must round-trip
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    flips_arr = np.ascontiguousarray(
        np.asarray(flips if flips is not None else np.zeros(n), np.uint8)
    )
    bad = ctypes.c_int(-1)
    rc = lib.ltpu_decode_batch(
        c_paths, n, resolution,
        flips_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        threads or default_threads(), ctypes.byref(bad),
    )
    if rc != 0:
        # bad stays -1 if the library errored without attributing a file
        which = repr(paths[bad.value]) if 0 <= bad.value < n else "unknown file"
        raise IOError(f"native decode failed for {which}")
    return out


def hflip_inplace(
    images: np.ndarray, flips: Sequence[bool], threads: int = 0
) -> bool:
    """In-place horizontal flip of `images[i]` where `flips[i]` — returns
    False (no-op) when the native lib is unavailable so callers can fall
    back to numpy."""
    lib = get_lib()
    if lib is None:
        return False
    assert images.dtype == np.uint8 and images.ndim == 4 and images.flags.c_contiguous
    n, h, w, c = images.shape
    assert c == 3, "native flip is RGB-only"
    flips_arr = np.ascontiguousarray(np.asarray(flips, np.uint8))
    lib.ltpu_flip_horizontal(
        images.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n, h, w,
        flips_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        threads or default_threads(),
    )
    return True


def resize_batch(
    images: np.ndarray,
    resolution: int,
    flips: Optional[Sequence[bool]] = None,
    threads: int = 0,
) -> np.ndarray:
    """Crop+resize+flip a pre-decoded uint8 (N, H, W, 3) batch."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native loader unavailable")
    images = np.ascontiguousarray(images, np.uint8)
    n, h, w, c = images.shape
    assert c == 3, "native resize is RGB-only"
    out = np.empty((n, resolution, resolution, 3), np.uint8)
    flips_arr = np.ascontiguousarray(
        np.asarray(flips if flips is not None else np.zeros(n), np.uint8)
    )
    lib.ltpu_resize_batch(
        images.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n, h, w, resolution,
        flips_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        threads or default_threads(),
    )
    return out
