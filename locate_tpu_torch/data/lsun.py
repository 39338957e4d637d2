"""LSUN LMDB export of the port, the counterpart of `locate_tpu/data/lsun.py`:
a one-time conversion of an LSUN scene archive (the format torchvision's
`LSUN` dataset reads: an LMDB whose values are raw WebP/JPEG bytes keyed
by content hash) into an image folder that the `folder` dataset and the
`pack` command consume. Records are read by the pure-Python LMDB reader
(`data/lmdb_reader.py`: no `lmdb` package), which also lets a run train
from the archive directly (`data.dataset="lsun"`). The export resumes for
free (files are content-keyed).

    python -m locate_tpu_torch lsun-export /data/lsun/bedroom_train_lmdb \
        /data/lsun/bedroom_train
    python -m locate_tpu_torch pack lsun_bedroom_128 \
        data.dataset=folder data.path=/data/lsun/bedroom_train --out=/data/lsun/packed128
"""

from __future__ import annotations

import os
from typing import Callable, Iterator, Optional, Tuple

# image container magic -> extension (LSUN values are WebP in current
# exports, JPEG in some older ones; PNG accepted for completeness)
_MAGICS = (
    (b"\xff\xd8\xff", "jpg"),
    (b"RIFF", "webp"),          # RIFF....WEBP — checked further below
    (b"\x89PNG\r\n\x1a\n", "png"),
)


def sniff_extension(data: bytes) -> str:
    """File extension from the image container's magic bytes."""
    for magic, ext in _MAGICS:
        if data.startswith(magic):
            if ext == "webp" and data[8:12] != b"WEBP":
                continue
            return ext
    return "bin"


def iter_lmdb(path: str) -> Iterator[Tuple[bytes, bytes]]:
    """Yield (key, value) over every record of an LMDB environment, via
    the dependency-free reader (data/lmdb_reader.py) — no `lmdb` package
    needed anywhere."""
    from locate_tpu_torch.data.lmdb_reader import LmdbReader

    reader = LmdbReader(path)
    try:
        yield from reader.items()
    finally:
        reader.close()


def lsun_to_folder(
    lmdb_path: str,
    out_dir: str,
    limit: Optional[int] = None,
    progress: bool = False,
    _iter: Optional[Callable[[str], Iterator[Tuple[bytes, bytes]]]] = None,
) -> int:
    """Write every LMDB record to `<out_dir>/<key-hex>.<ext>`; returns the
    number of files written. Content-keyed names make re-runs idempotent
    (existing files are skipped), so an interrupted export resumes for
    free. `_iter` is injectable for tests."""
    os.makedirs(out_dir, exist_ok=True)
    it = (_iter or iter_lmdb)(lmdb_path)
    n = 0
    for key, value in it:
        name = key.hex() if any(c < 0x21 or c > 0x7E for c in key) else (
            key.decode("ascii"))
        dst = os.path.join(out_dir, f"{name}.{sniff_extension(value)}")
        if not os.path.exists(dst):
            tmp = dst + ".tmp"
            with open(tmp, "wb") as f:
                f.write(value)
            os.replace(tmp, dst)  # atomic: no torn files on interrupt
        n += 1
        if progress and n % 10000 == 0:
            print(f"[locate-tpu-torch] lsun-export: {n} records", flush=True)
        if limit is not None and n >= limit:
            break
    return n
