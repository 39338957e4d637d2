"""Packed dataset format, the port's counterpart of `locate_tpu/data/packed.py`:
pre-decoded, pre-resized uint8 memmap shards.

At 128^2 and above, a per-epoch JPEG decode on the host cannot keep up
with the card. So a dataset is decoded ONCE, offline, into raw uint8
shards at the training resolution, and the producer then does page-cache
memcpy. The format on disk is the JAX package's, so a pack that either
package writes reads in the other, byte for byte.

Layout of a packed dataset directory:

    meta.json         {"format": "locate-tpu-packed/v1", "count": N,
                       "resolution": R, "channels": C, "num_classes": K,
                       "shard_size": S}
    labels.npy        int32 (N,)
    shard_00000.u8    raw uint8, shard_size*(R*R*C) bytes (last may be short)
    shard_00001.u8    ...

Shards (rather than one giant file) keep packing resumable/parallelizable
and let a host hold a subset. Shard files are opened lazily as read-only
memmaps and gathered per batch with one fancy-index per touched shard.

Deterministic-resume semantics are untouched: the BatchProducer's index
stream and one-flip-draw-per-example invariant (pipeline.py) are dataset-
independent, and `example()` here never consumes the stream RNG.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np

FORMAT = "locate-tpu-packed/v1"

Example = Tuple[np.ndarray, int]


class PackedDataset:
    """Read side: memmap-backed uint8 examples at a fixed resolution."""

    def __init__(self, path: str):
        self.path = path
        meta_path = os.path.join(path, "meta.json")
        if not os.path.isfile(meta_path):
            raise FileNotFoundError(
                f"not a packed dataset (no meta.json): {path!r} — create one "
                f"with `python -m locate_tpu_torch pack`"
            )
        with open(meta_path) as f:
            meta = json.load(f)
        if meta.get("format") != FORMAT:
            raise ValueError(f"unknown packed format {meta.get('format')!r}")
        self.count = int(meta["count"])
        self.resolution = int(meta["resolution"])
        self.channels = int(meta["channels"])
        self.num_classes = int(meta.get("num_classes", 0))
        self.shard_size = int(meta["shard_size"])
        self.labels = np.load(os.path.join(path, "labels.npy"))
        if len(self.labels) != self.count:
            raise ValueError(
                f"labels.npy has {len(self.labels)} entries, meta says "
                f"{self.count}"
            )
        n_shards = -(-self.count // self.shard_size)
        self._shard_paths = [
            os.path.join(path, f"shard_{i:05d}.u8") for i in range(n_shards)
        ]
        missing = [p for p in self._shard_paths if not os.path.isfile(p)]
        if missing:
            raise FileNotFoundError(f"packed dataset missing shards: {missing[:3]}")
        self._mmaps: list = [None] * n_shards

    def __len__(self) -> int:
        return self.count

    def _shard(self, s: int) -> np.ndarray:
        mm = self._mmaps[s]
        if mm is None:
            r, c = self.resolution, self.channels
            lo = s * self.shard_size
            n = min(self.shard_size, self.count - lo)
            mm = np.memmap(
                self._shard_paths[s], np.uint8, mode="r", shape=(n, r, r, c)
            )
            self._mmaps[s] = mm
        return mm

    def example(self, index: int, rng=None) -> Example:
        s, off = divmod(int(index), self.shard_size)
        return np.array(self._shard(s)[off]), int(self.labels[index])

    def batch_fast(self, indices, flips) -> Tuple[np.ndarray, np.ndarray]:
        idx = np.asarray(indices, np.int64)
        n = len(idx)
        r, c = self.resolution, self.channels
        out = np.empty((n, r, r, c), np.uint8)
        shards = idx // self.shard_size
        offs = idx % self.shard_size
        flips = np.asarray(flips, bool)
        any_flips = bool(flips.any())
        # Fast path: one contiguous gather per touched shard, then the
        # native in-place flip (numpy's reversed-stride copy measured
        # 7ms/batch @128^2x128 — 65% of batch time; the C++ pixel swap is
        # memory-bound).
        native_flip = False
        if any_flips and c == 3:
            from locate_tpu_torch.data import native

            native_flip = native.available()
        for s in np.unique(shards):
            shard = self._shard(int(s))
            in_s = shards == s
            if not any_flips or native_flip:
                sel = np.nonzero(in_s)[0]
                out[sel] = shard[offs[sel]]
                continue
            # numpy fallback: fuse the flip into the gather as a
            # reversed-W read so each example is copied exactly once
            for flipped in (False, True):
                sel = np.nonzero(in_s & (flips == flipped))[0]
                if len(sel) == 0:
                    continue
                if flipped:
                    out[sel] = shard[offs[sel], :, ::-1]
                else:
                    out[sel] = shard[offs[sel]]
        if any_flips and native_flip:
            from locate_tpu_torch.data import native

            native.hflip_inplace(out, flips)
        return out, self.labels[idx].astype(np.int32)


def pack_dataset(
    src,
    out_dir: str,
    *,
    shard_size: int = 4096,
    batch_size: int = 64,
    num_classes: Optional[int] = None,
    progress: bool = False,
) -> str:
    """One-time offline pack: decode+resize `src` (any dataset object with
    `__len__`/`example`, and optionally `batch_fast`) into `out_dir` in
    dataset order. Idempotent: refuses to overwrite an existing pack.

    Decode uses the source's `batch_fast` (the native C++ thread-pool
    decoder for ImageFolder) when available, falling back to `example`
    per file — so packing itself runs at native-loader speed.
    """
    if os.path.exists(os.path.join(out_dir, "meta.json")):
        raise FileExistsError(f"packed dataset already exists at {out_dir!r}")
    os.makedirs(out_dir, exist_ok=True)
    n = len(src)
    if n == 0:
        raise ValueError("source dataset is empty")
    # probe shape from example 0
    img0, _ = src.example(0, None)
    r, _, c = img0.shape[0], img0.shape[1], img0.shape[2]
    labels = np.zeros((n,), np.int32)
    use_fast = hasattr(src, "batch_fast")

    shard_idx = -1
    shard_f = None
    written_in_shard = 0
    try:
        i = 0
        while i < n:
            j = min(i + batch_size, n)
            idx = list(range(i, j))
            if use_fast:
                try:
                    imgs, labs = src.batch_fast(idx, [False] * len(idx))
                except RuntimeError:
                    use_fast = False
            if not use_fast:
                pair = [src.example(k, None) for k in idx]
                imgs = np.stack([p[0] for p in pair])
                labs = np.asarray([p[1] for p in pair], np.int32)
            if imgs.shape[1:] != (r, r, c):
                raise ValueError(
                    f"examples {i}:{j} have shape {imgs.shape[1:]}, "
                    f"expected {(r, r, c)}"
                )
            labels[i:j] = labs
            imgs = np.ascontiguousarray(imgs, np.uint8)
            # split the batch across shard boundaries
            pos = 0
            while pos < len(imgs):
                if shard_f is None or written_in_shard == shard_size:
                    if shard_f is not None:
                        shard_f.close()
                    shard_idx += 1
                    shard_f = open(
                        os.path.join(out_dir, f"shard_{shard_idx:05d}.u8"), "wb"
                    )
                    written_in_shard = 0
                take = min(len(imgs) - pos, shard_size - written_in_shard)
                shard_f.write(imgs[pos : pos + take].tobytes())
                written_in_shard += take
                pos += take
            i = j
            if progress and (i % (batch_size * 50) == 0 or i == n):
                print(f"[locate-tpu-torch pack] {i}/{n}")
    finally:
        if shard_f is not None:
            shard_f.close()

    np.save(os.path.join(out_dir, "labels.npy"), labels)
    meta = {
        "format": FORMAT,
        "count": n,
        "resolution": r,
        "channels": c,
        "num_classes": int(
            num_classes
            if num_classes is not None
            else getattr(src, "num_classes", 0)
        ),
        "shard_size": shard_size,
    }
    # meta.json written LAST: its presence marks a complete pack
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f)
    return out_dir
