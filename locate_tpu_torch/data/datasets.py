"""Dataset sources of the port, counterparts of `locate_tpu/data/datasets.py`.

A dataset is a plain object with:

    * ``__len__()``
    * ``example(index, rng) -> (image_u8 (H,W,C) uint8, label int)``

and, where a batched path exists, ``batch_fast(indices, flips)``.
Decoding and resizing run on the host; the [-1, 1] normalization runs
once a batch on the device, inside the train step (`train/step.py`), and
augmentation (the random flip) is per example on the host.

CIFAR-10 is read from local binary batches if present; without them
`make_dataset` falls back to the synthetic dataset, which needs no files
and serves the tests and the input-path benchmarks. Every array this
module returns equals the JAX package's for the same arguments, byte for
byte.
"""

from __future__ import annotations

import json
import os
import pickle
import tarfile
import threading
import zipfile
from typing import List, Optional, Tuple

import numpy as np

Example = Tuple[np.ndarray, int]


def _pil_decode(fp, resolution: int, channels: int) -> np.ndarray:
    """PIL decode + center-crop-to-square + bilinear resize -> (H, W, C)
    uint8. `fp` is a path or a file-like (zip member). The shared decode
    protocol of ImageFolder and ZipImages."""
    from PIL import Image

    with Image.open(fp) as im:
        im = im.convert("RGB" if channels == 3 else "L")
        w, h = im.size
        s = min(w, h)
        im = im.crop(((w - s) // 2, (h - s) // 2, (w + s) // 2, (h + s) // 2))
        im = im.resize((resolution, resolution), Image.BILINEAR)
        arr = np.asarray(im, np.uint8)
    if arr.ndim == 2:
        arr = arr[..., None]
    return arr


class SyntheticImages:
    """Deterministic procedurally-generated images.

    Structured (gaussian blobs + gradients keyed by index) rather than pure
    noise so D has something learnable; class id selects the palette when
    `num_classes > 0`. Used for tests and for input-pipeline/throughput
    benchmarking without any files on disk.
    """

    def __init__(self, resolution: int, channels: int = 3, length: int = 50_000,
                 num_classes: int = 0, seed: int = 0):
        self.resolution = resolution
        self.channels = channels
        self.length = length
        self.num_classes = num_classes
        self.seed = seed
        r = resolution
        ys, xs = np.mgrid[0:r, 0:r].astype(np.float32) / max(1, r - 1)
        self._ys, self._xs = ys, xs

    def __len__(self) -> int:
        return self.length

    @property
    def labels(self) -> np.ndarray:
        """Per-index labels (index % num_classes), exposed for per-class
        eval's real-side filtering."""
        base = np.arange(self.length, dtype=np.int32)
        return base % self.num_classes if self.num_classes else base * 0

    def _render(self, indices: np.ndarray):
        """Vectorized renderer: (images_u8, labels_i32) for a batch of
        example indices. float32 throughout (matches the original
        per-example renderer's accumulation dtype exactly)."""
        n = len(indices)
        r = self.resolution
        c = self.channels
        # one Philox draw block per example, deterministic in the index
        draws = np.stack(
            [
                np.random.Generator(
                    np.random.Philox(key=self.seed, counter=int(i))
                ).uniform(size=1 + c + 3 * (3 + c))
                for i in indices
            ]
        ).astype(np.float32)  # 1 angle + c base + 3 blobs x (2 ctr + 1 sig + c color)
        labels = (
            np.asarray(indices) % self.num_classes if self.num_classes else np.zeros(n)
        ).astype(np.int32)
        angle = draws[:, 0] * np.float32(2 * np.pi)
        base = 0.2 + 0.6 * draws[:, 1 : 1 + c]  # (n, c)
        grad = (
            np.cos(angle)[:, None, None] * self._xs + np.sin(angle)[:, None, None] * self._ys
        )  # (n, r, r)
        img = base[:, None, None, :] + 0.3 * grad[..., None]
        off = 1 + c
        for k in range(3):
            blk = draws[:, off + k * (3 + c) : off + (k + 1) * (3 + c)]
            cy = 0.2 + 0.6 * blk[:, 0]
            cx = 0.2 + 0.6 * blk[:, 1]
            sig = 0.05 + 0.2 * blk[:, 2]
            color = -0.7 + 1.4 * blk[:, 3 : 3 + c]  # (n, c)
            if self.num_classes:
                rows = np.arange(c)[None, :]
                color = color[np.arange(n)[:, None], (rows - labels[:, None]) % c]
            blob = np.exp(
                -(
                    (self._ys[None] - cy[:, None, None]) ** 2
                    + (self._xs[None] - cx[:, None, None]) ** 2
                )
                / (2 * sig[:, None, None] ** 2)
            )
            img = img + blob[..., None] * color[:, None, None, :]
        img = np.clip(img, np.float32(0.0), np.float32(1.0))
        return (img * np.float32(255.0)).astype(np.uint8), labels

    def example(self, index: int, rng: Optional[np.random.Generator] = None) -> Example:
        imgs, labels = self._render(np.asarray([index]))
        return imgs[0], int(labels[0])

    def batch_fast(self, indices, flips):
        imgs, labels = self._render(np.asarray(indices))
        flips = np.asarray(flips, bool)
        if flips.any():
            imgs[flips] = imgs[flips, :, ::-1]
        return imgs, labels


class Cifar10:
    """CIFAR-10 from the standard python-pickle binary batches
    (`cifar-10-batches-py/` dir or `cifar-10-python.tar.gz`), fully resident
    in host RAM (it is 150 MB)."""

    def __init__(self, path: str, train: bool = True):
        arrays, labels = self._load(path, train)
        self.images = arrays  # (N, 32, 32, 3) uint8
        self.labels = labels
        self.resolution = 32
        self.channels = 3
        self.num_classes = 10

    @staticmethod
    def _load(path: str, train: bool):
        names = (
            [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"]
        )
        batches = []
        if os.path.isdir(path):
            base = path
            if os.path.isdir(os.path.join(path, "cifar-10-batches-py")):
                base = os.path.join(path, "cifar-10-batches-py")
            for name in names:
                with open(os.path.join(base, name), "rb") as f:
                    batches.append(pickle.load(f, encoding="bytes"))
        elif tarfile.is_tarfile(path):
            with tarfile.open(path) as tar:
                for name in names:
                    member = tar.getmember(f"cifar-10-batches-py/{name}")
                    batches.append(pickle.load(tar.extractfile(member), encoding="bytes"))
        else:
            raise FileNotFoundError(f"no CIFAR-10 data at {path!r}")
        imgs = np.concatenate([b[b"data"] for b in batches], axis=0)
        imgs = imgs.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)  # NCHW->NHWC
        labels = np.concatenate([np.asarray(b[b"labels"]) for b in batches])
        return np.ascontiguousarray(imgs), labels.astype(np.int32)

    def __len__(self) -> int:
        return len(self.images)

    def example(self, index: int, rng=None) -> Example:
        return self.images[index], int(self.labels[index])

    def batch_fast(self, indices, flips):
        idx = np.asarray(indices)
        imgs = self.images[idx]  # fancy indexing already copies
        flips = np.asarray(flips, bool)
        if flips.any():
            imgs[flips] = imgs[flips, :, ::-1]
        return imgs, self.labels[idx].astype(np.int32)


class ImageFolder:
    """Flat or class-per-subdir folder of images, decoded with PIL and
    resized to `resolution` (CelebA, LSUN and FFHQ are delivered as image
    folders). Labels are subdir indices when subdirs exist, else 0."""

    EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")

    def __init__(self, path: str, resolution: int, channels: int = 3):
        self.resolution = resolution
        self.channels = channels
        self.files: List[str] = []
        self.labels: List[int] = []
        classes = sorted(
            d for d in os.listdir(path) if os.path.isdir(os.path.join(path, d))
        ) if os.path.isdir(path) else []
        if classes:
            for ci, cls in enumerate(classes):
                for fn in sorted(os.listdir(os.path.join(path, cls))):
                    if fn.lower().endswith(self.EXTENSIONS):
                        self.files.append(os.path.join(path, cls, fn))
                        self.labels.append(ci)
            self.num_classes = len(classes)
        else:
            for fn in sorted(os.listdir(path)):
                if fn.lower().endswith(self.EXTENSIONS):
                    self.files.append(os.path.join(path, fn))
                    self.labels.append(0)
            self.num_classes = 0
        if not self.files:
            raise FileNotFoundError(f"no images under {path!r}")
        # native decoder handles JPEG/PNG RGB only (cached: checked per batch)
        self._native_eligible = channels == 3 and all(
            f.lower().endswith(self.NATIVE_EXTENSIONS) for f in self.files
        )

    def __len__(self) -> int:
        return len(self.files)

    # formats the native decoder handles (loader.cc sniffs JPEG/PNG magic)
    NATIVE_EXTENSIONS = (".png", ".jpg", ".jpeg")

    def batch_fast(self, indices, flips):
        """Native batched decode+crop+resize+flip (C++ thread pool; see
        data/_native/loader.cc). Raises RuntimeError when the native path
        is structurally unavailable (lib missing, non-RGB, non-JPEG/PNG
        files present) — the producer then falls back to `example`
        permanently; raises OSError on a corrupt file — the producer
        retries that batch via `example`."""
        from locate_tpu_torch.data import native

        if not self._native_eligible or not native.available():
            raise RuntimeError("native loader unavailable for this folder")
        paths = [self.files[int(i)] for i in indices]
        images = native.decode_batch(paths, self.resolution, flips)
        labels = np.asarray([self.labels[int(i)] for i in indices], np.int32)
        return images, labels

    def example(self, index: int, rng=None) -> Example:
        arr = _pil_decode(self.files[index], self.resolution, self.channels)
        return arr, int(self.labels[index])


class ZipImages:
    """Images inside a zip archive, read WITHOUT extraction — the
    StyleGAN2-ADA ecosystem's canonical dataset format (its
    dataset_tool.py emits exactly this: image members + an optional
    `dataset.json` with ``{"labels": [[member_name, int], ...]}``).

    Labels resolve in priority order: dataset.json when present, else
    first-level directory names inside the archive (mirroring
    ImageFolder's class-per-subdir rule), else unlabeled. Decode protocol
    (center-crop + bilinear resize, `_pil_decode`) matches ImageFolder
    exactly, so `pack`-ing a zip and `pack`-ing its extracted folder give
    byte-identical shards. Random access seeks within the archive (zip
    central directory -> O(1) member lookup); a lock serializes reads on
    the shared handle (the pipeline's single producer thread never
    contends; eval-path calls stay safe)."""

    EXTENSIONS = ImageFolder.EXTENSIONS

    def __init__(self, path: str, resolution: int, channels: int = 3):
        self.path = path
        self.resolution = resolution
        self.channels = channels
        self._zf: Optional[zipfile.ZipFile] = None
        self._lock = threading.Lock()
        with zipfile.ZipFile(path) as zf:
            members = sorted(
                n for n in zf.namelist()
                if n.lower().endswith(self.EXTENSIONS) and not n.endswith("/")
            )
            if not members:
                raise FileNotFoundError(f"no images inside {path!r}")
            label_map = None
            if "dataset.json" in zf.namelist():
                meta = json.loads(zf.read("dataset.json"))
                raw = meta.get("labels")
                if raw:  # ADA convention: null means unlabeled
                    label_map = {name: int(lab) for name, lab in raw}
        self.names = members
        if label_map is not None:
            self.labels = np.asarray(
                [label_map.get(n, 0) for n in members], np.int32
            )
            self.num_classes = int(self.labels.max()) + 1
        else:
            tops = sorted({n.split("/", 1)[0] for n in members if "/" in n})
            if tops and all("/" in n for n in members):
                idx = {t: i for i, t in enumerate(tops)}
                self.labels = np.asarray(
                    [idx[n.split("/", 1)[0]] for n in members], np.int32
                )
                self.num_classes = len(tops)
            else:
                self.labels = np.zeros(len(members), np.int32)
                self.num_classes = 0

    def __len__(self) -> int:
        return len(self.names)

    def example(self, index: int, rng=None) -> Example:
        with self._lock:
            if self._zf is None:
                self._zf = zipfile.ZipFile(self.path)
            data = self._zf.read(self.names[index])
        import io

        arr = _pil_decode(io.BytesIO(data), self.resolution, self.channels)
        return arr, int(self.labels[index])


def make_dataset(cfg) -> object:
    """Dataset factory from a DataConfig."""
    if cfg.dataset == "synthetic":
        return SyntheticImages(
            cfg.resolution, cfg.img_channels, num_classes=cfg.num_classes
        )
    if cfg.dataset == "cifar10":
        try:
            return Cifar10(cfg.path or "data/cifar10")
        except FileNotFoundError:
            # Offline fallback: keep config 1 runnable anywhere.
            return SyntheticImages(32, 3, num_classes=cfg.num_classes or 10)
    if cfg.dataset == "folder":
        # convenience: a .zip path under dataset="folder" still works
        if cfg.path.lower().endswith(".zip") and os.path.isfile(cfg.path):
            return ZipImages(cfg.path, cfg.resolution, cfg.img_channels)
        return ImageFolder(cfg.path, cfg.resolution, cfg.img_channels)
    if cfg.dataset == "zip":
        return ZipImages(cfg.path, cfg.resolution, cfg.img_channels)
    if cfg.dataset == "tfrecord":
        from locate_tpu_torch.data.tfrecords import TFRecordImages

        return TFRecordImages(cfg.path, cfg.resolution, cfg.img_channels)
    if cfg.dataset in ("lsun", "lmdb"):
        from locate_tpu_torch.data.lmdb_reader import LmdbImages

        return LmdbImages(cfg.path, cfg.resolution, cfg.img_channels)
    if cfg.dataset == "packed":
        from locate_tpu_torch.data.packed import PackedDataset

        ds = PackedDataset(cfg.path)
        if ds.resolution != cfg.resolution:
            raise ValueError(
                f"packed dataset at {cfg.path!r} is {ds.resolution}px but "
                f"data.resolution={cfg.resolution} — re-pack at the training "
                f"resolution (packed shards are never resized at load time)"
            )
        return ds
    raise ValueError(f"unknown dataset {cfg.dataset!r}")
