"""TFRecord image datasets of the port, counterparts of
`locate_tpu/data/tfrecords.py` (FFHQ and LSUN are distributed as
StyleGAN-style .tfrecords shards).

Two record conventions are understood:

  * StyleGAN (progressive_growing_of_gans / stylegan{,2}) — tf.train.Example
    with ``shape`` (int64_list [C, H, W]) and ``data`` (bytes_list: raw
    uint8 CHW pixels);
  * TF-slim — ``image/encoded`` (bytes_list: JPEG/PNG) with optional
    ``image/class/label`` (int64_list).

Design notes:

  * NO TensorFlow import anywhere on the read path: the TFRecord framing
    (u64 length + masked-crc32c + payload) and the tf.train.Example proto
    are parsed with ~80 lines of wire-format code below — tf.data would
    drag a second runtime onto the host for what is a memcpy-shaped job.
  * TFRecords are a SEQUENTIAL format; this framework's input pipeline
    (data/pipeline.py) wants random access (deterministic shuffles,
    bitwise resume via skip_examples). A one-time framing scan builds a
    record-offset index, cached next to each shard as ``<file>.idx.npy``,
    after which reads are mmap-style seeks.
  * For steady-state training throughput, `pack` the tfrecords
    once into the packed uint8 memmap format; this reader is the
    compatibility on-ramp (and is what `pack` itself consumes).

CRCs are length-checked but not verified (the cost would be real on a
small host; a truncated/corrupt shard still fails loudly via framing).
"""

from __future__ import annotations

import os
import struct
from typing import List, Optional, Tuple

import numpy as np

Example = Tuple[np.ndarray, int]


# --------------------------------------------------------------------------
# minimal protobuf wire parser (tf.train.Example subset)
# --------------------------------------------------------------------------

def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a message; value is an
    int for varint fields and a memoryview slice for length-delimited."""
    pos, end = 0, len(buf)
    while pos < end:
        tag, pos = _read_varint(buf, pos)
        field, wt = tag >> 3, tag & 7
        if wt == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wt == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wt == 5:  # 32-bit
            val = buf[pos:pos + 4]
            pos += 4
        elif wt == 1:  # 64-bit
            val = buf[pos:pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield field, wt, val


def parse_example(payload: bytes) -> dict:
    """tf.train.Example -> {name: list-of-bytes | ndarray}. Supports
    BytesList, packed/unpacked Int64List and FloatList."""
    out = {}
    for f, _, features in _iter_fields(payload):
        if f != 1:  # Example.features
            continue
        for f2, _, entry in _iter_fields(features):
            if f2 != 1:  # Features.feature (map entry)
                continue
            name, feature = None, None
            for f3, _, v in _iter_fields(entry):
                if f3 == 1:
                    name = bytes(v).decode("utf-8")
                elif f3 == 2:
                    feature = v
            if name is None or feature is None:
                continue
            for kind, _, lst in _iter_fields(feature):
                if kind == 1:  # BytesList
                    vals = [bytes(v) for f4, _, v in _iter_fields(lst)
                            if f4 == 1]
                    out[name] = vals
                elif kind == 2:  # FloatList
                    floats: List[float] = []
                    for f4, wt4, v in _iter_fields(lst):
                        if f4 != 1:
                            continue
                        if wt4 == 2:  # packed
                            floats.extend(
                                np.frombuffer(v, "<f4").tolist()
                            )
                        else:
                            floats.append(
                                struct.unpack("<f", bytes(v))[0]
                            )
                    out[name] = np.asarray(floats, np.float32)
                elif kind == 3:  # Int64List
                    ints: List[int] = []
                    for f4, wt4, v in _iter_fields(lst):
                        if f4 != 1:
                            continue
                        if wt4 == 2:  # packed varints
                            p = 0
                            while p < len(v):
                                val, p = _read_varint(v, p)
                                ints.append(val)
                        else:
                            ints.append(v)
                    out[name] = np.asarray(ints, np.int64)
    return out


# --------------------------------------------------------------------------
# record framing
# --------------------------------------------------------------------------

def iter_record_offsets(path: str):
    """Yield (offset, payload_length) for each record by walking the
    framing: u64le length, u32 crc(length), payload, u32 crc(payload)."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        pos = 0
        while pos + 12 <= size:
            f.seek(pos)
            header = f.read(12)
            if len(header) < 12:
                break
            (length,) = struct.unpack("<Q", header[:8])
            if pos + 12 + length + 4 > size:
                raise ValueError(
                    f"truncated tfrecord {path!r} at offset {pos}"
                )
            yield pos + 12, length
            pos += 12 + length + 4


def read_record(f, offset: int, length: int) -> bytes:
    f.seek(offset)
    return f.read(length)


def _index_path(path: str) -> str:
    return path + ".idx.npy"


def _load_or_build_index(path: str) -> np.ndarray:
    """(N, 2) int64 [offset, length] per record; cached beside the shard
    (rebuilt if stale)."""
    ip = _index_path(path)
    if os.path.exists(ip) and os.path.getmtime(ip) >= os.path.getmtime(path):
        idx = np.load(ip)
        if idx.ndim == 2 and idx.shape[1] == 2:
            return idx
    idx = np.asarray(list(iter_record_offsets(path)), np.int64).reshape(-1, 2)
    try:
        np.save(ip, idx)
    except OSError:
        pass  # read-only dataset dir: index rebuilt per run
    return idx


# --------------------------------------------------------------------------
# the dataset
# --------------------------------------------------------------------------

class TFRecordImages:
    """Random-access image dataset over one or more .tfrecords shards.

    `path` is a single file or a directory (all ``*.tfrecord*`` files,
    sorted). Images are center-cropped and resized to `resolution` when
    the stored size differs (PIL path, like ImageFolder). Labels come
    from ``image/class/label`` when present, else 0."""

    EXTENSIONS = (".tfrecord", ".tfrecords")

    def __init__(self, path: str, resolution: int, channels: int = 3):
        self.resolution = resolution
        self.channels = channels
        if os.path.isdir(path):
            self.files = sorted(
                os.path.join(path, f)
                for f in os.listdir(path)
                if f.lower().endswith(self.EXTENSIONS)
            )
        else:
            self.files = [path]
        if not self.files or not all(os.path.isfile(f) for f in self.files):
            raise FileNotFoundError(f"no tfrecord shards under {path!r}")
        self._indices = [_load_or_build_index(f) for f in self.files]
        counts = [len(i) for i in self._indices]
        self._starts = np.cumsum([0] + counts)
        self._handles: List[Optional[object]] = [None] * len(self.files)
        # Conditioning ranges come from the config (model.num_classes);
        # per-record labels are surfaced but not scanned ahead of time.
        self.num_classes = 0
        if len(self) == 0:
            raise ValueError(f"tfrecord shards under {path!r} are empty")

    def __len__(self) -> int:
        return int(self._starts[-1])

    def _record(self, index: int) -> bytes:
        shard = int(np.searchsorted(self._starts, index, "right") - 1)
        off, ln = self._indices[shard][index - self._starts[shard]]
        h = self._handles[shard]
        if h is None:
            h = self._handles[shard] = open(self.files[shard], "rb")
        return read_record(h, int(off), int(ln))

    def example(self, index: int, rng=None) -> Example:
        feats = parse_example(self._record(index))
        if "data" in feats and "shape" in feats:  # StyleGAN convention
            c, h, w = (int(v) for v in feats["shape"][:3])
            arr = np.frombuffer(feats["data"][0], np.uint8).reshape(c, h, w)
            arr = arr.transpose(1, 2, 0)  # CHW -> HWC
        elif "image/encoded" in feats:  # TF-slim convention
            import io

            from PIL import Image

            with Image.open(io.BytesIO(feats["image/encoded"][0])) as im:
                im = im.convert("RGB" if self.channels == 3 else "L")
                arr = np.asarray(im, np.uint8)
            if arr.ndim == 2:
                arr = arr[..., None]
        else:
            raise ValueError(
                "unrecognized tfrecord example (expected StyleGAN "
                "'data'+'shape' or TF-slim 'image/encoded'); found keys: "
                f"{sorted(feats)}"
            )
        if arr.shape[-1] != self.channels:
            if self.channels == 3 and arr.shape[-1] == 1:
                arr = np.repeat(arr, 3, axis=-1)
            else:
                arr = arr[..., : self.channels]
        if arr.shape[0] != self.resolution or arr.shape[1] != self.resolution:
            from PIL import Image

            h0, w0 = arr.shape[:2]
            s = min(h0, w0)
            arr = arr[(h0 - s) // 2:(h0 + s) // 2,
                      (w0 - s) // 2:(w0 + s) // 2]
            im = Image.fromarray(arr.squeeze() if arr.shape[-1] == 1 else arr)
            im = im.resize((self.resolution, self.resolution), Image.BILINEAR)
            arr = np.asarray(im, np.uint8)
            if arr.ndim == 2:
                arr = arr[..., None]
        label = 0
        lab = feats.get("image/class/label")
        if lab is not None and len(lab):
            label = int(lab[0])
        return arr, label


# --------------------------------------------------------------------------
# writer (fixture/export utility; also lets tests round-trip without TF)
# --------------------------------------------------------------------------

def _crc32c_masked(data: bytes) -> int:
    """Masked CRC32C per the TFRecord spec. Table-driven; only the writer
    pays for it (the reader skips CRC verification)."""
    poly = 0x82F63B78
    crc = 0xFFFFFFFF
    for byte in data:
        crc ^= byte
        for _ in range(8):
            crc = (crc >> 1) ^ (poly if crc & 1 else 0)
    crc ^= 0xFFFFFFFF
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field(num: int, wt: int, payload: bytes) -> bytes:
    head = _varint(num << 3 | wt)
    if wt == 2:
        return head + _varint(len(payload)) + payload
    return head + payload


def encode_example(image_chw_u8: np.ndarray, label: Optional[int] = None
                   ) -> bytes:
    """tf.train.Example in the StyleGAN convention ('shape' + 'data'
    [+ 'image/class/label'])."""
    c, h, w = image_chw_u8.shape
    shape_payload = b"".join(_varint(v) for v in (c, h, w))
    shape_feat = _field(3, 2, _field(1, 2, shape_payload))  # packed Int64List
    data_feat = _field(1, 2, _field(1, 2, image_chw_u8.tobytes()))
    entries = [
        _field(1, 2, _field(1, 2, b"shape") + _field(2, 2, shape_feat)),
        _field(1, 2, _field(1, 2, b"data") + _field(2, 2, data_feat)),
    ]
    if label is not None:
        lab_feat = _field(3, 2, _field(1, 2, _varint(int(label))))
        entries.append(
            _field(1, 2, _field(1, 2, b"image/class/label")
                   + _field(2, 2, lab_feat))
        )
    return _field(1, 2, b"".join(entries))  # Example.features


def write_tfrecord(path: str, payloads) -> None:
    """Write framed records (each a serialized tf.train.Example)."""
    with open(path, "wb") as f:
        for p in payloads:
            header = struct.pack("<Q", len(p))
            f.write(header)
            f.write(struct.pack("<I", _crc32c_masked(header)))
            f.write(p)
            f.write(struct.pack("<I", _crc32c_masked(p)))
