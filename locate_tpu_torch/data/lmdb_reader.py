"""Pure-Python read-only LMDB reader of the port, the counterpart of
`locate_tpu/data/lmdb_reader.py`: LSUN's container with no dependency.

LSUN-bedroom 128^2 is the repo's primary configuration, and the reference
read it through torchvision's `LSUN` dataset, which wraps the `lmdb`
package (a C extension). LMDB files are a B+tree of fixed-size pages,
and READ-ONLY access needs no locks and no C: ~200 lines of struct
unpacking.

On-disk layout implemented here (LMDB 0.9.x "data version 1", 64-bit
builds — the layout of every published LSUN archive):

    page header (16 B):  pgno u64 | pad u16 | flags u16 |
                         lower u16, upper u16        (branch/leaf: ptr bounds)
                         -or- pb_pages u32           (overflow: page count)
    page flags:          1=BRANCH 2=LEAF 4=OVERFLOW 8=META 0x20=LEAF2
    meta page (after header):
        magic u32 (0xBEEFC0DE) | version u32 (1) | address u64 | mapsize u64
        | db[0] FREE | db[1] MAIN | last_pg u64 | txnid u64
    db record (48 B):    pad u32 (db[0].pad == page size!) | flags u16 |
                         depth u16 | branch_pages u64 | leaf_pages u64 |
                         overflow_pages u64 | entries u64 | root u64
    node (at page_start + ptr, ptrs are u16 at offset 16, count
    (lower-16)/2):       lo u16 | hi u16 | flags u16 | ksize u16 | key...
        leaf:   data size = lo | hi<<16; flags&1 (BIGDATA) -> 8-byte
                overflow pgno follows the key, value bytes live at
                overflow_pgno*psize + 16, contiguous across pages
        branch: child pgno = lo | hi<<16 | flags<<32 (node 0's key unused)

The two meta pages (pgno 0/1) alternate between commits; the valid one with
the larger txnid is current. Everything is little-endian (the files are not
portable across endianness; neither is the C library's mmap).

Exposed here:
  * `LmdbReader` — len / ordered iteration / O(log n) key lookup /
    O(1) random access by integer index (after one cheap leaf-page scan
    that never touches the values).
  * `LmdbImages` — the dataset adapter (`data.dataset="lsun"` or
    `"lmdb"`): a single LMDB environment, or a directory of `*_lmdb`
    environments as class-per-subdir (torchvision's multi-category LSUN
    layout), decoded with PIL (LSUN values are WebP; older exports JPEG).

Held against the JAX package's reader on files from the writer twin
(tests/lmdb_mini.py) that follows the same struct layout.
"""

from __future__ import annotations

import mmap
import os
import struct
from typing import Iterator, List, Optional, Tuple

import numpy as np

MAGIC = 0xBEEFC0DE
DATA_VERSION = 1

P_BRANCH = 0x01
P_LEAF = 0x02
P_OVERFLOW = 0x04
P_META = 0x08
P_LEAF2 = 0x20

F_BIGDATA = 0x01
F_SUBDATA = 0x02
F_DUPDATA = 0x04

PAGEHDRSZ = 16
_INVALID = 0xFFFFFFFFFFFFFFFF


class LmdbError(RuntimeError):
    pass


def _env_file(path: str) -> str:
    """Resolve an environment path: a directory containing `data.mdb`
    (LMDB's default "subdir" mode — LSUN's layout) or the .mdb file."""
    if os.path.isdir(path):
        f = os.path.join(path, "data.mdb")
        if not os.path.exists(f):
            raise LmdbError(f"no data.mdb under {path!r}")
        return f
    return path


class LmdbReader:
    """Read-only main-database reader of one LMDB environment.

    * `len(r)` — entry count (from the committed meta).
    * `r.items()` — ordered (key, value) iteration.
    * `r[i]` — i-th (key, value) in key order; the first access scans the
      leaf pages once (keys only, values untouched) to build the index.
    * `r.get(key)` — exact-match lookup, None when absent.

    Named sub-databases and DUPSORT data are out of scope (LSUN and every
    image archive in the wild keep records directly in the main DB); they
    raise `LmdbError` rather than misread.
    """

    def __init__(self, path: str):
        self.path = _env_file(path)
        self._f = open(self.path, "rb")
        try:
            self._m = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        except ValueError as e:  # zero-length file
            raise LmdbError(f"{self.path!r} is empty") from e
        m = self._m
        if len(m) < 2 * PAGEHDRSZ + 136:
            raise LmdbError(f"{self.path!r} too small to hold LMDB metas")
        # psize lives in meta 0's FREE-db pad (mm_psize alias in mdb.c);
        # meta 1 sits one page in, so meta 0 must be read first.
        psize = struct.unpack_from("<I", m, PAGEHDRSZ + 24)[0]
        if not 512 <= psize <= 65536 or psize & (psize - 1):
            raise LmdbError(
                f"implausible page size {psize} — not an LMDB file, or a "
                "32-bit-build file (unsupported)"
            )
        self.psize = psize
        metas = []
        for pg in (0, 1):
            off = pg * psize + PAGEHDRSZ
            if off + 136 > len(m):
                continue
            magic, version = struct.unpack_from("<II", m, off)
            if magic != MAGIC:
                continue
            if version != DATA_VERSION:
                raise LmdbError(f"LMDB data version {version} != 1")
            txnid = struct.unpack_from("<Q", m, off + 128)[0]
            metas.append((txnid, off))
        if not metas:
            raise LmdbError(f"no valid LMDB meta page in {self.path!r}")
        txnid, off = max(metas)
        main = off + 24 + 48  # past magic/version/address/mapsize + FREE db
        (_pad, flags, depth, _bp, _lp, _op, entries, root) = struct.unpack_from(
            "<IHHQQQQQ", m, main
        )
        if flags & 0x04:  # MDB_DUPSORT on the main DB
            raise LmdbError("DUPSORT main database unsupported")
        self.depth = depth
        self.entries = entries
        self.root = root
        self.last_pgno = len(m) // psize - 1
        if root != _INVALID and root > self.last_pgno:
            raise LmdbError(f"root page {root} beyond file end")
        self._cum: Optional[np.ndarray] = None
        self._leaves: Optional[np.ndarray] = None
        self._page_cache: dict = {}

    # -- page plumbing ------------------------------------------------------

    def _page(self, pgno: int) -> Tuple[int, int, List[int]]:
        """(flags, numkeys, ptrs) of a branch/leaf page."""
        if pgno > self.last_pgno:
            raise LmdbError(f"page {pgno} beyond file end")
        base = pgno * self.psize
        flags, lower = struct.unpack_from("<HH", self._m, base + 10)
        if flags & P_LEAF2:
            raise LmdbError("LEAF2 (fixed-key) pages unsupported")
        if not flags & (P_BRANCH | P_LEAF):
            raise LmdbError(f"page {pgno}: unexpected flags 0x{flags:x}")
        n = (lower - PAGEHDRSZ) >> 1
        ptrs = struct.unpack_from(f"<{n}H", self._m, base + PAGEHDRSZ)
        return flags, n, list(ptrs)

    def _branch_child(self, base: int, ptr: int) -> Tuple[bytes, int]:
        lo, hi, fl, ksize = struct.unpack_from("<HHHH", self._m, base + ptr)
        key = bytes(self._m[base + ptr + 8 : base + ptr + 8 + ksize])
        return key, lo | hi << 16 | fl << 32

    def _leaf_node(self, pgno: int, ptr: int) -> Tuple[bytes, bytes]:
        base = pgno * self.psize
        lo, hi, fl, ksize = struct.unpack_from("<HHHH", self._m, base + ptr)
        if fl & (F_DUPDATA | F_SUBDATA):
            raise LmdbError("DUPSORT/sub-database records unsupported")
        dsize = lo | hi << 16
        koff = base + ptr + 8
        key = bytes(self._m[koff : koff + ksize])
        if fl & F_BIGDATA:
            (ovpg,) = struct.unpack_from("<Q", self._m, koff + ksize)
            doff = ovpg * self.psize + PAGEHDRSZ
            if doff + dsize > len(self._m):
                raise LmdbError(f"overflow value at page {ovpg} truncated")
            return key, bytes(self._m[doff : doff + dsize])
        return key, bytes(self._m[koff + ksize : koff + ksize + dsize])

    # -- public API ---------------------------------------------------------

    def __len__(self) -> int:
        return self.entries

    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        """All (key, value), in key order, streaming (no index build)."""
        if self.root == _INVALID:
            return
        stack = [(self.root, 0)]
        while stack:
            pgno, i = stack.pop()
            flags, n, ptrs = self._page(pgno)
            if flags & P_LEAF:
                for ptr in ptrs:
                    yield self._leaf_node(pgno, ptr)
                continue
            if i < n:
                stack.append((pgno, i + 1))
                base = pgno * self.psize
                stack.append((self._branch_child(base, ptrs[i])[1], 0))

    def _build_index(self) -> None:
        """One DFS over branch+leaf pages (values never touched): leaf page
        numbers in key order + a cumulative entry count for binary search.
        ~10 bytes/page, not per record — 3M-record LSUN costs ~1 MB."""
        leaves: List[int] = []
        counts: List[int] = []
        if self.root != _INVALID:
            stack = [self.root]
            while stack:
                pgno = stack.pop()
                flags, n, ptrs = self._page(pgno)
                if flags & P_LEAF:
                    leaves.append(pgno)
                    counts.append(n)
                else:
                    base = pgno * self.psize
                    for ptr in reversed(ptrs):
                        stack.append(self._branch_child(base, ptr)[1])
        self._leaves = np.asarray(leaves, np.int64)
        self._cum = np.cumsum(np.asarray(counts, np.int64))
        total = int(self._cum[-1]) if len(self._cum) else 0
        if total != self.entries:
            raise LmdbError(
                f"index scan found {total} entries, meta says {self.entries}"
            )

    def __getitem__(self, index: int) -> Tuple[bytes, bytes]:
        if self._cum is None:
            self._build_index()
        if not 0 <= index < self.entries:
            raise IndexError(index)
        li = int(np.searchsorted(self._cum, index, side="right"))
        pgno = int(self._leaves[li])
        slot = index - (int(self._cum[li - 1]) if li else 0)
        ptrs = self._page_cache.get(pgno)
        if ptrs is None:
            ptrs = self._page(pgno)[2]
            if len(self._page_cache) > 64:
                self._page_cache.clear()
            self._page_cache[pgno] = ptrs
        return self._leaf_node(pgno, ptrs[slot])

    def get(self, key: bytes) -> Optional[bytes]:
        """Exact-key lookup by B+tree descent (memcmp order, LMDB's
        default comparator)."""
        if self.root == _INVALID:
            return None
        pgno = self.root
        for _ in range(self.depth + 1):
            flags, n, ptrs = self._page(pgno)
            base = pgno * self.psize
            if flags & P_BRANCH:
                # rightmost child whose separator key <= target (node 0's
                # key is unused — it covers everything to the left)
                lo_i, hi_i = 1, n
                while lo_i < hi_i:
                    mid = (lo_i + hi_i) // 2
                    if self._branch_child(base, ptrs[mid])[0] <= key:
                        lo_i = mid + 1
                    else:
                        hi_i = mid
                pgno = self._branch_child(base, ptrs[lo_i - 1])[1]
                continue
            lo_i, hi_i = 0, n
            while lo_i < hi_i:
                mid = (lo_i + hi_i) // 2
                k, v = self._leaf_node(pgno, ptrs[mid])
                if k == key:
                    return v
                if k < key:
                    lo_i = mid + 1
                else:
                    hi_i = mid
            return None
        raise LmdbError("B+tree deeper than advertised depth")

    def close(self) -> None:
        self._m.close()
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# dataset adapter
# ---------------------------------------------------------------------------


def _is_env(path: str) -> bool:
    return os.path.isdir(path) and os.path.exists(
        os.path.join(path, "data.mdb")
    )


class LmdbImages:
    """Image dataset over LMDB archive(s) (`data.dataset="lsun"`/"lmdb").

    `path` is one environment (dir with `data.mdb`, or a `.mdb` file) —
    unconditional, label 0 — or a directory whose subdirectories are each
    an environment (torchvision's multi-category LSUN layout:
    `bedroom_train_lmdb/`, `church_train_lmdb/`, ...) — class-per-subdir,
    sorted order. Values are decoded with PIL (WebP for current LSUN
    exports, JPEG for older ones), center-cropped square and resized, the
    same protocol as `ImageFolder`. For production input rates run
    `pack` once (decode at memcpy speed afterwards); this
    adapter is the zero-setup direct path.
    """

    def __init__(self, path: str, resolution: int, channels: int = 3):
        self.resolution = resolution
        self.channels = channels
        if _is_env(path) or os.path.isfile(path):
            self._readers = [LmdbReader(path)]
            self.num_classes = 0
        else:
            if not os.path.isdir(path):
                raise FileNotFoundError(f"no LMDB environment at {path!r}")
            envs = sorted(
                d for d in os.listdir(path)
                if _is_env(os.path.join(path, d))
            )
            if not envs:
                raise LmdbError(
                    f"{path!r} holds neither data.mdb nor *_lmdb subdirs"
                )
            self._readers = [LmdbReader(os.path.join(path, d)) for d in envs]
            self.num_classes = len(envs) if len(envs) > 1 else 0
        lens = [len(r) for r in self._readers]
        self._cum = np.cumsum(np.asarray(lens, np.int64))

    def __len__(self) -> int:
        return int(self._cum[-1])

    @property
    def labels(self) -> np.ndarray:
        """Per-index class labels (reader index), for per-class eval."""
        out = np.zeros(len(self), np.int32)
        start = 0
        for ci, end in enumerate(self._cum):
            out[start:end] = ci if self.num_classes else 0
            start = int(end)
        return out

    def _record(self, index: int) -> Tuple[bytes, int]:
        ri = int(np.searchsorted(self._cum, index, side="right"))
        local = index - (int(self._cum[ri - 1]) if ri else 0)
        return self._readers[ri][local][1], (ri if self.num_classes else 0)

    def example(self, index: int, rng=None):
        import io

        from PIL import Image

        data, label = self._record(index)
        with Image.open(io.BytesIO(data)) as im:
            im = im.convert("RGB" if self.channels == 3 else "L")
            w, h = im.size
            s = min(w, h)
            im = im.crop(((w - s) // 2, (h - s) // 2, (w + s) // 2, (h + s) // 2))
            im = im.resize((self.resolution, self.resolution), Image.BILINEAR)
            arr = np.asarray(im, np.uint8)
        if arr.ndim == 2:
            arr = arr[..., None]
        return arr, label

    def close(self) -> None:
        for r in self._readers:
            r.close()
