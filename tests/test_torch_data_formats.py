"""The port's archive readers against the JAX package's on the same files:
zip (dataset.json labels, subdirectory labels, none), TFRecords (the
StyleGAN and TF-slim conventions, a directory of shards with a resize, a
truncated shard), LMDB and the LSUN export (the reader, the image adapter,
`lsun-export` through `cli.main`) and the grain adapters; the same arrays,
labels and errors. Fixtures are built as tests/test_zip_dataset.py,
test_tfrecords.py, test_lmdb.py and lmdb_mini.py build them. Last, the
data package's modules import neither JAX nor the JAX package."""

import io
import json
import os
import re
import subprocess
import sys
import zipfile

import numpy as np
import pytest
from PIL import Image

from lmdb_mini import write_lmdb
from locate_tpu.data import datasets as jds
from locate_tpu.data import lmdb_reader as jlm
from locate_tpu.data import lsun as jlsun
from locate_tpu.data import tfrecords as jtf
from locate_tpu_torch import cli
from locate_tpu_torch.config import DataConfig
from locate_tpu_torch.data import datasets as tds
from locate_tpu_torch.data import lmdb_reader as tlm
from locate_tpu_torch.data import lsun as tlsun
from locate_tpu_torch.data import tfrecords as ttf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA_MODULES = ("datasets", "packed", "native", "pipeline", "tfrecords", "lmdb_reader",
                "lsun", "grain_adapter")


def assert_same_examples(port, ref, n):
    assert len(port) == len(ref) == n
    for i in range(n):
        (pa, pl), (ra, rl) = port.example(i), ref.example(i)
        np.testing.assert_array_equal(pa, ra)
        assert pa.dtype == ra.dtype and pl == rl


def raises_alike(exc, fn_port, fn_ref):
    with pytest.raises(exc) as port_err:
        fn_port()
    with pytest.raises(exc) as ref_err:
        fn_ref()
    assert type(port_err.value).__name__ == type(ref_err.value).__name__
    assert str(port_err.value) == str(ref_err.value)


# ---------------------------------------------------------------------------
# zip
# ---------------------------------------------------------------------------


def png_bytes(rng, size=(20, 14)):
    arr = rng.integers(0, 256, (size[1], size[0], 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def write_zip(path, n=6, labels=None, subdirs=None):
    rng = np.random.default_rng(0)
    with zipfile.ZipFile(path, "w") as zf:
        names = []
        for i in range(n):
            name = f"{subdirs[i % len(subdirs)]}/img{i:03d}.png" if subdirs else f"img{i:03d}.png"
            zf.writestr(name, png_bytes(rng))
            names.append(name)
        zf.writestr("README.txt", b"not an image")
        if labels is not None:
            zf.writestr("dataset.json", json.dumps(
                {"labels": [[nm, int(lab)] for nm, lab in zip(names, labels)]}))


@pytest.mark.parametrize("form", ["dataset_json", "subdirs", "unlabeled"])
def test_zip_images(tmp_path, form):
    path = str(tmp_path / "ds.zip")
    write_zip(path, labels=[0, 1, 2, 0, 1, 2] if form == "dataset_json" else None,
              subdirs=["cat", "dog"] if form == "subdirs" else None)
    port, ref = tds.ZipImages(path, 16), jds.ZipImages(path, 16)
    assert port.names == ref.names and port.num_classes == ref.num_classes
    assert port.num_classes == {"dataset_json": 3, "subdirs": 2, "unlabeled": 0}[form]
    np.testing.assert_array_equal(port.labels, ref.labels)
    assert_same_examples(port, ref, 6)
    for dataset in ("zip", "folder"):  # a .zip under dataset="folder" reads as zip
        assert isinstance(tds.make_dataset(DataConfig(dataset=dataset, path=path,
                                                      resolution=16)), tds.ZipImages)


def test_zip_without_images_raises_alike(tmp_path):
    path = str(tmp_path / "empty.zip")
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr("notes.txt", b"x")
    raises_alike(FileNotFoundError, lambda: tds.ZipImages(path, 8),
                 lambda: jds.ZipImages(path, 8))


# ---------------------------------------------------------------------------
# TFRecords
# ---------------------------------------------------------------------------


def chw_images(n, c, h, w, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, c, h, w), dtype=np.uint8)


def test_tfrecord_writer_and_parser_agree(tmp_path):
    imgs = chw_images(5, 3, 16, 16)
    payloads = [ttf.encode_example(im, label=i % 3) for i, im in enumerate(imgs)]
    assert payloads == [jtf.encode_example(im, label=i % 3) for i, im in enumerate(imgs)]
    ttf.write_tfrecord(str(tmp_path / "port.tfrecords"), payloads)
    jtf.write_tfrecord(str(tmp_path / "jax.tfrecords"), payloads)
    assert (tmp_path / "port.tfrecords").read_bytes() == (tmp_path / "jax.tfrecords").read_bytes()
    for p in payloads[:2]:
        port, ref = ttf.parse_example(p), jtf.parse_example(p)
        assert sorted(port) == sorted(ref)
        for k in ref:
            np.testing.assert_array_equal(np.asarray(port[k], dtype=object),
                                          np.asarray(ref[k], dtype=object))


@pytest.mark.parametrize("stored,res,shards", [(16, 16, 1), (32, 16, 2)])
def test_stylegan_convention(tmp_path, stored, res, shards):
    imgs = chw_images(6, 3, stored, stored, seed=stored)
    per = len(imgs) // shards
    for s in range(shards):
        ttf.write_tfrecord(str(tmp_path / f"shard-{s}.tfrecords"),
                           [ttf.encode_example(im, label=i % 3)
                            for i, im in enumerate(imgs[s * per:(s + 1) * per])])
    path = str(tmp_path) if shards > 1 else str(tmp_path / "shard-0.tfrecords")
    port, ref = ttf.TFRecordImages(path, res), jtf.TFRecordImages(path, res)
    assert_same_examples(port, ref, 6)
    assert isinstance(tds.make_dataset(DataConfig(dataset="tfrecord", path=path,
                                                  resolution=res)), ttf.TFRecordImages)


def test_tfslim_convention(tmp_path):
    img = chw_images(1, 3, 16, 16, seed=2)[0].transpose(1, 2, 0)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    f = ttf._field
    entries = [
        f(1, 2, f(1, 2, b"image/encoded") + f(2, 2, f(1, 2, f(1, 2, buf.getvalue())))),
        f(1, 2, f(1, 2, b"image/class/label") + f(2, 2, f(3, 2, f(1, 2, ttf._varint(7))))),
    ]
    path = str(tmp_path / "slim.tfrecords")
    ttf.write_tfrecord(path, [f(1, 2, b"".join(entries))])
    port = ttf.TFRecordImages(path, 16)
    assert_same_examples(port, jtf.TFRecordImages(path, 16), 1)
    np.testing.assert_array_equal(port.example(0)[0], img)
    assert port.example(0)[1] == 7


def test_tfrecord_errors_alike(tmp_path):
    path = str(tmp_path / "t.tfrecords")
    ttf.write_tfrecord(path, [ttf.encode_example(im) for im in chw_images(2, 3, 8, 8)])
    data = open(path, "rb").read()
    open(path, "wb").write(data[:-10])  # chop the tail record
    raises_alike(ValueError, lambda: ttf.TFRecordImages(path, 8),
                 lambda: jtf.TFRecordImages(path, 8))
    odd = str(tmp_path / "odd.tfrecords")
    f = ttf._field
    ttf.write_tfrecord(odd, [f(1, 2, f(1, 2, f(1, 2, b"other") + f(2, 2, f(3, 2, b""))))])
    raises_alike(ValueError, lambda: ttf.TFRecordImages(odd, 8).example(0),
                 lambda: jtf.TFRecordImages(odd, 8).example(0))
    raises_alike(FileNotFoundError, lambda: ttf.TFRecordImages(str(tmp_path / "none"), 8),
                 lambda: jtf.TFRecordImages(str(tmp_path / "none"), 8))


# ---------------------------------------------------------------------------
# LMDB and the LSUN export
# ---------------------------------------------------------------------------


def records(n, seed=0, vmax=40):
    rng = np.random.default_rng(seed)
    recs = {}
    for _ in range(n):
        k = bytes(rng.integers(0, 256, rng.integers(4, 24), dtype=np.uint8))
        recs[k] = bytes(rng.integers(0, 256, rng.integers(4, vmax), dtype=np.uint8))
    return sorted(recs.items())


def webp_records(n, hw, seed):
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 256, (hw, hw, 3), dtype=np.uint8)).save(
            buf, "WEBP", lossless=True)
        recs.append((f"{seed}img{i:03d}".encode(), buf.getvalue()))
    return sorted(recs)


@pytest.mark.parametrize("psize,n,vmax", [(512, 400, 40), (4096, 300, 6000)])
def test_lmdb_reader(tmp_path, psize, n, vmax):
    recs = records(n, seed=psize, vmax=vmax)
    write_lmdb(str(tmp_path / "env"), recs, psize=psize)
    with tlm.LmdbReader(str(tmp_path / "env")) as port, \
            jlm.LmdbReader(str(tmp_path / "env")) as ref:
        assert (port.psize, port.depth, len(port)) == (ref.psize, ref.depth, len(ref))
        assert list(port.items()) == list(ref.items()) == recs
        for i in np.random.default_rng(1).permutation(len(recs))[:80]:
            assert port[int(i)] == ref[int(i)]
            assert port.get(recs[int(i)][0]) == recs[int(i)][1]
        assert port.get(b"\xff" * 64) is None
        with pytest.raises(IndexError):
            port[len(recs)]


def test_lmdb_errors_alike(tmp_path):
    junk = tmp_path / "junk.mdb"
    junk.write_bytes(b"\x00" * 8192)
    assert issubclass(tlm.LmdbError, RuntimeError)
    raises_alike(RuntimeError, lambda: tlm.LmdbReader(str(junk)),
                 lambda: jlm.LmdbReader(str(junk)))
    raises_alike(Exception, lambda: tlm.LmdbReader(str(tmp_path)),
                 lambda: jlm.LmdbReader(str(tmp_path)))


@pytest.mark.parametrize("layout", ["single", "categories"])
def test_lmdb_images(tmp_path, layout):
    if layout == "single":
        write_lmdb(str(tmp_path / "env"), webp_records(6, 16, seed=0), psize=4096)
        path, n = str(tmp_path / "env"), 6
    else:
        for ci, cat in enumerate(["aaa_train_lmdb", "bbb_train_lmdb"]):
            write_lmdb(str(tmp_path / cat), webp_records(4, 24, seed=ci), psize=4096)
        path, n = str(tmp_path), 8
    port, ref = tlm.LmdbImages(path, 16), jlm.LmdbImages(path, 16)
    assert port.num_classes == ref.num_classes == (0 if layout == "single" else 2)
    np.testing.assert_array_equal(port.labels, ref.labels)
    assert_same_examples(port, ref, n)
    assert isinstance(tds.make_dataset(DataConfig(dataset="lsun", path=path, resolution=16)),
                      tlm.LmdbImages)
    port.close()
    ref.close()


def test_lsun_export_and_command(tmp_path, capsys):
    recs = webp_records(5, 8, seed=9)
    write_lmdb(str(tmp_path / "env"), recs, psize=4096)
    assert tlsun.lsun_to_folder(str(tmp_path / "env"), str(tmp_path / "port")) == \
        jlsun.lsun_to_folder(str(tmp_path / "env"), str(tmp_path / "jax")) == 5
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    assert all((tmp_path / "port" / n).read_bytes() == (tmp_path / "jax" / n).read_bytes()
               for n in names)
    for data in (recs[0][1], b"\xff\xd8\xff..", b"\x89PNG\r\n\x1a\n..", b"RIFF0000WAVE", b"x"):
        assert tlsun.sniff_extension(data) == jlsun.sniff_extension(data)
    fake = [(b"\x01\xffhashkey", recs[0][1]), (b"plainkey", recs[1][1])]
    assert tlsun.lsun_to_folder("unused", str(tmp_path / "fake"), _iter=lambda p: iter(fake)) == 2
    assert sorted(os.listdir(tmp_path / "fake")) == ["01ff686173686b6579.webp", "plainkey.webp"]
    assert cli.main(["lsun-export", str(tmp_path / "env"), str(tmp_path / "cli"),
                     "--limit", "3"]) == 0
    assert "exported 3 LSUN records" in capsys.readouterr().out
    assert len(os.listdir(tmp_path / "cli")) == 3
    assert cli.main(["lsun-export"]) == 1


# ---------------------------------------------------------------------------
# grain
# ---------------------------------------------------------------------------


def test_grain_adapters():
    grain = pytest.importorskip("grain")
    from locate_tpu.data import grain_adapter as jga
    from locate_tpu_torch.data import grain_adapter as tga

    ds = tds.SyntheticImages(16, 3, length=24, num_classes=4)
    port, ref = tga.AsGrainSource(ds), jga.AsGrainSource(jds.SyntheticImages(
        16, 3, length=24, num_classes=4))
    assert len(port) == len(ref) == 24
    for i in (0, 7, 23):
        np.testing.assert_array_equal(port[i]["image"], ref[i]["image"])
        assert port[i]["label"] == ref[i]["label"] and port[i]["label"].dtype == np.int32
    md = grain.MapDataset.source(port).shuffle(seed=0).batch(8)
    seen = {img.tobytes() for i in range(3) for img in md[i]["image"]}
    assert seen == {ds.example(i)[0].tobytes() for i in range(24)}
    items = [{"image": np.zeros((8, 8, 3), np.uint8), "label": 3},
             (np.ones((8, 8, 3), np.uint8), 1), np.full((8, 8, 3), 2, np.uint8)]
    port_ds, ref_ds = tga.GrainDataset(items, 8), jga.GrainDataset(items, 8)
    assert_same_examples(port_ds, ref_ds, 3)
    for bad in ([np.zeros((8, 8, 3), np.float32)], [np.zeros((4, 4, 3), np.uint8)]):
        raises_alike(Exception, lambda: tga.GrainDataset(bad, 8).example(0),
                     lambda: jga.GrainDataset(bad, 8).example(0))


# ---------------------------------------------------------------------------
# standing alone
# ---------------------------------------------------------------------------


def test_the_data_package_imports_no_jax():
    """Every counterpart of `locate_tpu/data/` exists, the C++ source is the
    port's own copy, and importing the nine modules loads no JAX and no
    JAX package (import graph, in a fresh interpreter; and by grep)."""
    jax_modules = sorted(n[:-3] for n in os.listdir(os.path.join(REPO, "locate_tpu", "data"))
                         if n.endswith(".py"))
    assert set(jax_modules) == set(DATA_MODULES) | {"__init__"}
    base = os.path.join(REPO, "locate_tpu_torch", "data")
    assert os.path.isfile(os.path.join(base, "_native", "loader.cc"))
    names = ["locate_tpu_torch.data"] + [f"locate_tpu_torch.data.{m}" for m in DATA_MODULES]
    code = ("import importlib, sys\n"
            f"for name in {names!r}:\n"
            "    importlib.import_module(name)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'locate_tpu'))\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    pattern = re.compile(r"^\s*(from|import)\s+(jax|locate_tpu)\b(?!_torch)", re.M)
    for m in DATA_MODULES:
        with open(os.path.join(base, f"{m}.py")) as fh:
            assert not pattern.search(fh.read()), m
