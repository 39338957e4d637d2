"""The port's datasets and packed shards (`locate_tpu_torch/data/datasets.py`,
`packed.py`) against the JAX package's on the same inputs: SyntheticImages
batches byte for byte (class palettes included), CIFAR-10 from local
batches and its synthetic fallback, image folders, the factory's
resolution guard, `pack_dataset`'s files byte for byte, packs read across
the two packages, `batch_fast` with flips on the native and the numpy path,
and the `pack` and `bench-input` commands."""

import json
import os
import pickle
import tarfile

import numpy as np
import pytest
from PIL import Image

from locate_tpu.config import DataConfig as JaxDataConfig
from locate_tpu.data import datasets as jds
from locate_tpu.data import packed as jpk
from locate_tpu_torch import cli
from locate_tpu_torch.config import DataConfig
from locate_tpu_torch.data import datasets as tds
from locate_tpu_torch.data import native
from locate_tpu_torch.data import packed as tpk


def assert_same_batch(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert a[0].dtype == b[0].dtype and np.asarray(a[1]).dtype == np.asarray(b[1]).dtype


@pytest.mark.parametrize("res,channels,classes,seed", [(16, 3, 0, 0), (16, 3, 4, 2),
                                                       (24, 1, 0, 5), (32, 3, 10, 1)])
def test_synthetic_images_byte_for_byte(res, channels, classes, seed):
    kw = dict(length=300, num_classes=classes, seed=seed)
    port, ref = tds.SyntheticImages(res, channels, **kw), jds.SyntheticImages(res, channels, **kw)
    idx = np.random.default_rng(seed).integers(0, 300, 40)
    flips = np.random.default_rng(seed + 1).random(40) < 0.5
    assert_same_batch(port.batch_fast(idx, flips), ref.batch_fast(idx, flips))
    assert_same_batch(port.example(7), ref.example(7))
    np.testing.assert_array_equal(port.labels, ref.labels)


def write_cifar(root, n=20):
    """Python-pickle CIFAR-10 batches of n images each, and the same as a
    tar.gz, as the dataset ships them."""
    base = root / "cifar-10-batches-py"
    base.mkdir()
    rng = np.random.default_rng(0)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        batch = {b"data": rng.integers(0, 256, (n, 3072), dtype=np.uint8),
                 b"labels": list(rng.integers(0, 10, n))}
        with open(base / name, "wb") as fh:
            pickle.dump(batch, fh)
    tar = root / "cifar-10-python.tar.gz"
    with tarfile.open(tar, "w:gz") as tf:
        tf.add(base, arcname="cifar-10-batches-py")
    return tar


@pytest.mark.parametrize("form", ["dir", "tar", "test_split"])
def test_cifar10_from_local_batches(tmp_path, form):
    tar = write_cifar(tmp_path)
    path, train = {"dir": (str(tmp_path), True), "tar": (str(tar), True),
                   "test_split": (str(tmp_path), False)}[form]
    port, ref = tds.Cifar10(path, train), jds.Cifar10(path, train)
    assert len(port) == len(ref) == (100 if train else 20)
    np.testing.assert_array_equal(port.images, ref.images)
    np.testing.assert_array_equal(port.labels, ref.labels)
    idx, flips = [3, 0, 17, 3], [True, False, True, False]
    assert_same_batch(port.batch_fast(idx, flips), ref.batch_fast(idx, flips))


def test_cifar10_falls_back_to_synthetic_offline():
    port = tds.make_dataset(DataConfig(dataset="cifar10", path="/nonexistent", resolution=32))
    ref = jds.make_dataset(JaxDataConfig(dataset="cifar10", path="/nonexistent",
                                         resolution=32))
    assert isinstance(port, tds.SyntheticImages) and port.num_classes == 10
    assert_same_batch(port.batch_fast([0, 5, 9], [False, True, False]),
                      ref.batch_fast([0, 5, 9], [False, True, False]))
    with pytest.raises(FileNotFoundError):
        tds.Cifar10("/nonexistent")


def write_folder(root, classes=("cat", "dog"), n=3, size=(30, 20)):
    for cls in classes or [""]:
        d = root / cls
        d.mkdir(parents=True, exist_ok=True)
        for i in range(n):
            arr = np.random.RandomState(i + 7 * len(cls)).randint(0, 255, (*size, 3), np.uint8)
            Image.fromarray(arr).save(d / f"{i}.png")
    return root


@pytest.mark.parametrize("classes", [("cat", "dog"), ()])
def test_image_folder_examples(tmp_path, classes):
    root = str(write_folder(tmp_path / "imgs", classes))
    port, ref = tds.ImageFolder(root, 16), jds.ImageFolder(root, 16)
    assert port.num_classes == ref.num_classes == len(classes)
    assert [os.path.relpath(f, root) for f in port.files] == \
        [os.path.relpath(f, root) for f in ref.files]
    assert port.labels == ref.labels
    for i in range(len(port)):
        assert_same_batch(port.example(i), ref.example(i))
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="no images"):
        tds.ImageFolder(str(tmp_path / "empty"), 16)


def test_make_dataset_kinds_and_packed_guard(tmp_path):
    out = tpk.pack_dataset(tds.SyntheticImages(16, 3, length=8), str(tmp_path / "p"))
    assert isinstance(tds.make_dataset(DataConfig(dataset="packed", path=out, resolution=16)),
                      tpk.PackedDataset)
    with pytest.raises(ValueError, match="re-pack") as port_err:
        tds.make_dataset(DataConfig(dataset="packed", path=out, resolution=32))
    with pytest.raises(ValueError) as ref_err:
        jds.make_dataset(JaxDataConfig(dataset="packed", path=out, resolution=32))
    assert str(port_err.value) == str(ref_err.value)
    with pytest.raises(ValueError, match="unknown dataset"):
        tds.make_dataset(DataConfig(dataset="imagenet"))
    folder = str(write_folder(tmp_path / "imgs"))
    assert isinstance(tds.make_dataset(DataConfig(dataset="folder", path=folder,
                                                  resolution=16)), tds.ImageFolder)


def files_of(path):
    return {name: open(os.path.join(path, name), "rb").read()
            for name in sorted(os.listdir(path))}


@pytest.mark.parametrize("shard_size,batch_size", [(10, 8), (4096, 64), (7, 3)])
def test_pack_dataset_writes_the_same_bytes(tmp_path, shard_size, batch_size):
    src = tds.SyntheticImages(16, 3, length=37, num_classes=4)
    port = tpk.pack_dataset(src, str(tmp_path / "port"), shard_size=shard_size,
                            batch_size=batch_size)
    ref = jpk.pack_dataset(jds.SyntheticImages(16, 3, length=37, num_classes=4),
                           str(tmp_path / "jax"), shard_size=shard_size, batch_size=batch_size)
    assert files_of(port) == files_of(ref)
    assert tpk.FORMAT == jpk.FORMAT
    with pytest.raises(FileExistsError):
        tpk.pack_dataset(src, port)


def test_packs_read_across_packages(tmp_path):
    src = tds.SyntheticImages(16, 3, length=25, num_classes=3)
    port_pack = tpk.pack_dataset(src, str(tmp_path / "port"), shard_size=7)
    jax_pack = jpk.pack_dataset(src, str(tmp_path / "jax"), shard_size=7)
    idx = [24, 0, 13, 7, 6, 14, 21]
    flips = [False, True, False, True, False, True, True]
    want = src.batch_fast(idx, flips)
    for reader in (tpk.PackedDataset(jax_pack), jpk.PackedDataset(port_pack)):
        assert (reader.count, reader.resolution, reader.channels, reader.num_classes) == \
            (25, 16, 3, 3)
        assert_same_batch(reader.batch_fast(idx, flips), want)
        assert_same_batch(reader.example(13), src.example(13))


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_packed_batch_fast_flips_on_both_paths(tmp_path, monkeypatch, path):
    """`batch_fast` with flips: the native in-place flip, or (with the
    library unavailable) the numpy reversed-W gather; both equal the JAX
    package's."""
    if path == "native" and not native.available():
        pytest.skip("the native loader did not build here")
    if path == "numpy":
        monkeypatch.setattr(native, "available", lambda: False)
    src = tds.SyntheticImages(16, 3, length=30)
    pack = tpk.pack_dataset(src, str(tmp_path / "p"), shard_size=8)
    idx = np.random.default_rng(3).integers(0, 30, 24)
    flips = np.random.default_rng(4).random(24) < 0.5
    port = tpk.PackedDataset(pack).batch_fast(idx, flips)
    assert_same_batch(port, jpk.PackedDataset(pack).batch_fast(idx, flips))
    assert_same_batch(port, src.batch_fast(idx, flips))


def test_pack_from_image_folder_same_bytes(tmp_path):
    root = str(write_folder(tmp_path / "imgs", n=4))
    port = tpk.pack_dataset(tds.ImageFolder(root, 16), str(tmp_path / "port"), shard_size=3)
    ref = jpk.pack_dataset(jds.ImageFolder(root, 16), str(tmp_path / "jax"), shard_size=3)
    assert files_of(port) == files_of(ref)


def test_partial_pack_is_not_a_dataset(tmp_path):
    d = tmp_path / "p"
    d.mkdir()
    (d / "shard_00000.u8").write_bytes(b"\0" * 64)
    with pytest.raises(FileNotFoundError, match="meta.json"):
        tpk.PackedDataset(str(d))


def test_pack_and_bench_input_commands(tmp_path, capsys):
    out = str(tmp_path / "packed")
    args = ["cifar10_32", "data.dataset=synthetic", "data.resolution=16"]
    assert cli.main(["pack", *args, f"--out={out}", "--shard-size=1000"]) == 0
    assert f"to {out}" in capsys.readouterr().out
    packed = jpk.PackedDataset(out)
    assert (len(packed), packed.resolution, packed.shard_size) == (50_000, 16, 1000)
    assert_same_batch(packed.example(43_210), jds.SyntheticImages(16, 3).example(43_210))
    assert cli.main(["bench-input", "cifar10_32", "data.dataset=packed", f"data.path={out}",
                     "data.resolution=16", "--batches=3"]) == 0
    d = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert d["unit"] == "images/sec" and d["value"] > 0 and "packed, 16px" in d["metric"]
