"""The port's native loader (`locate_tpu_torch/data/native.py`, its own copy
of `_native/loader.cc`) against the JAX package's: the same C ABI (version
2), built into the port's own directory and never the JAX package's
library; decode, crop, resize and flip equal the JAX native's output on
PNG and JPEG files; the errors match; an ImageFolder batch equals the JAX
package's through both. Skips only where g++, libjpeg or libpng is
missing."""

import os
import shutil
import subprocess

import numpy as np
import pytest
from PIL import Image

from locate_tpu.data import datasets as jds
from locate_tpu.data import native as jnative
from locate_tpu_torch.data import datasets as tds
from locate_tpu_torch.data import native


def toolchain_missing():
    """Why the library cannot build here (no g++, or no libjpeg/libpng
    headers to compile against), else None."""
    if shutil.which("g++") is None:
        return "no g++"
    probe = subprocess.run(["g++", "-x", "c++", "-E", "-"], input=b"#include <cstdio>\n"
                           b"#include <jpeglib.h>\n#include <png.h>\n", capture_output=True)
    return "no libjpeg or libpng headers" if probe.returncode else None


pytestmark = pytest.mark.skipif(toolchain_missing() is not None,
                                reason=str(toolchain_missing()))


def test_builds_its_own_library_with_the_same_abi():
    assert native.available(), native.load_error()
    assert jnative.available()
    lib = native.get_lib()
    assert lib.ltpu_version() == 2
    assert os.path.dirname(lib._name) == native._BUILD_DIR
    assert native._BUILD_DIR.endswith(os.path.join(".build", "torch_loader"))
    assert os.path.realpath(lib._name) != os.path.realpath(jnative.get_lib()._name)
    assert native._SRC != jnative._SRC and native.load_error() is None
    with open(native._SRC) as port_src, open(jnative._SRC) as jax_src:
        body = port_src.read().split("#include <atomic>", 1)[1]
        assert body == jax_src.read().split("#include <atomic>", 1)[1]


def images(tmp_path):
    """PNG and JPEG files of several shapes: square, wide, tall, gray,
    small (upscaled) and large (JPEG DCT downscale)."""
    rs = np.random.RandomState(0)
    smooth = np.asarray(Image.fromarray(rs.randint(0, 255, (8, 8, 3), np.uint8))
                        .resize((256, 192), Image.BILINEAR))
    out = []
    for name, arr in (("sq.png", rs.randint(0, 255, (24, 24, 3), np.uint8)),
                      ("wide.png", rs.randint(0, 255, (40, 120, 3), np.uint8)),
                      ("tall.jpg", rs.randint(0, 255, (90, 30, 3), np.uint8)),
                      ("gray.png", rs.randint(0, 255, (20, 20), np.uint8)),
                      ("small.png", rs.randint(0, 255, (10, 14, 3), np.uint8)),
                      ("big.jpg", smooth)):
        path = str(tmp_path / name)
        Image.fromarray(arr).save(path, **({"quality": 90} if name.endswith("jpg") else {}))
        out.append(path)
    return out


@pytest.mark.parametrize("res", [16, 24, 64])
def test_decode_batch_equals_the_jax_native(tmp_path, res):
    paths = images(tmp_path)
    flips = [i % 2 == 1 for i in range(len(paths))]
    port = native.decode_batch(paths, res, flips)
    np.testing.assert_array_equal(port, jnative.decode_batch(paths, res, flips))
    assert port.shape == (len(paths), res, res, 3) and port.dtype == np.uint8
    np.testing.assert_array_equal(port[1], native.decode_batch(paths[1:2], res)[0][:, ::-1])


def test_png_at_its_own_size_is_exact(tmp_path):
    arr = np.random.RandomState(1).randint(0, 255, (24, 24, 3), np.uint8)
    Image.fromarray(arr).save(tmp_path / "a.png")
    np.testing.assert_array_equal(native.decode_batch([str(tmp_path / "a.png")], 24)[0], arr)


@pytest.mark.parametrize("res", [16, 32, 48])
def test_resize_and_flip_equal_the_jax_native(res):
    imgs = np.random.RandomState(2).randint(0, 255, (5, 32, 40, 3), np.uint8)
    flips = [True, False, True, True, False]
    np.testing.assert_array_equal(native.resize_batch(imgs, res, flips),
                                  jnative.resize_batch(imgs, res, flips))
    a, b = imgs[:, :, :32].copy(), imgs[:, :, :32].copy()
    assert native.hflip_inplace(a, flips) and jnative.hflip_inplace(b, flips)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a[0], imgs[0, :, :32][:, ::-1])


def test_a_corrupt_file_raises_as_the_jax_native(tmp_path):
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"\xff\xd8not a real jpeg")
    with pytest.raises(IOError) as port_err:
        native.decode_batch([str(bad)], 16)
    with pytest.raises(IOError) as ref_err:
        jnative.decode_batch([str(bad)], 16)
    assert str(port_err.value) == str(ref_err.value) and "bad.jpg" in str(port_err.value)


def test_image_folder_batch_fast_equals_the_jax_package(tmp_path):
    for cls in ("a", "b"):
        (tmp_path / cls).mkdir()
        for i in range(3):
            arr = np.random.RandomState(i + 5 * len(cls)).randint(0, 255, (20, 28, 3), np.uint8)
            Image.fromarray(arr).save(tmp_path / cls / f"{i}.png")
    port, ref = tds.ImageFolder(str(tmp_path), 16), jds.ImageFolder(str(tmp_path), 16)
    idx, flips = [5, 0, 3, 1], [True, False, False, True]
    p, r = port.batch_fast(idx, flips), ref.batch_fast(idx, flips)
    np.testing.assert_array_equal(p[0], r[0])
    np.testing.assert_array_equal(p[1], r[1])
    (tmp_path / "a" / "x.bmp").write_bytes(b"BM")  # not JPEG/PNG: no native path
    with pytest.raises(RuntimeError, match="native loader unavailable"):
        tds.ImageFolder(str(tmp_path), 16).batch_fast(idx, flips)
