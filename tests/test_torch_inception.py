"""`locate_tpu_torch/io/inception.py` against the JAX package's
`locate_tpu/io/inception.py` on the CPU in f32, from one random archive
(`random_archive`, the converter's format): the pool3 graph in both
variants at 75x75 (the smallest input every stride survives) within rtol
2e-3, atol 2e-4; `preprocess` 32x32 -> 299x299 within 1e-5; the
extractor's whole protocol, its `.npz` dispatch and grayscale; the
classifier head's logits; the archive's format check; and the
PyTorch twin's folded weights (`tests/torch_inception.py`)."""

import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from locate_tpu.io import inception as jinc
from locate_tpu.io.fid import NpzFeatureExtractor as JaxNpzFeatureExtractor
from locate_tpu_torch.io import inception as inc
from locate_tpu_torch.io.fid import NpzFeatureExtractor
from torch_threads import few_threads

sys.path.insert(0, "scripts")
SIZE = 75


@pytest.fixture(autouse=True)
def two_threads():
    with few_threads(2):
        yield


@pytest.fixture(scope="module")
def archives(tmp_path_factory):
    root = tmp_path_factory.mktemp("inception")
    return {v: inc.random_archive(str(root / f"{v}.npz"), seed=3, variant=v, fc_classes=10)
            for v in ("torchvision", "fid")}


@pytest.mark.parametrize("variant", ["torchvision", "fid"])
def test_pool3_matches_jax(archives, variant):
    net, mean, std, got_variant, fc = inc.load_npz(archives[variant], "cpu")
    params, jmean, jstd, jvariant = jinc.load_npz(archives[variant])
    assert got_variant == jvariant == variant and net.variant == variant
    np.testing.assert_array_equal(mean, jmean)
    x = np.random.default_rng(0).normal(size=(2, SIZE, SIZE, 3)).astype(np.float32)
    with torch.no_grad():
        got = net(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
    want = np.asarray(jinc.pool3_features(params, jnp.asarray(x), variant))
    assert got.shape == (2, 2048)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4)
    # the head's logits
    np.testing.assert_allclose(inc.logits_from_pool3(fc, got).numpy(),
                               np.asarray(jinc.logits_from_pool3(params["fc"], got)),
                               rtol=1e-5, atol=1e-5)


def test_variants_pool_differently(archives):
    net, *_ = inc.load_npz(archives["fid"], "cpu")
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(1, 3, SIZE, SIZE))
                         .astype(np.float32))
    with torch.no_grad():
        a = inc.pool3_features(net, x, "torchvision")
        b = inc.pool3_features(net, x, "fid")
    assert not torch.allclose(a, b)
    with pytest.raises(ValueError, match="unknown inception variant"):
        inc.pool3_features(net, x, "keras")


def test_preprocess_matches_jax():
    u8 = np.random.default_rng(1).integers(0, 256, (3, 32, 32, 3), np.uint8)
    mean = np.asarray([0.485, 0.456, 0.406], np.float32)
    std = np.asarray([0.229, 0.224, 0.225], np.float32)
    got = inc.preprocess(u8, mean, std).numpy()
    want = np.asarray(jinc.preprocess(jnp.asarray(u8), mean, std)).transpose(0, 3, 1, 2)
    assert got.shape == (3, 3, 299, 299)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_extractor_matches_jax_through_the_whole_protocol(archives):
    """uint8 32x32 -> resize -> normalize -> pool3 through the `.npz`
    dispatch of both packages' NpzFeatureExtractor; gray is repeated to
    RGB; the head is `.fc`."""
    path = archives["fid"]
    ex = NpzFeatureExtractor(path, device="cpu")
    jex = JaxNpzFeatureExtractor(path)
    assert ex.cache_token == jex.cache_token == f"inception_v3:{path}"
    u8 = np.random.default_rng(2).integers(0, 256, (2, 32, 32, 3), np.uint8)
    got = ex(u8)
    assert got.shape == (2, 2048) and got.dtype == np.float32
    np.testing.assert_allclose(got, jex(u8), rtol=2e-3, atol=2e-4)
    for a, b in zip(ex.fc, jex.fc):
        np.testing.assert_array_equal(a, b)
    gray = u8[..., :1]
    np.testing.assert_array_equal(ex(gray), ex(np.repeat(gray, 3, axis=-1)))


def test_archive_format_is_checked(tmp_path):
    path = str(tmp_path / "bad.npz")
    np.savez(path, format=np.asarray("mystery/v9"), w0=np.zeros((3, 3, 3, 8)))
    with pytest.raises(ValueError, match="mystery"):
        NpzFeatureExtractor(path, device="cpu")
    np.savez(path, w0=np.zeros((3, 3, 3, 8)))
    with pytest.raises(ValueError, match="is not a locate-tpu-inception-v3/v1 archive"):
        inc.load_npz(path, "cpu")


def test_the_twins_folded_weights_load():
    """The converter's BN folding of the torchvision-named twin, read by
    the port's graph, gives the twin's pool3."""
    from convert_inception import fold_state_dict
    from torch_inception import random_twin

    twin = random_twin("fid", seed=7)
    folded = fold_state_dict(twin.state_dict(), "fid")
    net = inc.InceptionV3("fid")
    net.load_state_dict({
        k: torch.from_numpy(np.ascontiguousarray(
            folded[f"{p}.w"].transpose(3, 2, 0, 1) if k.endswith("weight") else folded[f"{p}.b"]))
        for p, *_ in inc.conv_specs() for k in (f"{p}.weight", f"{p}.bias")})
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 3, SIZE, SIZE))
                         .astype(np.float32))
    with torch.no_grad():
        np.testing.assert_allclose(net(x).numpy(), twin(x).numpy(), rtol=2e-3, atol=2e-4)
