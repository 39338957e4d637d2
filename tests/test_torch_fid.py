"""`locate_tpu_torch/io/fid.py` against the JAX package's `locate_tpu/io/fid.py`
on the CPU in f32: the random-conv extractor's features (JAX's weight
draws and SAME padding, at an even and an odd size) within rtol 1e-4,
atol 1e-5; the legacy `.npz` conv stack; the numpy metrics equal on the
same features; and `evaluate_generator` of one JAX init carried across
(tiny_config, width 8, 256 samples): rFID, KID, PRDC and IS within 1e-3
relative. At 16x16 the last stage is 1x1, so its 32 std features are 0
in both packages and the covariances are singular there: both take
scipy's same regularized path."""

import dataclasses

import numpy as np
import jax
import pytest
import torch

from locate_tpu.data.datasets import SyntheticImages as JaxSyntheticImages
from locate_tpu.data.datasets import make_dataset as jax_make_dataset
from locate_tpu.io import fid as jfid
from locate_tpu.models.gan import build_gan as jax_build_gan
from locate_tpu_torch.data.datasets import SyntheticImages, make_dataset
from locate_tpu_torch.io import fid
from locate_tpu_torch.models.generator import build_generator
from torch_port_parity import as_state_dict, port_config, randomize_zero_init
from torch_threads import few_threads

N_SAMPLES = 256
CLASSES = 5


@pytest.fixture(autouse=True)
def two_threads():
    with few_threads(2):
        yield


def rel(got, want):
    return abs(got - want) / max(abs(want), 1e-12)


class WithHead:
    """An extractor with a classifier head `.fc` (the Inception Score's
    contract) over random-conv features."""

    def __init__(self, inner, dim):
        rng = np.random.default_rng(11)
        self.inner = inner
        self.cache_token = inner.cache_token
        self.fc = (rng.normal(size=(dim, CLASSES)).astype(np.float32) / 4,
                   rng.normal(size=CLASSES).astype(np.float32))

    def __call__(self, images):
        return self.inner(images)


def carried(cfg, **model):
    """(JAX gan, its generator params, the port generator holding them)."""
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **model))
    jgan = jax_build_gan(cfg)
    params = randomize_zero_init(jgan.generator.init(jax.random.PRNGKey(0)),
                                 jax.random.PRNGKey(5))
    gen = build_generator(port_config(cfg).model, "float32", device="cpu").eval()
    gen.load_state_dict({k: torch.from_numpy(v) for k, v in as_state_dict(params).items()})
    return cfg, jgan, params, gen


@pytest.fixture(scope="module")
def models(tiny_config):
    """One JAX init carried across, shared by the tests that generate (the
    JAX generator compiles once at batch 64)."""
    return carried(tiny_config)


@pytest.fixture(scope="module")
def evaluated(models):
    """Both packages' evaluate_generator on the same weights, dataset and
    extractor: (port result, JAX result, port `out`, JAX `out`, seconds)."""
    cfg, jgan, params, gen = models
    dim = 16 * 8
    res, outs, seconds = [], [], {}
    for ev, ex, ds, model in (
            (fid.evaluate_generator, fid.RandomConvFeatures(width=8, device="cpu"),
             make_dataset(port_config(cfg).data), gen),
            (lambda *a, **k: jfid.evaluate_generator(jgan, *a, **k),
             jfid.RandomConvFeatures(width=8), jax_make_dataset(cfg.data), params)):
        out = {}
        kw = dict(seconds=seconds) if ev is fid.evaluate_generator else {}
        res.append(ev(model, ds, n_samples=N_SAMPLES, extractor=WithHead(ex, dim), prdc_k=3,
                      is_splits=4, out=out, seed=2, **kw))
        outs.append(out)
    return res[0], res[1], outs[0], outs[1], seconds


def test_evaluate_generator_matches_jax(evaluated):
    got, want, _, _, _ = evaluated
    assert set(got) == set(want)
    assert got["n_fake"] == got["n_real"] == want["n_fake"] == N_SAMPLES
    for k in ("fid", "kid", "is_mean", "is_std", "precision", "recall", "density",
              "coverage"):
        assert np.isfinite(got[k]) and rel(got[k], want[k]) < 1e-3, (k, got[k], want[k])
    assert got["fid"] > 0


def test_evaluate_generator_out_and_seconds(evaluated):
    _, _, got, want, seconds = evaluated
    assert set(got) == set(want)
    np.testing.assert_allclose(got["real_features"], want["real_features"], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got["fake_features"], want["fake_features"], rtol=1e-3,
                               atol=1e-3)
    assert set(seconds) == {"generate", "features", "data", "metrics"}
    assert all(v >= 0 for v in seconds.values())


@pytest.mark.parametrize("hw", [(32, 32), (33, 17)])
def test_random_conv_features_match_jax(hw):
    """Both SAME paddings: (0, 1) on an even size, (1, 1) on an odd one;
    population std; 16 * width features."""
    imgs = np.random.default_rng(0).integers(0, 256, (5, *hw, 3), np.uint8)
    ex = fid.RandomConvFeatures(seed=3, width=8, device="cpu")
    got = ex(imgs)
    want = jfid.RandomConvFeatures(seed=3, width=8)(imgs)
    assert got.shape == want.shape == (5, 128) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert ex.cache_token == "random_conv:3:8"
    # a tensor batch gives the same features
    np.testing.assert_array_equal(ex(torch.from_numpy(imgs)), got)


def test_same_padding():
    assert fid.same_padding(32) == (0, 1) and fid.same_padding(33) == (1, 1)
    assert fid.same_padding(1) == (1, 1) and fid.same_padding(2) == (0, 1)


def test_gray_default_weights_match_jax():
    """One input channel and the default width: JAX's weight draws at
    3x3x1x64 up to 3x3x256x256."""
    imgs = np.random.default_rng(1).integers(0, 256, (2, 16, 16, 1), np.uint8)
    got = fid.RandomConvFeatures(device="cpu")(imgs)
    np.testing.assert_allclose(got, jfid.RandomConvFeatures()(imgs), rtol=1e-4, atol=1e-5)


def test_legacy_npz_stack_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    path = str(tmp_path / "stack.npz")
    np.savez(path, w0=rng.normal(size=(3, 3, 3, 8)).astype(np.float32) * 0.3,
             w1=rng.normal(size=(3, 3, 8, 12)).astype(np.float32) * 0.2)
    imgs = rng.integers(0, 256, (3, 15, 15, 3), np.uint8)
    ex = fid.NpzFeatureExtractor(path, device="cpu")
    assert ex.cache_token == f"npz:{path}" and not hasattr(ex, "fc")
    np.testing.assert_allclose(ex(imgs), jfid.NpzFeatureExtractor(path)(imgs), rtol=1e-4,
                               atol=1e-5)


def test_numpy_metrics_equal_jax(tmp_path):
    rng = np.random.default_rng(3)
    a = rng.normal(size=(300, 12))
    b = rng.normal(loc=0.3, size=(280, 12)) * 1.1
    sa, ja = fid.feature_stats(a), jfid.feature_stats(a)
    sb = fid.feature_stats(b)
    np.testing.assert_array_equal(sa[0], ja[0])
    np.testing.assert_array_equal(sa[1], ja[1])
    assert fid.frechet_distance(*sa, *sb) == jfid.frechet_distance(*sa, *sb)
    assert fid.kid(a, b, subset_size=100, seed=4) == jfid.kid(a, b, subset_size=100, seed=4)
    assert fid.prdc(a, b, k=4) == jfid.prdc(a, b, k=4)
    logits = rng.normal(size=(40, 7)) * 3
    assert fid.inception_score(logits, 4) == jfid.inception_score(logits, 4)
    np.testing.assert_array_equal(fid._knn_radius(a, 3), jfid._knn_radius(a, 3))
    # the stats files pass both ways
    fid.save_stats(str(tmp_path / "p.npz"), *sa, n=np.int64(300))
    for got, want in zip(jfid.load_stats(str(tmp_path / "p.npz")), sa):
        np.testing.assert_array_equal(got, want)
    jfid.save_stats(str(tmp_path / "j.npz"), *sb)
    for got, want in zip(fid.load_stats(str(tmp_path / "j.npz")), sb):
        np.testing.assert_array_equal(got, want)
    np.savez(str(tmp_path / "bad.npz"), mu=sa[0])
    with pytest.raises(ValueError, match="not a stats archive"):
        fid.load_stats(str(tmp_path / "bad.npz"))
    with pytest.raises(ValueError, match="KID needs >= 2"):
        fid.kid(a[:1], b)
    with pytest.raises(ValueError, match="prdc needs > k=4"):
        fid.prdc(a[:4], b, k=4)


def test_features_in_batches_and_the_cache(tiny_config):
    """The real side is extracted once for a cache key: a second call
    reads it back; another seed is another key."""
    cfg, _, _, gen = carried(tiny_config)
    calls = []
    inner = fid.RandomConvFeatures(width=8, device="cpu")

    def ex(images):
        calls.append(len(images))
        return inner(images)

    ex.cache_token = inner.cache_token
    ds = SyntheticImages(16, 3, length=64)
    cache = {}
    a = fid.evaluate_generator(gen, ds, n_samples=16, batch=8, extractor=ex, cache=cache)
    assert calls == [8, 8, 8, 8]
    b = fid.evaluate_generator(gen, ds, n_samples=16, batch=8, extractor=ex, cache=cache)
    assert calls == [8] * 6 and a == b and len(cache) == 1
    fid.evaluate_generator(gen, ds, n_samples=16, batch=8, extractor=ex, cache=cache, seed=1)
    assert len(cache) == 2
    imgs = np.stack([ds.example(i)[0] for i in range(10)])
    np.testing.assert_allclose(fid.features_in_batches(imgs, inner, 3), inner(imgs),
                               rtol=1e-5, atol=1e-5)


def test_per_class_and_ref_stats_match_jax(tiny_config):
    """`label` holds both sides to one class (conditional fakes, the
    dataset's examples of the class); ref_stats mode has no KID and keeps
    IS; the JAX function's errors."""
    cfg, jgan, params, gen = carried(tiny_config, num_classes=2, class_embed_dim=4)
    ds = SyntheticImages(16, 3, length=64, num_classes=2)
    jds = JaxSyntheticImages(16, 3, length=64, num_classes=2)
    ex, jex = (fid.RandomConvFeatures(width=8, device="cpu"), jfid.RandomConvFeatures(width=8))
    got = fid.evaluate_generator(gen, ds, n_samples=12, batch=8, extractor=ex, label=1)
    want = jfid.evaluate_generator(jgan, params, jds, n_samples=12, batch=8, extractor=jex,
                                   label=1)
    assert got["n_real"] == want["n_real"] == 12
    assert rel(got["fid"], want["fid"]) < 1e-3 and rel(got["kid"], want["kid"]) < 1e-3

    head = WithHead(ex, 128)
    mu, sigma = np.zeros(128), np.eye(128)
    got = fid.evaluate_generator(gen, None, n_samples=12, batch=8, extractor=head,
                                 ref_stats=(mu, sigma), is_splits=3)
    jhead = WithHead(jex, 128)
    want = jfid.evaluate_generator(jgan, params, None, n_samples=12, batch=8, extractor=jhead,
                                   ref_stats=(mu, sigma), is_splits=3)
    assert got.keys() == want.keys() and got["kid"] is None and got["n_real"] is None
    assert got["real_side"] == "ref_stats"
    for k in ("fid", "is_mean"):
        assert rel(got[k], want[k]) < 1e-3, k

    with pytest.raises(ValueError, match="prdc needs per-sample real features"):
        fid.evaluate_generator(gen, None, n_samples=8, extractor=ex, ref_stats=(mu, sigma),
                               prdc_k=2)
    with pytest.raises(ValueError, match="needs a dataset or ref_stats"):
        fid.evaluate_generator(gen, None, n_samples=8, extractor=ex)
    with pytest.raises(ValueError, match="classifier head"):
        fid.evaluate_generator(gen, ds, n_samples=8, extractor=ex, is_splits=2)
    with pytest.raises(ValueError, match="no examples of class 1"):
        fid.evaluate_generator(gen, SyntheticImages(16, 3, length=64, num_classes=1),
                               n_samples=8, extractor=ex, label=1)

    class NoLabels:
        def __len__(self):
            return 4

    with pytest.raises(ValueError, match="needs a dataset with a .labels array"):
        fid.evaluate_generator(gen, NoLabels(), n_samples=8, extractor=ex, label=0)


def test_extractors_run_on_the_card_unless_asked():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            fid.RandomConvFeatures()
    assert fid.RandomConvFeatures(device="cpu").device.type == "cpu"


def test_swd_generator_matches_jax(models):
    """`io/swd.py:swd_generator`: fakes from JAX's latent keys, reals from
    the eval's draw, the JAX function's value on the same weights (the
    images' uint8 rounding may flip a pixel between the packages, hence
    1e-3)."""
    from locate_tpu.io import swd as jswd
    from locate_tpu_torch.io import swd

    _, jgan, params, gen = models
    kw = dict(n_samples=64, batch=64, patches_per_image=16, n_proj=32, repeats=1)
    got = swd.swd_generator(gen, SyntheticImages(16, length=64), **kw)
    want = jswd.swd_generator(jgan, params, JaxSyntheticImages(16, length=64), **kw)
    assert got.keys() == want.keys() == {"swd_16", "swd_avg"}
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-3 * abs(want[k]), (k, got[k], want[k])
    assert got["swd_avg"] > 0
