"""`locate_tpu_torch/utils/jax_random.py` against `jax.random`: keys,
fold-ins, bits and uniforms bit for bit; normals within 1 f32 ulp (and
bit for bit) at the shapes the port draws (the style family's const
noise planes up to 128^2, spectral norm's start vectors), and within 2
ulps at a million draws, where XLA CPU's f32 log rounds a few inputs
apart from the port's copy of it."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from locate_tpu_torch.utils import jax_random as jr

CASES = [(0, None, (9,)), (0, None, (512,)), (0x4E4F4953, 0, (4, 4, 1)),
         (0x4E4F4953, 3, (16, 16, 1)), (0x4E4F4953, 14, (64, 64, 1)),
         (0x4E4F4953, 20, (128, 128, 1)), (7, 12345, (7, 3)), (2**32 - 1, 2**31, (33,))]


def keys(seed, fold):
    k, kk = jax.random.PRNGKey(seed), jr.prng_key(seed)
    if fold is not None:
        k, kk = jax.random.fold_in(k, fold), jr.fold_in(kk, fold)
    return k, kk


@pytest.mark.parametrize("seed,fold,shape", CASES)
def test_draws_match_jax(seed, fold, shape):
    k, kk = keys(seed, fold)
    np.testing.assert_array_equal(np.asarray(jax.random.key_data(k)), kk)
    np.testing.assert_array_equal(np.asarray(jax.random.bits(k, shape, jnp.uint32)),
                                  jr.random_bits(kk, shape))
    np.testing.assert_array_equal(np.asarray(jax.random.uniform(k, shape)),
                                  jr.uniform(kk, shape))
    want = np.asarray(jax.random.normal(k, shape, jnp.float32))
    got = jr.normal(kk, shape)
    assert got.dtype == np.float32 and got.shape == shape
    assert (np.abs(got - want) <= np.spacing(np.abs(want))).all()
    np.testing.assert_array_equal(got, want)


def test_a_million_normals():
    k, kk = keys(0, 5)
    want = np.asarray(jax.random.normal(k, (1_000_000,), jnp.float32))
    got = jr.normal(kk, (1_000_000,))
    ulps = np.abs(got - want) / np.spacing(np.abs(want))
    assert ulps.max() <= 2 and (ulps == 0).mean() > 0.9999


@pytest.mark.parametrize("seed,num", [(0, 2), (0, 4), (7, 5), (2**32 - 1, 3)])
def test_split_matches_jax(seed, num):
    """`split` (the eval's extractor weights take split(PRNGKey(seed), 4))
    bit for bit."""
    k, kk = keys(seed, None)
    np.testing.assert_array_equal(np.asarray(jax.random.key_data(jax.random.split(k, num))),
                                  jr.split(kk, num))


@pytest.mark.parametrize("h", [16, 17, 32, 64, 128])
def test_randint_matches_jax_at_the_swd_shapes(h):
    """`randint` as SWD draws its patch rows and columns: maxval h - 6,
    up to 1024 images of 128 patches, from the two keys of a level's
    k_patch; and bounds that cross int32's range or meet."""
    k_patch, kk_patch = keys(3, h)
    for sub, ssub in zip(jax.random.split(k_patch), jr.split(kk_patch)):
        for shape in ((1024, 128), (3, 128)):
            want = np.asarray(jax.random.randint(sub, shape, 0, h - 6))
            got = jr.randint(ssub, shape, 0, h - 6)
            assert got.dtype == want.dtype == np.int32
            np.testing.assert_array_equal(got, want)
    for lo, hi in ((5, 5), (5, 3), (-10, 1000), (-2**31, 2**31 - 1)):
        np.testing.assert_array_equal(np.asarray(jax.random.randint(k_patch, (64,), lo, hi)),
                                      jr.randint(kk_patch, (64,), lo, hi))
