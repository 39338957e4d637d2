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
