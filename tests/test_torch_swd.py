"""`locate_tpu_torch/io/swd.py` against the JAX package's `locate_tpu/io/swd.py`
on the CPU in f32: the pyramid, the patch gather (JAX's `randint`
positions, bitwise), the estimate with fixed directions, every level of
`swd` within 1e-4 relative with JAX's own draws, and swd(x, x) == 0
exactly (`swd_generator` is held in tests/test_torch_fid.py, beside the
generator it shares)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from locate_tpu.io import swd as jswd
from locate_tpu_torch.io import swd
from locate_tpu_torch.utils import jax_random as jr
from torch_threads import few_threads

KW = dict(patches_per_image=16, n_proj=64, repeats=2, seed=3)


@pytest.fixture(autouse=True)
def two_threads():
    with few_threads(2):
        yield


def images(shape, seed, stripe=False):
    x = np.random.default_rng(seed).integers(0, 256, shape, np.uint8)
    if stripe:
        x[:, ::3] = 0
    return x


def test_pyramid_matches_jax_and_reconstructs():
    x = np.random.default_rng(0).normal(size=(2, 32, 32, 3)).astype(np.float32)
    got = swd.laplacian_pyramid(torch.from_numpy(x), 3)
    want = jswd.laplacian_pyramid(jnp.asarray(x), 3)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-4)
    recon = got[-1]
    for lvl in reversed(got[:-1]):
        recon = swd._pyr_up(recon) + lvl
    np.testing.assert_allclose(recon.numpy(), x, rtol=1e-5, atol=1e-5)


def test_patch_descriptors_gather_jax_positions():
    """The same patches, bit for bit, as JAX's vmapped dynamic_slice at its
    randint positions."""
    lvl = np.random.default_rng(4).normal(size=(3, 17, 16, 2)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    got = swd.patch_descriptors(torch.from_numpy(lvl), np.asarray(jax.random.key_data(key)),
                                patches_per_image=10)
    want = np.asarray(jswd.patch_descriptors(jnp.asarray(lvl), key, patches_per_image=10))
    assert tuple(got.shape) == want.shape == (30, 7, 7, 2)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sliced_wasserstein_with_fixed_and_drawn_directions():
    rng = np.random.default_rng(1)
    a = rng.normal(size=(64, 10)).astype(np.float32)
    b = rng.normal(size=(64, 10)).astype(np.float32) + 0.5
    dirs = rng.normal(size=(10, 7)).astype(np.float32)
    key = jax.random.PRNGKey(0)
    kk = jr.prng_key(0)
    got = swd.sliced_wasserstein(torch.from_numpy(a), torch.from_numpy(b), kk, dirs=dirs)
    d = dirs / np.linalg.norm(dirs, axis=0, keepdims=True)
    ref = np.mean(np.abs(np.sort(a @ d, axis=0) - np.sort(b @ d, axis=0)))
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    got = swd.sliced_wasserstein(torch.from_numpy(a), torch.from_numpy(b), kk, n_proj=32)
    want = float(jswd.sliced_wasserstein(jnp.asarray(a), jnp.asarray(b), key, n_proj=32))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    one = swd.sliced_wasserstein(torch.tensor([[0.0], [1.0], [2.0]]),
                                 torch.tensor([[4.0], [0.5], [1.5]]), kk, dirs=[[1.0]])
    np.testing.assert_allclose(one, 1.0, rtol=1e-6)
    with pytest.raises(ValueError, match="descriptor sets differ"):
        swd.sliced_wasserstein(torch.zeros(3, 2), torch.zeros(4, 2), kk)


@pytest.mark.parametrize("shape", [(8, 32, 32, 3), (6, 64, 64, 1)])
def test_every_level_matches_jax(shape):
    real, fake = images(shape, 0), images(shape, 1, stripe=True)
    got = swd.swd(real, fake, device="cpu", **KW)
    want = jswd.swd(real, fake, **KW)
    assert got.keys() == want.keys()
    assert len(got) == int(np.log2(shape[1] // 16)) + 2
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-4 * abs(want[k]), (k, got[k], want[k])
    # the same sets score zero exactly; a tensor input gives the same result
    same = swd.swd(real, real, device="cpu", **KW)
    assert all(v == 0.0 for v in same.values())
    assert swd.swd(torch.from_numpy(real), torch.from_numpy(fake), **KW) == got


def test_swd_errors():
    with pytest.raises(ValueError, match="image sets differ"):
        swd.swd(np.zeros((2, 16, 16, 3), np.uint8), np.zeros((3, 16, 16, 3), np.uint8),
                device="cpu")
    with pytest.raises(ValueError, match="below min_res=16"):
        swd.swd(np.zeros((2, 8, 8, 3), np.uint8), np.zeros((2, 8, 8, 3), np.uint8),
                device="cpu")

