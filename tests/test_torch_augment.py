"""The port's discriminator augmentation (`ops/augment.py`) against the JAX
package's `augment_pipeline`: the same parameters (drawn by the JAX
package's key splits, `torch_step_draws.aug_params`) give the same images
and the same input gradients, per category and all five together, f32 on
the CPU (1e-6; the affine warp 1e-5, its source points go through cos and
sin); the port's own draws have the parameters' shapes, dtypes and
ranges, p = 0 is the identity and p = 1 turns every op on."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from locate_tpu.ops.augment import affine_warp as jax_affine_warp
from locate_tpu.ops.augment import augment_pipeline
from locate_tpu_torch.ops import augment as aug
from torch_step_draws import aug_params

ALL = ("geom", "affine", "color", "noise", "cutout")


def images(shape, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


@pytest.mark.parametrize("ops", [("geom",), ("affine",), ("color",), ("noise",), ("cutout",),
                                 ALL, ("geom", "color", "cutout")],
                         ids=lambda o: "+".join(o))
@pytest.mark.parametrize("shape", [(6, 16, 16, 3), (5, 8, 12, 1)], ids=["square", "gray"])
def test_augment_matches_jax(ops, shape):
    x = images(shape)
    key = jax.random.PRNGKey(4)
    p = 0.6
    want, vjp = jax.vjp(lambda v: augment_pipeline(key, v, p, ops), jnp.asarray(x))
    params = {k: torch.from_numpy(np.array(v)) for k, v in
              aug_params(key, shape, p, ops).items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    got = aug.augment(xt, params, ops)
    tol = 1e-5 if "affine" in ops else 1e-6
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=tol, atol=tol)
    ct = images(shape, seed=1)
    (want_dx,) = vjp(jnp.asarray(ct))
    (dx,) = torch.autograd.grad(got, xt, torch.from_numpy(ct))
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), rtol=tol, atol=tol)


def test_affine_warp_matches_jax_and_its_identity_is_exact():
    x = images((4, 9, 9, 2))
    rng = np.random.default_rng(2)
    scale, aniso = (np.exp2(rng.standard_normal(4) * 0.2).astype(np.float32) for _ in range(2))
    theta = rng.uniform(-np.pi, np.pi, 4).astype(np.float32)
    tx, ty = (rng.standard_normal(4).astype(np.float32) * 2 for _ in range(2))
    want = jax_affine_warp(jnp.asarray(x), *(jnp.asarray(a) for a in
                                             (scale, theta, aniso, tx, ty)))
    got = aug.affine_warp(torch.from_numpy(x), *(torch.from_numpy(a) for a in
                                                 (scale, theta, aniso, tx, ty)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    one, zero = torch.ones(4), torch.zeros(4)
    same = aug.affine_warp(torch.from_numpy(x), one, zero, one, zero, zero)
    assert torch.equal(same, torch.from_numpy(x))


def test_draw_params_shapes_and_ranges():
    gen = torch.Generator().manual_seed(0)
    shape = (64, 16, 16, 3)
    p = torch.tensor(0.5)
    params = aug.draw_params(gen, shape, p, ALL)
    assert set(params) == {"flip", "ty", "tx", "rk", "iso", "theta", "aniso", "atx", "aty",
                           "b_on", "b", "c_on", "cfac", "s_on", "sfac", "n_on", "sigma",
                           "noise", "cut_on", "cy", "cx"}
    for k, v in params.items():
        assert v.shape == ((64, 16, 16, 3) if k == "noise" else (64,)), k
    assert params["flip"].dtype == torch.bool and params["ty"].dtype == torch.int64
    assert params["ty"].abs().max() <= 2 and set(params["rk"].tolist()) <= {0, 1, 2, 3}
    assert params["theta"].abs().max() <= np.pi and (params["cy"] < 16).all()
    assert 10 < int(params["flip"].sum()) < 54  # p = 0.5 of 64
    assert "rk" not in aug.draw_params(gen, (2, 8, 12, 3), 0.5, ("geom",))
    assert "s_on" not in aug.draw_params(gen, (2, 8, 8, 1), 0.5, ("color",))


def test_p_zero_is_the_identity_and_p_one_changes_every_image():
    x = torch.from_numpy(images((8, 16, 16, 3)))
    gen = torch.Generator().manual_seed(1)
    off = aug.augment(x, aug.draw_params(gen, x.shape, 0.0, ALL), ALL)
    assert torch.equal(off, x)
    params = aug.draw_params(gen, x.shape, 1.0, ("color",))
    on = aug.augment(x, params, ("color",))
    assert all(bool(params[k].all()) for k in ("b_on", "c_on", "s_on"))
    assert all(not torch.equal(a, b) for a, b in zip(on, x))


def test_bf16_images_keep_their_dtype():
    x = torch.from_numpy(images((3, 8, 8, 3))).to(torch.bfloat16)
    params = aug.draw_params(torch.Generator().manual_seed(2), x.shape, 0.7, ALL)
    assert aug.augment(x, params, ALL).dtype == torch.bfloat16


def test_parse_ops():
    assert aug.parse_ops("geom, color,cutout") == ("geom", "color", "cutout")
    with pytest.raises(ValueError, match="unknown"):
        aug.parse_ops("geom,blur")
