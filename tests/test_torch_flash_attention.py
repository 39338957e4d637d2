"""The port's plain flash-attention versions against the JAX package's flash
kernels, on the CPU: `flash_forward_reference` (o and the logsumexp ell)
and `flash_backward_reference` against `flash_attention(interpret=True)`,
its `jax.vjp`, and `attention_reference`, on the same numpy inputs.

Tolerances: f32 at rtol = atol = 2e-5, the JAX tests' own
(tests/test_self_attention.py); bf16 within one bf16 step (2^-7 relative,
taken at the output's largest magnitude for the elements near zero), which
also covers XLA keeping a bf16 cast in f32 in interpret mode. On the CPU
`FlashAttention` runs these plain versions; the kernels' own tests are the
`gpu`-marked ones of tests/test_torch_kernels_gpu.py."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from locate_tpu.ops.pallas import flash_attention as jfa
from locate_tpu_torch.ops import flash_attention as tfa

TOL = dict(rtol=2e-5, atol=2e-5)
BF16_STEP = 2.0 ** -7

# (B, T, S, dh, dv, block_q, block_kv): dh != dv everywhere, T = 16, S != T,
# several tile splits on the JAX side
CASES = {
    "t256_64x64": (2, 256, 256, 32, 64, 64, 64),
    "t256_dh8_128x32": (2, 256, 256, 8, 32, 128, 32),
    "t16_wide_heads": (2, 16, 16, 64, 256, 16, 16),
    "s_longer": (2, 64, 128, 16, 24, 32, 64),
    "s_shorter_default_tiles": (3, 128, 64, 8, 32, None, None),
}


def inputs(case, seed=0):
    b, t, s, dh, dv, _, _ = CASES[case]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, t, dh), (b, s, dh), (b, s, dv), (b, t, dv))]


def jax_forward(case, arrays, dtype=jnp.float32):
    """(o, ell) of the interpreted Pallas forward."""
    *_, dh, _, bq, bkv = CASES[case]
    q, k, v = (jnp.asarray(a, dtype) for a in arrays[:3])
    o, ell = jfa._flash_forward(q, k, v, scale=dh ** -0.5, block_q=bq, block_kv=bkv,
                                interpret=True)
    return np.asarray(o.astype(jnp.float32)), np.asarray(ell[..., 0])


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_forward_matches_the_jax_kernel(case):
    arrays = inputs(case)
    dh = CASES[case][3]
    want_o, want_ell = jax_forward(case, arrays)
    q, k, v = (torch.from_numpy(a) for a in arrays[:3])
    o, ell = tfa.flash_forward_reference(q, k, v, dh ** -0.5)
    assert o.dtype == torch.float32 and ell.shape == q.shape[:2]
    np.testing.assert_allclose(o.numpy(), want_o, **TOL)
    np.testing.assert_allclose(ell.numpy(), want_ell, **TOL)
    # the composition, the JAX one and the port's
    oracle = np.asarray(jfa.attention_reference(*(jnp.asarray(a) for a in arrays[:3]),
                                                scale=dh ** -0.5))
    np.testing.assert_allclose(o.numpy(), oracle, **TOL)
    np.testing.assert_allclose(tfa.attention_reference(q, k, v, scale=dh ** -0.5).numpy(),
                               oracle, **TOL)


def assert_within_a_bf16_step(got, want):
    allowed = BF16_STEP * np.maximum(np.abs(want), np.abs(want).max())
    assert (np.abs(got - want) <= allowed).all(), float(np.abs(got - want).max())


@pytest.mark.parametrize("case", ["t256_dh8_128x32", "s_longer"])
def test_plain_forward_matches_the_jax_kernel_bf16(case):
    arrays = inputs(case, seed=1)
    dh = CASES[case][3]
    want_o, want_ell = jax_forward(case, arrays, jnp.bfloat16)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays[:3])
    o, ell = tfa.flash_forward_reference(q, k, v, dh ** -0.5)
    assert o.dtype == torch.bfloat16 and ell.dtype == torch.float32
    assert_within_a_bf16_step(o.float().numpy(), want_o)
    np.testing.assert_allclose(ell.numpy(), want_ell, rtol=1e-5, atol=1e-5)
    assert_within_a_bf16_step(
        tfa.attention_reference(q, k, v, scale=dh ** -0.5).float().numpy(), want_o)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_matches_jax_grad_of_the_kernels(case):
    arrays = inputs(case, seed=2)
    *_, dh, _, bq, bkv = CASES[case]
    scale = dh ** -0.5
    q, k, v, do = (jnp.asarray(a) for a in arrays)
    _, vjp = jax.vjp(lambda *a: jfa.flash_attention(*a, scale=scale, block_q=bq,
                                                    block_kv=bkv, interpret=True), q, k, v)
    want = [np.asarray(g) for g in vjp(do)]
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in arrays)
    o, ell = tfa.flash_forward_reference(tq, tk, tv, scale)
    got = tfa.flash_backward_reference(tq, tk, tv, o, ell, tdo, scale)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **TOL)
    # the two wrappers, each on its own, give the same on CPU tensors
    delta = tfa.row_delta(o, tdo)
    np.testing.assert_array_equal(tfa.flash_dq(tq, tk, tv, tdo, ell, delta, scale).numpy(),
                                  got[0].numpy())
    for g, w in zip(tfa.flash_dkv(tq, tk, tv, tdo, ell, delta, scale), got[1:]):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


def test_plain_backward_bf16_rounds_p_and_ds_once():
    """bf16: dq, dk, dv within a bf16 step of the interpreted kernels' (the
    kernels round P and dS per tile, the plain version once, to the same
    values)."""
    arrays = inputs("t256_dh8_128x32", seed=3)
    scale = 8 ** -0.5
    q, k, v, do = (jnp.asarray(a, jnp.bfloat16) for a in arrays)
    _, vjp = jax.vjp(lambda *a: jfa.flash_attention(*a, scale=scale, block_q=128, block_kv=32,
                                                    interpret=True), q, k, v)
    want = [np.asarray(g.astype(jnp.float32)) for g in vjp(do)]
    tq, tk, tv, tdo = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
    o, ell = tfa.flash_forward_reference(tq, tk, tv, scale)
    for g, w in zip(tfa.flash_backward_reference(tq, tk, tv, o, ell, tdo, scale), want):
        assert g.dtype == torch.bfloat16
        assert_within_a_bf16_step(g.float().numpy(), w)


def test_function_on_cpu_tensors_matches_the_composition():
    """`flash_attention` on CPU tensors: forward and first-order gradients
    equal autograd of `attention_reference`, f32 2e-5; no kernel launch is
    counted."""
    arrays = inputs("s_longer", seed=4)
    before = (tfa.flash_fwd.launches, tfa.flash_dq.launches, tfa.flash_dkv.launches)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays[:3]]
    do = torch.from_numpy(arrays[3])
    got = torch.autograd.grad(tfa.flash_attention(*leaves, scale=0.25), leaves, do)
    want = torch.autograd.grad(tfa.attention_reference(*leaves, scale=0.25), leaves, do)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)
    assert (tfa.flash_fwd.launches, tfa.flash_dq.launches, tfa.flash_dkv.launches) == before


def test_function_gradcheck_f64():
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal(s)).requires_grad_(True)
               for s in ((2, 5, 3), (2, 7, 3), (2, 7, 4)))
    assert torch.autograd.gradcheck(lambda *a: tfa.flash_attention(*a, scale=0.6), (q, k, v))


def test_double_backward_raises():
    """Differentiating the flash backward again (what R1 would do through
    the kernels) raises: second-order terms take `attention_reference`."""
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in inputs("s_longer", seed=6)[:3]]
    o = tfa.flash_attention(*leaves, scale=0.25)
    (gq,) = torch.autograd.grad((o * o).sum(), leaves[0], create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        gq.sum().backward()
    # the composition differentiates twice
    o = tfa.attention_reference(*leaves, scale=0.25)
    (gq,) = torch.autograd.grad((o * o).sum(), leaves[0], create_graph=True)
    gq.sum().backward()
    assert leaves[1].grad is not None and bool(torch.isfinite(leaves[1].grad).all())


def test_function_saves_no_score_matrix():
    """The Function keeps q, k, v, o and ell (all O(T)), never P."""
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in inputs("t256_64x64", seed=7)[:3]]
    o = tfa.flash_attention(*leaves, scale=0.2)
    saved = o.grad_fn.saved_tensors
    assert [tuple(t.shape) for t in saved] == [(2, 256, 32), (2, 256, 32), (2, 256, 64),
                                               (2, 256, 64), (2, 256)]


def test_function_under_checkpoint():
    """A checkpointed caller unpacks the saved tensors once; the gradients
    are those of the direct call."""
    import torch.utils.checkpoint as cp

    arrays = inputs("s_longer", seed=8)
    do = torch.from_numpy(arrays[3])
    grads = []
    for wrap in (False, True):
        leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays[:3]]
        fn = lambda *a: tfa.flash_attention(*a, scale=0.25)  # noqa: E731
        o = cp.checkpoint(fn, *leaves, use_reentrant=False) if wrap else fn(*leaves)
        grads.append(torch.autograd.grad(o, leaves, do))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind,b,t,want", [
    (tfa._FWD, 64, 16384, (64, 16)), (tfa._FWD, 1, 16384, (64, 16)),
    (tfa._FWD, 1, 4096, (16, 64)), (tfa._DQ, 16, 16, (16, 64)),
    (tfa._DQ, 64, 256, (64, 16)), (tfa._DKV, 1, 4096, (64, 16)),
    (tfa._DKV, 64, 16, (16, 64)),
])
def test_tile_candidates(kind, b, t, want):
    """64-row q tiles where they give each of the 132 SMs a block (the dK/dV
    pass: wherever T has 64 rows), 16-row tiles otherwise."""
    assert tfa.tile_candidates(kind, b, t) == want


def test_pick_tile_asks_the_library():
    class Lib:
        def __init__(self, limit):
            self.limit, self.asked = limit, []

        def locate_flash_smem_bytes(self, kind, dh, dv, bq):
            self.asked.append((kind, dh, dv, bq))
            return 4 * bq * (dh + dv) * 10

    lib = Lib(None)
    assert tfa.pick_tile(tfa._FWD, 64, 4096, 8, 32, lib) == 64
    assert lib.asked == [(tfa._FWD, 8, 32, 64)]
    assert tfa.pick_tile(tfa._DKV, 64, 4096, 64, 256, lib) == 16  # 64 rows: 819,200 bytes
    with pytest.raises(ValueError, match="shared memory"):
        tfa.pick_tile(tfa._FWD, 1, 16, 4096, 4096, lib)


def test_wrappers_refuse_other_devices():
    q = torch.zeros(1, 4, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        tfa.flash_fwd(q, q, q, 1.0)
