"""Second-order terms on the kernel path: the gate Functions are
first-order (`once_differentiable`), so a gradient of a gradient through
them raises instead of returning a zero; the train step's kernel-free
twins (`plain_twin`) give GP, R1, R2 and path lengths the plain path's
gradients exactly, on the networks' own parameter tensors. CPU, f32, the
tiny widths at 8x8 (a CPU tensor runs each Function's plain version
inside the same Function)."""

import dataclasses

import pytest
import torch

from locate_tpu_torch.models.gan import build_gan
from locate_tpu_torch.objectives.losses import gradient_penalty, path_lengths, r1_penalty
from locate_tpu_torch.train.state import create_train_state
from locate_tpu_torch.train.step import make_train_step
from torch_step_draws import configs


def gans(tiny_config, **train):
    _, tcfg = configs(tiny_config, train=train)
    kernel = build_gan(dataclasses.replace(tcfg, use_pallas=True), device="cpu", seed=1)
    plain = build_gan(dataclasses.replace(tcfg, use_pallas=False), device="cpu", seed=1)
    step = make_train_step(dataclasses.replace(tcfg, use_pallas=True), kernel)
    create_train_state(tcfg, kernel)
    return kernel, plain, step


def inputs(n=3, res=8, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand((n, res, res, 3), generator=g) * 2 - 1,
            torch.rand((n, res, res, 3), generator=g) * 2 - 1,
            torch.rand((n, 1, 1, 1), generator=g))


def grads(loss, module):
    return torch.autograd.grad(loss, list(module.parameters()), allow_unused=True)


def test_gp_and_r1_through_the_gate_function_raise(tiny_config):
    kernel, _, _ = gans(tiny_config, gp_gamma=10.0)
    real, fake, eps = inputs()
    D = kernel.discriminator
    for pen in (lambda: gradient_penalty(D, real, fake, eps),
                lambda: r1_penalty(D, real)):
        with pytest.raises(RuntimeError, match="once_differentiable"):
            grads(pen(), D)


def test_pl_through_the_gate_function_raises(tiny_config):
    kernel, _, _ = gans(tiny_config, pl_gamma=2.0)
    z = torch.randn(3, kernel.config.latent_dim, generator=torch.Generator().manual_seed(2))
    y = torch.randn(3, 8, 8, 3, generator=torch.Generator().manual_seed(3))
    with pytest.raises(RuntimeError, match="once_differentiable"):
        grads(path_lengths(kernel.generator, z, None, y).mean(), kernel.generator)


def test_twins_give_the_plain_paths_gradients(tiny_config):
    """GP, R1 (and so R2) through D's twin and PL through G's twin, on the
    use_pallas networks, equal the use_pallas=False networks' gradients
    bit for bit, and reach the networks' own parameters."""
    kernel, plain, step = gans(tiny_config, gp_gamma=10.0, pl_gamma=2.0, r1_remat=False)
    assert step._d_twin is not kernel.discriminator and step._g_twin is not kernel.generator
    real, fake, eps = inputs()
    for pen_k, pen_p in (
            (gradient_penalty(step.d_apply_r1, real, fake, eps),
             gradient_penalty(plain.discriminator, real, fake, eps)),
            (r1_penalty(step.d_apply_r1, real), r1_penalty(plain.discriminator, real))):
        assert torch.equal(pen_k, pen_p)
        for a, b in zip(grads(pen_k, kernel.discriminator), grads(pen_p, plain.discriminator)):
            assert (a is None and b is None) or torch.equal(a, b)
    z = torch.randn(3, kernel.config.latent_dim, generator=torch.Generator().manual_seed(2))
    y = torch.randn(3, 8, 8, 3, generator=torch.Generator().manual_seed(3))
    lk = path_lengths(step._g_twin, z, None, y).mean()
    lp = path_lengths(plain.generator, z, None, y).mean()
    assert torch.equal(lk, lp)
    gk, gp = grads(lk, kernel.generator), grads(lp, plain.generator)
    assert any(g is not None and g.abs().max() > 0 for g in gk)
    for a, b in zip(gk, gp):
        assert (a is None and b is None) or torch.equal(a, b)
