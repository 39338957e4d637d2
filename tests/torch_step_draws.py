"""Helpers of the tests that hold the port's train step against the JAX
package's with every option: the JAX step's draws of one step, made with
its own key plumbing (`locate_tpu/train/step.py`: the splits of
`state.rng`, the fold-ins of ADA's, bCR's, GP's and PL's streams, the
per-critic key families, the EMA's per-leaf keys) and each op's
`jax.random` calls (`locate_tpu/ops/augment.py`), as the port's named
draws (`locate_tpu_torch/train/step.py`), so that both steps see the same
numbers; and the two-step parity run itself."""

import dataclasses
import math

import numpy as np
import jax
import jax.numpy as jnp
import torch

from locate_tpu.models.gan import build_gan as jax_build_gan
from locate_tpu.objectives.ema import ema_init as jax_ema_init
from locate_tpu.train.state import create_train_state as jax_create_train_state
from locate_tpu.train.step import make_train_step as jax_make_train_step
from locate_tpu_torch.models.gan import build_gan
from locate_tpu_torch.train.state import state_from_jax
from locate_tpu_torch.train.step import make_train_step
from torch_port_parity import as_state_dict, port_config, randomize_zero_init, rel_err

ADA_TAG, BCR_TAG, GP_TAG, PL_TAG = 0x41444121, 0x424352, 0x47504750, 0x504C3132
MIX_Z2_TAG, MIX_CUT_TAG, NOISE_TAG = 0x4D5832, 0x4D5833, 0x4E5A31


def aug_params(key, shape, p, ops):
    """`augment_pipeline(key, x, p, ops)`'s draws for an x of NHWC `shape`,
    as `locate_tpu_torch/ops/augment.py` parameters (numpy)."""
    n, h, w, c = shape
    p = jnp.asarray(p, jnp.float32)
    ks = jax.random.split(key, 14)
    rnd = jax.random
    out = {}

    def bern(k):
        return rnd.bernoulli(k, p, (n,))

    if "geom" in ops:
        out["flip"] = bern(ks[0])
        t_on = bern(ks[1])
        my, mx = max(h // 8, 1), max(w // 8, 1)
        out["ty"] = jnp.where(t_on, rnd.randint(ks[2], (n,), -my, my + 1), 0)
        out["tx"] = jnp.where(t_on, rnd.randint(ks[3], (n,), -mx, mx + 1), 0)
        if h == w:
            out["rk"] = jnp.where(bern(ks[12]), rnd.randint(ks[13], (n,), 1, 4), 0)
    if "affine" in ops:
        ka = rnd.split(rnd.fold_in(key, 0xAFF1), 9)
        out["iso"] = jnp.where(bern(ka[0]), jnp.exp2(rnd.normal(ka[1], (n,)) * 0.2), 1.0)
        out["theta"] = jnp.where(bern(ka[2]),
                                 rnd.uniform(ka[3], (n,), jnp.float32, -jnp.pi, jnp.pi), 0.0)
        out["aniso"] = jnp.where(bern(ka[4]), jnp.exp2(rnd.normal(ka[5], (n,)) * 0.2), 1.0)
        t_on = bern(ka[6])
        out["atx"] = jnp.where(t_on, rnd.normal(ka[7], (n,)) * 0.125 * w, 0.0)
        out["aty"] = jnp.where(t_on, rnd.normal(ka[8], (n,)) * 0.125 * h, 0.0)
    if "color" in ops:
        out["b_on"] = bern(ks[4])
        out["b"] = rnd.normal(ks[5], (n, 1, 1, 1)) * 0.2
        out["c_on"] = bern(ks[6])
        out["cfac"] = jnp.exp2(rnd.normal(ks[7], (n, 1, 1, 1)) * 0.5)
        if c == 3:
            out["s_on"] = bern(ks[8])
            out["sfac"] = jnp.exp2(rnd.normal(ks[9], (n, 1, 1, 1)))
    if "noise" in ops:
        k_a, k_s, k_n = rnd.split(rnd.fold_in(key, 0x4E6F69), 3)
        out["n_on"] = bern(k_a)
        out["sigma"] = jnp.abs(rnd.normal(k_s, (n, 1, 1, 1))) * 0.1
        out["noise"] = rnd.normal(k_n, shape)
    if "cutout" in ops:
        out["cut_on"] = bern(ks[10])
        k_cy, k_cx = rnd.split(ks[11])
        out["cy"] = rnd.randint(k_cy, (n,), 0, h)
        out["cx"] = rnd.randint(k_cx, (n,), 0, w)
    squeeze = ("b", "cfac", "sfac", "sigma")
    return {k: np.asarray(v).reshape(n) if k in squeeze else np.asarray(v)
            for k, v in out.items()}


def _ops(spec):
    return tuple(s.strip() for s in spec.split(",") if s.strip())


def _aug_keys(rng, count):
    return jax.random.split(jax.random.fold_in(rng, ADA_TAG), count)


def _flat(prefix, params):
    return {f"{prefix}.{k}": v for k, v in params.items()}


def style_draws(jcfg, jgan, key, n, side):
    """The style family's draws of the G forward on the latent key `key`
    (`g_apply_train`): mixing's second latent and crossover, random
    noise's planes a stage and conv, as the port's `<name>_<side>` draws."""
    m, out = jcfg.model, {}
    if m.arch != "style":
        return out
    if m.style.mixing_prob > 0.0:
        num_ws = jgan.generator.num_ws
        out[f"mix_z2_{side}"] = np.asarray(
            jgan.sample_latents(jax.random.fold_in(key, MIX_Z2_TAG), n))
        ku, kl = jax.random.split(jax.random.fold_in(key, MIX_CUT_TAG))
        mix = jax.random.uniform(ku, (n,)) < m.style.mixing_prob
        layer = jax.random.randint(kl, (n,), 1, num_ws)
        out[f"mix_cut_{side}"] = np.asarray(jnp.where(mix, layer, num_ws).astype(jnp.int32))
    if m.style.noise == "random":
        kn = jax.random.fold_in(key, NOISE_TAG)
        for i, r in enumerate(m.stage_resolutions()):
            ki = jax.random.fold_in(kn, i)
            for j in range(m.blocks_per_stage):
                out[f"g_noise_{side}.{i}.{j}"] = np.asarray(jax.random.normal(
                    jax.random.fold_in(ki, j), (n, r, r, 1), jnp.float32))
    return out


def _critic(jgan, tcfg, rng, n, real_shape, fake_shape, ada_p, zl, aug_count):
    """One D update's draws: latents and labels from the keys `zl`, ADA's
    (from `aug_keys(rng, aug_count)`), bCR's and GP's from `rng`."""
    out = {"z_d": np.asarray(jgan.sample_latents(zl[0], n))}
    lab = jgan.sample_labels(zl[1], n)
    if lab is not None:
        out["labels_d"] = np.asarray(lab)
    if tcfg.augment_p > 0.0 or tcfg.ada_target > 0.0:
        ka = _aug_keys(rng, aug_count)
        out.update(_flat("aug_real", aug_params(ka[0], real_shape, ada_p,
                                                _ops(tcfg.augment_ops))))
        out.update(_flat("aug_fake", aug_params(ka[1], fake_shape, ada_p,
                                                _ops(tcfg.augment_ops))))
    if tcfg.bcr_gamma > 0.0:
        kr, kf = jax.random.split(_aug_keys(jax.random.fold_in(rng, BCR_TAG), 1)[0])
        ops = _ops(tcfg.bcr_ops)
        out.update(_flat("bcr_real", aug_params(kr, real_shape, tcfg.bcr_p, ops)))
        out.update(_flat("bcr_fake", aug_params(kf, fake_shape, tcfg.bcr_p, ops)))
    if tcfg.gp_gamma > 0.0:
        out["gp_eps"] = np.asarray(jax.random.uniform(jax.random.fold_in(rng, GP_TAG),
                                                      (n, 1, 1, 1), jnp.float32))
    return out


def jax_draws(jcfg, jgan, jstate, pstate, real_shape):
    """Every draw the JAX step makes from `jstate` for reals of NHWC
    `real_shape` (one critic's under d_steps), as the port's draws
    (torch tensors; the EMA's bits in the port's parameter order)."""
    t = jcfg.train
    rng = jstate.rng
    n = real_shape[0]
    m = jcfg.model
    fake_shape = (n, m.resolution, m.resolution, m.img_channels)
    ada_p = jstate.ada_p
    aug_on = t.augment_p > 0.0 or t.ada_target > 0.0
    if t.fused_step:
        k_ema, k_z, k_l = jax.random.split(rng, 3)
        out = _critic(jgan, t, rng, n, real_shape, fake_shape, ada_p, (k_z, k_l), 2)
        out.update(style_draws(jcfg, jgan, k_z, n, "d"))
    elif t.d_steps > 1:
        k_ema, k_zg, k_lg = jax.random.split(rng, 3)
        per = []
        for i in range(t.d_steps):
            ri = jax.random.fold_in(rng, i)
            zl = (jax.random.fold_in(ri, 1), jax.random.fold_in(ri, 2))
            per.append({**_critic(jgan, t, ri, n, real_shape, fake_shape, ada_p, zl, 3),
                        **style_draws(jcfg, jgan, zl[0], n, "d")})
        out = {k: np.stack([d[k] for d in per]) for k in per[0]}
        out.update(style_draws(jcfg, jgan, k_zg, n, "g"))
        out["z_g"] = np.asarray(jgan.sample_latents(k_zg, n))
        lab = jgan.sample_labels(k_lg, n)
        if lab is not None:
            out["labels_g"] = np.asarray(lab)
        if aug_on:
            out.update(_flat("aug_g", aug_params(_aug_keys(rng, 3)[2], fake_shape, ada_p,
                                                 _ops(t.augment_ops))))
    else:
        k_ema, k_zd, k_zg, k_ld, k_lg = jax.random.split(rng, 5)
        if t.share_latents:
            k_zg, k_lg = k_zd, k_ld
        out = _critic(jgan, t, rng, n, real_shape, fake_shape, ada_p, (k_zd, k_ld), 3)
        out.update(style_draws(jcfg, jgan, k_zd, n, "d"))
        if not t.share_latents:  # else G's forward takes the "d" draws
            out.update(style_draws(jcfg, jgan, k_zg, n, "g"))
        out["z_g"] = np.asarray(jgan.sample_latents(k_zg, n))
        lab = jgan.sample_labels(k_lg, n)
        if lab is not None:
            out["labels_g"] = np.asarray(lab)
        if aug_on:
            out.update(_flat("aug_g", aug_params(_aug_keys(rng, 3)[2], fake_shape, ada_p,
                                                 _ops(t.augment_ops))))
    if t.pl_gamma > 0.0:
        h, w = fake_shape[1], fake_shape[2]
        y = jax.random.normal(jax.random.fold_in(rng, PL_TAG), fake_shape, jnp.float32)
        out["pl_noise"] = np.asarray(y / jnp.sqrt(jnp.asarray(h * w, jnp.float32)))
    if t.ema_decay > 0 and t.ema_dtype == "bfloat16":
        out["ema_bits"] = port_bits(jax_ema_bits(k_ema, jstate.ema_params), pstate)
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def jax_ema_bits(key, ema_params):
    """The bits `ema_update` draws for a bf16 shadow: one key per leaf of
    `jax.random.split(key, leaves)`, 16 random bits an element."""
    leaves, treedef = jax.tree.flatten(ema_params)
    keys = jax.random.split(key, len(leaves))
    bits = [np.asarray(jax.random.bits(k, leaf.shape, jnp.uint32) & jnp.uint32(0xFFFF))
            for leaf, k in zip(leaves, keys)]
    return jax.tree.unflatten(treedef, [b.astype(np.float32) for b in bits])


def port_bits(bits_tree, pstate):
    """A bits pytree in the port's flat parameter order, as int32."""
    named = as_state_dict(bits_tree)
    return pstate.g_params.from_named(named).to(torch.int32).numpy()


# --- the two-step parity run ---------------------------------------------------

BATCH = 4


def configs(tiny_config, train=None, model=None, use_pallas=False, batch=BATCH, res=8):
    """The JAX config and the port's copy: the tiny model at `res` (8: two
    stages a net, a gate in each, which keeps the JAX compile short) with
    the gate's clamp at 16, the flagship's guards, `train` and `model`
    overrides."""
    attn = dataclasses.replace(tiny_config.model.attention, gate_max=16.0)
    jcfg = dataclasses.replace(
        tiny_config, use_pallas=use_pallas,
        model=dataclasses.replace(tiny_config.model, attention=attn, resolution=res,
                                  **(model or {})),
        data=dataclasses.replace(tiny_config.data, resolution=res),
        train=dataclasses.replace(tiny_config.train, global_batch=batch,
                                  grad_norm_limit=1e6, max_nonfinite_skips=200,
                                  **(train or {})))
    return jcfg, port_config(jcfg)


def jax_state(jcfg, jgan, scale=0.2):
    """A fresh JAX state with its zero-init leaves filled with N(0, scale^2)
    (the gates, the biases and the class projection move)."""
    state = jax_create_train_state(jcfg, jgan, jax.random.PRNGKey(0))
    g = randomize_zero_init(state.g_params, jax.random.PRNGKey(1), scale)
    d = randomize_zero_init(state.d_params, jax.random.PRNGKey(2), scale)
    ema = (jax_ema_init(g, jnp.dtype(jcfg.train.ema_dtype))
           if state.ema_params is not None else None)
    return state.replace(g_params=g, d_params=d, ema_params=ema)


def batch(jcfg, n=BATCH, seed=0):
    """A uint8 batch (and labels) at the config's resolution, with a
    leading [d_steps] axis under the multi-critic flavor."""
    rng = np.random.default_rng(seed)
    lead = (jcfg.train.d_steps,) if jcfg.train.d_steps > 1 else ()
    res = jcfg.data.resolution
    classes = max(jcfg.model.num_classes, 1)
    return {"image": rng.integers(0, 256, lead + (n, res, res, 3), dtype=np.uint8),
            "label": rng.integers(0, classes, lead + (n,)).astype(np.int32)}


# D losses that a shift of every logit leaves unchanged: D's head bias
# then has a gradient that is rounding noise around 0, as a softmax gate's
# logit bias has
SHIFT_INVARIANT = ("wgan", "ragan", "rahinge", "rpgan")


def compare_params(pstate, jstate, steps, lr=2e-4, tol=1e-3, d_steps=1, loss="nonsat"):
    """G, D and EMA params per leaf within `tol` norm-relative; a softmax
    gate's logit bias, and D's head bias under a shift-invariant loss
    (whose gradients are rounding noise around 0), within their Adam
    moves."""
    parts = [("g", pstate.g_params.named(pstate.g_params.flat), jstate.g_params),
             ("d", pstate.d_params.named(pstate.d_params.flat), jstate.d_params)]
    if jstate.ema_params is not None:
        parts.append(("ema", pstate.g_params.named(pstate.ema_params.float()),
                      jstate.ema_params))
    for part, port, want in parts:
        updates = steps * d_steps if part == "d" else steps
        want = as_state_dict(want)
        assert set(port) == set(want), part
        for name, w in want.items():
            got = port[name].numpy()
            if name.endswith("to_logits.b") or (
                    part == "d" and name == "head.b" and loss in SHIFT_INVARIANT):
                # Adam (beta1 0) moves an element by at most lr sqrt(t) at step t
                bound = 2 * lr * sum(math.sqrt(t) for t in range(1, updates + 1))
                assert np.abs(got - w).max() <= bound * 1.01, (part, name)
            else:
                assert rel_err(got, w) < tol, (part, name, rel_err(got, w))


def run_parity(jcfg, tcfg, steps=2, use_pallas=None, rtol=2e-4, atol=1e-5, n=BATCH,
               param_tol=1e-3, scale=0.2, state_fn=None, record=None):
    """`steps` steps of the jitted JAX step and of the port's from one
    state with the same draws: every metric within rtol (atol; the mean
    logits under a shift-invariant loss also within the Adam moves of D's
    head bias, whose gradient is rounding noise), params as
    `compare_params` says, the option tensors (ADA's p, the path-length
    mean, LeCam's trackers) within rtol. `state_fn`, when given, maps
    the fresh JAX state to the start state; `record`, a list when given,
    gets each step's draws. Returns the last metrics of both, and both
    states."""
    jgan = jax_build_gan(jcfg)
    jstate = jax_state(jcfg, jgan, scale)
    if state_fn is not None:
        jstate = state_fn(jstate)
    jstep = jax.jit(jax_make_train_step(jcfg, jgan))
    if use_pallas is not None:
        tcfg = dataclasses.replace(tcfg, use_pallas=use_pallas)
    gan = build_gan(tcfg, device="cpu")
    pstate = state_from_jax(jstate, tcfg, gan)
    step = make_train_step(tcfg, gan)
    b = batch(jcfg, n)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    real_shape = b["image"].shape[-4:]
    for i in range(steps):
        draws = jax_draws(jcfg, jgan, jstate, pstate, real_shape)
        if record is not None:
            record.append(draws)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        pstate, pm = step(pstate, tb, **draws)
        assert set(pm) == set(jm), (sorted(pm), sorted(jm))
        for k in jm:
            tol = atol
            if k in ("real_logits", "fake_logits") and jcfg.train.loss in SHIFT_INVARIANT:
                # D's head bias, whose gradient is rounding noise under such a
                # loss, has taken Adam steps of up to lr sqrt(t) at random
                updates = i * jcfg.train.d_steps
                lr = jcfg.train.d_opt.lr
                tol = atol + 2 * lr * sum(math.sqrt(t) for t in range(1, updates + 1))
            np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=rtol, atol=tol,
                                       err_msg=f"step {i} {k}")
        assert pstate.step == int(jstate.step) == i + 1
        compare_params(pstate, jstate, steps=i + 1, tol=param_tol,
                       d_steps=jcfg.train.d_steps, loss=jcfg.train.loss)
        for name in ("ada_p", "pl_mean", "lecam"):
            want = getattr(jstate, name)
            assert (want is None) == (getattr(pstate, name) is None), name
            if want is not None:
                np.testing.assert_allclose(getattr(pstate, name).numpy(), np.asarray(want),
                                           rtol=rtol, atol=atol, err_msg=name)
    return pm, jm, pstate, jstate


def perturbed(jstate, key, scale=1e-7):
    """`jstate` with every G and D weight times 1 + scale N(0, 1)."""
    def move(tree, k):
        leaves, treedef = jax.tree.flatten(tree)
        keys = jax.random.split(k, len(leaves))
        return jax.tree.unflatten(treedef, [
            leaf * (1 + scale * jax.random.normal(kl, leaf.shape)) if leaf.ndim else leaf
            for leaf, kl in zip(leaves, keys)])
    kg, kd = jax.random.split(key)
    return jstate.replace(g_params=move(jstate.g_params, kg), d_params=move(jstate.d_params, kd))


def run_noise_parity(jcfg, tcfg, n, scale, rtol=2e-4, atol=1e-5):
    """Two steps of the jitted JAX step and of the port's (on its gate
    Function) from one state with the same draws; beside them the JAX
    step from the same state with its G and D weights moved by 1e-7
    relative noise (three draws). Step 1's metrics within `rtol`; step
    2's within the larger of `rtol` and ten times the JAX step's own
    largest move under the noise (phase 6's rule in chip_smoke.py), both
    beside `atol`. Returns, a step, each metric's port-vs-JAX error and
    the JAX step's largest noise move (relative)."""
    jgan = jax_build_gan(jcfg)
    jstate = jax_state(jcfg, jgan, scale)
    jstep = jax.jit(jax_make_train_step(jcfg, jgan))
    tcfg = dataclasses.replace(tcfg, use_pallas=True)
    gan = build_gan(tcfg, device="cpu")
    pstate = state_from_jax(jstate, tcfg, gan)
    step = make_train_step(tcfg, gan)
    b = batch(jcfg, n)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    noisy = [perturbed(jstate, jax.random.PRNGKey(s)) for s in (11, 12, 13)]
    out = []
    for i in range(2):
        draws = jax_draws(jcfg, jgan, jstate, pstate, b["image"].shape[-4:])
        jstate, jm = jstep(jstate, jb)
        pstate, pm = step(pstate, tb, **draws)
        moved = []
        for j, ns in enumerate(noisy):
            noisy[j], nm = jstep(ns, jb)
            moved.append(nm)
        row = {}
        for k in jm:
            want = float(jm[k])
            scale_k = max(abs(want), 1e-30)
            noise = max(abs(float(m[k]) - want) for m in moved) / scale_k
            tol = rtol if i == 0 else max(rtol, 10 * noise)
            np.testing.assert_allclose(float(pm[k]), want, rtol=tol, atol=atol,
                                       err_msg=f"step {i} {k} (JAX noise move {noise:.2e})")
            row[k] = dict(port_vs_jax=abs(float(pm[k]) - want) / scale_k, jax_noise=noise)
        out.append(row)
    return out
