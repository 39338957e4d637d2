"""The port's tensor parallelism, the model axis of the (data, model) mesh:
the split leaves and dimensions against the JAX package's
`param_shardings` (on `jax.eval_shape` of the JAX init, no compile) for
four model families, each rank's mesh position against JAX's device
placement, and one spawn of four gloo CPU ranks (tests/torch_dp_worker.py)
that runs an f32 model wide enough to split its convs, the seed dense and
the gates' logit convs (softmax gate, use_pallas: the kernels' plain
versions on the CPU) two steps with R1 at the first on (2, 2) at ZeRO 0
and 1, on (1, 4) and, for the style family made class-conditional with
spectral norm and the orthogonal penalty, on (2, 2): against
the one-process port (bitwise across the model ranks of a data row), the
(2, 2) step against one step of JAX's `make_sharded_train_step` on a
(2, 2) fake-device mesh from the same weights and draws, the state sizes
a rank keeps, and checkpoints across meshes."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from locate_tpu.config import ParallelConfig as JaxParallelConfig
from locate_tpu.config import StyleConfig as JaxStyleConfig
from locate_tpu.config import get_config as jax_get_config
from locate_tpu.models.gan import build_gan as jax_build_gan
from locate_tpu.parallel.mesh import make_mesh as jax_make_mesh
from locate_tpu.parallel.sharding import make_sharded_train_step, param_shardings
from locate_tpu.parallel.sharding import place_train_state as jax_place_train_state
from locate_tpu_torch.config import ParallelConfig, get_config
from locate_tpu_torch.io.checkpoint import CheckpointManager
from locate_tpu_torch.models.gan import build_gan
from locate_tpu_torch.parallel.mesh import Mesh
from locate_tpu_torch.parallel.tp import ModelLayout
from locate_tpu_torch.train.state import create_train_state, state_from_jax, state_tensors
from locate_tpu_torch.train.step import make_train_step
from torch_dp_worker import finish_ranks, start_ranks
from torch_port_parity import rel_err
from torch_step_draws import configs, jax_draws, jax_state
from torch_threads import few_threads

WORLD, N, STEPS = 4, 4, 2
TRAIN = dict(r1_gamma=1.0, r1_interval=2)  # R1 fires at step 0
# stages of 256, 128, 128 channels: every conv, the seed dense and the
# gates' logit convs split at mp 2 and 4
WIDE = dict(base_channels=256, max_channels=256, min_channels=128)
# the zero-init leaves' noise: at the default 0.2 the wide model's gates
# make R1's gradient norm ~7e3, and the one-process step alone, on one CPU
# thread against three, differs by 15 % at its second step
INIT_SCALE = 0.02
STYLE = JaxStyleConfig(mapping_layers=2, mixing_prob=0.9, noise="random")
# the readers of split leaves that the locate run leaves out, added to the
# style run: spectral norm's sigma, the orthogonal penalty (`ORTHO`),
# class_embed and class_proj
READERS = dict(spectral_norm=True, num_classes=4, class_embed_dim=128)
ORTHO = 1e-4
# (name, family, dp, mp, zero_stage)
RUNS = (("tp22", "locate", 2, 2, 0), ("tp22_zero1", "locate", 2, 2, 1),
        ("tp14", "locate", 1, 4, 0), ("style22", "style", 2, 2, 0))
# the families the layout is held on: (preset, overrides)
FAMILIES = {"lsun_bedroom_128": ("lsun_bedroom_128", {}),
            "ffhq_512": ("ffhq_512", {}),
            "style": ("celeba_64", {"model.arch": "style"}),
            "self_attention": ("lsun_bedroom_128", {"model.attention.kind": "self"})}
MESHES = ((1, 2), (2, 2), (1, 4))


def _mesh_cfg(cfg, dp, mp, zero_stage=0):
    return dataclasses.replace(cfg, parallel=ParallelConfig(
        data_parallel=dp, model_parallel=mp, zero_stage=zero_stage))


# --------------------------------------------------------------- the layout
def _jax_split(params, mesh):
    """{dotted leaf name: its axis over `model`} of JAX's rule."""
    out = {}
    shardings = param_shardings(params, mesh)
    for path, s in jax.tree_util.tree_flatten_with_path(shardings)[0]:
        name = ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        for axis, part in enumerate(s.spec):
            if part == "model":
                out[name] = axis
    return out


@pytest.mark.parametrize("dp, mp", MESHES)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_split_leaves_are_the_jax_rule(family, dp, mp):
    """The port's split leaves and dimensions (`ModelLayout` on the port's
    OIHW shapes) are those of `param_shardings` on the JAX init's shapes:
    a conv's split port dim 0 is JAX's trailing HWIO axis."""
    preset, overrides = FAMILIES[family]
    jgan = jax_build_gan(jax_get_config(preset, overrides))
    shapes = jax.eval_shape(lambda: jgan.init(jax.random.PRNGKey(0)))
    mesh = JaxMesh(np.asarray(jax.devices()[:dp * mp]).reshape(dp, mp), ("data", "model"))
    gan = build_gan(get_config(preset, overrides), "cpu")
    port_mesh = Mesh(dp=dp, mp=mp, world=dp * mp)
    for net, module in (("generator", gan.generator), ("discriminator", gan.discriminator)):
        want = _jax_split(shapes[net], mesh)
        named = list(module.named_parameters())
        layout = ModelLayout(port_mesh, [n for n, _ in named], [p.shape for _, p in named])
        got = {}
        for (name, p), d in zip(named, layout.dims):
            if d is not None:
                got[name] = 3 if p.dim() == 4 else d  # OIHW's O is HWIO's axis 3
        assert want and got == want, (net, sorted(set(got) ^ set(want)))


@pytest.mark.parametrize("dp, mp", [(4, 2), (2, 2), (1, 4)])
def test_mesh_position_is_jax_placement(dp, mp):
    """Rank r's (data, model) index is device r's place in JAX's mesh."""
    want = jax_make_mesh(JaxParallelConfig(data_parallel=dp, model_parallel=mp),
                         devices=jax.devices()[:dp * mp])
    for d in range(dp):
        for m in range(mp):
            rank = want.devices[d, m].id
            mesh = Mesh(dp=dp, mp=mp, rank=rank, world=dp * mp)
            assert (mesh.data_index, mesh.model_index) == (d, m)


# ------------------------------------------------------------ four gloo ranks
def one_process(tcfg, tensors, images, steps, draws=None, labels=None):
    """`steps` steps of the port's one-process step from `tensors`."""
    gan = build_gan(tcfg, "cpu", seed=tcfg.train.seed)
    state = create_train_state(tcfg, gan, seed=tcfg.train.seed)
    with torch.no_grad():
        for k, t in state_tensors(state).items():
            t.copy_(tensors[k])
    step = make_train_step(tcfg, gan)
    out = []
    batch = {"image": torch.from_numpy(images)}
    if labels is not None:
        batch["label"] = torch.from_numpy(labels)
    for i in range(steps):
        given = {k: torch.as_tensor(v) for k, v in draws[i].items()} if draws else {}
        state, m = step(state, batch, **given)
        out.append({k: float(v) for k, v in m.items()})
    return state, out


def jax_sharded_step(jcfg, jstate, images):
    """One step of JAX's `make_sharded_train_step` on a (2, 2) mesh of the
    fake CPU devices: its metrics. JAX runs its XLA composition (the
    reference the Pallas kernels are held to; in interpret mode they take
    15 s more to compile here), the port its kernels' plain versions."""
    jcfg = dataclasses.replace(jcfg, use_pallas=False, parallel=JaxParallelConfig(
        data_parallel=2, model_parallel=2))
    mesh = jax_make_mesh(jcfg.parallel, devices=jax.devices()[:4])
    jgan = jax_build_gan(jcfg)
    with mesh:
        step_for, shardings_for, b_shard = make_sharded_train_step(jcfg, jgan, mesh)
        # a copy: the step donates its input state's buffers
        state = jax.tree.map(lambda x: jnp.array(x, copy=True), jstate)
        state = jax_place_train_state(state, shardings_for(state))
        batch = jax.device_put({"image": jnp.asarray(images),
                                "label": jnp.zeros(images.shape[:1], jnp.int32)},
                               {"image": b_shard, "label": b_shard})
        _, m = step_for(state)(state, batch)
    return {k: float(v) for k, v in m.items()}


@pytest.fixture(scope="module")
def tp(tiny_config, tmp_path_factory):
    """Start the four ranks on every case, compute the one-process and JAX
    references meanwhile, and return everything."""
    tmp = tmp_path_factory.mktemp("tp")
    jcfg, tcfg = configs(tiny_config, train=TRAIN, model=WIDE, use_pallas=True, batch=N,
                         res=16)
    _, scfg = configs(tiny_config, train=dict(TRAIN, ortho_gamma=ORTHO),
                      model=dict(WIDE, arch="style", style=STYLE, **READERS), use_pallas=True,
                      batch=N, res=16)
    jgan = jax_build_gan(jcfg)
    jstate = jax_state(jcfg, jgan, scale=INIT_SCALE)
    pstate = state_from_jax(jstate, tcfg, build_gan(tcfg, "cpu"))
    tensors = {k: t.clone() for k, t in state_tensors(pstate).items()}
    fresh = {k: t.clone() for k, t in state_tensors(
        create_train_state(scfg, build_gan(scfg, "cpu"))).items()}
    images = np.random.default_rng(0).integers(0, 256, (N, 16, 16, 3), dtype=np.uint8)
    labels = np.arange(N, dtype=np.int64) % READERS["num_classes"]
    # the global program's draws, two steps (JAX's key moves by one split)
    draws, s = [], jstate
    for _ in range(STEPS):
        draws.append({k: v.numpy() for k, v in jax_draws(jcfg, jgan, s, pstate,
                                                          images.shape).items()})
        s = s.replace(rng=jax.random.split(s.rng, 1)[0])
    one_dir = str(tmp / "one")
    CheckpointManager(one_dir).save(pstate)
    runs = {}
    for name, family, dp, mp, zero in RUNS:
        style = family == "style"
        runs[name] = dict(cfg=_mesh_cfg(scfg if style else tcfg, dp, mp, zero),
                          tensors=fresh if style else tensors, images=images, steps=STEPS,
                          draws=None if style else draws, labels=labels if style else None)
    runs["tp22_zero1"]["checkpoint"] = str(tmp / "ckpt22")
    inputs = dict(runs=runs, tp_checkpoints=dict(
        cfg=_mesh_cfg(tcfg, 2, 2, 1), cfg12=_mesh_cfg(tcfg, 1, 2), dir=str(tmp / "ckpt22"),
        one_dir=one_dir))
    procs = start_ranks(inputs, tmp, WORLD)
    try:
        with few_threads(2):  # beside the ranks' eight threads
            ref = dict(locate=one_process(tcfg, tensors, images, STEPS, draws),
                       style=one_process(scfg, fresh, images, STEPS, labels=labels))
        ref["jax"] = jax_sharded_step(jcfg, jstate, images)
    finally:
        ranks = finish_ranks(procs, tmp)
    return dict(ranks=ranks, ref=ref, inputs=inputs, tcfg=tcfg, one=pstate)


def _close(got, want, rtol, atol, what):
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w), (what, sorted(set(g) ^ set(w)))
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=atol,
                                       err_msg=f"{what} step {i} {k}")


@pytest.mark.parametrize("name, family, dp, mp, zero", RUNS)
def test_tp_step_equals_one_process(tp, name, family, dp, mp, zero):
    """Every metric bitwise equal on the model ranks of a data row (and on
    every rank: the metrics are means over the data axis), each within
    the data-parallel bounds of the one-process port; R1 fired at step 0;
    each rank sits where the mesh puts it."""
    runs = [r[name] for r in tp["ranks"]]
    for r, run in enumerate(runs):
        assert run["index"] == (r // mp, r % mp)
        assert run["metrics"] == runs[(r // mp) * mp]["metrics"], (name, r)
        assert run["metrics"] == runs[0]["metrics"], (name, r)
    got = runs[0]["metrics"]
    assert got[0]["r1"] > 0 and got[1]["r1"] == 0
    _close(got, tp["ref"][family][1], 2e-4, 2e-5, name)


@pytest.mark.parametrize("name, family, dp, mp, zero", RUNS)
def test_tp_parameters_equal_one_process(tp, name, family, dp, mp, zero):
    """The gathered parameters after the two steps, per leaf within 1e-3
    norm-relative of the one-process port's; a softmax gate's logit bias
    (a gradient of rounding noise around 0) within Adam's moves."""
    one = tp["ref"][family][0]
    got_state = tp["ranks"][0][name]["state"]
    lr = tp["tcfg"].train.g_opt.lr
    for net, flat in (("g", one.g_params), ("d", one.d_params)):
        got, ref = flat.named(got_state[f"{net}_params"]), flat.named(flat.flat)
        for leaf, w in ref.items():
            if leaf.endswith("to_logits.b"):
                bound = 2 * lr * (1 + math.sqrt(2))
                assert (got[leaf] - w).abs().max() <= bound * 1.01, (net, leaf)
            else:
                assert rel_err(got[leaf].numpy(), w.numpy()) < 1e-3, (net, leaf)
    if zero:  # ZeRO-1 splits stage 0's arithmetic elementwise: bit for bit
        base = tp["ranks"][0]["tp22"]
        assert tp["ranks"][0][name]["metrics"] == base["metrics"]
        for k, t in base["state"].items():
            assert torch.equal(got_state[k], t), k


@pytest.mark.parametrize("name, family, dp, mp, zero", RUNS)
def test_tp_rank_keeps_the_layouts_sizes(tp, name, family, dp, mp, zero):
    """Each rank's state tensors hold its model slice of the split leaves
    and the other leaves whole (a ZeRO-1 rank its data slice of the
    moments and the EMA of that), fewer bytes than one process's."""
    cfg = tp["inputs"]["runs"][name]["cfg"]
    one = create_train_state(cfg, build_gan(cfg, "cpu"))
    mesh = Mesh(dp=dp, mp=mp, world=dp * mp)
    local = {}
    for net, flat in (("g", one.g_params), ("d", one.d_params)):
        layout = ModelLayout(mesh, flat.names, flat.full_shapes)
        assert any(d is not None for d in layout.dims)
        assert layout.local_numel < layout.full_numel
        local[net] = layout.local_numel
    zeroed = -(-local["g"] // dp) if zero else local["g"]
    want = {"g_params": local["g"], "d_params": local["d"], "ema_params": zeroed}
    for net in ("g", "d"):
        want[f"{net}_opt.mu"] = want[f"{net}_opt.nu"] = (-(-local[net] // dp) if zero
                                                          else local[net])
    for rank in tp["ranks"]:
        sizes = rank[name]["bytes"]
        for k, n in want.items():
            assert sizes[k] == 4 * n, (name, k)


def test_tp_checkpoints_cross_meshes(tp):
    """A (2, 2) ZeRO-1 checkpoint restores in one process bit for bit, and
    at (1, 2); a one-process checkpoint restores on (2, 2) bit for bit."""
    res = [r["tp_checkpoints"] for r in tp["ranks"]]
    at_save = tp["ranks"][0]["tp22_zero1"]["state"]
    tcfg = tp["tcfg"]
    state = create_train_state(tcfg, build_gan(tcfg, "cpu"))
    CheckpointManager(tp["inputs"]["tp_checkpoints"]["dir"]).restore(state)
    assert state.step == STEPS
    for k, t in state_tensors(state).items():
        assert torch.equal(t, at_save[k]), k
    for r in res[:2]:
        for k, t in at_save.items():
            assert torch.equal(r["restored_12"][k], t), k
    for r in res:
        for k, t in state_tensors(tp["one"]).items():
            assert torch.equal(r["one_restored"][k], t), k


def test_tp_step_equals_the_jax_sharded_step(tp):
    """The port's (2, 2) first step against one step of JAX's
    `make_sharded_train_step` on a (2, 2) mesh, same weights and draws."""
    _close([tp["ranks"][0]["tp22"]["metrics"][0]], [tp["ref"]["jax"]], 2e-4, 1e-5, "jax")
