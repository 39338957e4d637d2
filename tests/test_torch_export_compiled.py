"""The compiled serving artifact of the port (`io/export.py`:
`export_compiled` / `load_compiled`) and the fourteen kernels as
`torch.ops.locate.*` ops, on the CPU at the tiny config in f32.

Each op passes `torch.library.opcheck`'s schema and fake-tensor checks. The
artifact equals the port's eager generator bitwise and the JAX package's
own artifact (`locate_tpu/io/export.py:export_compiled`) within 2e-4, the
tolerance of `tests/test_model_parity_torch.py`, on weights from
`gan.init(PRNGKey(0))` (zero-init leaves filled) carried across by
`params_from_jax`. The fused-stage generators (softmax and sigmoid, fusion
forced) and the self-attention generator export with their ops in the
graph, and `load_compiled` runs in a process that loads no model code."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import jax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from locate_tpu.io.export import export_compiled as jax_export_compiled
from locate_tpu.io.export import load_compiled as jax_load_compiled
from locate_tpu.models.gan import build_gan
from locate_tpu_torch.io.export import export_compiled, load_compiled
from locate_tpu_torch.models.generator import build_generator
from locate_tpu_torch.nn import blocks
from locate_tpu_torch.ops import flash_attention as fl
from locate_tpu_torch.ops import fused_attention as fa
from locate_tpu_torch.ops import fused_stage as fs
from torch_port_parity import as_state_dict, port_config, randomize_zero_init
from torch_threads import on_one_thread

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 3
TOL = 2e-4
OPS = ("flash_fwd", "flash_dq", "flash_dkv", "softmax_gate_stats", "softmax_gate_apply",
       "softmax_gate_csum", "softmax_gate_backward", "sigmoid_gate", "sigmoid_gate_backward",
       "stage_conv", "stage_sigmoid", "stage_softmax_stats", "stage_softmax_apply_pool",
       "stage_conv_bwd")


def _rand(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def op_args(name):
    """Arguments of `torch.ops.locate.<name>` at tiny shapes: attention
    (B, T, dh, dv) = (2, 16, 8, 16); the gate (N, HW, C, Hd) = (2, 16, 8, 4);
    the stage (N, H, W, C, Co, Hd) = (2, 8, 8, 8, 16, 4) with its 1x1 skip."""
    rng = np.random.default_rng(0)
    q, k, v, do = _rand(rng, 2, 16, 8), _rand(rng, 2, 16, 8), _rand(rng, 2, 16, 16), \
        _rand(rng, 2, 16, 16)
    ell, delta = _rand(rng, 2, 16), _rand(rng, 2, 16)
    x2d, dy2d = _rand(rng, 2, 16, 8), _rand(rng, 2, 16, 8)
    gate = [_rand(rng, 16, 4), _rand(rng, 8, 4), _rand(rng, 4), _rand(rng, 4, 8), _rand(rng, 8)]
    m, se = fa.softmax_gate_stats_reference(x2d, *gate, act="leaky_relu", leaky_slope=0.2)
    stats = (x2d, *gate, "leaky_relu", 0.2)
    apply = ("leaky_relu", 0.2, 16.0, 1.5, None)
    x, dw = _rand(rng, 2, 8, 8, 8), _rand(rng, 2, 8, 8, 16)
    a, b = _rand(rng, 2, 8), _rand(rng, 2, 8)
    wr, wc, bc, ws = _rand(rng, 3, 8, 16), _rand(rng, 3, 16, 16), _rand(rng, 16), \
        _rand(rng, 8, 16)
    sgate = [_rand(rng, 64, 4), _rand(rng, 16, 4), _rand(rng, 4), _rand(rng, 4, 16),
             _rand(rng, 16)]
    w_pre = _rand(rng, 2, 8, 8, 16)
    sm, sse = fa.softmax_gate_stats_reference(w_pre.reshape(2, 64, 16), *sgate,
                                              act="leaky_relu", leaky_slope=0.2)
    conv = (x, a, b, wr, wc, bc, ws)
    return {
        "flash_fwd": (q, k, v, 0.5, None),
        "flash_dq": (q, k, v, do, ell, delta, 0.5, None),
        "flash_dkv": (q, k, v, do, ell, delta, 0.5, None),
        "softmax_gate_stats": (*stats, None),
        "softmax_gate_apply": (x2d, *gate, m, se, *apply),
        "softmax_gate_csum": (x2d, dy2d, *gate, m, se, *apply),
        "softmax_gate_backward": (x2d, dy2d, *gate, m, se, _rand(rng, 2, 1, 8), *apply),
        "sigmoid_gate": (*stats, 1.5, None),
        "sigmoid_gate_backward": (x2d, dy2d, *gate, "leaky_relu", 0.2, 1.5, None),
        "stage_conv": (*conv, "leaky_relu", 0.2, False, True, None),
        "stage_sigmoid": (*conv, *sgate, "leaky_relu", 0.2, 1.5, False, False, None),
        "stage_softmax_stats": (*conv, *sgate, "leaky_relu", 0.2, False, None),
        "stage_softmax_apply_pool": (w_pre, *sgate, sm, sse, "leaky_relu", 0.2, 64.0, 1.5,
                                     None),
        "stage_conv_bwd": (x, dw, a, b, wr, wc, ws, "leaky_relu", 0.2, False, None),
    }[name]


@pytest.mark.parametrize("name", OPS)
def test_opcheck(name):
    """Each kernel's op: its schema (no output aliases an input) and its
    fake implementation (the CPU outputs' shapes, dtypes and strides)."""
    torch.library.opcheck(getattr(torch.ops.locate, name).default, op_args(name),
                          test_utils=("test_schema", "test_faketensor"))


def test_the_fourteen_ops_are_registered_beside_their_wrappers():
    wrappers = {fl: OPS[:3], fa: OPS[3:9], fs: OPS[9:]}
    for module, names in wrappers.items():
        for name in names:
            assert hasattr(getattr(module, name), "launches")
            assert torch.ops.locate.__getattr__(name).default.namespace == "locate"


class OpLog(TorchDispatchMode):
    """The `torch.ops.locate.*` ops an eager forward dispatches, in order."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "locate":
            self.names.append(func._opname)
        return func(*args, **(kwargs or {}))


def graph_ops(path):
    program = torch.export.load(path)
    return [n.target._opname for n in program.graph.nodes
            if n.op == "call_function" and getattr(n.target, "namespace", None) == "locate"]


def jax_case(kind):
    """(JAX gan, generator params with zero-init leaves filled, port model
    config) of the tiny config, use_pallas on: the JAX gates run their
    Pallas kernels in interpret mode, the port's its ops' plain versions."""
    from locate_tpu.config import AttentionConfig, Config, DataConfig, ModelConfig, StyleConfig
    from locate_tpu.config import TrainConfig

    model = ModelConfig(resolution=16, base_channels=32, max_channels=32, min_channels=16,
                        latent_dim=16, attention=AttentionConfig(pos_features=4, bottleneck=2),
                        use_pallas=True)
    if kind == "conditional":
        model = dataclasses.replace(model, num_classes=3)
    if kind == "style":
        model = dataclasses.replace(model, arch="style",
                                    style=dataclasses.replace(model.style, mapping_layers=2))
    cfg = Config(name="tiny", model=model, data=DataConfig(dataset="synthetic", resolution=16),
                 train=TrainConfig(global_batch=8, compute_dtype="float32"), workdir="/tmp/x")
    gan = build_gan(cfg)
    params = randomize_zero_init(gan.init(jax.random.PRNGKey(0))["generator"],
                                 jax.random.PRNGKey(5))
    return gan, params, port_config(gan.config)


def latents(seed=1, batch=BATCH):
    return np.random.default_rng(seed).standard_normal((batch, 16)).astype(np.float32)


@pytest.mark.parametrize("kind", ["unconditional", "conditional", "style"])
@on_one_thread
def test_artifact_equals_eager_and_the_jax_artifact(kind, tmp_path):
    """The port's artifact equals its eager generator bitwise, and the JAX
    package's artifact within 2e-4. JAX's `export_compiled` cannot trace a
    class-conditional generator (it bakes the params in as numpy arrays,
    which a traced label array cannot index), so there the port's artifact
    is held against the JAX generator's jitted apply."""
    gan, params, cfg = jax_case(kind)
    sd = {k: torch.from_numpy(v) for k, v in as_state_dict(params).items()}
    path = export_compiled(cfg, sd, str(tmp_path / "gen"), batch=BATCH,
                           compute_dtype="float32", device="cpu")
    assert path == str(tmp_path / "gen.pt2")
    fn, sig = load_compiled(path)
    assert sig == {"batch": BATCH, "latent_dim": 16, "num_classes": cfg.num_classes,
                   "resolution": 16, "platforms": ["cpu"]}
    z = latents()
    args = (torch.from_numpy(z),)
    jargs = (z,)
    if cfg.num_classes:
        labels = np.array([0, 2, 1], np.int32)
        args += (torch.from_numpy(labels.astype(np.int64)),)
        jargs += (labels,)
    gen = build_generator(cfg, "float32", "cpu").eval()
    gen.load_state_dict(sd)
    with torch.no_grad():
        eager = gen(*args)
    got = fn(*args)
    assert got.dtype == torch.float32 and got.shape == (BATCH, 16, 16, 3)
    assert torch.equal(got, eager)
    if cfg.num_classes:
        want = jax.jit(gan.generator.apply)(params, *jargs)
    else:
        call, jsig = jax_load_compiled(jax_export_compiled(gan.config, params,
                                                           str(tmp_path / "jax_gen"),
                                                           batch=BATCH))
        assert {k: jsig[k] for k in ("batch", "latent_dim", "num_classes", "resolution")} == \
            {k: sig[k] for k in ("batch", "latent_dim", "num_classes", "resolution")}
        want = call(*jargs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), atol=TOL, rtol=TOL)
    if kind != "unconditional":
        assert "softmax_gate_stats" in graph_ops(path)


FORCED = {"softmax": dict(mode="softmax"), "sigmoid": dict(mode="sigmoid"),
          "self": dict(kind="self")}
FORCED_OPS = {"softmax": {"stage_softmax_stats", "softmax_gate_apply"},
              "sigmoid": {"stage_sigmoid"}, "self": {"stage_conv", "flash_fwd"}}


@pytest.mark.parametrize("flavor", list(FORCED))
@on_one_thread
def test_fused_generators_export_through_their_ops(flavor, tmp_path, monkeypatch):
    """With every stage flavor fused (`FUSE_MIN_LOCATIONS = 0`) the softmax
    and sigmoid generators, and the self-attention generator, export; the
    graph holds the `torch.ops.locate.*` calls of the eager forward, in
    its order, and the artifact equals the eager generator bitwise."""
    from locate_tpu_torch.config import AttentionConfig, ModelConfig

    monkeypatch.setattr(blocks, "FUSE_MIN_LOCATIONS", 0)
    cfg = ModelConfig(resolution=16, base_channels=32, max_channels=32, min_channels=16,
                      latent_dim=16, use_pallas=True,
                      attention=AttentionConfig(pos_features=4, bottleneck=2, **FORCED[flavor]))
    gen = build_generator(cfg, "float32", "cpu", seed=3).eval()
    with torch.no_grad():  # the zero-init logits and gamma filled: every gate is live
        for name, p in gen.named_parameters():
            if not p.any():
                p.copy_(torch.randn(p.shape, generator=torch.Generator().manual_seed(7)) * 0.2)
    path = export_compiled(cfg, gen.state_dict(), str(tmp_path / "gen"), batch=2,
                           compute_dtype="float32", device="cpu")
    fn, _ = load_compiled(path)
    z = torch.from_numpy(latents(2, batch=2))
    log = OpLog()
    with torch.no_grad(), log:
        eager = gen(z)
    assert FORCED_OPS[flavor] <= set(log.names)
    assert graph_ops(path) == log.names
    assert torch.equal(fn(z), eager)


CHILD = """
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from locate_tpu_torch.ops import flash_attention, fused_attention, fused_stage
from locate_tpu_torch.io.export import load_compiled
fn, sig = load_compiled(sys.argv[1])
out = fn(torch.from_numpy(np.load(sys.argv[2])))
np.save(sys.argv[3], out.numpy())
try:
    fn(torch.zeros(sig["batch"] + 1, sig["latent_dim"]))
    wrong_batch = None
except ValueError as e:
    wrong_batch = str(e)
loaded = sorted(m for m in sys.modules
                if m.startswith(("locate_tpu_torch.models", "locate_tpu_torch.nn",
                                 "locate_tpu_torch.train"))
                or m.split(".")[0] in ("jax", "jaxlib", "locate_tpu"))
print(json.dumps({"loaded": loaded, "wrong_batch": wrong_batch}))
"""


@on_one_thread
def test_load_compiled_needs_no_model_code(tmp_path):
    """A process that imports torch, the three kernel modules and
    `load_compiled` runs the artifact (bitwise the parent's eager
    generator) without loading the models, the blocks or the train code,
    JAX or the JAX package; a wrong batch raises."""
    from locate_tpu_torch.config import AttentionConfig, ModelConfig

    cfg = ModelConfig(resolution=16, base_channels=32, max_channels=32, min_channels=16,
                      latent_dim=16, use_pallas=True,
                      attention=AttentionConfig(pos_features=4, bottleneck=2))
    gen = build_generator(cfg, "float32", "cpu", seed=4).eval()
    path = export_compiled(cfg, gen.state_dict(), str(tmp_path / "gen.npz"), batch=2,
                           compute_dtype="float32", device="cpu")
    assert path == str(tmp_path / "gen.pt2")
    assert "softmax_gate_apply" in graph_ops(path)
    z = latents(3, batch=2)
    np.save(tmp_path / "z.npy", z)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", CHILD, path, str(tmp_path / "z.npy"),
                           str(tmp_path / "out.npy")], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["loaded"] == []
    assert "exported at batch 2" in report["wrong_batch"]
    with torch.no_grad():
        eager = gen(torch.from_numpy(z))
    assert torch.equal(torch.from_numpy(np.load(tmp_path / "out.npy")), eager)


def test_a_card_artifact_refuses_a_host_without_a_card(tmp_path, monkeypatch):
    """The sidecar names the device the trace ran on; an artifact traced on
    the card raises where `torch.cuda.is_available()` is False."""
    base = tmp_path / "gen"
    (tmp_path / "gen.pt2.json").write_text(json.dumps(
        {"batch": 2, "latent_dim": 16, "num_classes": 0, "resolution": 16,
         "platforms": ["cuda"]}))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="traced on"):
        load_compiled(str(base) + ".pt2")
