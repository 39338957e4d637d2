"""The port's generator against the JAX package's, end to end on the CPU in
float32: the same weights (carried across by `params_from_jax`, after
filling the zero-init logit convs), the same latents (numpy, seeded).
Tolerance 2e-4, as tests/test_model_parity_torch.py. Also the two ways
weights arrive from JAX (`locate-tpu export` .npz + .json, and the
`--torch` state_dict), and the port's CLI on the CPU."""

import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from locate_tpu.config import AttentionConfig as JaxAttentionConfig
from locate_tpu.config import ModelConfig as JaxModelConfig
from locate_tpu.io.export import _flatten, export_generator
from locate_tpu.io.sampling import to_uint8
from locate_tpu.io.torch_bridge import state_dict_from_params
from locate_tpu.models.generator import build_generator as jax_build_generator
from locate_tpu_torch import cli
from locate_tpu_torch import config as tconfig
from locate_tpu_torch.io.export import load_generator, params_from_jax
from locate_tpu_torch.io.sampling import to_uint8_tensor
from locate_tpu_torch.models.generator import build_generator

TOL = dict(rtol=2e-4, atol=2e-4)
BASE = dict(resolution=16, base_channels=32, max_channels=32, min_channels=16,
            latent_dim=12, blocks_per_stage=2)
ATTN = dict(pos_features=4, bottleneck=2, gate_max=16.0)
CASES = {
    "composed_classes": dict(use_pallas=False, num_classes=3, class_embed_dim=6),
    "pallas": dict(use_pallas=True),
}
_jax_runs = {}


def configs(**kw):
    fields = {**BASE, **kw}
    return (JaxModelConfig(**fields, attention=JaxAttentionConfig(**ATTN)),
            tconfig.ModelConfig(**fields, attention=tconfig.AttentionConfig(**ATTN)))


def randomize_zero_init(params, key):
    """Fill all-zero leaves (the logit convs, biases) with noise so the
    gates and biases are exercised (tests/test_model_parity_torch.py)."""
    leaves, treedef = jax.tree.flatten(params)
    keys = jax.random.split(key, len(leaves))
    out = [jnp.where(jnp.all(l == 0), jax.random.normal(k, l.shape) * 0.2, l)
           if l.ndim > 0 else l for l, k in zip(leaves, keys)]
    return jax.tree.unflatten(treedef, out)


def jax_run(case):
    """(params, z, labels, images) of the JAX generator, once per case."""
    if case not in _jax_runs:
        jcfg, _ = configs(**CASES[case])
        g = jax_build_generator(jcfg)
        params = randomize_zero_init(g.init(jax.random.PRNGKey(0)), jax.random.PRNGKey(5))
        z = np.random.default_rng(1).standard_normal((3, jcfg.latent_dim)).astype(np.float32)
        labels = np.array([0, 2, 1]) if jcfg.num_classes else None
        imgs = np.asarray(g.apply(params, jnp.asarray(z),
                                  None if labels is None else jnp.asarray(labels)))
        _jax_runs[case] = (params, z, labels, imgs)
    return _jax_runs[case]


def port_images(model, z, labels=None):
    with torch.inference_mode():
        return model(torch.from_numpy(z),
                     None if labels is None else torch.from_numpy(labels)).numpy()


@pytest.mark.parametrize("case", sorted(CASES))
def test_generator_matches_jax(case):
    params, z, labels, want = jax_run(case)
    _, tcfg = configs(**CASES[case])
    model = build_generator(tcfg, "float32", device="cpu")
    model.load_state_dict(params_from_jax(_flatten(jax.device_get(params))))
    got = port_images(model, z, labels)
    assert got.shape == want.shape == (3, 16, 16, 3)
    assert np.abs(want).max() > 0.1  # not a trivially flat image
    np.testing.assert_allclose(got, want, **TOL)


def test_export_and_torch_state_dict_load_the_same_weights(tmp_path):
    params, z, _, want = jax_run("pallas")
    jcfg, _ = configs(**CASES["pallas"])
    path = export_generator(jcfg, params, str(tmp_path / "gen"))
    model = load_generator(path, device="cpu", compute_dtype="float32")
    assert model.config.use_pallas
    got = port_images(model, z)
    np.testing.assert_allclose(got, want, **TOL)
    # the same uint8 images as the JAX sampler's host conversion
    got_u8 = to_uint8_tensor(torch.from_numpy(got)).numpy()
    want_u8 = to_uint8(want)
    assert np.abs(got_u8.astype(int) - want_u8.astype(int)).max() <= 1
    assert (got_u8 == want_u8).mean() > 0.99
    np.testing.assert_array_equal(to_uint8(got), got_u8)

    # `locate-tpu export --torch=PATH.pt` writes torch_bridge's state_dict
    pt = tmp_path / "gen.pt"
    torch.save(state_dict_from_params(params), pt)
    other = build_generator(model.config, "float32", device="cpu", seed=7)
    other.load_state_dict(torch.load(pt))
    np.testing.assert_array_equal(port_images(other, z), got)


TINY = ["model.base_channels=32", "model.max_channels=32", "model.min_channels=16",
        "model.latent_dim=16", "model.resolution=16", "data.resolution=16",
        "train.compute_dtype=float32"]


def test_bench_sample_cli_cpu(capsys):
    rc = cli.main(["bench-sample", "lsun_bedroom_128", *TINY, "use_pallas=true",
                   "--batch", "2", "--steps", "1", "--device=cpu"])
    assert rc == 0
    d = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert d["unit"] == "images/sec" and d["value"] > 0
    assert "cpu" in d["metric"] and d["weights"] == "init"


def test_sample_cli_cpu(tmp_path, capsys):
    params, _, _, _ = jax_run("pallas")
    jcfg, _ = configs(**CASES["pallas"])
    path = export_generator(jcfg, params, str(tmp_path / "gen"))
    out = tmp_path / "grid.png"
    rc = cli.main(["sample", "cifar10_32", f"--generator={path}", "--count=4",
                   f"--out={out}", "--device=cpu", "--truncation=1.5"])
    assert rc == 0 and out.is_file()
    from PIL import Image

    assert Image.open(out).size == (32, 32)  # 2x2 grid of 16x16 images


@pytest.mark.parametrize("override,message", [
    (dict(arch="style"), "style"),
    (dict(g_rgb="skip"), "skip"),
    (dict(attention=tconfig.AttentionConfig(kind="self")), "self"),
])
def test_unported_paths_raise(override, message):
    fields = {**BASE, "attention": tconfig.AttentionConfig(**ATTN), **override}
    with pytest.raises(NotImplementedError, match=message):
        model = build_generator(tconfig.ModelConfig(**fields), "float32", device="cpu")
        port_images(model, np.zeros((1, BASE["latent_dim"]), np.float32))


def test_fused_stage_resolution_raises(monkeypatch):
    """Where the JAX package's gate profile fuses a whole stage (>= 512^2
    locations with use_pallas, the ffhq_512 preset) the port builds the
    generator and runs that stage's upsample, conv block and gate through
    `fused_stage` (on the CPU its plain versions), and nothing is raised."""
    from locate_tpu_torch.nn import blocks

    cfg = tconfig.get_config("ffhq_512")
    model_cfg = tconfig.ModelConfig(**{
        **{f: getattr(cfg.model, f) for f in ("resolution", "attention")},
        "base_channels": 16, "max_channels": 16, "min_channels": 8,
        "use_pallas": cfg.use_pallas})
    model = build_generator(model_cfg, "float32", device="cpu")
    top = model.trunk[-1]
    assert isinstance(top, blocks.FusableStage)
    calls = []
    original = blocks.fused_stage
    monkeypatch.setattr(blocks, "fused_stage",
                        lambda *a, **kw: calls.append(kw) or original(*a, **kw))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 256, 256, 8))
                         .astype(np.float32))
    with torch.no_grad():
        y = top(x)
    assert y.shape == (1, 512, 512, 8) and bool(torch.isfinite(y).all())
    assert len(calls) == 1 and calls[0]["upsample"] and calls[0]["mode"] == "softmax"
