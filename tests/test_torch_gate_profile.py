"""The port's dispatch thresholds as data (`locate_tpu_torch/ops/gate_profile.py`
and its JSON), the two dispatch sites that read them (`nn/blocks.py`,
`ops/attention.py`) and scripts/torch_retune_gates.py's rules, held against
the JAX package's rule (scripts/retune_gates.py, run on made-up timings)."""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from locate_tpu_torch.config import AttentionConfig, get_config
from locate_tpu_torch.models.gan import model_config
from locate_tpu_torch.nn import blocks
from locate_tpu_torch.ops import gate_profile
from locate_tpu_torch.ops.attention import LocateAttention

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts",
                                                                     f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def profile_file(tmp_path, monkeypatch):
    """Write a profile (the shipped one with `changes`) and point
    LOCATE_TPU_TORCH_GATE_PROFILE at it."""
    def write(**changes):
        path = tmp_path / "gate_profile.json"
        path.write_text(json.dumps(dict(gate_profile.load(), **changes)))
        monkeypatch.setenv(gate_profile.ENV, str(path))
        gate_profile.reload()  # the file at this path changed
        return path
    yield write
    gate_profile.reload()


def test_defaults_load():
    """The shipped profile: every flavor, the sigmoid gate's ranges, and the
    card and power limit it was measured on."""
    assert gate_profile.profile_path().endswith(os.path.join("ops", "gate_profile.json"))
    prof = gate_profile.load()
    assert set(prof["min_locations"]) == set(gate_profile.FLAVORS)
    assert all(gate_profile.min_locations(f) > 0 for f in gate_profile.FLAVORS)
    assert all(lo <= hi for lo, hi in gate_profile.sigmoid_ranges())
    meta = prof["meta"]
    assert meta["source"] == "scripts/torch_retune_gates.py"
    assert "H100" in meta["device"] and meta["nvidia_smi"].endswith(" W")
    assert meta["stage_measurements"] and meta["sigmoid_measurements"]


def test_env_override(profile_file):
    path = profile_file(min_locations={f: 7 for f in gate_profile.FLAVORS},
                        sigmoid_locations=[{"min": 3, "max": 5}])
    assert gate_profile.profile_path() == str(path)
    assert gate_profile.min_locations("down_pair") == 7
    assert gate_profile.sigmoid_ranges() == [(3, 5)]
    assert gate_profile.sigmoid_fused(4) and not gate_profile.sigmoid_fused(6)


@pytest.mark.parametrize("broken", ["flavor", "sigmoid"])
def test_a_missing_entry_raises(profile_file, broken):
    if broken == "flavor":
        mins = {f: 1 for f in gate_profile.FLAVORS if f != "up_conv"}
        profile_file(min_locations=mins)
        match = "up_conv"
    else:
        profile_file(sigmoid_locations={"min": 0, "max": 1})
        match = "sigmoid_locations"
    with pytest.raises(ValueError, match=match):
        gate_profile.load()


def test_fuse_min_locations_wins(monkeypatch, profile_file):
    profile_file(min_locations={f: 1 << 40 for f in gate_profile.FLAVORS})
    assert blocks.fuse_threshold("pair") == 1 << 40
    monkeypatch.setattr(blocks, "FUSE_MIN_LOCATIONS", 0)
    assert all(blocks.fuse_threshold(f) == 0 for f in gate_profile.FLAVORS)


def test_dispatch_sites_read_the_profile(profile_file):
    """A FusableStage's plan and a sigmoid LocateAttention's dispatch follow
    the profile in force, flavor by flavor."""
    cfg = model_config(get_config("ffhq_512", {"model.base_channels": "32",
                                               "model.max_channels": "32",
                                               "model.min_channels": "16"}))
    with torch.device("meta"):
        g_stage = blocks.generator_stage(16, 16, 64, cfg, first=False)
        d_stage = blocks.discriminator_stage(16, 16, 64, cfg, last=False)
    mins = {f: 1 << 40 for f in gate_profile.FLAVORS}
    profile_file(min_locations=dict(mins, up_pair=64 * 64))
    assert [c[0] for c in g_stage.plan(32, 32)] == ["up_pair"]
    assert [c[0] for c in d_stage.plan(64, 64)] == [None, None, None]
    profile_file(min_locations=dict(mins, up_pair=128 * 128, down_pair=64 * 64),
                 sigmoid_locations=[{"min": 16, "max": 16}, {"min": 1024, "max": 4096}])
    assert [c[0] for c in g_stage.plan(32, 32)] == [None, None, None]
    assert [c[0] for c in d_stage.plan(64, 64)] == ["down_pair"]
    layer = LocateAttention(8, AttentionConfig(mode="sigmoid"), use_pallas=True,
                            gen=torch.Generator(device="cpu"))
    assert [layer.fused_profitable(hw) for hw in (16, 64, 256, 1024, 4096, 16384)] == [
        True, False, False, True, True, False]


def test_plan_is_what_forward_runs(monkeypatch, profile_file):
    """`FusableStage.forward` runs `plan`'s calls: an unfused upsample
    alone, then its conv block as a plain flavor where that one fuses."""
    calls = []
    monkeypatch.setattr(blocks, "_apply_fused_stage",
                        lambda cfg, block, attn, x, cd, up, dn: calls.append((up, dn)) or x)
    mins = {f: 1 << 40 for f in gate_profile.FLAVORS}
    profile_file(min_locations=dict(mins, pair=1))
    cfg = model_config(get_config("ffhq_512", {"model.base_channels": "16",
                                               "model.max_channels": "16",
                                               "model.min_channels": "16"}))
    stage = blocks.generator_stage(16, 16, 8, cfg, first=False,
                                   gen=torch.Generator(device="cpu"))
    plan = stage.plan(4, 4)
    assert [(c[0], c[1], c[2], c[3]) for c in plan] == [(None, 0, 1, 4), ("pair", 1, 2, 8)]
    with torch.no_grad():
        stage(torch.zeros(1, 4, 4, 16))
    assert calls == [(False, False)]


def jax_rule(ladder, times, out):
    """scripts/retune_gates.py's thresholds for made-up times: its main()
    with the timing, the operands and the stage functions stubbed."""
    jr = script("retune_gates")
    jr.timed_grad = lambda fn, ops, iters, reps: times[fn]
    jr.make_ops = lambda key, n, res, c, mode, upsample: None
    jr.stage_fn = lambda impl, mode, res, up, down, interpret: (impl, mode, res, up, down)
    argv = sys.argv
    sys.argv = ["retune_gates.py", "--out", str(out),
                "--ladder", ",".join(f"{r}:64:16" for r in ladder)]
    try:
        jr.main()
    finally:
        sys.argv = argv
    return json.loads(out.read_text())["min_locations"]


@pytest.mark.parametrize("seed", range(4))
def test_threshold_rule_agrees_with_jax(seed, tmp_path):
    """On made-up ladders (each rung won, lost or tied by either mode) the
    port's `min_locations_rule` gives the JAX script's thresholds."""
    rt = script("torch_retune_gates")
    rng = np.random.default_rng(seed)
    ladder = [64, 128, 256, 512]
    times, rows = {}, {}
    for flavor, (modes, up, down) in rt.FLAVOR_SPECS.items():
        for mode in modes:
            for res in ladder:
                fused = float(rng.uniform(1.0, 2.0))
                unfused = fused * float(rng.choice([0.5, 1.0, 1.01, 1.03, 2.0]))
                times[("pallas", mode, res, up, down)] = fused / 1e3
                times[("xla", mode, res, up, down)] = unfused / 1e3
                rows.setdefault(flavor, []).append((res, fused, unfused))
    want = jax_rule(ladder, times, tmp_path / "profile.json")
    got = {f: rt.min_locations_rule(r, 0.02, ladder) for f, r in rows.items()}
    assert got == want


def test_sigmoid_ranges_rule():
    rt = script("torch_retune_gates")
    rows = [(16, 1.0, 1.06), (64, 1.0, 0.5), (256, 1.0, 0.9), (1024, 1.0, 2.4),
            (4096, 1.0, 3.0), (262144, 1.0, 4.8)]
    assert rt.sigmoid_ranges_rule(rows, 0.02) == [{"min": 16, "max": 16},
                                                  {"min": 1024, "max": 262144}]
    assert rt.sigmoid_ranges_rule([(16, 1.0, 1.01), (64, 1.0, 0.9)], 0.02) == []
    assert rt.sigmoid_ranges_rule([(64, 1.0, 2.0), (16, 1.0, 2.0)], 0.02) == [
        {"min": 16, "max": 64}]
