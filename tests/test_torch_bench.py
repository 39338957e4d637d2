"""The port's `bench` command (the counterpart of bench.py) on the CPU: one
JSON line from a full-width lsun_bedroom_128 train step at batch 1, one
step a call; one JSON line from several steps a call (spc=2, cut to
16x16), with the one-step-a-call rate beside it; and every config bench
builds, the modes the port does not run included (the guard against
bench.py's round-5 override crash, where a config the bench built could
not be built)."""

import json

import pytest
import torch

from locate_tpu_torch import cli


@pytest.fixture
def two_threads():
    """A full-width step on the CPU, beside other test workers: two
    threads each keep the workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def test_bench_prints_one_json_line(capsys, two_threads):
    assert cli.main(["bench", "1", "1", "spc=1", "--device=cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    d = json.loads(lines[0])
    assert d["unit"] == "images/sec" and d["value"] > 0 and d["batch"] == 1
    assert d["use_pallas"] is True and "cpu" in d["metric"] and d["device"] == "cpu"
    # G and D forward and backward at 128^2: tens of GFLOP per image
    assert d["flops_per_step"] > 1e10
    assert d["mfu"] is None  # no tensor-core peak for a CPU rate
    assert d["steps_per_call"] == 1 and "single_step_images_per_sec" not in d


@pytest.mark.parametrize("modes", [[], ["xla"], ["fused"], ["e2e"], ["spc=16"],
                                   ["xla", "spc=16"], ["fused", "spc=4"],
                                   ["e2e", "spc=16"]])
def test_every_bench_config_builds(modes):
    cfg = cli.bench_config(128, modes)
    t = cfg.train
    assert cfg.name == "lsun_bedroom_128" and cfg.data.resolution == 128
    assert t.global_batch == 128 and t.compute_dtype == "bfloat16"
    assert cfg.use_pallas == ("xla" not in modes)
    assert t.fused_step == ("fused" in modes)
    assert (t.r1_gamma, t.ada_target, t.augment_p, t.lecam_gamma, t.grad_norm_limit,
            t.max_nonfinite_skips) == (0.0, 0.0, 0.0, 0.0, 0.0, 0)
    spc = [int(m[4:]) for m in modes if m.startswith("spc=")]
    # bench.py's default: 16 steps a call, one for e2e
    assert t.steps_per_call == (spc[0] if spc else 1 if "e2e" in modes else 16)
    assert cfg.parallel.data_parallel == 1


@pytest.mark.parametrize("modes,message", [(["fused"], "fused"), (["e2e"], "data pipeline")])
def test_unported_bench_modes_raise(modes, message):
    with pytest.raises(NotImplementedError, match=message):
        cli.main(["bench", "1", "1", *modes, "--device=cpu"])


def test_bench_several_steps_a_call(capsys, two_threads):
    """`bench 1 2 spc=2` (make_multi_step: two steps a call) prints one
    JSON line with steps_per_call 2 and the one-step-a-call rate beside
    the headline, on one flop count; cut to 16x16 to stay quick."""
    small = ["model.resolution=16", "data.resolution=16", "model.base_channels=32",
             "model.max_channels=32", "model.min_channels=16"]
    assert cli.main(["bench", "1", "2", "spc=2", "--device=cpu", *small]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    d = json.loads(lines[0])
    assert d["steps_per_call"] == 2 and d["value"] > 0
    assert d["single_step_images_per_sec"] > 0 and d["single_step_mfu"] is None
    assert "16x16" in d["metric"] and d["flops_per_step"] > 0


def test_bench_config_takes_overrides_last():
    """`bench [batch] [steps] key=value ...`: config overrides, applied
    after bench's own pins."""
    cfg = cli.bench_config(64, ["xla"], {"model.attention.kind": "self",
                                         "model.attention_stages": "4,8,16,32,64",
                                         "train.r1_gamma": "1.0"})
    assert cfg.model.attention.kind == "self" and not cfg.use_pallas
    assert cfg.model.attention_at(64) and not cfg.model.attention_at(128)
    assert cfg.train.r1_gamma == 1.0 and cfg.train.global_batch == 64


def test_bench_refuses_unknown_arguments():
    with pytest.raises(SystemExit, match="unknown argument"):
        cli.main(["bench", "1", "1", "lsun_bedroom_128", "--device=cpu"])
