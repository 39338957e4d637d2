"""The port's config is a copy of the JAX package's: for every preset,
with and without overrides, `get_config` gives equal dataclass dicts."""

import dataclasses

import pytest

from locate_tpu import config as jax_config
from locate_tpu_torch import config as torch_config

OVERRIDES = {
    "none": None,
    "model": {"model.resolution": "64", "model.attention.gate_max": "8",
              "model.attention.per_channel": "false", "model.act": "gelu",
              "model.attention_stages": "8,16", "use_pallas": "true"},
    # steps_per_call only validates once log_every is a multiple of it:
    # the fixed-point loop must reach the same config in both packages
    "fixed_point": {"train.steps_per_call": "4", "train.log_every": "100",
                    "train.sample_every": "400", "train.checkpoint_every": "400",
                    "train.total_steps": "800", "train.compute_dtype": "float32"},
}


def test_same_presets():
    assert sorted(jax_config.PRESETS) == sorted(torch_config.PRESETS)


@pytest.mark.parametrize("ov", sorted(OVERRIDES))
@pytest.mark.parametrize("preset", sorted(jax_config.PRESETS))
def test_get_config_matches(preset, ov):
    overrides = OVERRIDES[ov]
    want = dataclasses.asdict(jax_config.get_config(preset, overrides))
    got = dataclasses.asdict(torch_config.get_config(preset, overrides))
    assert got == want


def test_invalid_override_raises_alike():
    bad = {"train.steps_per_call": "3", "train.log_every": "100"}
    with pytest.raises(ValueError) as want:
        jax_config.get_config("cifar10_32", bad)
    with pytest.raises(ValueError) as got:
        torch_config.get_config("cifar10_32", bad)
    assert str(got.value) == str(want.value)


def test_parse_cli_overrides_matches():
    argv = ["model.resolution=64", "train.lr = 1e-3", "use_pallas=true"]
    assert (torch_config.parse_cli_overrides(argv)
            == jax_config.parse_cli_overrides(argv))
