"""The port's entry points run on the card by default: on a machine
without one they raise unless the caller asks for the CPU, and nothing
falls back to the CPU or to the plain version by itself."""

import pytest
import torch

from locate_tpu_torch import cli
from locate_tpu_torch import config as tconfig
from locate_tpu_torch.device import resolve_device
from locate_tpu_torch.io.export import load_generator
from locate_tpu_torch.models.generator import build_generator
from locate_tpu_torch.ops import fused_attention as tfa

TINY = tconfig.ModelConfig(resolution=8, base_channels=16, max_channels=16,
                           min_channels=8, latent_dim=4)


@pytest.fixture
def no_card(monkeypatch):
    """Pretend there is no card, whatever machine runs the test."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_is_cuda(no_card):
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device()
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_build_generator_needs_a_card_or_cpu(no_card):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_generator(TINY)
    model = build_generator(TINY, device="cpu")
    assert all(p.device.type == "cpu" for p in model.parameters())


def test_load_generator_needs_a_card_or_cpu(no_card, tmp_path):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_generator(str(tmp_path / "missing.npz"))


@pytest.mark.parametrize("command", [
    ["bench-sample", "cifar10_32", "--batch=1", "--steps=1"],
    ["sample", "cifar10_32", "--generator=missing.npz"],
])
def test_cli_needs_a_card_or_cpu(no_card, command):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(command)


def test_cli_unported_flags_raise():
    for flag in ("--dp", "--checkpoint=runs/x"):
        with pytest.raises(SystemExit, match="slice"):
            cli.main(["bench-sample", "cifar10_32", flag, "--device=cpu"])


def test_kernel_wrappers_refuse_other_devices():
    x = torch.zeros((1, 4, 8), device="meta")
    ops = [torch.zeros(s, device="meta") for s in ((4, 8), (8, 8), (8,), (8, 8), (8,))]
    with pytest.raises(ValueError, match="no kernel"):
        tfa.softmax_gate_stats(x, *ops, act="leaky_relu", leaky_slope=0.2)
