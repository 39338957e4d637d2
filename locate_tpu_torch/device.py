"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: a missing
card is an error, never a silent fall back to the CPU (a CPU run would be
reported under the card's name)."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """`None` means "cuda". A CUDA device without a visible card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r} (cuda or cpu)")
    return dev


def device_name(device: torch.device) -> str:
    """The card's name, or "cpu": every result names where it ran."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"
