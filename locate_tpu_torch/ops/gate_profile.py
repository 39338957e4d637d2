"""Kernel dispatch thresholds as data, counterpart of
`locate_tpu/ops/pallas/gate_profile.py`, measured on the card.

`gate_profile.json` beside this module holds:

- `min_locations`: for each stage flavor, the count of (fine) locations
  H*W at or above which `nn/blocks.py` runs a conv block through the fused
  stage instead of its layers one by one;
- `sigmoid_locations`: a list of ranges `{"min": lo, "max": hi}` of H*W in
  which a sigmoid `LocateAttention` layer runs its one-pass kernels (at
  `lo <= H*W <= hi` for some range) instead of the plain composition; one
  range where the kernels win on one run of the ladder, more where they
  lose between two;
- `meta`: the card, its power limit, the date and the script that
  measured them.

`scripts/torch_retune_gates.py --write` re-measures the ladder on the card
and rewrites the file under the rule "never slower than the alternative".

Flavors (`nn/blocks.py`'s dispatch sites):
    pair       conv block + location gate, no resample
    conv       conv block only, no resample
    up_pair    upsample + conv block + gate (a generator stage)
    up_conv    upsample + conv block
    down_pair  conv block + gate + 2x2 average pool (a discriminator stage)
    down_conv  conv block + 2x2 average pool

`LOCATE_TPU_TORCH_GATE_PROFILE=<path>` reads another file (a retune run's
output, a test's); `nn/blocks.py:FUSE_MIN_LOCATIONS`, set to an int,
overrides every flavor at once (tests and chip_smoke.py force fusion so).
"""

from __future__ import annotations

import functools
import json
import os
from typing import List, Tuple

FLAVORS = ("pair", "conv", "up_pair", "up_conv", "down_pair", "down_conv")
ENV = "LOCATE_TPU_TORCH_GATE_PROFILE"

_DEFAULT_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "gate_profile.json")


def profile_path() -> str:
    return os.environ.get(ENV, _DEFAULT_PATH)


@functools.lru_cache(maxsize=8)
def _load(path: str) -> dict:
    with open(path) as fh:
        prof = json.load(fh)
    missing = [f for f in FLAVORS if f not in prof.get("min_locations", {})]
    if missing:
        raise ValueError(f"gate profile {path} lacks min_locations for {missing}")
    ranges = prof.get("sigmoid_locations")
    if not isinstance(ranges, list) or not all({"min", "max"} <= set(r) for r in ranges):
        raise ValueError(f"gate profile {path} lacks sigmoid_locations, a list of "
                         "{min, max} ranges")
    return prof


def load() -> dict:
    """The active profile (cached per path)."""
    return _load(profile_path())


def min_locations(flavor: str) -> int:
    """The fused stage's threshold of H*W locations for a stage flavor."""
    return int(load()["min_locations"][flavor])


def sigmoid_ranges() -> List[Tuple[int, int]]:
    """[(lo, hi), ...]: the sigmoid gate runs its kernels where
    lo <= H*W <= hi for one of them."""
    return [(int(r["min"]), int(r["max"])) for r in load()["sigmoid_locations"]]


def sigmoid_fused(locations: int) -> bool:
    """Whether the sigmoid gate runs its kernels at H*W = `locations`."""
    return any(lo <= locations <= hi for lo, hi in sigmoid_ranges())


def reload() -> None:
    """Drop the cache (after a retune rewrote the file, or the override
    moved)."""
    _load.cache_clear()
