"""Loading exported generators, counterpart of `locate_tpu/io/export.py`.

`params_from_jax` is the function that carries weights across frameworks
(`flatten_tree` gives it a params pytree's arrays).
It takes the JAX generator's params as numpy arrays keyed by their pytree
path, joined with `/` (the `.npz` that `locate-tpu export` writes) or `.`
(the `--torch=PATH.pt` state_dict of `locate_tpu/io/torch_bridge.py`), and
returns the port's state_dict: conv kernels transposed HWIO -> OIHW, dense
`w` kept [in, out], norm scale/bias, biases and class embeddings unchanged
(the torch_bridge convention, copied here rather than imported).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from locate_tpu_torch.config import AttentionConfig, ModelConfig, StyleConfig
from locate_tpu_torch.device import resolve_device
from locate_tpu_torch.models.generator import Generator, build_generator


def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """A params pytree of nested dicts and lists (JAX arrays or numpy) as
    numpy arrays keyed by their `/`-joined path, the layout of the `.npz`
    that `locate-tpu export` writes."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_tree(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten_tree(v, f"{prefix}{i}/"))
    else:
        out[prefix.rstrip("/")] = np.asarray(tree)
    return out


def params_from_jax(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    sd = {}
    for key, arr in flat.items():
        name = key.replace("/", ".")
        arr = np.asarray(arr)
        if arr.dtype.kind == "V" or str(arr.dtype) == "bfloat16":
            arr = arr.astype(np.float32)
        if name.rsplit(".", 1)[-1] == "w" and arr.ndim == 4:
            arr = np.transpose(arr, (3, 2, 0, 1))  # HWIO -> OIHW
        sd[name] = torch.from_numpy(np.array(arr, copy=True))
    return sd


def _load_model_config(path: str) -> ModelConfig:
    """The ModelConfig of an exported generator's `.json` sidecar."""
    base = path[:-4] if path.endswith(".npz") else path
    with open(base + ".json") as f:
        raw = json.load(f)
    raw["attention"] = AttentionConfig(**raw["attention"])
    if isinstance(raw.get("style"), dict):
        raw["style"] = StyleConfig(**raw["style"])
    if isinstance(raw.get("attention_stages"), list):
        raw["attention_stages"] = tuple(raw["attention_stages"])
    return ModelConfig(**raw)


def load_generator(path: str, device=None, compute_dtype=None,
                   use_pallas: Optional[bool] = None) -> Generator:
    """Load the `<path>.npz` + `<path>.json` pair that `locate-tpu export`
    writes into a port generator on `device` (the card unless "cpu").
    `use_pallas`, when given, replaces the exported config's value."""
    device = resolve_device(device)
    base = path[:-4] if path.endswith(".npz") else path
    cfg = _load_model_config(base)
    if use_pallas is not None:
        cfg = dataclasses.replace(cfg, use_pallas=use_pallas)
    gen = build_generator(cfg, compute_dtype, device)
    with np.load(base + ".npz") as npz:
        gen.load_state_dict(params_from_jax(dict(npz)))
    return gen
