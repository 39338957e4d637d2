"""Exported generators, counterpart of `locate_tpu/io/export.py`: the
`.npz` + `.json` pair that `locate-tpu export` writes, read by
`load_generator` and written by `export_generator` (in the JAX layout, so
the JAX package's `load_generator` reads the port's exports too).

`params_from_jax` is the function that carries weights across frameworks
(`flatten_tree` gives it a params pytree's arrays), `params_to_jax` its
exact inverse.
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
import os
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


def params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The inverse of `params_from_jax`: a port state_dict as f32 numpy
    arrays keyed by their `/`-joined JAX paths, conv kernels transposed
    OIHW -> HWIO."""
    flat = {}
    for name, t in state_dict.items():
        arr = t.detach().float().cpu().numpy()
        if name.rsplit(".", 1)[-1] == "w" and arr.ndim == 4:
            arr = np.transpose(arr, (2, 3, 1, 0))  # OIHW -> HWIO
        flat[name.replace(".", "/")] = np.ascontiguousarray(arr)
    return flat


def export_generator(model_cfg: ModelConfig, params: Mapping[str, torch.Tensor],
                     path: str) -> str:
    """Write `<path>.npz` (the generator's parameters, `params` a port
    state_dict such as `FlatParams.named(state.ema_params)`, in the JAX
    layout) and `<path>.json` (its model config); returns the `.npz`."""
    base = path[:-4] if path.endswith(".npz") else path
    os.makedirs(os.path.dirname(base) or ".", exist_ok=True)
    np.savez(base + ".npz", **params_to_jax(params))
    with open(base + ".json", "w") as f:
        json.dump(dataclasses.asdict(model_cfg), f, indent=2)
    return base + ".npz"


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
