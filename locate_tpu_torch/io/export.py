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

`export_compiled` writes the compiled serving artifact, the counterpart
of the JAX package's StableHLO export: the generator traced by
`torch.export` at one fixed batch with its weights inside, saved as a
`.pt2`, and `load_compiled` runs it with no model code and no weights
file. The model code is imported only by the functions that build a
generator.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from locate_tpu_torch.config import AttentionConfig, ModelConfig, StyleConfig
from locate_tpu_torch.device import resolve_device


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
                   use_pallas: Optional[bool] = None) -> torch.nn.Module:
    """Load the `<path>.npz` + `<path>.json` pair that `locate-tpu export`
    writes into a port generator on `device` (the card unless "cpu").
    `use_pallas`, when given, replaces the exported config's value."""
    from locate_tpu_torch.models.generator import build_generator

    device = resolve_device(device)
    base = path[:-4] if path.endswith(".npz") else path
    cfg = _load_model_config(base)
    if use_pallas is not None:
        cfg = dataclasses.replace(cfg, use_pallas=use_pallas)
    gen = build_generator(cfg, compute_dtype, device)
    with np.load(base + ".npz") as npz:
        gen.load_state_dict(params_from_jax(dict(npz)))
    return gen


def _artifact_base(path: str) -> str:
    for suffix in (".pt2", ".npz"):
        if path.endswith(suffix):
            return path[:-len(suffix)]
    return path


def export_compiled(model_cfg: ModelConfig, params: Mapping[str, torch.Tensor], path: str,
                    batch: int = 64, compute_dtype=None, device=None) -> str:
    """Write the compiled serving artifact of the generator `model_cfg`
    describes with the weights `params` (a port state_dict): the
    generator, built on `device` (the card unless "cpu") in eval mode, is
    traced by `torch.export.export` under `torch.no_grad()` at the fixed
    `batch` (no dynamic shapes), the port's counterpart of the JAX
    package's fixed-batch `jax.export`. Returns the `.pt2` path.

    Writes `<base>.pt2` (`torch.export.save`, the weights inside) and
    `<base>.pt2.json` (the call's signature: batch, latent_dim,
    num_classes, resolution, and `platforms`, the device type it was
    traced on). The artifact takes (z) or, with num_classes > 0,
    (z, labels), and returns the NHWC images in the compute dtype.

    What the trace fixes and what the run decides: the stage dispatch
    (`nn/blocks.py:FusableStage.plan` under `ops/gate_profile.json` or
    `FUSE_MIN_LOCATIONS`, and `LocateAttention`'s fused or composed path)
    is decided when the artifact is traced, in the tracing process; each
    kernel is a `torch.ops.locate.*` node whose route, tile and grid are
    decided when the artifact runs, as the eager wrappers decide them. A
    style generator is traced through its plain `forward(z, labels)`: no
    truncation and no random noise are in the artifact. An artifact
    traced on the card holds CUDA tensors and runs only on a card."""
    from locate_tpu_torch.models.generator import build_generator

    device = resolve_device(device)
    base = _artifact_base(path)
    os.makedirs(os.path.dirname(base) or ".", exist_ok=True)
    gen = build_generator(model_cfg, compute_dtype, device)
    gen.load_state_dict(dict(params))
    gen.eval()
    args = (torch.zeros((batch, model_cfg.latent_dim), dtype=torch.float32, device=device),)
    if model_cfg.num_classes > 0:
        args += (torch.zeros((batch,), dtype=torch.int64, device=device),)
    with torch.no_grad():
        program = torch.export.export(gen, args)
    torch.export.save(program, base + ".pt2")
    with open(base + ".pt2.json", "w") as f:
        json.dump({"batch": batch, "latent_dim": model_cfg.latent_dim,
                   "num_classes": model_cfg.num_classes, "resolution": model_cfg.resolution,
                   "platforms": [device.type]}, f, indent=2)
    return base + ".pt2"


def load_compiled(path: str) -> Tuple[Callable[..., torch.Tensor], Dict[str, Any]]:
    """Load a `.pt2` artifact of `export_compiled`: (callable, signature
    dict). The callable takes (z) or (z, labels) at exactly the exported
    batch and runs under `torch.no_grad()`. It needs only torch and the
    port's three kernel modules, which register the `torch.ops.locate.*`
    ops: no model code and no weights file. An artifact traced on the
    card raises where there is none."""
    from locate_tpu_torch.ops import flash_attention, fused_attention, fused_stage  # noqa: F401

    base = _artifact_base(path)
    with open(base + ".pt2.json") as f:
        sig = json.load(f)
    if "cuda" in sig["platforms"] and not torch.cuda.is_available():
        raise RuntimeError(f"{base}.pt2 was traced on {sig['platforms']}, and "
                           "torch.cuda.is_available() is False")
    module = torch.export.load(base + ".pt2").module()
    arity = 2 if sig["num_classes"] > 0 else 1

    def call(*args):
        if len(args) != arity:
            raise TypeError(f"the artifact takes {arity} argument(s), got {len(args)}")
        if args[0].shape[0] != sig["batch"]:
            raise ValueError(f"the artifact was exported at batch {sig['batch']}, "
                             f"got z of shape {tuple(args[0].shape)}")
        with torch.no_grad():
            return module(*args)

    return call, sig
