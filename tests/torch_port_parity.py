"""Helpers of the tests that hold the PyTorch port against the JAX package:
the same config in both packages, JAX params with their zero-init leaves
filled, JAX params or gradients as the port's state_dict, and the JAX
layer's sigmoid dispatch as the port's gate profile."""

import dataclasses
import json

import numpy as np
import jax
import jax.numpy as jnp

from locate_tpu_torch import config as tconfig
from locate_tpu_torch.io.export import flatten_tree, params_from_jax


def use_jax_sigmoid_bound(monkeypatch, tmp_path):
    """Point LOCATE_TPU_TORCH_GATE_PROFILE at a copy of the card's profile
    whose sigmoid range is the JAX layer's (`fused_profitable`: the
    one-pass kernel at H*W <= 256), so that the port dispatches a sigmoid
    gate as the JAX package does."""
    from locate_tpu_torch.ops import gate_profile

    path = tmp_path / "gate_profile.json"
    path.write_text(json.dumps(dict(gate_profile.load(),
                                    sigmoid_locations=[{"min": 0, "max": 256}])))
    monkeypatch.setenv(gate_profile.ENV, str(path))


def port_config(cfg):
    """The port's copy of a JAX config dataclass (the field names match)."""
    if dataclasses.is_dataclass(cfg):
        cls = getattr(tconfig, type(cfg).__name__)
        return cls(**{f.name: port_config(getattr(cfg, f.name))
                      for f in dataclasses.fields(cfg)})
    return cfg


def randomize_zero_init(params, key, scale=0.2):
    """Fill all-zero leaves (the logit convs, biases, class projections)
    with noise so the gates, biases and projections are exercised."""
    leaves, treedef = jax.tree.flatten(params)
    keys = jax.random.split(key, len(leaves))
    out = [jnp.where(jnp.all(l == 0), jax.random.normal(k, l.shape) * scale, l)
           if l.ndim > 0 else l for l, k in zip(leaves, keys)]
    return jax.tree.unflatten(treedef, out)


def as_state_dict(tree):
    """A JAX params (or gradient) pytree in the port's layout and names."""
    return {k: v.numpy() for k, v in params_from_jax(flatten_tree(jax.device_get(tree))).items()}


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))
