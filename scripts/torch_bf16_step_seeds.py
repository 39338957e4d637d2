#!/usr/bin/env python3
"""Whole bf16 train steps against f32 on several seeds, on one NVIDIA card.

    python3 scripts/torch_bf16_step_seeds.py [RECIPE ...]

For each recipe of chip_smoke.py's `RECIPES` (default: limited_data;
"shipped": the preset as shipped) on lsun_bedroom_128 at full width,
batch 64, 128^2, and for each of 8 seeds: seeded random weights (chip_smoke.py's `trainer`), a batch
and the state's generator made from the seed, both learning rates at 0
(so every step reads the same weights), 2 steps (R1 firing at step 0)
on three paths from those weights and draws: the kernel path in
bf16, the plain path in bf16 and the plain path in f32. It prints one
JSON line a seed with the norm-relative error against the f32 path of
D's and G's gradients as handed to the optimizers (every critic's under
d_steps), and of the loss metrics (d_loss, g_loss, the mean real and
fake logits) of every step, together and one by one, for the kernel path
and for the plain path; then one summary line a recipe: for each
quantity, the kernel / plain ratios over the seeds and how many seeds
exceed chip_smoke.py's bf16 factor (2) or fall below 1.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def smoke_module():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


SEEDS, STEPS = 8, 2


def one_path(cs, cfg, weights, seed):
    """(D gradients, G gradients, loss metrics [STEPS, 4]) of STEPS steps
    of `cfg` from `weights`, on one fixed batch made from `seed`."""
    gan, state, step = cs.trainer(cfg, seed=seed, weights=weights)
    lead = (cfg.train.d_steps,) if cfg.train.d_steps > 1 else ()
    batch = {k: v[0] for k, v in cs.stacked_batch(1, cs.BATCH, 128, seed=seed,
                                                 lead=lead).items()}
    rec = cs.recorded_gradients(step)
    state, history, _ = cs.timed_steps(step, state, batch, STEPS)
    losses = torch.tensor([[float(m[k]) for k in cs.LOSS_KEYS] for m in history],
                          dtype=torch.float64)
    out = (torch.cat(rec["d"]).double(), torch.cat(rec["g"]).double(), losses)
    del gan, state, step, rec, batch
    cs.release_memory()
    return out


def part(run, key, loss_keys):
    """One quantity of a path's run: D's or G's gradients, the loss
    metrics of every step, or one loss metric."""
    named = {"d_grads": run[0], "g_grads": run[1], "losses": run[2]}
    return named[key] if key in named else run[2][:, loss_keys.index(key)]


def err(a, b):
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_bf16_step_seeds: needs a CUDA card", file=sys.stderr)
        return 2
    from locate_tpu_torch.config import get_config

    cs = smoke_module()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.nvidia_smi(), flush=True)
    for name in sys.argv[1:] or ["limited_data"]:
        overrides = {} if name == "shipped" else cs.RECIPES[name]
        cfg = get_config("lsun_bedroom_128", {"use_pallas": "true", **overrides})
        ratios = {key: [] for key in ("d_grads", "g_grads", "losses", *cs.LOSS_KEYS)}
        for seed in range(SEEDS):
            gan, _, _ = cs.trainer(cfg, seed=seed)
            weights = ({k: v.clone() for k, v in gan.generator.state_dict().items()},
                       {k: v.clone() for k, v in gan.discriminator.state_dict().items()})
            del gan
            paths = {path: one_path(cs, cs.path_config(cfg, use_pallas, dtype), weights, seed)
                     for path, use_pallas, dtype in (("kernel", True, "bfloat16"),
                                                     ("plain", False, "bfloat16"),
                                                     ("f32", False, "float32"))}
            row = {"recipe": name, "seed": seed, "steps": STEPS}
            for key in ratios:
                truth = part(paths["f32"], key, cs.LOSS_KEYS)
                k, p = (err(part(paths[path], key, cs.LOSS_KEYS), truth)
                        for path in ("kernel", "plain"))
                row[key] = {"kernel_vs_f32": k, "plain_vs_f32": p}
                ratios[key].append(k / max(p, 1e-30))
            print(json.dumps(row), flush=True)
            del paths, weights
            cs.release_memory()
        print(json.dumps({"recipe": name, "seeds": SEEDS, "kernel_over_plain": ratios,
                          "seeds_over_2": {k: sum(r > cs.BF16_FACTOR for r in v)
                                           for k, v in ratios.items()},
                          "seeds_under_1": {k: sum(r < 1.0 for r in v)
                                            for k, v in ratios.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
