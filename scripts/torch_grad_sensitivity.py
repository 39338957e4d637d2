#!/usr/bin/env python3
"""How sensitive the port's train-step gradient is, on one NVIDIA card.

    python3 scripts/torch_grad_sensitivity.py

lsun_bedroom_128's generator and discriminator with seeded random weights
(logit convs filled, as chip_smoke.py fills them), f32 compute, TF32 off,
batch 64, one step's D and G gradients with fixed latents. For each
resolution (128, 64, 32; the same widths, fewer stages) it prints one JSON
line with the norm-relative change of the plain path's gradient trees when
every weight is scaled by (1 + 1e-7 N(0, 1)), and the kernel path's
distance from the plain path, and the largest error of any gate backward
call of the kernel path against the plain backward on the tensors that
call saved (each against the sum of its terms' absolute values, as
chip_smoke.py measures it).
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


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_grad_sensitivity: needs a CUDA card", file=sys.stderr)
        return 2
    from locate_tpu_torch.config import get_config
    from locate_tpu_torch.ops import fused_attention as fa

    cs = smoke_module()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda")
    g.manual_seed(5)
    z_d = torch.randn(cs.BATCH, 128, device="cuda", generator=g)
    z_g = torch.randn(cs.BATCH, 128, device="cuda", generator=g)
    for res in (128, 64, 32):
        cfg = get_config("lsun_bedroom_128", {
            "use_pallas": "true", "model.resolution": str(res), "data.resolution": str(res),
            "train.r1_gamma": "0.0"})
        gan, _, _ = cs.trainer(cfg)
        weights = (gan.generator.state_dict(), gan.discriminator.state_dict())
        del gan
        calls = []
        with cs.checked_gate_backward(fa, calls):
            kernel = cs.step_grads(cfg, weights, z_d, z_g, res, True, "float32")
        plain = cs.step_grads(cfg, weights, z_d, z_g, res, False, "float32")
        noisy = cs.step_grads(cfg, weights, z_d, z_g, res, False, "float32", perturb=1e-7)
        worst_call = max(v for row in calls for k, v in row.items()
                         if k.endswith("_rel_err_kernel_vs_plain") and not k.startswith("db2"))
        print(json.dumps({
            "resolution": res, "gate_calls": len(calls),
            "worst_gate_call_rel_err_kernel_vs_plain": worst_call,
            **{f"{net}_rel_change_plain_at_1e7_weight_noise": cs.rel_err(noisy[i], plain[i])
               for i, net in enumerate("DG")},
            **{f"{net}_rel_err_kernel_vs_plain": cs.rel_err(kernel[i], plain[i])
               for i, net in enumerate("DG")},
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
