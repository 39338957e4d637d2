#!/usr/bin/env python3
"""Smoke test of the PyTorch port of locate-tpu on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's paths through the entry points a user calls and holds
every CUDA kernel against its plain PyTorch version. Which kernels a path
launches, and how often, follows the models' dispatch under the card's
gate profile (locate_tpu_torch/ops/gate_profile.json, `path_plan`): G's
stages from 64^2 up fuse their conv block behind the upsample (and the
gate after it where there is one), no other stage fuses, and the sigmoid
gate runs its kernels from 32^2 to 512^2. lsun_bedroom_128 at
full width (use_pallas=true, bf16 compute, f32 params), serving and the
alternating train step, the main path of the softmax gate's kernels; then
ffhq_512 at full width and depth, serving and its train step with lazy R1,
the main path of the fused-stage kernels; then ffhq_512 with
model.attention.mode=sigmoid, serving and training alike, the main path of
the sigmoid gate's three kernels; then lsun_bedroom_128 with
model.attention.kind=self, serving with all six self-attention layers and
training with five, the main path of the three flash kernels; then the
lsun_bedroom_128 step fed through the input path; the train loop of
lsun_bedroom_128 with checkpoints, an in-training eval, a SIGKILL and
resume, export and sampling from a checkpoint; three more presets and six
recipes of the train step's options; the style family, spectral norm and
projection; the eval of the loop's checkpoint; last, data parallelism:
lsun_bedroom_128's loop in a world-size-1 NCCL group and on two gloo
ranks sharing the card. Phases, one line each:

  1. the card: torch's name for it, and `name, power.limit` from nvidia-smi;
  2. build: csrc/fused_attention.cu, csrc/fused_stage.cu and
     csrc/flash_attention.cu, one nvcc each, started together, with
     `-Xptxas -v`: each kernel's registers, shared memory and spills, and
     the dynamic shared memory of the gate's blocks at every (C, Hd) of the
     path, of the stage's at 512^2 x 64 and of the flash kernels' at every
     (T, dh, dv) with the q tile picked there, on both routes of the
     three passes, with the blocks that fit on an SM; the SASS of every
     mma instance of the bf16 forward and backward (`cuobjdump -sass`)
     holds HMMA or HGMMA instructions, and none spills more than 16 bytes;
     the five mma kernels of the stage (`stage_softmax_stats_mma`,
     `stage_conv_bwd_mma`, `stage_conv_mma`, `stage_sigmoid_mma` at each
     (C, Co) template, `stage_softmax_apply_pool_mma` at (64, 64)): HMMA
     in the SASS, no spill, registers, shared memory and blocks an SM; the
     simt kernels' shared memory and blocks an SM beside them; the gate
     backward's mma kernels (`softmax_bwd_mma`, `sigmoid_bwd_mma` at
     (C, Hd, Cout) = (64, 16, 64); `softmax_bwd_wide_mma`,
     `sigmoid_bwd_wide_mma` and their weight-gradient pass
     `gate_wgrad_wide_mma` at (512, 128, 512)) and the softmax forward
     pair's (`softmax_stats_mma`, `softmax_apply_mma` at (64, 16, 64)) alike:
     HMMA in the SASS, no spill, registers, shared memory and blocks an SM;
  3. the gate's forward kernels (stats, apply) against the plain version at
     the nine G and D gate shapes of lsun_bedroom_128, batch 64, bf16, with
     gate weights that make the gate vary and pass the clamp at 16, plus one
     f32 shape with TF32 off; then at ffhq_512's new shapes (HW 65536 and
     262144, C 64), batch 16. Rule in bf16: the kernel's norm-relative error
     against an f32 plain computation of the same inputs is at most twice
     the bf16 plain version's. Rule in f32: at most 1e-4 against the plain
     version. Both passes run on the route their wrappers pick: at each
     bf16 shape at C = 64 the tensor-core kernels (mma), and on the same
     inputs the simt kernels too, both under the rule, each twice bitwise
     equal, the mma route faster than the simt route and than the plain
     version (timed); the other widths and f32 on simt;
  4. the gate's backward kernels (csum, backward) at the same shapes, and
     at ffhq_512's two C = 512 shapes at batch 16, under the same rules,
     for c, dx, dpos_proj, dW1x, db1, dW2 and db2. These are
     sums that cancel (db2 exactly: sum_s dl = c - c), so each error is taken
     against the norm of the sum of its terms' absolute values, the scale
     rounding error grows with; the same inputs run twice give bitwise-equal
     gradients. The backward runs on the route its wrapper picks: at each
     bf16 shape at C = 64 or 512 the tensor-core kernels (mma), and on the
     same inputs the simt kernel too, both under the rule, each twice
     bitwise equal, the mma route faster than the simt route and than the
     plain version (timed); C = 128 and 256 and f32 on simt;
  5. lsun_bedroom_128 serving: seeded random weights with non-zero logit
     convs serve requests of batch 1, 16 and 64 through `generate_samples`;
     the launch counters read 6 per forward for each forward gate kernel
     (3 on the mma route: G's C = 64 stages), 2 of stage_conv (G's 64^2
     and 128^2 first conv blocks, fused behind the upsample) and 0 for
     every other; each
     attention layer of the batch-64 request is held against the plain
     version on the activations it received; the kernel
     path, the plain path and an f32 plain generator run the same latents
     (kernel error <= 2x plain error); `bench-sample`'s images/sec at batch
     64 for both paths, peak memory, idle share;
  6. lsun_bedroom_128 training: the shipped preset (R1 gamma 1 every 16
     steps, the grad-norm and non-finite guards, EMA 0.999), batch 64, seeded
     weights, 3 steps from step 0 through `make_train_step`: losses, norms and
     r1 finite, G, D and EMA moved, the guard counters as the norms imply,
     launch counters 30 / 30 / 24 / 24 per step, stage_conv 4 and
     stage_conv_bwd 2 (G's two fused conv blocks) on the mma route,
     softmax_stats' and softmax_apply's 30 on their routes: 12 mma (C =
     64), 18 simt; softmax_bwd's 24: 16 mma (C = 64 and 512), 8 simt;
     softmax_csum's 24: 9 mma (C = 64), 15 simt.
     Then one step's gradients from one state and batch with the same latents
     on the kernel path, the plain path and an f32 plain path: the kernel
     path's error against f32 is at most twice the plain path's, for D and
     for G. With random weights the 128^2 model's gradient is ill-conditioned
     (the f32 plain path's own gradient moves by percents when the weights
     move by 1e-7, printed), so two more checks carry the weight: each of the
     step's 24 gate backward calls (16 on the mma route) is held against the
     plain backward on its own saved tensors (the bf16 rule), and at 64^2
     (one stage fewer, same widths) the f32 kernel path's gradients are
     within 1e-3 of the f32 plain path's (or ten times the plain path's own
     change under 1e-7 weight noise, if larger), each call within 1e-4;
  7. lsun_bedroom_128 training throughput: `bench 128 20` and `bench 128 20
     xla` (16 steps a call through a CUDA graph of the step, and one step a
     call beside it: images/sec, flops per step, MFU; the kernel path must
     be the faster at both), peak memory of a batch-128 step with R1 firing
     (r1_remat on and off), and over PROFILED_EAGER_STEPS eager step(s)
     and over one 4-step graph call of each path the device's idle share
     and its kernels by time;
  8. (in 3 and 4) each gate kernel's time at each shape (CUDA graphs of
     back-to-back launches timed with CUDA events) beside its bound, share
     of the bound and the plain version's time;
  9. the four fused-stage kernels against their plain versions at
     ffhq_512's 512^2 stage (C = Co = 64, Hd = 16), batch 16, and in the
     `up` forms at each smaller stage the profile fuses (ffhq_512's 64^2 to
     256^2 at batch 16, lsun_bedroom_128's 64^2 and 128^2 at 64), bf16 and f32
     under the rules of 3: the softmax stats pass in G's `up` form (coarse
     256^2 in) and D's plain form, the pooled apply pass, the conv pass
     plain, `up`, `down` and with a 1x1 skip (C 32), the conv backward plain
     and `up` (its outputs against their absolute-term scales, two f32 runs
     bitwise equal), the stats pass and the backward also with the 1x1
     skip (C 32); the conv pass, the stats pass, the pooled apply pass and
     the backward in bf16 on the mma route (the wrappers' choice) and, on
     the same inputs, the simt route, both under the bf16 rule, each case
     twice and bitwise equal, f32 on the simt route; each bf16 case timed
     beside its bound, the plain version's time and the simt route's time
     (fails if the mma route is not the faster); then, in G's `up` and D's
     plain form, the stats pass's m and se against `softmax_stats_mma` on
     the w the stage stores, with the same gate weights: m bitwise equal,
     se within the f32 steps of its longer sum (one l for the fused and the
     unfused path);
 10. ffhq_512 serving: one request of 4 through `generate_samples` (the
     launches of one forward: the stats pass of each of G's four fused
     stages, the gate's stats at the four stages below and its apply at all
     eight, 1 and 5 of them on the mma route), the kernel path, the plain
     path and an f32
     plain generator on the same latents (kernel error <= 2x plain error),
     the idle share of a batch-16 request, and `bench-sample ffhq_512
     --batch=16` on both paths with peak memory;
 11. ffhq_512 training (the fused-stage kernels' main path): the preset as
     shipped (R1 gamma 0.1 every 16 steps, remat, both guards) at batch 16,
     3 steps from step 0: the checks of 6, launches per step of all eight
     kernels as the plan implies, every launch of stage_conv,
     stage_softmax_stats (12 a step) and stage_conv_bwd on the mma route
     (D's 512^2 stage runs unfused: no pooled apply), softmax_bwd's 32 on
     their routes (24 mma, 8 simt), softmax_csum's 32 (17 mma: C = 64),
     softmax_stats' 64 (31 mma) and softmax_apply's 72 (39 mma), sec/step,
     images/sec, peak memory, idle
     share and top kernels; the same steps again with the grad-norm guard
     raised to 1e9, where G's and D's updates all apply and G, D and the
     EMA move (random weights give G a norm of 2e6-2e7, above the shipped
     1e6, so this is the card's check of G's Adam update); then the plain
     path's 3 steps alike;
 12. one ffhq_512 step's gradients with R1 on the kernel path, each of its
     four fused-stage backward calls (G's 64^2 to 512^2 stages: the
     recompute of w by stage_conv and the backward, both on the mma route)
     held against the plain backward chain on its own saved tensors (the
     bf16 rule); the step's csum calls on their routes (17 of 32 on the
     mma route, those at C = 64, the four in the fused calls among them);
 13. one step's whole gradients at ffhq_512's widths cut to 64^2 with every
     stage fused, f32 kernel path against f32 plain path (the tolerance of
     6), each of the 20 fused-stage backward calls within 1e-4, on the simt
     route;
 14. one 512^2 G stage and one D stage, forward plus backward, fused
     (forced), unfused and on the plain path;
 15. the sigmoid gate's two kernels (sigmoid_gate, sigmoid_bwd) against
     their plain versions at the six shapes where ffhq_512-sigmoid runs
     them outside a fused stage (32^2 at C = 128 and C = 64, 64^2 to 512^2
     at C = 64), and at the 4^2 gate's (16, 512, 128), which the profile
     leaves to the plain composition, batch 16, bf16, one also in f32,
     under the rules of 3 and 4 at gate_max 1.5 (below the gate's ceiling of 2, so the clamp
     binds at about a third of the locations); two runs bitwise equal; each
     timed beside its bound and the plain version's time; the backward at
     C = 64 (HW % 128 == 0) and (16, 512, 128) in bf16 on the mma route
     (sigmoid_bwd_mma, sigmoid_bwd_wide_mma; the forward at C = 512 on
     sigmoid_gate_wide_mma) and, on the same inputs, the simt route, both
     under the rule, each twice bitwise equal, timed (fails if the mma
     route is not faster than the simt route and the plain version); the
     shape at C = 128 and f32 on simt;
 16. the stage's sigmoid pass (stage_sigmoid) at 512^2 in G's `up` and
     D's `down` forms, plain and with a 1x1 skip, and in the `up` form at
     64^2 to 256^2, under the rules of 9 at gate_max 1.5, on both routes,
     timed alike;
 17. ffhq_512-sigmoid serving as 10: one forward launches the gate's
     kernel once (G's 32^2 gate) and the stage's sigmoid pass 4 times, no
     softmax kernel;
 18. ffhq_512-sigmoid training as 11: 33 / 20 / 12 launches a step of
     sigmoid_gate / sigmoid_bwd / stage_sigmoid, 4 of stage_conv and of
     stage_conv_bwd, none of the softmax kernels; the three stage kernels
     on the mma route; sigmoid_bwd's 20 on their routes (17 mma, 3 simt),
     sigmoid_gate's 33 (all simt: C = 64 and 128), and on phase 19's step
     each of the 16 gate backward calls outside the fused stages
     (SigmoidGate) held against the plain backward on its own saved
     tensors (the bf16 rule);
 19. as 12, the four sigmoid stage backward calls of one step, their gate
     backward on the mma route;
 20. as 13, at 64^2 with every sigmoid stage fused;
 21. the gate profile's ladder again (scripts/torch_retune_gates.py's
     measurements): one sigmoid layer's kernels against the plain
     composition at ffhq_512's gate widths from 4^2 to 512^2, and each
     stage flavor fused against unfused from 64^2 to 512^2, forward plus
     backward in CUDA graphs; each rung's two times, the thresholds the
     profile holds and those this run's times would give;
 22. the three flash kernels (flash_fwd, flash_dq, flash_dkv) against their
     plain versions at the nine (T, dh, dv) of lsun_bedroom_128's
     self-attention layers (G's six from T = 16, dh 64, dv 256 to T = 16384,
     dh 8, dv 32, and D's three others), batch 16, plus heads = 2 and one
     S != T case, bf16 and f32, under the rules of 3 and 4; two runs bitwise
     equal; in bf16 all three passes on the tensor-core (mma) route and, on
     the same inputs, on the simt route, both under the bf16 rule; each
     bf16 case timed beside its bound, its exponential floor (B T S
     exponentials on 2,112 SFU lanes), blocks per SM, its plain version, the
     simt route and `F.scaled_dot_product_attention` (forward, and autograd
     backward for the two backward kernels together), which the port never
     calls; then the training shapes at batch 64, timed only; fails if the
     mma pair is slower than the library's backward at (64, 1024, 16, 64),
     or `flash_fwd` slower than the library's forward at (16, 256, 32, 128)
     or (64, 4096, 8, 32);
 23. lsun_bedroom_128 + attention.kind=self serving, all six layers:
     requests of 1, 16 and 64 (6 flash_fwd launches a forward, all on the
     mma route, and G's two fused conv blocks' stage_conv), each layer of the batch-16 request against
     the plain composition on its own q, k, v, the three generators on the
     same latents,
     `bench-sample` at batch 1, 16, 64 with peak memory, the plain path at
     the largest batch the allocator grants (its refusal at batch 64, one
     68.7 GB score tensor, is caught and recorded), idle share, top kernels;
 24. the same preset training as shipped (batch 64, R1, both guards, EMA)
     with attention at 4^2..64^2: 3 steps from step 0 under the checks of 6,
     launches 25 / 20 / 20 a step (and 4 / 2 of stage_conv and
     stage_conv_bwd), every flash launch on the mma route,
     sec/step, images/sec, peak memory, idle share, top kernels; then the
     plain path alike; a refused batch is halved and recorded;
 25. one such step's gradients with each of its 20 flash backward calls on
     the mma route and held against the plain backward on its own saved
     tensors (bf16), and at 64^2 in f32 (the simt route) the whole
     gradients against the plain path (the tolerance of 6), each call
     within 1e-4;
 26. several steps a call (`make_multi_step`, a CUDA graph of the whole
     alternating step replayed k times, R1's steps a second graph): from
     one state, one call against the same steps run eagerly, params,
     optimizer states, EMA, guard counters, step, generator state and the
     call's reduced metrics bitwise equal (or, where two eager runs differ,
     within their spread), each capture launching one eager step's
     kernels: lsun_bedroom_128's bench config at batch 64, spc=4; the
     preset as shipped (R1 every 16, both guards), two calls of 16 from
     step 0; ffhq_512 with each gate, spc=2, the guard raised; the
     self-attention config of 24, spc=2;
 27. bench-sample's CUDA graph of the draw, the forward and the uint8
     conversion against eager `generate_samples` from one seed, bitwise,
     at batch 64 (lsun_bedroom_128) and 16 (ffhq_512), with the idle share;
 28. the input path (packed shards, the producer thread, the pinned-memory
     device prefetch): the pack's rate at 128^2 and whether the native
     loader built on this host; `bench 128 20 e2e` on the kernel path
     (fails if its reconciliation e2e <= 1.15 min(input path, device
     only) does not hold, or if the input path alone is slower than the
     device-only step); the idle share and top kernels of
     PROFILED_EAGER_STEPS eager step(s) fed by the live pipeline, beside
     the idle share of as many fed batches pulled before the window and of
     as many steps on one fixed batch; 4
     prefetched batches, the step run between them, copied back and equal
     byte for byte to a second producer's host batches from the same
     seed; two spc=4 graph calls fed from the prefetch, bitwise equal to
     the same calls fed host-made tensors;
 29. the train loop (`python -m locate_tpu_torch train` in child
     processes): lsun_bedroom_128 as shipped at full width, batch 64, bf16,
     synthetic data, 8 steps a call (a CUDA graph), 32 steps, an async
     checkpoint every 8, an in-training eval (rFID, rKID, keep_best) every
     16; the children hold cuDNN to deterministic algorithms (two
     unheld runs differed in every earlier run of this phase); run A;
     run B SIGKILLed as soon as checkpoints/16 is complete (after step
     16's eval) and resumed to 32: its final checkpoint (every state
     tensor, the step, the generator), its sample grid, its metrics.jsonl
     (one monotone trajectory, every record but the timing fields, the
     eval records included), its best.json and best checkpoint equal A's;
     then the loop in this process (no sample grid, no eval) with the
     counters from 0 (each of the step's six kernels
     launched: the softmax gate's four, stage_conv and stage_conv_bwd, and
     no other), the device's idle share and top kernels over one logged
     window (steps 25-32, an async save and a log read in it), its logged
     images/sec beside `bench 64 10`'s fixed-batch rate at spc=8 and the
     loop's recipe (R1, guards) on one fixed batch at spc=8 (10 calls
     each, 20 before phases 37-38), an async
     save's time on the step's stream; `export` of A's checkpoint, and
     `sample --generator` on the export and `sample --checkpoint` on A
     writing the same PNG bytes for one seed;
 30. three more presets as shipped, at full width: cifar10_32 (f32
     compute), celeba_64 (attention at every stage) and ffhq_256
     (class-conditional, the projection D): a served batch; 4 steps from
     one state with the same draws and the learning rate at 0
     (`paths_from_one_state`): on the kernel path in the preset's dtype,
     each gate backward call of step 0 held to the plain backward on its
     own saved tensors by the rule of 3; and 2 whole steps in f32 at 64^2
     or below on the kernel and the plain path, D's and G's gradients and
     the loss metrics within 1e-4 of the plain path or ten times its own
     move under 1e-7 weight noise; ffhq_256's at batch 16 (the checked
     calls' f32 references; printed as a cut); a graph call of 4 steps at
     the preset's batch (ffhq_256 halved while the allocator refuses it
     with R1; printed) bitwise equal to the eager steps (cuDNN
     deterministic), R1 firing; each kernel's launches a step, the softmax
     gate's four above 0;
 31. lsun_bedroom_128 as shipped at full width and batch 64 under six
     recipes of docs/GUIDE.md: the limited-data stack (ADA, bCR, LeCam),
     R3GAN (rpgan, R1 and R2), WGAN-GP with 5 critic steps, the fused
     simultaneous step, path-length and orthogonal regularization, and
     grad_accum 2 with the bf16 EMA, the warmup-cosine schedule and
     ema_rampup: 2 kernel-path steps and 1 f32 step a path as in 30 (the
     f32 step at 64^2); a 2-step graph call
     bitwise equal to its eager steps, crossing an R1 step (and a PL
     step); the softmax gate's launches a step above 0; step times and
     the idle share; then `bench 128 20 fused` beside 7's `bench 128 20`;
 32. the style family serving: celeba_64 with docs/GUIDE.md's style recipe
     (`model.arch=style model.style.mapping_layers=8`), bf16, batch 64,
     w-space truncation at psi 0.7: three `SampleGraph` replays bitwise
     equal to three eager batches from one seed, on the kernel and the
     plain path; the served forward's gate launches on both routes;
     images/sec of both, the idle share;
 33. the style family training at batch 64: the recipe with PL (R1 0.1),
     and a StyleGAN2 variant adding the skip head, style mixing at 0.9 and
     random noise: 2 steps and 1 f32 step a path as in 30, a 2-step graph
     call bitwise equal to its eager steps crossing R1's and PL's step,
     every draw (the second latent, the crossover, the noise planes) made
     on the card from the state's generator; the softmax gate's launches a
     step above 0;
 34. lsun_bedroom_128 as shipped with `model.spectral_norm=true`, and with
     `model.g_rgb=skip`, as 31;
 35. `project` through the CLI: 16 random images, 32 steps as replays of
     one captured step, from a checkpoint of a seeded state, in the z
     space on lsun_bedroom_128 and the w+ space on the style recipe: the
     loss falls, the gate kernels launch; one eager step's gate backward
     calls held to the plain backward; 4 eager steps against 4 graph
     replays, bitwise;
 36. the eval (`eval` through the CLI) of 29's checkpoint of run A, 1024
     samples a side, with SWD and PRDC (k 5): rFID, KID, swd_avg, PRDC, the
     seconds of generation, features and metrics, images/sec; the gate
     kernels' launches, those of its 32 served forwards; the rFID of the
     same uint8 real and fake sets with the card's features (f32, TF32
     off) and the CPU's within 1e-3 relative; `compare` of a folder
     against itself (fid under 1e-3, swd_avg 0); an InceptionV3 extractor
     with random weights from an `.npz` written from a seed: its
     images/sec at batch 64, its card features within rtol 2e-3 / atol
     2e-4 of the CPU's;
 37. "dp-one-rank-nccl": in a child process, `initialize_from_env()` makes a
     world-size-1 NCCL group; `train()` of lsun_bedroom_128 as shipped
     (full width, batch 64, bf16, 8 steps as one call of a CUDA graph that
     captures the step's collectives, R1 at step 0) at zero_stage 0, 1 and
     3, each bitwise equal (final checkpoint, generator, every logged
     metric) to the same run before the group was made, each launching
     the step's six kernels; `ShardedSampler` bitwise equal to
     `generate_samples` at a count of 67; the step's ms (bench's config, no
     R1), eager and as a graph, with and without the group;
 38. "dp-two-ranks-gloo": two child processes on the card in a gloo group
     ("gspmd", zero_stage 0, the preset's options: all_reduce and
     broadcast only), `train()` of lsun_bedroom_128 at global batch 64 (32
     a rank), 2 eager steps with R1 at the first, against the same run in
     this process without a group: every metric bitwise equal on both
     ranks and within 1e-2 relative of the one-process run's (the worst
     printed), metrics.jsonl written by rank 0 alone, the six kernels
     launched on both ranks, step 2's seconds on each;
 39. one JSON line `{"kernels": [...]}` for the fourteen kernels (the three
     flash kernels, the five routed stage kernels, softmax_stats,
     softmax_apply, softmax_bwd and sigmoid_bwd with their mma-route
     launches and the simt route's time of the same launches beside their
     own; stage_softmax_apply_pool, off ffhq_512's path under the profile,
     with the launches of 13's every-stage-fused step; each with its
     launches in 29's loop, a step of 33's style recipe, a forward of 32's
     serving, 36's eval, 37's NCCL run at zero_stage 0 and 38's rank 0);
 40. the card's name and power limit again, then the last line
     `{"ok": true, "device": {...}}`.

Any failed check exits non-zero before the last line. Needs one card; run
it from the root of a checkout (the kernels build into .build/kernels/).
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

PEAK_BYTES_PER_S = 3.35e12                        # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
BATCH = 64
# (HW, C, Hd) of the six lsun_bedroom_128 generator stages and of the six
# discriminator stages (the gate runs at a D stage's output width); Cout = C
G_SHAPES = [(16, 512, 128), (64, 256, 64), (256, 128, 32),
            (1024, 64, 16), (4096, 64, 16), (16384, 64, 16)]
D_SHAPES = [(16384, 64, 16), (4096, 64, 16), (1024, 128, 32),
            (256, 256, 64), (64, 512, 128), (16, 512, 128)]
SHAPES = G_SHAPES + [s for s in D_SHAPES if s not in G_SHAPES]
# the gate backward's tensor-core kernels (their mma route, bf16): two on
# one body at (C, Hd, Cout) = (64, 16, 64), two on one body at (512, 128,
# 512) and that template's weight-gradient pass; each must hold HMMA and
# not spill
GATE_MMA_KERNELS = ("softmax_bwd_mma", "sigmoid_bwd_mma", "softmax_bwd_wide_mma",
                    "sigmoid_bwd_wide_mma", "gate_wgrad_wide_mma")
# the softmax gate's forward pair and csum pass on the tensor cores (bf16 at
# (64, 16, 64), one body on the backward's logit core), with the pass each
# answers to in the occupancy query; each must hold HMMA and not spill, the
# pair at FWD_MMA_BLOCKS blocks an SM
GATE_FWD_MMA_KERNELS = ("softmax_stats_mma", "softmax_apply_mma", "softmax_csum_mma")
FWD_MMA_PASS = {"softmax_stats_mma": 0, "softmax_apply_mma": 1, "softmax_csum_mma": 2}
FWD_MMA_BLOCKS = 3
# the forward's two wrappers with two routes (the csum pass takes their route)
GATE_FWD_ROUTED = ("softmax_stats", "softmax_apply")
# the sigmoid gate's forward on the tensor cores at (512, 128, 512), on the
# sigmoid backward's logit code; HMMA, no spill
SIGMOID_MMA_KERNELS = ("sigmoid_gate_wide_mma",)
F32_SHAPE = (1024, 64, 16)
F32_TOL = 1e-4
# a whole step's gradient tree at 64^2, kernel path vs plain path, f32: at
# most this, or ten times what 1e-7 weight noise moves the plain path by
TRAIN_F32_TOL = 1e-3
BF16_FACTOR = 2.0
# two errors both under this are both rounding noise: the 2x rule is not applied
BF16_FLOOR = 1e-5
GRAD_NAMES = ("c", "dx", "dpos_proj", "dW1x", "db1", "dW2", "db2")
SOURCE = "locate_tpu_torch/csrc/fused_attention.cu"
KERNELS = ("softmax_stats", "softmax_apply", "softmax_csum", "softmax_bwd")
REPLACES = {"softmax_stats": "locate_tpu/ops/pallas/fused_attention.py:152",
            "softmax_apply": "locate_tpu/ops/pallas/fused_attention.py:179",
            "softmax_csum": "locate_tpu/ops/pallas/fused_attention.py:358",
            "softmax_bwd": "locate_tpu/ops/pallas/fused_attention.py:397",
            "stage_conv": "locate_tpu/ops/pallas/fused_stage.py:366",
            "stage_softmax_stats": "locate_tpu/ops/pallas/fused_stage.py:410",
            "stage_softmax_apply_pool": "locate_tpu/ops/pallas/fused_stage.py:397",
            "stage_conv_bwd": "locate_tpu/ops/pallas/fused_stage.py:451",
            "sigmoid_gate": "locate_tpu/ops/pallas/fused_attention.py:145",
            "sigmoid_bwd": "locate_tpu/ops/pallas/fused_attention.py:387",
            "stage_sigmoid": "locate_tpu/ops/pallas/fused_stage.py:378",
            "flash_fwd": "locate_tpu/ops/pallas/flash_attention.py:86",
            "flash_dq": "locate_tpu/ops/pallas/flash_attention.py:178",
            "flash_dkv": "locate_tpu/ops/pallas/flash_attention.py:202"}
# the CUDA kernels of csrc/fused_attention.cu and csrc/fused_stage.cu, as
# ptxas and the profiler name them (a name before any name it contains)
CUDA_KERNELS = ("softmax_stats_partial", "softmax_stats_merge", "softmax_apply",
                "softmax_csum_partial", "softmax_bwd", "reduce_partials", "sigmoid_gate",
                "sigmoid_bwd")
STAGE_SOURCE = "locate_tpu_torch/csrc/fused_stage.cu"
STAGE_KERNELS = ("stage_conv", "stage_softmax_stats", "stage_softmax_apply_pool",
                 "stage_conv_bwd")
# the tensor-core kernels of the routed stage wrappers (their mma route,
# bf16), the first four templates on (C, Co), the apply-pool pass's at
# (64, 64) only; each must hold HMMA and not spill
STAGE_MMA_KERNELS = ("stage_softmax_stats_mma", "stage_conv_bwd_mma", "stage_conv_mma",
                     "stage_sigmoid_mma", "stage_softmax_apply_pool_mma")
# the five wrappers with two routes, and the simt time each bf16 case of
# phases 9 and 16 must beat on the mma route
STAGE_ROUTED = ("stage_softmax_stats", "stage_conv_bwd", "stage_conv", "stage_sigmoid",
                "stage_softmax_apply_pool")
STAGE_CUDA_KERNELS = ("stage_conv_bwd", "stage_softmax_apply_pool", "stage_softmax_stats",
                      "stage_conv", "stage_sigmoid", "softmax_stats_merge", "reduce_partials")
FLASH_SOURCE = "locate_tpu_torch/csrc/flash_attention.cu"
FLASH_KERNELS = ("flash_fwd", "flash_dq", "flash_dkv")
# the tensor-core instances of the three wrappers (the mma route, bf16),
# templates on the padded head widths; each must hold HMMA or HGMMA
FLASH_MMA_KERNELS = ("flash_fwd_mma", "flash_dq_mma", "flash_dkv_mma")
FLASH_MMA_SPILL_LIMIT = 16  # bytes: the simt kernels' worst spill
# (stage_softmax_stats_mma holds softmax_stats_mma, softmax_apply_mma holds
# softmax_apply, sigmoid_gate_wide_mma holds sigmoid_gate: the longer name
# first)
ALL_CUDA_KERNELS = (GATE_MMA_KERNELS + STAGE_MMA_KERNELS + GATE_FWD_MMA_KERNELS
                    + SIGMOID_MMA_KERNELS + STAGE_CUDA_KERNELS + CUDA_KERNELS
                    + FLASH_MMA_KERNELS + FLASH_KERNELS)
# the exponential floor of a flash pass: B T S exponentials on the H100's
# 132 x 16 SFU lanes (one ex2 a lane a clock) at the SXM card's 1.98 GHz
# boost clock, the clock PEAK_FLOPS's f32 figure (132 x 128 FMA x 2) assumes
SFU_LANES = 132 * 16
SFU_HZ = 1.98e9

# ffhq_512 (config.py:792-808): batch 16 per card (the preset's global 256
# over a v5p-32's 16 chips); the gate's new shapes (HW, C, Hd) at 256^2 and
# 512^2, and the two C = 512 shapes its batch gives the wide backward
FFHQ_BATCH = 16
FFHQ_GATE_SHAPES = [(65536, 64, 16), (262144, 64, 16)]
FFHQ_WIDE_SHAPES = [(16, 512, 128), (64, 512, 128)]

# ffhq_512 with model.attention.mode=sigmoid
SIGMOID = {"model.attention.mode": "sigmoid"}
SIGMOID_KERNELS = ("sigmoid_gate", "sigmoid_bwd")
# below the sigmoid gate's ceiling of 2, so that the clamp binds in the
# kernel checks (the preset's 16 never does)
SIGMOID_GATE_MAX = 1.5
SIGMOID_F32_SHAPE = (1024, 64, 16)
# the sigmoid gate's (512, 128, 512) template at ffhq_512's 4^2 gate
SIGMOID_WIDE_SHAPES = [(16, 512, 128)]

# lsun_bedroom_128 with model.attention.kind=self (heads 1, dk = C/8,
# dv = C/2): serving runs all six layers (T up to 16384); training drops the
# 128^2 layer, because R1 runs through the kernel-free twin of D, whose
# plain attention holds (T, T) f32 matrices, 1.07 GB a tensor an image at
# 128^2. (T, dh, dv) of G's layer at each resolution, and of D's (whose
# layer runs at its stage's output width).
SELF = {"model.attention.kind": "self"}
SELF_TRAIN_STAGES = "4,8,16,32,64"
FLASH_BATCH = 16
FLASH_G_SHAPES = {4: (16, 64, 256), 8: (64, 32, 128), 16: (256, 16, 64), 32: (1024, 8, 32),
                  64: (4096, 8, 32), 128: (16384, 8, 32)}
FLASH_D_SHAPES = {128: (16384, 8, 32), 64: (4096, 8, 32), 32: (1024, 16, 64),
                  16: (256, 32, 128), 8: (64, 64, 256), 4: (16, 64, 256)}
FLASH_SHAPES = list(FLASH_G_SHAPES.values()) + [s for s in FLASH_D_SHAPES.values()
                                                if s not in FLASH_G_SHAPES.values()]
FLASH_TRAIN_RES = (4, 8, 16, 32, 64)
# launches per train step of each (T, dh, dv): forward G twice (the fake,
# the G step) and D three times (real, fake, the G step); backward G once
# and D three times, each one dQ and one dK/dV pass; no remat, and R1's
# twin launches nothing
FLASH_FWD_PER_STEP, FLASH_BWD_PER_STEP = {}, {}
for _res in FLASH_TRAIN_RES:
    for _shape, _fwd, _bwd in ((FLASH_G_SHAPES[_res], 2, 1), (FLASH_D_SHAPES[_res], 3, 3)):
        FLASH_FWD_PER_STEP[_shape] = FLASH_FWD_PER_STEP.get(_shape, 0) + _fwd
        FLASH_BWD_PER_STEP[_shape] = FLASH_BWD_PER_STEP.get(_shape, 0) + _bwd
FLASH_PER_STEP = {"flash_fwd": sum(FLASH_FWD_PER_STEP.values()),
                  "flash_dq": sum(FLASH_BWD_PER_STEP.values()),
                  "flash_dkv": sum(FLASH_BWD_PER_STEP.values())}
FLASH_NAMES = ("o", "ell", "dq", "dk", "dv")

# ---------------------------------------------------------------------------
# Launch plans: what a path launches, from its models' dispatch under the
# card's gate profile (locate_tpu_torch/ops/gate_profile.json)
# ---------------------------------------------------------------------------

WRAPPERS = ("softmax_stats", "softmax_apply", "softmax_csum", "softmax_bwd", "stage_conv",
            "stage_softmax_stats", "stage_softmax_apply_pool", "stage_conv_bwd",
            "sigmoid_gate", "sigmoid_bwd", "stage_sigmoid", "flash_fwd", "flash_dq",
            "flash_dkv")


def path_plan(cfg, serve: bool = False) -> dict:
    """{wrapper: {key: launches}} of one train step of `cfg`'s kernel path
    (`serve`: of one served forward), read from the models' own dispatch
    (`FusableStage.plan`, `LocateAttention.fused_profitable`) under the
    active gate profile. A gate kernel's key is its (HW, C, Hd), Cout = C;
    a stage kernel's its form and fine resolution, "up@512". A train step
    runs G forward 2 times (3 under remat: the G step's forward again in
    its backward) and backward once, D forward 3 times (6 under remat) and
    backward 3 times; R1's twin of D launches nothing. An unfused softmax
    gate runs stats and apply forward, csum and the backward backward; a
    sigmoid gate in its profile's ranges sigmoid_gate and sigmoid_bwd; a
    fused pair the stage's pass forward (stats, then apply, pooled after
    a pool; the sigmoid pass) and backward the conv pass (w again), the
    gate's stats, csum and backward (sigmoid_bwd) and the conv backward; a
    fused conv block the conv pass and the conv backward. Self-attention
    layers are left to FLASH_PER_STEP. "sigmoid_gate_bwd" counts the
    sigmoid backward calls outside a fused stage (SigmoidGate's)."""
    from locate_tpu_torch.models.discriminator import Discriminator
    from locate_tpu_torch.models.gan import model_config
    from locate_tpu_torch.models.generator import Generator
    from locate_tpu_torch.nn.blocks import _resampled
    from locate_tpu_torch.ops.attention import LocateAttention

    mcfg = dataclasses.replace(model_config(cfg), use_pallas=True)
    with torch.device("meta"):
        nets = {"g": Generator(mcfg, torch.bfloat16), "d": Discriminator(mcfg, torch.bfloat16)}
    remat = 2 if mcfg.remat else 1
    passes = ({"g": (1, 0), "d": (0, 0)} if serve else
              {"g": (1 + remat, 1), "d": (3 * remat, 3)})
    out = {k: {} for k in WRAPPERS + ("sigmoid_gate_bwd",)}

    def add(kernel, key, n):
        if n:
            out[kernel][key] = out[kernel].get(key, 0) + n

    for name, net in nets.items():
        fwd, bwd = passes[name]
        h = w = 4 if name == "g" else mcfg.resolution
        for stage in net.trunk:
            layers = list(stage)
            for flavor, i, _, sh, sw in stage.plan(h, w):
                if flavor is None:
                    gate = layers[i]
                    if not isinstance(gate, LocateAttention) or not gate.use_fused:
                        continue
                    if not gate.fused_profitable(sh * sw):
                        continue
                    key = (sh * sw, gate.to_logits.w.shape[0], gate.to_hidden.w.shape[0])
                    if gate.cfg.mode == "softmax":
                        for k, n in (("softmax_stats", fwd), ("softmax_apply", fwd),
                                     ("softmax_csum", bwd), ("softmax_bwd", bwd)):
                            add(k, key, n)
                    else:
                        add("sigmoid_gate", key, fwd)
                        add("sigmoid_bwd", key, bwd)
                        add("sigmoid_gate_bwd", key, bwd)
                    continue
                up, down = flavor.startswith("up_"), flavor.startswith("down_")
                res = sh * (2 if up else 1)
                form = f"{'up' if up else 'plain'}@{res}"
                out_form = f"{'up' if up else 'down' if down else 'plain'}@{res}"
                if flavor.endswith("conv"):
                    add("stage_conv", out_form, fwd)
                    add("stage_conv_bwd", form, bwd)
                    continue
                gate = layers[i + up + 1]
                key = (res * res, gate.to_logits.w.shape[0], gate.to_hidden.w.shape[0])
                add("stage_conv", form, bwd)
                add("stage_conv_bwd", form, bwd)
                if gate.cfg.mode == "sigmoid":
                    add("stage_sigmoid", out_form, fwd)
                    add("sigmoid_bwd", key, bwd)
                    continue
                add("stage_softmax_stats", form, fwd)
                if down:
                    add("stage_softmax_apply_pool", f"plain@{res}", fwd)
                else:
                    add("softmax_apply", key, fwd)
                for k in ("softmax_stats", "softmax_csum", "softmax_bwd"):
                    add(k, key, bwd)
            for layer in layers:
                h, w = _resampled(layer, h, w)
    return out


def totals(plan: dict) -> dict:
    """{wrapper: launches} of a plan, the wrappers it does not launch left out."""
    return {k: sum(v.values()) for k, v in plan.items() if v and k in WRAPPERS}


def lsun_config(**overrides):
    from locate_tpu_torch.config import get_config

    return get_config("lsun_bedroom_128", {"use_pallas": "true", **overrides})


def ffhq_config(**overrides):
    from locate_tpu_torch.config import get_config

    return get_config("ffhq_512", {"train.global_batch": str(FFHQ_BATCH), **overrides})


# the plans of the paths chip_smoke drives, under the profile in the tree
LSUN_PLAN = path_plan(lsun_config())
LSUN_SERVE_PLAN = path_plan(lsun_config(), serve=True)
FFHQ_PLAN = path_plan(ffhq_config())
FFHQ_SERVE_PLAN = path_plan(ffhq_config(), serve=True)
SIGMOID_PLAN = path_plan(ffhq_config(**SIGMOID))
SIGMOID_SERVE_PLAN = path_plan(ffhq_config(**SIGMOID), serve=True)
SELF_PLAN = path_plan(lsun_config(**SELF, **{"model.attention_stages": SELF_TRAIN_STAGES}))
SELF_SERVE_PLAN = path_plan(lsun_config(**SELF), serve=True)
# lsun_bedroom_128's gate launches a shape: one served forward, one step
SERVE = LSUN_SERVE_PLAN["softmax_stats"]
FWD_PER_STEP = LSUN_PLAN["softmax_stats"]
BWD_PER_STEP = LSUN_PLAN["softmax_bwd"]
# ffhq_512's (softmax gate): a step's stage launches by form, and each gate
# kernel's by shape; a served forward's
FFHQ_STAGE_PER_STEP = {k: FFHQ_PLAN[k] for k in ("stage_softmax_stats", "stage_softmax_apply_pool",
                                                 "stage_conv", "stage_conv_bwd")}
FFHQ_GATE_PER_STEP = {k: sum(FFHQ_PLAN[k].values()) for k in
                      ("softmax_stats", "softmax_apply", "softmax_csum", "softmax_bwd")}
FFHQ_BWD_PER_STEP = FFHQ_PLAN["softmax_bwd"]
FFHQ_STATS_PER_STEP = FFHQ_PLAN["softmax_stats"]
FFHQ_APPLY_PER_STEP = FFHQ_PLAN["softmax_apply"]
FFHQ_STATS_SERVE = FFHQ_SERVE_PLAN["softmax_stats"]
FFHQ_APPLY_SERVE = FFHQ_SERVE_PLAN["softmax_apply"]
FFHQ_SERVE_PER_FORWARD = totals(FFHQ_SERVE_PLAN)
# ffhq_512-sigmoid's: the shapes where the gate runs its kernels outside a
# fused stage (phase 15's), a step's launches by shape and by form
SIGMOID_SHAPES = sorted(SIGMOID_PLAN["sigmoid_gate"], key=lambda s: (s[1], s[0]), reverse=True)
SIGMOID_FWD_PER_STEP = SIGMOID_PLAN["sigmoid_gate"]
SIGMOID_BWD_PER_STEP = SIGMOID_PLAN["sigmoid_bwd"]
# the backward's shapes inside a fused stage only
SIGMOID_STAGE_BWD_SHAPES = sorted(s for s in SIGMOID_BWD_PER_STEP if s not in SIGMOID_SHAPES)
SIGMOID_SERVE = SIGMOID_SERVE_PLAN["sigmoid_gate"]
SIGMOID_STAGE_PER_STEP = {k: SIGMOID_PLAN[k] for k in ("stage_sigmoid", "stage_conv",
                                                       "stage_conv_bwd")}
SIGMOID_PER_STEP = totals(SIGMOID_PLAN)
SIGMOID_SERVE_PER_FORWARD = totals(SIGMOID_SERVE_PLAN)


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


START = time.perf_counter()


def say(phase: str, **fields) -> None:
    """One tagged JSON line, with the seconds since the script started."""
    fields["elapsed_seconds"] = time.perf_counter() - START
    print(f"[{phase}] " + json.dumps(fields), flush=True)


def rel_err(got: torch.Tensor, truth: torch.Tensor, scale: torch.Tensor = None) -> float:
    got, truth = got.double(), truth.double()
    scale = truth if scale is None else scale.double()
    return float((got - truth).norm() / scale.norm().clamp_min(1e-12))


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def kernel_name(mangled: str) -> str:
    """The readable name of a compiled kernel: its ALL_CUDA_KERNELS name
    with <bf16> or <f32> for the templates (and a second, integer argument
    where there is one, as the flash kernels' rows per thread), or with its
    integer arguments where it has only those (the mma kernels' <DH,DV>),
    else the mangled name itself."""
    base = next((k for k in ALL_CUDA_KERNELS if k in mangled), mangled)
    m = re.search(r"I(f|13__nv_bfloat16)(?:Li(\d+))?E", mangled)
    if not m:
        ints = re.search(r"I((?:Li\d+E)+)E", mangled)  # integer arguments only
        if ints:
            return f"{base}<{','.join(re.findall(r'Li(\d+)E', ints.group(1)))}>"
        return base
    dtype = "f32" if m.group(1) == "f" else "bf16"
    return f"{base}<{dtype}{',' + m.group(2) if m.group(2) else ''}>"


def parse_ptxas(log: str) -> dict:
    """{kernel: {registers, static_smem, spill_stores, spill_loads}} from
    the `-Xptxas -v` output of a build."""
    kernels, current = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            current = kernel_name(m.group(1))
            kernels[current] = {}
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and current:
            kernels[current].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and current:
            kernels[current]["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            kernels[current]["static_smem"] = int(s.group(1)) if s else 0
    return kernels


def graph_ms(fn, reps: int = 10, replays: int = 5) -> float:
    """Device time of one `fn()` call: `reps` calls captured in a CUDA
    graph (so host overhead leaves no gaps), replayed, timed by events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (reps * replays)
    del graph
    return ms


def kernel_split(fn, calls: int = 5) -> dict:
    """Device microseconds per call of each CUDA kernel `fn` launches,
    by kernel name, from torch.profiler (empty if it records none)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        name = next((k for k in ALL_CUDA_KERNELS if k in ev.key), None)
        if name:
            total = getattr(ev, "device_time_total", None)
            if total is None:
                total = ev.cuda_time_total
            out[name] = out.get(name, 0.0) + total / calls
    return out


def gate_inputs(n, hw, c, hd, dtype, seed):
    """Gate operands whose weights make the gate vary and pass 16 where
    HW > 16: x (N, HW, C) in `dtype`, the rest f32 as the layer holds them,
    and a cotangent dy like x."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    dev = dict(device="cuda", generator=g)
    x = torch.randn(n, hw, c, **dev).to(dtype)
    pp = torch.randn(hw, hd, **dev) * 0.5
    w1 = torch.randn(c, hd, **dev) / math.sqrt(c)
    b1 = torch.randn(hd, **dev) * 0.1
    w2 = torch.randn(hd, c, **dev) * 3.0 / math.sqrt(hd)
    b2 = torch.randn(c, **dev) * 0.1
    dy = torch.randn(n, hw, c, **dev).to(dtype)
    return [x, pp, w1, b1, w2, b2], dy


def bound(kind: str, n, hw, c, hd, cout, dtype):
    """(bound_ms, bound_by): the larger of the bytes the function must move
    (each input read once, each output written once) over the memory rate
    and its multiply-adds over the peak rate for the operands' type. Every
    pass must compute the gate MLP (2*(C*Hd + Hd*Cout) flops a location);
    a backward pass three times that (the forward, dh and dx, dW1x and
    dW2). The sigmoid gate's two passes read no statistics."""
    es = torch.finfo(dtype).bits // 8
    weights = (c * hd + hd * cout) * es + (hw * hd + hd + cout) * 4
    xbytes = n * hw * c * es
    stats = 2 * n * cout * 4
    mlp = 2.0 * n * hw * (c * hd + hd * cout)
    grads = (c * hd + hd * cout + hd + cout + hw * hd) * 4
    if kind == "softmax_stats":
        nbytes, flops = xbytes + weights + stats, mlp
    elif kind == "softmax_apply":
        nbytes, flops = 2 * xbytes + weights + stats, mlp
    elif kind == "softmax_csum":
        nbytes, flops = 2 * xbytes + weights + stats + n * cout * 4, mlp
    elif kind == "sigmoid_gate":  # reads x, writes y
        nbytes, flops = 2 * xbytes + weights, mlp
    elif kind == "sigmoid_bwd":  # reads x and dy; writes dx and f32 gradients
        nbytes, flops = 3 * xbytes + weights + grads, 3 * mlp
    else:  # softmax_bwd: reads x, dy, stats, c; writes dx and f32 gradients
        nbytes, flops = 3 * xbytes + weights + stats + n * cout * 4 + grads, 3 * mlp
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


KW = dict(act="leaky_relu", leaky_slope=0.2)


def run_forward(fa, ops, hw, plain: bool, route=None):
    """(m, se, y): the plain versions, or both kernels on `route` (the
    wrappers' choice where None)."""
    if plain:
        m, se = fa.softmax_gate_stats_reference(*ops, **KW)
        y = fa.softmax_gate_apply_reference(*ops, m, se, hw_scale=float(hw),
                                            gate_max=16.0, **KW)
    else:
        m, se = fa.softmax_gate_stats(*ops, route=route, **KW)
        y = fa.softmax_gate_apply(*ops, m, se, hw_scale=float(hw), gate_max=16.0, route=route,
                                  **KW)
    return m, se, y


def run_backward(fa, ops, dy, hw, plain: bool, route=None, csum_route=None):
    """(c, dx, dpos_proj, dW1x, db1, dW2, db2), each path its own stats;
    the kernels' backward on `route` and their csum pass on `csum_route`
    (each the wrapper's choice where None)."""
    opts = dict(hw_scale=float(hw), gate_max=16.0, **KW)
    if plain:
        m, se = fa.softmax_gate_stats_reference(*ops, **KW)
        c = fa.softmax_gate_csum_reference(ops[0], dy, *ops[1:], m, se, **opts)
        grads = fa.softmax_gate_backward_reference(ops[0], dy, *ops[1:], m, se, c, **opts)
    else:
        m, se = fa.softmax_gate_stats(*ops, **KW)
        c = fa.softmax_gate_csum(ops[0], dy, *ops[1:], m, se, route=csum_route, **opts)
        grads = fa.softmax_gate_backward(ops[0], dy, *ops[1:], m, se, c, route=route, **opts)
    return (c, *grads)


def term_scales(fa, x2d, dy, pp, w1x, b1, w2, b2, m, se, c, opts):
    """(c, dx, dpos_proj, dW1x, db1, dW2, db2) computed on the absolute
    values of their terms: the scale a sum's rounding error grows with.
    Several of these sums cancel (db2 to exactly 0, since sum_s dl = c - c;
    dW1x and db1 nearly so where x or act'(u) barely vary over the
    locations), so errors are measured against these scales, not against
    the gradients themselves."""
    cd = x2d.dtype
    xf, dyf = x2d.float(), dy.float()
    w1c, w2c = w1x.to(cd).float(), w2.to(cd).float()
    u = xf @ w1c + pp.float() + b1.float()
    h = fa._act(opts["act"], opts["leaky_slope"])(u).to(cd).float()
    l = h @ w2c + b2.float()
    hw = opts["hw_scale"]
    g = torch.exp(l - m) / se * hw
    dg = fa._dgate(xf, dyf, l.shape[-1]) * fa._gate_mask(g, opts["gate_max"])
    terms_c = fa._dgate(xf.abs(), dyf.abs(), l.shape[-1]) * g
    dl = (g * dg).abs() + (g / hw) * c.abs()
    du = fa._act_grad(opts["act"], opts["leaky_slope"])(u).abs() * (dl @ w2c.abs().t())
    dx = fa._clamp_gate(g, opts["gate_max"]) * dyf.abs() + du @ w1c.abs().t()
    return (terms_c.sum(dim=1, keepdim=True), dx, du.sum(dim=0),
            torch.einsum("nsc,nsh->ch", xf.abs(), du), du.sum(dim=(0, 1)),
            torch.einsum("nsh,nsc->hc", h.abs(), dl), dl.sum(dim=(0, 1)))


def hold(name, shape, k, p, t, dtype, row, scale=None):
    """The agreement rule for one output: bf16 against f32, f32 against plain."""
    check(bool(torch.isfinite(k).all()), f"{name} not finite at {shape}")
    row[f"{name}_max_abs_err"] = float((k.float() - p.float()).abs().max())
    if dtype == torch.bfloat16:
        ek, ep = rel_err(k, t, scale), rel_err(p, t, scale)
        row[f"{name}_rel_err_kernel_vs_f32"] = ek
        row[f"{name}_rel_err_plain_vs_f32"] = ep
        check(ek <= max(BF16_FACTOR * ep, BF16_FLOOR),
              f"{name} at {shape}: kernel error {ek:.3e} > {BF16_FACTOR} x plain bf16 "
              f"error {ep:.3e}")
    else:
        e = rel_err(k, p, scale)
        row[f"{name}_rel_err_kernel_vs_plain"] = e
        check(e <= F32_TOL, f"{name} at {shape} f32: {e:.3e} > {F32_TOL}")


def timed(kind, fn, plain_fn, n, hw, c, hd, dtype):
    ms, plain_ms = graph_ms(fn), graph_ms(plain_fn)
    b_ms, b_by = bound(kind, n, hw, c, hd, c, dtype)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                share_of_bound=b_ms / ms)


def cases():
    out = [(hw, c, hd, torch.bfloat16) for hw, c, hd in SHAPES]
    return out + [(*F32_SHAPE, torch.float32)]


def ffhq_gate_cases(wide=False):
    """ffhq_512's new gate shapes in bf16; with `wide` also its two C = 512
    shapes, where the backward at batch 16 takes the wide mma template."""
    shapes = FFHQ_GATE_SHAPES + (FFHQ_WIDE_SHAPES if wide else [])
    return [(hw, c, hd, torch.bfloat16) for hw, c, hd in shapes]


def phase_forward(fa, shapes, batch, phase="forward-kernels-vs-plain"):
    """Phase 3 and the forward half of phase 8. The stats and apply passes
    run on the route their wrappers pick (`gate_fwd_route`); where that is
    the mma route (bf16 at C = 64), the simt route runs on the same inputs
    too, under the same rule, each route twice and bitwise equal, is timed
    beside it, and must be slower, as must the plain version."""
    rows = []
    for i, (hw, c, hd, dtype) in enumerate(shapes):
        ops, _ = gate_inputs(batch, hw, c, hd, dtype, seed=100 + i)
        shape = dict(N=batch, HW=hw, C=c, Hd=hd, Cout=c)
        route = fa.gate_fwd_route(dtype, hw, c, hd, c)
        with torch.inference_mode():
            before = read_fwd_routes()
            kern = run_forward(fa, ops, hw, plain=False)
            want = {k: dict(v, **{route: v[route] + 1}) for k, v in before.items()}
            check(read_fwd_routes() == want, f"the forward at {shape}: not on the {route} route")
            again = run_forward(fa, ops, hw, plain=False)
            simt = simt_again = None
            if route == "mma":
                simt = run_forward(fa, ops, hw, plain=False, route="simt")
                simt_again = run_forward(fa, ops, hw, plain=False, route="simt")
            plain = run_forward(fa, ops, hw, plain=True)
            truth = run_forward(fa, [ops[0].float()] + ops[1:], hw, plain=True)
            torch.cuda.synchronize()
            l = fa.gate_logits_reference(ops[0].float(), *ops[1:], **KW)
            gate = torch.exp(l - truth[0]) / truth[1] * hw
            clamped = float((gate > 16.0).float().mean())
            gate_std = float(gate.std())
            del l, gate
        row = dict(shape=shape, dtype=str(dtype).replace("torch.", ""), route=route,
                   gate_std=round(gate_std, 3), clamped_share=clamped)
        for tag, first, second in (("", kern, again), ("simt ", simt, simt_again)):
            if first is not None:
                for name, a, b in zip(("m", "se", "y"), first, second):
                    check(torch.equal(a, b), f"{name} at {shape} ({tag}route): two runs differ "
                                             f"bitwise")
        row["bitwise_repeatable"] = True
        for name, k, p, t in zip(("m", "se", "y"), kern, plain, truth):
            hold(name, shape, k, p, t, dtype, row)
        if simt is not None:  # the simt route on the same inputs, under the same rule
            for name, k, p, t in zip(("m", "se", "y"), simt, plain, truth):
                hold(f"simt_{name}", shape, k, p, t, dtype, row)
        check(gate_std > 0.5, f"gate barely varies at {shape}")
        if hw > 16:
            check(clamped > 0.0, f"gate never reaches the clamp at {shape}")
        del kern, again, simt, simt_again, plain, truth

        # timing: operands pre-cast as the kernel takes them
        kops = [ops[0], ops[1], ops[2].to(dtype), ops[3], ops[4].to(dtype), ops[5]]
        apply_kw = dict(hw_scale=float(hw), gate_max=16.0, **KW)
        with torch.inference_mode():
            m, se = fa.softmax_gate_stats(*kops, **KW)
            calls = {"softmax_stats": (
                lambda r: fa.softmax_gate_stats(*kops, route=r, **KW),
                lambda: fa.softmax_gate_stats_reference(*kops, **KW)),
                     "softmax_apply": (
                lambda r: fa.softmax_gate_apply(*kops, m, se, route=r, **apply_kw),
                lambda: fa.softmax_gate_apply_reference(*kops, m, se, **apply_kw))}
            for kernel, (fn, plain_fn) in calls.items():
                row[kernel] = timed(kernel, lambda: fn(None), plain_fn, batch, hw, c, hd, dtype)
                row[kernel]["route"] = route
                if route == "mma":
                    ms_simt = graph_ms(lambda: fn("simt"))
                    row[kernel].update(ms_simt=ms_simt,
                                       share_of_bound_simt=row[kernel]["bound_ms"] / ms_simt)
                    check_mma_wins(kernel, shape, row[kernel])
            row["profiler_us_per_call"] = kernel_split(lambda: fa.softmax_gate_apply(
                *kops, *fa.softmax_gate_stats(*kops, **KW), **apply_kw))
        say(phase, **row)
        rows.append(row)
        del ops, kops, m, se
        torch.cuda.empty_cache()
    return rows


def bwd_grid_of(fa, route, n, hw, c, hd) -> dict:
    """The grid and workspace of a gate backward call on `route`: the simt
    kernel's tile rows and batch rows a block (its workspace slices), or,
    at the wide mma template's widths, the weight-gradient pass's splits
    and the workspace bytes."""
    if route == "mma" and (c, hd, c) == fa.GATE_WIDE:
        splits, w_floats, pp_floats = fa.bwd_wide_grid(n, hw, c, hd, c)
        return dict(splits=splits, workspace_bytes=4 * (w_floats + pp_floats))
    if route == "mma":
        return dict(tile_rows=fa.GATE_MMA_TILE)
    t, rows = fa.bwd_grid(n, hw, c)
    return dict(tile_rows=t, batch_rows_per_block=rows,
                workspace_bytes=4 * (-(-hw // t) * -(-n // rows) * (2 * c * hd + hd + c)
                                     + -(-n // rows) * hw * hd))


def check_mma_wins(kernel, shape, t):
    """A gate kernel's mma route must beat, on the same inputs, both the
    simt route and the plain version."""
    ms = t["ms"]
    check(ms < t["ms_simt"], f"{kernel} at {shape}: the mma route ({ms:.4f} ms) is not faster "
                             f"than the simt route ({t['ms_simt']:.4f} ms)")
    check(ms < t["plain_ms"], f"{kernel} at {shape}: the mma route ({ms:.4f} ms) is not faster "
                              f"than the plain version ({t['plain_ms']:.4f} ms)")


def phase_backward(fa, shapes, batch, phase="backward-kernels-vs-plain"):
    """Phase 4 and the backward half of phase 8. softmax_bwd runs on the
    route its wrapper picks (`gate_bwd_route`), and softmax_csum on the
    forward pair's (`gate_fwd_route`); where the backward's is the mma route
    (bf16 at C = 64 and 512), the simt route of both runs on the same inputs
    too, under the same rule and twice bitwise equal, is timed beside it,
    and must be slower, as must the plain version. Where csum's is the mma
    route (bf16 at C = 64), the mma backward also runs on c from the simt
    csum: its c is held to the rule, repeats bitwise and is timed, and db2's
    error over its term scale with each csum's c is recorded; c from the
    mma csum (the backward's own l) must not make it larger."""
    rows = []
    for i, (hw, c, hd, dtype) in enumerate(shapes):
        ops, dy = gate_inputs(batch, hw, c, hd, dtype, seed=200 + i)
        shape = dict(N=batch, HW=hw, C=c, Hd=hd, Cout=c)
        route = fa.gate_bwd_route(dtype, hw, c, hd, c)
        csum_route = fa.gate_fwd_route(dtype, hw, c, hd, c)
        with torch.no_grad():
            before = {k: read_gate_routes(k) for k in ("softmax_bwd", "softmax_csum")}
            kern = run_backward(fa, ops, dy, hw, plain=False)
            want = {"softmax_bwd": dict(before["softmax_bwd"], **{
                route: before["softmax_bwd"][route] + 1}),
                    "softmax_csum": dict(before["softmax_csum"], **{
                        csum_route: before["softmax_csum"][csum_route] + 1})}
            for k in want:
                check(read_gate_routes(k) == want[k],
                      f"{k} at {shape}: not on the {route if k == 'softmax_bwd' else csum_route} "
                      f"route")
            again = run_backward(fa, ops, dy, hw, plain=False)
            simt = simt_again = mixed = mixed_again = None
            if route == "mma":
                simt = run_backward(fa, ops, dy, hw, plain=False, route="simt",
                                    csum_route="simt")
                simt_again = run_backward(fa, ops, dy, hw, plain=False, route="simt",
                                          csum_route="simt")
            if csum_route == "mma":  # the mma backward on the simt csum's c
                mixed = run_backward(fa, ops, dy, hw, plain=False, csum_route="simt")
                mixed_again = run_backward(fa, ops, dy, hw, plain=False, csum_route="simt")
            plain = run_backward(fa, ops, dy, hw, plain=True)
            truth = run_backward(fa, [ops[0].float()] + ops[1:], dy.float(), hw, plain=True)
            torch.cuda.synchronize()
        row = dict(shape=shape, dtype=str(dtype).replace("torch.", ""), route=route,
                   csum_route=csum_route, bwd_grid=bwd_grid_of(fa, route, batch, hw, c, hd))
        for tag, first, second in (("", kern, again), (" (simt)", simt, simt_again),
                                   (" (c from the simt csum)", mixed, mixed_again)):
            if first is not None:
                for name, k, a in zip(GRAD_NAMES, first, second):
                    check(torch.equal(k, a), f"{name} at {shape}{tag}: two runs differ bitwise")
        row["bitwise_repeatable"] = True
        with torch.no_grad():
            m, se = fa.softmax_gate_stats_reference(ops[0].float(), *ops[1:], **KW)
            scales = term_scales(fa, ops[0].float(), dy.float(), *ops[1:], m, se, truth[0],
                                 dict(hw_scale=float(hw), gate_max=16.0, **KW))
        for name, k, p, t, sc in zip(GRAD_NAMES, kern, plain, truth, scales):
            hold(name, shape, k, p, t, dtype, row, scale=sc)
        if simt is not None:  # the simt route on the same inputs, under the same rule
            for name, k, p, t, sc in zip(GRAD_NAMES, simt, plain, truth, scales):
                hold(f"simt_{name}", shape, k, p, t, dtype, row, scale=sc)
        if mixed is not None:  # one l against two: db2 over its term scale either way
            hold("simt_csum_c", shape, mixed[0], plain[0], truth[0], dtype, row, scale=scales[0])
            row["db2_rel_err_c_from_mma_csum"] = rel_err(kern[-1], truth[-1], scales[-1])
            row["db2_rel_err_c_from_simt_csum"] = rel_err(mixed[-1], truth[-1], scales[-1])
            check(row["db2_rel_err_c_from_mma_csum"] <= row["db2_rel_err_c_from_simt_csum"],
                  f"db2 at {shape}: c from the mma csum gives "
                  f"{row['db2_rel_err_c_from_mma_csum']:.3e} of its term scale, more than c "
                  f"from the simt csum ({row['db2_rel_err_c_from_simt_csum']:.3e})")
        del kern, again, simt, simt_again, mixed, mixed_again, plain, truth

        kops = [ops[0], ops[1], ops[2].to(dtype), ops[3], ops[4].to(dtype), ops[5]]
        opts = dict(hw_scale=float(hw), gate_max=16.0, **KW)
        with torch.no_grad():
            m, se = fa.softmax_gate_stats(*kops, **KW)
            cs = fa.softmax_gate_csum(kops[0], dy, *kops[1:], m, se, **opts)

            def csum(r=None):
                return fa.softmax_gate_csum(kops[0], dy, *kops[1:], m, se, route=r, **opts)

            row["softmax_csum"] = timed(
                "softmax_csum", csum,
                lambda: fa.softmax_gate_csum_reference(kops[0], dy, *kops[1:], m, se, **opts),
                batch, hw, c, hd, dtype)
            row["softmax_csum"]["route"] = csum_route
            if csum_route == "mma":
                ms_simt = graph_ms(lambda: csum("simt"))
                row["softmax_csum"].update(
                    ms_simt=ms_simt, share_of_bound_simt=row["softmax_csum"]["bound_ms"] / ms_simt)
                check_mma_wins("softmax_csum", shape, row["softmax_csum"])
            row["softmax_bwd"] = timed(
                "softmax_bwd", lambda: fa.softmax_gate_backward(kops[0], dy, *kops[1:], m, se,
                                                                cs, **opts),
                lambda: fa.softmax_gate_backward_reference(kops[0], dy, *kops[1:], m, se, cs,
                                                           **opts),
                batch, hw, c, hd, dtype)
            row["softmax_bwd"]["route"] = route
            if route == "mma":
                ms_simt = graph_ms(lambda: fa.softmax_gate_backward(
                    kops[0], dy, *kops[1:], m, se, cs, route="simt", **opts))
                row["softmax_bwd"]["ms_simt"] = ms_simt
                row["softmax_bwd"]["share_of_bound_simt"] = row["softmax_bwd"]["bound_ms"] / ms_simt
                check_mma_wins("softmax_bwd", shape, row["softmax_bwd"])
            row["profiler_us_per_call"] = kernel_split(lambda: fa.softmax_gate_backward(
                kops[0], dy, *kops[1:], m, se,
                fa.softmax_gate_csum(kops[0], dy, *kops[1:], m, se, **opts), **opts))
        say(phase, **row)
        rows.append(row)
        del ops, dy, kops, m, se, cs
        torch.cuda.empty_cache()
    return rows


def run_sigmoid(fa, ops, dy, plain: bool, forward: bool = True, route=None, fwd_route=None):
    """(y, dx, dpos_proj, dW1x, db1, dW2, db2) of the sigmoid gate at
    SIGMOID_GATE_MAX, kernels (the backward on `route`, the forward on
    `fwd_route`, each the wrapper's choice where None) or plain versions; y
    is None without `forward`."""
    kw = dict(gate_max=SIGMOID_GATE_MAX, **KW)
    fwd = (fa.sigmoid_gate_reference if plain
           else lambda *a, **k: fa.sigmoid_gate(*a, route=fwd_route, **k))
    bwd = (fa.sigmoid_gate_backward_reference if plain
           else lambda *a, **k: fa.sigmoid_gate_backward(*a, route=route, **k))
    return (fwd(*ops, **kw) if forward else None, *bwd(ops[0], dy, *ops[1:], **kw))


def sigmoid_term_scales(fa, x2d, dy, pp, w1x, b1, w2, b2, gate_max=SIGMOID_GATE_MAX,
                        act=KW["act"], leaky_slope=KW["leaky_slope"]):
    """The sigmoid backward's (dx, dpos_proj, dW1x, db1, dW2, db2) computed
    on the absolute values of their terms, as `term_scales`."""
    cd = x2d.dtype
    xf, dyf = x2d.float(), dy.float()
    w1c, w2c = w1x.to(cd).float(), w2.to(cd).float()
    u = xf @ w1c + pp.float() + b1.float()
    h = fa._act(act, leaky_slope)(u).to(cd).float()
    p = torch.sigmoid(h @ w2c + b2.float())
    dl = (2.0 * p * (1.0 - p) * fa._dgate(xf.abs(), dyf.abs(), w2.shape[1])
          * fa._gate_mask(2.0 * p, gate_max))
    du = fa._act_grad(act, leaky_slope)(u).abs() * (dl @ w2c.abs().t())
    dx = fa._clamp_gate(2.0 * p, gate_max) * dyf.abs() + du @ w1c.abs().t()
    return (dx, du.sum(dim=0), torch.einsum("nsc,nsh->ch", xf.abs(), du),
            du.sum(dim=(0, 1)), torch.einsum("nsh,nsc->hc", h.abs(), dl), dl.sum(dim=(0, 1)))


def sigmoid_gate_cases():
    """Phase 15's (HW, C, Hd, dtype, forward) cases: the shapes where
    ffhq_512-sigmoid runs the gate's kernels outside a fused stage (the
    profile's ranges) in bf16, the C = 512 template's shape at the 4^2
    gate (held on the card wherever the profile sends that gate) and one
    shape in f32, forward and backward, and the backward alone at a fused
    stage's shape that no gate outside one has, in bf16."""
    return ([(hw, c, hd, torch.bfloat16, True) for hw, c, hd in SIGMOID_SHAPES]
            + [(*s, torch.bfloat16, True) for s in SIGMOID_WIDE_SHAPES
               if s not in SIGMOID_SHAPES]
            + [(*SIGMOID_F32_SHAPE, torch.float32, True)]
            + [(*s, torch.bfloat16, False) for s in SIGMOID_STAGE_BWD_SHAPES])


def phase_sigmoid_gate(fa):
    """Phase 15: the sigmoid gate's two kernels against their plain versions
    at the shapes of `sigmoid_gate_cases`, batch 16, under the rules of
    phases 3-4 at gate_max 1.5 (the clamp binds at a
    part of the locations); two runs bitwise equal; each timed beside its
    bound and the plain version's time. sigmoid_bwd runs on the route its
    wrapper picks (`gate_bwd_route`); where that is the mma route (bf16 at
    the 512^2 stage's shape and at C = 512), the simt route runs on the
    same inputs too, under the same rule and twice bitwise equal, is timed
    beside it, and must be slower, as must the plain version; sigmoid_gate
    alike on its route (`sigmoid_gate_route`: the mma route at C = 512),
    where the mma route's grid unsplit over Cout is timed too."""
    n = FFHQ_BATCH
    names = ("y",) + GRAD_NAMES[1:]
    kw = dict(gate_max=SIGMOID_GATE_MAX, **KW)
    rows = []
    for i, (hw, c, hd, dtype, forward) in enumerate(sigmoid_gate_cases()):
        ops, dy = gate_inputs(n, hw, c, hd, dtype, seed=600 + i)
        shape = dict(N=n, HW=hw, C=c, Hd=hd, Cout=c)
        route = fa.gate_bwd_route(dtype, hw, c, hd, c)
        fwd_route = fa.sigmoid_gate_route(dtype, hw, c, hd, c)
        with torch.no_grad():
            before = {k: read_gate_routes(k) for k in SIGMOID_KERNELS}
            kern = run_sigmoid(fa, ops, dy, False, forward)
            for k, r in zip(SIGMOID_KERNELS, (fwd_route, route)):
                want = dict(before[k], **{r: before[k][r] + int(forward or k == "sigmoid_bwd")})
                check(read_gate_routes(k) == want, f"{k} at {shape}: not on the {r} route")
            again = run_sigmoid(fa, ops, dy, False, forward)
            simt = simt_again = None
            if route == "mma" or (forward and fwd_route == "mma"):
                simt = run_sigmoid(fa, ops, dy, False, forward and fwd_route == "mma",
                                   route="simt", fwd_route="simt")
                simt_again = run_sigmoid(fa, ops, dy, False, forward and fwd_route == "mma",
                                         route="simt", fwd_route="simt")
            plain = run_sigmoid(fa, ops, dy, True, forward)
            truth = run_sigmoid(fa, [ops[0].float()] + ops[1:], dy.float(), True, forward)
            scales = (None, *sigmoid_term_scales(fa, ops[0].float(), dy, *ops[1:]))
            l = fa.gate_logits_reference(ops[0].float(), *ops[1:], **KW)
            clamped = float((2.0 * torch.sigmoid(l) > SIGMOID_GATE_MAX).float().mean())
            del l
            torch.cuda.synchronize()
        row = dict(shape=shape, dtype=str(dtype).replace("torch.", ""),
                   gate_max=SIGMOID_GATE_MAX, clamped_share=clamped, route=route,
                   bwd_grid=bwd_grid_of(fa, route, n, hw, c, hd))
        check(0.05 < clamped < 0.95, f"gate_max {SIGMOID_GATE_MAX} clamps {clamped} at {shape}")
        for name, k, a in zip(names, kern, again):
            check(k is None or torch.equal(k, a), f"{name} at {shape}: two runs differ bitwise")
        if simt is not None:
            for name, k, a in zip(names, simt, simt_again):
                check(k is None or torch.equal(k, a),
                      f"{name} at {shape} (simt): two runs differ bitwise")
        row["bitwise_repeatable"] = True
        for name, k, p, t, sc in zip(names, kern, plain, truth, scales):
            if k is not None:
                hold(name, shape, k, p, t, dtype, row, scale=sc)
        if simt is not None:  # the simt route on the same inputs, under the same rule
            for name, k, p, t, sc in zip(names, simt, plain, truth, scales):
                if k is not None:
                    hold(f"simt_{name}", shape, k, p, t, dtype, row, scale=sc)
        del kern, again, simt, simt_again, plain, truth, scales

        kops = [ops[0], ops[1], ops[2].to(dtype), ops[3], ops[4].to(dtype), ops[5]]
        with torch.no_grad():
            if forward:
                row["sigmoid_gate"] = timed(
                    "sigmoid_gate", lambda: fa.sigmoid_gate(*kops, **kw),
                    lambda: fa.sigmoid_gate_reference(*kops, **kw), n, hw, c, hd, dtype)
                row["sigmoid_gate"]["route"] = fwd_route
                if fwd_route == "mma":
                    t = row["sigmoid_gate"]
                    t["ms_simt"] = graph_ms(lambda: fa.sigmoid_gate(*kops, route="simt", **kw))
                    t["share_of_bound_simt"] = t["bound_ms"] / t["ms_simt"]
                    t["splits"] = fa.sigmoid_wide_splits(n, hw, torch.cuda.get_device_properties(
                        0).multi_processor_count)
                    with wide_splits(fa, 1):  # the mma route's grid without the split
                        t["ms_unsplit"] = graph_ms(lambda: fa.sigmoid_gate(*kops, **kw))
                    check_mma_wins("sigmoid_gate", shape, t)
            row["sigmoid_bwd"] = timed(
                "sigmoid_bwd", lambda: fa.sigmoid_gate_backward(kops[0], dy, *kops[1:], **kw),
                lambda: fa.sigmoid_gate_backward_reference(kops[0], dy, *kops[1:], **kw),
                n, hw, c, hd, dtype)
            row["sigmoid_bwd"]["route"] = route
            if route == "mma":
                ms_simt = graph_ms(
                    lambda: fa.sigmoid_gate_backward(kops[0], dy, *kops[1:], route="simt", **kw))
                row["sigmoid_bwd"]["ms_simt"] = ms_simt
                row["sigmoid_bwd"]["share_of_bound_simt"] = row["sigmoid_bwd"]["bound_ms"] / ms_simt
                check_mma_wins("sigmoid_bwd", shape, row["sigmoid_bwd"])
            row["profiler_us_per_call"] = kernel_split(
                lambda: fa.sigmoid_gate_backward(kops[0], dy, *kops[1:], **kw))
        say("sigmoid-gate-kernels-vs-plain", **row)
        rows.append(row)
        del ops, dy, kops
        torch.cuda.empty_cache()
    return rows


@contextlib.contextmanager
def wide_splits(fa, splits: int):
    """Run the sigmoid gate's wide forward split `splits` ways over Cout
    inside the block, whatever `sigmoid_wide_splits` would pick: to time
    its other grids on the same inputs."""
    pick = fa.sigmoid_wide_splits
    fa.sigmoid_wide_splits = lambda n, hw, sms: splits
    try:
        yield
    finally:
        fa.sigmoid_wide_splits = pick


def fill_gammas(model, value: float = 0.5, suffix: str = "gamma") -> int:
    """Set every self-attention block's zero-init `gamma` (or the leaves
    named with another `suffix`: the style family's noise strengths), so
    that the block attends and its gradients are not all zero; returns
    how many."""
    n = 0
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(suffix):
                p.fill_(value)
                n += 1
    return n


def randomize_logit_convs(model, seed: int, scale: float) -> None:
    """Fill the zero-init logit convs (and all biases) so every gate
    varies: a zero logit conv makes the gate exactly 1, and a wrong gate
    MLP would pass unseen. Logits of std about 0.7 * scale."""
    g = torch.Generator(device="cpu")
    g.manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("to_logits.w"):
                hd = p.shape[1]
                p.copy_(torch.randn(p.shape, generator=g) * scale / math.sqrt(hd))
            elif name.endswith(".b"):
                p.copy_(torch.randn(p.shape, generator=g) * 0.1)


def check_attention_layers(fa, captured):
    """Each attention layer of the served batch-64 request, held against
    the plain version on the very activations it received."""
    out = []
    for layer, x, y in captured:
        with torch.inference_mode():
            xc, *w = layer.fused_operands(x)
            n, h, wd, c = xc.shape
            kw = dict(mode="softmax", act=layer.act, leaky_slope=layer.leaky_slope,
                      hw_scale=float(h * wd), gate_max=layer.cfg.gate_max)
            x2d = xc.reshape(n, h * wd, c)
            plain = fa.locate_attention_core_reference(x2d, *w, **kw)
            truth = fa.locate_attention_core_reference(x2d.float(), *w, **kw)
            l = fa.gate_logits_reference(x2d.float(), *w,
                                         act=layer.act, leaky_slope=layer.leaky_slope)
            gate = torch.softmax(l, dim=1) * (h * wd)
        y2d = y.reshape(n, h * wd, c)
        ek, ep = rel_err(y2d, truth), rel_err(plain, truth)
        row = dict(HW=h * wd, C=c, rel_err_kernel_vs_f32=ek, rel_err_plain_vs_f32=ep,
                   max_abs_err_kernel_vs_plain=float((y2d.float() - plain.float()).abs().max()),
                   gate_std=float(gate.std()), clamped_share=float((gate > 16.0).float().mean()))
        check(ek <= max(BF16_FACTOR * ep, 1e-6),
              f"attention layer at HW={h * wd}: kernel error {ek:.3e} > "
              f"{BF16_FACTOR} x plain error {ep:.3e}")
        check(row["gate_std"] > 0.01, f"attention layer at HW={h * wd}: constant gate")
        out.append(row)
    return out


def counters():
    """{kernel: its wrapper} for the fourteen kernels of the three libraries."""
    from locate_tpu_torch.ops import flash_attention as fl
    from locate_tpu_torch.ops import fused_attention as fa
    from locate_tpu_torch.ops import fused_stage as fs

    return {"softmax_stats": fa.softmax_gate_stats, "softmax_apply": fa.softmax_gate_apply,
            "softmax_csum": fa.softmax_gate_csum, "softmax_bwd": fa.softmax_gate_backward,
            **{k: getattr(fs, k) for k in STAGE_KERNELS},
            "sigmoid_gate": fa.sigmoid_gate, "sigmoid_bwd": fa.sigmoid_gate_backward,
            "stage_sigmoid": fs.stage_sigmoid,
            **{k: getattr(fl, k) for k in FLASH_KERNELS}}


def expected(launches: dict, times: int = 1) -> dict:
    """Every counter's launches for `times` runs of a path that launches
    `launches` (the kernels it does not name: none)."""
    return {k: launches.get(k, 0) * times for k in counters()}


def reset_counters():
    for fn in counters().values():
        fn.launches = 0
        for route in ("mma", "simt"):
            if hasattr(fn, f"launches_{route}"):
                setattr(fn, f"launches_{route}", 0)


def read_counters() -> dict:
    return {k: fn.launches for k, fn in counters().items()}


def read_gate_routes(kernel: str = "softmax_bwd") -> dict:
    """{route: launches} of a gate wrapper with two routes (softmax_bwd,
    sigmoid_bwd, softmax_stats, softmax_apply, softmax_csum or
    sigmoid_gate)."""
    return {r: getattr(counters()[kernel], f"launches_{r}") for r in ("mma", "simt")}


def read_fwd_routes() -> dict:
    """{kernel: {route: launches}} of the softmax gate's forward pair."""
    return {k: read_gate_routes(k) for k in GATE_FWD_ROUTED}


def gate_routes_per_step(fa, per_step: dict, steps: int = 1, forward: bool = False,
                         sigmoid: bool = False) -> dict:
    """{route: launches} of a gate kernel with two routes over `steps`
    steps that launch it `per_step[(HW, C, Hd)]` times a step at each
    shape, bf16, Cout = C: a backward (`gate_bwd_route`), softmax_bwd 16
    mma and 8 simt a lsun_bedroom_128 step, 24 and 8 an ffhq_512 one,
    sigmoid_bwd 11 and 5 an ffhq_512-sigmoid one; with `forward` the
    softmax forward pair and csum pass (`gate_fwd_route`), 12 mma and 18
    simt a lsun_bedroom_128 step for stats or apply, 34 / 33 and 33 / 33 an
    ffhq_512 one (stats / apply), csum 9 / 15 and 17 / 15; with `sigmoid`
    the sigmoid gate's forward (`sigmoid_gate_route`), 15 mma and 12 simt
    an ffhq_512-sigmoid step."""
    route_of = (fa.sigmoid_gate_route if sigmoid else fa.gate_fwd_route if forward
                else fa.gate_bwd_route)
    out = {"mma": 0, "simt": 0}
    for (hw, c, hd), k in per_step.items():
        out[route_of(torch.bfloat16, hw, c, hd, c)] += k * steps
    return out


def read_route_counters() -> dict:
    """{kernel: {route: launches}} of the three flash wrappers."""
    from locate_tpu_torch.ops import flash_attention as fl

    return {k: {r: getattr(getattr(fl, k), f"launches_{r}") for r in ("mma", "simt")}
            for k in FLASH_KERNELS}


def read_stage_routes() -> dict:
    """{kernel: {route: launches}} of the fused-stage wrappers with two
    routes (STAGE_ROUTED)."""
    from locate_tpu_torch.ops import fused_stage as fs

    return {k: {r: getattr(getattr(fs, k), f"launches_{r}") for r in ("mma", "simt")}
            for k in STAGE_ROUTED}


def stage_routes_expected(launches: dict, route: str = "mma") -> dict:
    """The route counters of STAGE_ROUTED after `launches` ({kernel:
    launches}), all on `route`."""
    return {k: {r: launches.get(k, 0) * (r == route) for r in ("mma", "simt")}
            for k in STAGE_ROUTED}


def routes_expected(launches: dict, route: str = "mma") -> dict:
    """The route counters of the three flash wrappers after `launches`
    ({kernel: launches}, none where a kernel is not named), all on
    `route`."""
    return {k: {r: launches.get(k, 0) * (r == route) for r in ("mma", "simt")}
            for k in FLASH_KERNELS}


def phase_generator(fa, cfg):
    from locate_tpu_torch.io.sampling import generate_samples
    from locate_tpu_torch.models.generator import build_generator
    from locate_tpu_torch.ops.attention import LocateAttention

    kernel_cfg = dataclasses.replace(cfg.model, use_pallas=True)
    plain_cfg = dataclasses.replace(cfg.model, use_pallas=False)
    model = build_generator(kernel_cfg, "bfloat16", "cuda", seed=0).eval()
    # scale 0.25: the gates vary, and a bf16 generator stays within a few
    # percent of the f32 one; peakier gates concentrate the feature maps
    # and bf16 rounding then moves whole images (both paths alike)
    randomize_logit_convs(model, seed=1, scale=0.25)
    params = sum(p.numel() for p in model.parameters())
    stages = len(cfg.model.stage_resolutions())
    captured = []

    def capture(layer, inputs, output):
        if inputs[0].shape[0] == BATCH:
            captured.append((layer, inputs[0], output))

    hooks = [m.register_forward_hook(capture) for m in model.modules()
             if isinstance(m, LocateAttention)]

    # the serving path: requests through the user-facing entry point
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    requests = (1, 16, BATCH)
    reset_counters()
    images = [generate_samples(model, gen, b) for b in requests]
    launches, fwd_routes = read_counters(), read_fwd_routes()
    for h in hooks:
        h.remove()
    check(len(captured) == stages, f"captured {len(captured)} attention layers")
    layers = check_attention_layers(fa, captured)
    del captured
    for b, img in zip(requests, images):
        check(img.shape == (b, 128, 128, 3) and str(img.dtype) == "uint8",
              f"request of {b}: images {img.shape} {img.dtype}")
        check(float(img.std()) > 0.0, f"request of {b}: constant images")
    want = totals(LSUN_SERVE_PLAN)
    check(launches == expected(want, len(requests)),
          f"serving launched {launches} for {len(requests)} forwards, want {want} each")
    want_routes = gate_routes_per_step(fa, SERVE, len(requests), forward=True)
    check(fwd_routes == {k: want_routes for k in GATE_FWD_ROUTED},
          f"serving's forward passes took the routes {fwd_routes}, want {want_routes} each")

    # the kernel path against the plain path, both against f32
    plain = build_generator(plain_cfg, "bfloat16", "cuda").eval()
    truth = build_generator(plain_cfg, "float32", "cuda").eval()
    plain.load_state_dict(model.state_dict())
    truth.load_state_dict(model.state_dict())
    gz = torch.Generator(device="cuda")
    gz.manual_seed(3)
    z = torch.randn(16, cfg.model.latent_dim, device="cuda", generator=gz)
    with torch.inference_mode():
        yk, yp, yt = (m(z).float() for m in (model, plain, truth))
    torch.cuda.synchronize()
    for name, y in (("kernel", yk), ("plain", yp), ("f32", yt)):
        check(bool(torch.isfinite(y).all()), f"{name} generator: non-finite images")
        check(float(y.abs().max()) <= 1.0, f"{name} generator: images outside [-1, 1]")
    ek, ep = rel_err(yk, yt), rel_err(yp, yt)
    check(ek <= max(BF16_FACTOR * ep, 1e-6),
          f"generator: kernel path error {ek:.3e} > {BF16_FACTOR} x plain path {ep:.3e}")
    say("generator", config="lsun_bedroom_128", params=params, requests=list(requests),
        launches=launches, forward_routes=fwd_routes, rel_err_kernel_path_vs_f32=ek,
        rel_err_plain_path_vs_f32=ep,
        max_abs_err_kernel_vs_plain_path=float((yk - yp).abs().max()),
        image_std=float(yt.std()), attention_layers=layers)
    del model, plain, truth
    torch.cuda.empty_cache()
    return launches


def cli_text(argv) -> str:
    """What `locate_tpu_torch.cli.main(argv)` prints; it must return 0."""
    from locate_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    check(rc == 0, f"{' '.join(argv)} returned {rc}")
    return buf.getvalue()


def run_cli(argv) -> dict:
    """The JSON line a command prints last."""
    return json.loads(cli_text(argv).strip().splitlines()[-1])


def profile_calls(fn, calls: int = 3, top: int = 0):
    """(idle share, top kernels) over `calls` calls of `fn`, from
    torch.profiler: the share of wall time with no kernel running (None
    when it records no device time), and the `top` CUDA kernels by device
    time per call, with their share of the device's busy time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return idle_and_top(prof, wall, calls, top)


def idle_and_top(prof, wall: float, calls: int = 1, top: int = 0):
    """`profile_calls`' two readings of a finished profiler over `wall`
    seconds of `calls` calls. A range a `record_function` annotation
    draws on the device's timeline is no kernel, and is left out."""
    def kernel(ev):
        return (getattr(ev, "device_type", None) == torch.autograd.DeviceType.CUDA
                and not getattr(ev, "is_user_annotation", False))

    spans = [(ev.time_range.start, ev.time_range.end) for ev in prof.events() if kernel(ev)]
    if not spans:
        return None, []
    spans.sort()
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    kernels = []
    if top:
        for ev in prof.key_averages():
            if not kernel(ev):
                continue  # an operator's row: its kernels have rows of their own
            total = getattr(ev, "self_device_time_total", None)
            if total is None:
                total = getattr(ev, "self_cuda_time_total", 0.0)
            if total > 0:
                kernels.append((total, ev.key))
        kernels = [dict(kernel=k[:90], ms_per_call=t / calls * 1e-3, share_of_busy=t / busy)
                   for t, k in sorted(kernels, reverse=True)[:top]]
    return max(0.0, 1.0 - busy * 1e-6 / wall), kernels


def phase_serving(cfg):
    from locate_tpu_torch.io.sampling import generate_samples
    from locate_tpu_torch.models.generator import build_generator

    def bench_sample(use_pallas):
        return run_cli(["bench-sample", "lsun_bedroom_128",
                        f"use_pallas={str(use_pallas).lower()}", "--batch=64", "--steps=10"])

    torch.cuda.reset_peak_memory_stats()
    serve = bench_sample(True)
    peak = torch.cuda.max_memory_allocated()
    serve_plain = bench_sample(False)
    model = build_generator(dataclasses.replace(cfg.model, use_pallas=True),
                            "bfloat16", "cuda").eval()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    idle, _ = profile_calls(lambda: generate_samples(model, gen, BATCH))
    say("serving", kernel_path=serve, plain_path=serve_plain,
        peak_memory_bytes_kernel_path=peak,
        device_idle_share=("not measured" if idle is None else idle))
    del model
    torch.cuda.empty_cache()


def fixed_batch(n, res=128, device="cuda"):
    import numpy as np

    host = np.random.default_rng(0).integers(0, 256, (n, res, res, 3), dtype=np.uint8)
    return {"image": torch.from_numpy(host).to(device),
            "label": torch.zeros(n, dtype=torch.long, device=device)}


def trainer(cfg, seed=0, weights=None):
    """A seeded GAN with non-zero logit convs (and self-attention gammas),
    or with `weights` (G's and D's state_dicts), its fresh state and step."""
    from locate_tpu_torch.models.gan import build_gan
    from locate_tpu_torch.train.state import create_train_state
    from locate_tpu_torch.train.step import make_train_step

    gan = build_gan(cfg, "cuda", seed=seed)
    for net in (gan.generator, gan.discriminator):
        randomize_logit_convs(net, seed=seed + 1, scale=0.25)
        fill_gammas(net)
        fill_gammas(net, 0.1, "noise_strength")
    if weights is not None:
        gan.generator.load_state_dict(weights[0])
        gan.discriminator.load_state_dict(weights[1])
    return gan, create_train_state(cfg, gan, seed=seed + 2), make_train_step(cfg, gan)


def check_history(history, tcfg):
    """The steps' metrics as floats, after checking them: all finite, R1 at
    its steps only, the guard counters as the gradient norms imply (no
    non-finite skips)."""
    history = [{k: float(v) for k, v in m.items()} for m in history]
    for i, m in enumerate(history):
        for k, v in m.items():
            check(math.isfinite(v), f"step {i}: {k} = {v}")
        check((m["r1"] > 0.0) == (i % tcfg.r1_interval == 0), f"step {i}: r1 = {m['r1']}")
    for net in ("d", "g"):
        count = streak = 0
        for i, m in enumerate(history):
            too_large = m[f"{net}_grad_norm"] > tcfg.grad_norm_limit
            count += too_large
            streak = streak + 1 if too_large else 0
            guards = tuple(m[f"{net}_{k}"] for k in ("grad_limit_count", "grad_limit_streak",
                                                    "nonfinite_streak"))
            check(guards == (count, streak, 0),
                  f"step {i}: {net} guard counters {guards}, the norms imply "
                  f"{(count, streak, 0)}")
    return history


def check_moved(before, state, history, tcfg):
    """The largest change of G, D and the EMA (which follows G). A net
    whose update passed the grad-norm guard at some step (a norm above
    `grad_norm_limit` skips the update) moved, and so did the EMA with G;
    a net whose every update was skipped did not move, and the EMA then
    stays on G up to its own rounding."""
    moved = {name: float((after - b).abs().max()) for name, b, after in zip(
        ("g", "d", "ema"), before,
        (state.g_params.flat, state.d_params.flat, state.ema_params))}
    for name, delta in moved.items():
        net = "g" if name == "ema" else name
        applied = sum(not (tcfg.grad_norm_limit > 0.0
                           and m[f"{net}_grad_norm"] > tcfg.grad_norm_limit) for m in history)
        if applied:
            check(delta > 0.0, f"{name} params did not move after {applied} applied updates")
        else:
            check(delta <= (1e-5 if name == "ema" else 0.0),
                  f"{name} params moved by {delta} though the guard skipped every update")
    return moved


def phase_train(fa):
    """Phase 6: the main path, three preset steps from step 0."""
    from locate_tpu_torch.config import get_config

    cfg = get_config("lsun_bedroom_128", {"use_pallas": "true"})
    tcfg = cfg.train
    check(tcfg.global_batch == BATCH and tcfg.compute_dtype == "bfloat16"
          and tcfg.r1_gamma == 1.0 and tcfg.grad_norm_limit == 1e6
          and tcfg.max_nonfinite_skips == 200 and tcfg.ema_decay == 0.999,
          "lsun_bedroom_128 is not the shipped recipe")
    gan, state, step = trainer(cfg)
    batch = fixed_batch(BATCH)
    before = [t.clone() for t in (state.g_params.flat, state.d_params.flat, state.ema_params)]
    steps = 3
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    history = []
    for _ in range(steps):
        state, metrics = step(state, batch)
        history.append(metrics)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counters()
    routes = dict(read_fwd_routes(), softmax_bwd=read_gate_routes(),
                  softmax_csum=read_gate_routes("softmax_csum"))
    history = check_history(history, tcfg)
    moved = check_moved(before, state, history, tcfg)
    # the gate profile's dispatch: G's conv blocks behind an upsample fuse
    per_step = totals(LSUN_PLAN)
    check(launches == expected(per_step, steps),
          f"train steps launched {launches}, want {per_step} per step")
    stage_routes = read_stage_routes()
    check(stage_routes == stage_routes_expected(launches),
          f"train steps' stage kernels took the routes {stage_routes}")
    check(routes["softmax_bwd"] == gate_routes_per_step(fa, BWD_PER_STEP, steps),
          f"train steps' softmax_bwd took the routes {routes['softmax_bwd']}, want "
          f"{gate_routes_per_step(fa, BWD_PER_STEP)} per step")
    for kernel in GATE_FWD_ROUTED:
        want = gate_routes_per_step(fa, FWD_PER_STEP, forward=True)
        check(routes[kernel] == {r: k * steps for r, k in want.items()},
              f"train steps' {kernel} took the routes {routes[kernel]}, want {want} per step")
    # csum takes the forward pair's route at the backward's shapes
    want = gate_routes_per_step(fa, BWD_PER_STEP, forward=True)
    check(routes["softmax_csum"] == {r: k * steps for r, k in want.items()},
          f"train steps' softmax_csum took the routes {routes['softmax_csum']}, want {want} "
          f"per step")
    say("train", config="lsun_bedroom_128 as shipped, use_pallas=true", batch=BATCH,
        steps=steps, seconds=seconds, launches=launches, gate_routes=routes,
        metrics=history, max_param_change=moved,
        params=dict(g=state.g_params.flat.numel(), d=state.d_params.flat.numel()))
    weights = (gan.generator.state_dict(), gan.discriminator.state_dict())
    del gan, state, step, before
    torch.cuda.empty_cache()
    return cfg, weights, launches, routes


@contextlib.contextmanager
def checked_gate_backward(fa, record, mode="softmax"):
    """Hold every backward of the gate Function (`SoftmaxGate`, or
    `SigmoidGate` for mode "sigmoid") run inside the block against the
    plain backward on the very tensors that call saved: in bf16 by the rule
    of phase 4 (against an f32 plain backward of the same inputs), in f32
    to F32_TOL. One row per call goes to `record`. The saved tensors are
    unpacked once (a checkpointed stage allows no more) and the wrapper
    runs the Function's kernel backward on them itself."""
    gate = fa.SigmoidGate if mode == "sigmoid" else fa.SoftmaxGate
    original = gate.backward

    def softmax(x2d, dy, pp, w1x, b1, w2, b2, m, se, opts):
        """(kernel, plain, f32 plain, term scales) of a SoftmaxGate call."""
        def plain(x, d, m, se):
            c = fa.softmax_gate_csum_reference(x, d, pp, w1x, b1, w2, b2, m, se, **opts)
            return fa.softmax_gate_backward_reference(x, d, pp, w1x, b1, w2, b2, m, se, c,
                                                      **opts)

        c = fa.softmax_gate_csum(x2d, dy, pp, w1x, b1, w2, b2, m, se, **opts)
        grads = fa.softmax_gate_backward(x2d, dy, pp, w1x, b1, w2, b2, m, se, c, **opts)
        p = t = plain(x2d, dy, m, se)
        xf = x2d.float()
        stats = fa.softmax_gate_stats_reference(xf, pp, w1x, b1, w2, b2, act=opts["act"],
                                                leaky_slope=opts["leaky_slope"])
        if x2d.dtype == torch.bfloat16:  # the f32 truth, its own softmax stats
            t = plain(xf, dy.float(), *stats)
        c = fa.softmax_gate_csum_reference(xf, dy.float(), pp, w1x, b1, w2, b2, *stats, **opts)
        scales = term_scales(fa, xf, dy.float(), pp, w1x, b1, w2, b2, *stats, c, opts)
        return grads, p, t, scales[1:]

    def sigmoid(x2d, dy, pp, w1x, b1, w2, b2, opts):
        """(kernel, plain, f32 plain, term scales) of a SigmoidGate call."""
        grads = fa.sigmoid_gate_backward(x2d, dy, pp, w1x, b1, w2, b2, **opts)
        p = t = fa.sigmoid_gate_backward_reference(x2d, dy, pp, w1x, b1, w2, b2, **opts)
        xf, dyf = x2d.float(), dy.float()
        if x2d.dtype == torch.bfloat16:
            t = fa.sigmoid_gate_backward_reference(xf, dyf, pp, w1x, b1, w2, b2, **opts)
        return grads, p, t, sigmoid_term_scales(fa, xf, dyf, pp, w1x, b1, w2, b2, **opts)

    def backward(ctx, dy):
        saved, opts = ctx.saved_tensors, ctx.options
        check(opts["act"] in fa.BWD_ACTS, f"no backward kernel for {opts['act']}")
        with torch.no_grad():
            grads, p, t, scales = (sigmoid if mode == "sigmoid" else softmax)(
                saved[0], dy, *saved[1:], opts)
        x2d, w1x, w2 = saved[0], saved[2], saved[4]
        n, hw, c = x2d.shape
        widths = (x2d.dtype, hw, c, w1x.shape[1], w2.shape[1])
        row = dict(N=n, HW=hw, C=c, dtype=str(x2d.dtype).replace("torch.", ""),
                   route=fa.gate_bwd_route(*widths))
        if mode != "sigmoid":  # the csum pass's route, the forward pair's
            row["csum_route"] = fa.gate_fwd_route(*widths)
        shape = dict(N=n, HW=hw, C=c)
        for name, k, pi, ti, sc in zip(GRAD_NAMES[1:], grads, p, t, scales):
            hold(name, shape, k, pi, ti, x2d.dtype, row, scale=sc)
        record.append(row)
        # none for the Function's non-tensor arguments, the options
        return (*grads, *[None] * len(opts))

    gate.backward = staticmethod(backward)
    try:
        yield
    finally:
        gate.backward = original


def step_grads(cfg, weights, z_d, z_g, res, use_pallas, dtype, perturb=0.0):
    """(D gradient, G gradient, D loss, G loss, r1) of one step's two halves
    on one path, from `weights`; `perturb` scales every weight by
    (1 + perturb * N(0, 1)) first."""
    from locate_tpu_torch.models.gan import build_gan
    from locate_tpu_torch.train.state import create_train_state
    from locate_tpu_torch.train.step import make_train_step

    pcfg = dataclasses.replace(
        cfg, use_pallas=use_pallas,
        model=dataclasses.replace(cfg.model, use_pallas=use_pallas),
        train=dataclasses.replace(cfg.train, compute_dtype=dtype))
    gan = build_gan(pcfg, "cuda")
    gan.generator.load_state_dict(weights[0])
    gan.discriminator.load_state_dict(weights[1])
    if perturb:
        g = torch.Generator(device="cuda")
        g.manual_seed(9)
        with torch.no_grad():
            for p in [*gan.generator.parameters(), *gan.discriminator.parameters()]:
                p.mul_(1.0 + perturb * torch.randn(p.shape, device="cuda", generator=g))
    state = create_train_state(pcfg, gan)
    step = make_train_step(pcfg, gan)
    real, labels, draws = step.prepare(state, fixed_batch(z_d.shape[0], res), z_d=z_d,
                                       z_g=z_g)
    with torch.no_grad():
        fake = gan.generator(draws["z_d"], draws.get("labels_d"))
    d_loss, d_aux, d_grads, _ = step.d_loss_and_grads(state, real, labels, fake,
                                                      draws.get("labels_d"), draws,
                                                      step.r1_due(state.step))
    g_loss, _, g_grads = step.g_loss_and_grads(state, draws["z_g"], draws.get("labels_g"),
                                               real, labels, {}, draws, False)
    torch.cuda.synchronize()
    out = (d_grads, g_grads, float(d_loss), float(g_loss), float(d_aux.get("r1", 0.0)))
    del gan, state, step
    torch.cuda.empty_cache()
    return out


def phase_train_grads(fa, cfg, weights):
    """Phase 6, second half: one step's gradients (R1 firing) on several
    paths from one state, batch and pair of latents."""
    g = torch.Generator(device="cuda")
    g.manual_seed(5)
    z_d = torch.randn(BATCH, cfg.model.latent_dim, device="cuda", generator=g)
    z_g = torch.randn(BATCH, cfg.model.latent_dim, device="cuda", generator=g)

    # 128^2, bf16: the kernel path's error against f32 at most twice the
    # plain path's; each gate backward of the kernel path held to the plain
    # backward on its own saved tensors
    calls = []
    with checked_gate_backward(fa, calls):
        kernel = step_grads(cfg, weights, z_d, z_g, 128, True, "bfloat16")
    want = sum(BWD_PER_STEP.values())
    check(len(calls) == want, f"{len(calls)} gate backward calls in one step's gradients, "
                              f"want {want}")
    want = gate_routes_per_step(fa, BWD_PER_STEP)
    got = {r: sum(call["route"] == r for call in calls) for r in want}
    check(got == want, f"one step's gate backward calls took the routes {got}, want {want}")
    want = gate_routes_per_step(fa, BWD_PER_STEP, forward=True)
    got = {r: sum(call["csum_route"] == r for call in calls) for r in want}
    check(got == want, f"one step's csum calls took the routes {got}, want {want}")
    paths = {"kernel": kernel,
             "plain": step_grads(cfg, weights, z_d, z_g, 128, False, "bfloat16"),
             "f32": step_grads(cfg, weights, z_d, z_g, 128, False, "float32"),
             # how far the f32 plain path itself moves when the weights move by 1e-7
             "f32_perturbed": step_grads(cfg, weights, z_d, z_g, 128, False, "float32",
                                         perturb=1e-7)}
    rows = {}
    for i, net in enumerate(("D", "G")):
        ek = rel_err(paths["kernel"][i], paths["f32"][i])
        ep = rel_err(paths["plain"][i], paths["f32"][i])
        rows[net] = dict(rel_err_kernel_vs_f32=ek, rel_err_plain_vs_f32=ep,
                         rel_change_f32_at_1e7_weight_noise=rel_err(
                             paths["f32_perturbed"][i], paths["f32"][i]))
        check(ek <= BF16_FACTOR * ep,
              f"{net} gradient: kernel path error {ek:.3e} > {BF16_FACTOR} x plain {ep:.3e}")
    worst = {name: max(r[f"{name}_rel_err_kernel_vs_f32"] / max(r[f"{name}_rel_err_plain_vs_f32"],
                                                              1e-12) for r in calls)
             for name in GRAD_NAMES[1:]}

    # 64^2 (one stage fewer, the same widths), f32: the kernel path within
    # TRAIN_F32_TOL of the plain path, every gate backward within F32_TOL
    from locate_tpu_torch.config import get_config

    cfg64 = get_config("lsun_bedroom_128", {"use_pallas": "true", "model.resolution": "64",
                                            "data.resolution": "64"})
    gan, _, _ = trainer(cfg64)
    w64 = (gan.generator.state_dict(), gan.discriminator.state_dict())
    del gan
    calls64 = []
    with checked_gate_backward(fa, calls64):
        k64 = step_grads(cfg64, w64, z_d, z_g, 64, True, "float32")
    p64 = step_grads(cfg64, w64, z_d, z_g, 64, False, "float32")
    noisy64 = step_grads(cfg64, w64, z_d, z_g, 64, False, "float32", perturb=1e-7)
    for i, net in enumerate(("D", "G")):
        e, moved = rel_err(k64[i], p64[i]), rel_err(noisy64[i], p64[i])
        limit = max(TRAIN_F32_TOL, 10.0 * moved)
        rows[net].update(rel_err_kernel_vs_plain_f32_at_64=e,
                         rel_change_f32_at_64_at_1e7_weight_noise=moved)
        check(e <= limit, f"{net} gradient at 64^2 f32: kernel path error {e:.3e} > {limit:.3e}")
    say("train-grads", batch=BATCH, r1_fired=True, gradients=rows,
        gate_backward_calls_checked={"bf16_128": len(calls), "f32_64": len(calls64)},
        worst_kernel_over_plain_error_ratio_bf16=worst,
        losses={k: dict(d_loss=v[2], g_loss=v[3], r1=v[4]) for k, v in paths.items()})


# phases 7 and 28 profile one eager step a path or feed (3 before phases
# 37-38; CUTS)
PROFILED_EAGER_STEPS = 1
# the calls `bench 128 N` times in phases 7, 28 and 31
BENCH_CALLS = "20"
# the calls each of phase 29's in-process benches times (20 before phases
# 37-38; CUTS)
LOOP_BENCH_CALLS = 10
# the depth cut to keep the script inside its time with phases 37-38,
# printed on a line each
CUTS = {"phase 7": "profiles 1 eager step of each path (was 3)",
        "phase 28": "packs 1024 images (was 2048); profiles 1 eager step a feed (was 3)",
        "phase 29": f"its two in-process benches time {LOOP_BENCH_CALLS} calls each (was 20)",
        "phase 37": "times the step on bench's config (no R1): 2 eager steps after 2, one "
                    "8-step graph call after its capture"}


def phase_train_throughput():
    """Phase 7: `bench 128 BENCH_CALLS` (16 steps a call, a CUDA graph of the step,
    and one step a call beside it) on the kernel path and the plain path:
    the kernel path faster at both; peak memory with R1; the idle share
    and top kernels of PROFILED_EAGER_STEPS eager step(s) and of one
    4-step graph call."""
    from locate_tpu_torch import cli
    from locate_tpu_torch.config import get_config
    from locate_tpu_torch.train.step import make_multi_step

    kernel = run_cli(["bench", "128", BENCH_CALLS])
    torch.cuda.empty_cache()
    plain = run_cli(["bench", "128", BENCH_CALLS, "xla"])
    torch.cuda.empty_cache()
    check(kernel["flops_per_step"] == plain["flops_per_step"], "flop counts differ")
    check(kernel["steps_per_call"] == plain["steps_per_call"] == 16, "bench did not run spc=16")
    for key in ("value", "single_step_images_per_sec"):
        check(kernel[key] > plain[key], f"bench 128 {BENCH_CALLS} {key}: the kernel path "
                                        f"({kernel[key]}) is not faster than the plain path "
                                        f"({plain[key]})")
    peaks = {}
    for remat in (True, False):
        cfg = get_config("lsun_bedroom_128", {"use_pallas": "true",
                                              "train.global_batch": "128",
                                              "train.r1_remat": str(remat).lower()})
        gan, state, step = trainer(cfg)
        batch = fixed_batch(128)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state, metrics = step(state, batch)  # step 0: R1 fires
        torch.cuda.synchronize()
        check(float(metrics["r1"]) > 0.0, "R1 did not fire at step 0")
        peaks[f"r1_remat={remat}"] = torch.cuda.max_memory_allocated()
        del gan, state, step, batch
        torch.cuda.empty_cache()
    profiles = {}
    for name, use_pallas in (("kernel_path", True), ("plain_path", False)):
        gan, state, step = trainer(cli.bench_config(128, [] if use_pallas else ["xla"]))
        batch = fixed_batch(128)
        idle, top = profile_calls(lambda: step(state, batch), calls=PROFILED_EAGER_STEPS,
                                  top=15)
        multi = make_multi_step(step, 4)
        batches = stacked_batch(4, 128)
        graph_idle, graph_top = profile_calls(lambda: multi(state, batches), calls=1, top=15)
        profiles[name] = dict(device_idle_share="not measured" if idle is None else idle,
                              top_kernels=top,
                              graph_call_4_steps=dict(
                                  device_idle_share=("not measured" if graph_idle is None
                                                     else graph_idle), top_kernels=graph_top))
        del gan, state, step, batch, multi, batches
        release_memory()
    say("train-throughput", kernel_path=kernel, plain_path=plain,
        peak_memory_bytes_batch128_with_r1=peaks, profiled_eager_steps=PROFILED_EAGER_STEPS,
        profile_batch128=profiles)
    return kernel, plain


# ---------------------------------------------------------------------------
# ffhq_512: the fused-stage path
# ---------------------------------------------------------------------------

STAGE_KW = dict(act="leaky_relu", leaky_slope=0.2)
BWD_NAMES = ("du", "dxs", "dWr", "dWc", "db_col", "dWskip")
STAGE_OUTPUTS = {"stage_conv": ("y",), "stage_softmax_stats": ("w_pre", "m", "se"),
                 "stage_softmax_apply_pool": ("y",), "stage_conv_bwd": BWD_NAMES,
                 "stage_sigmoid": ("y",)}
# (kernel, form, C, Co, fine resolution, batch): at ffhq_512's 512^2 stage
# every form, G's `up` from 256^2 x 64 and D's plain ones; `down` is the
# conv-only pool tail; `skip` a 1x1 skip; then the `up` forms at the other
# resolutions where the gate profile fuses a stage of ffhq_512 (batch 16)
# or of lsun_bedroom_128 (batch 64)
STAGE_CASES_512 = [("stage_softmax_stats", "up", 64, 64), ("stage_softmax_stats", "plain", 64, 64),
                   ("stage_softmax_apply_pool", "plain", 64, 64),
                   ("stage_conv", "plain", 64, 64), ("stage_conv", "up", 64, 64),
                   ("stage_conv", "down", 64, 64), ("stage_conv", "skip", 32, 64),
                   ("stage_conv_bwd", "plain", 64, 64), ("stage_conv_bwd", "up", 64, 64),
                   ("stage_softmax_stats", "skip", 32, 64), ("stage_conv_bwd", "skip", 32, 64)]


def planned_cases(kernels, plans, n, skip=()):
    """(kernel, form, 64, 64, res, n) of each form@res below 512^2 that
    `plans` launch for `kernels` (not in `skip`)."""
    out = []
    for kernel in kernels:
        keys = sorted({key for plan in plans for key in plan[kernel]},
                      key=lambda k: int(k.split("@")[1]))
        for key in keys:
            form, res = key.split("@")
            case = (kernel, form, 64, 64, int(res), n)
            if int(res) < 512 and case not in skip:
                out.append(case)
    return out


STAGE_CASES = ([c + (512, FFHQ_BATCH) for c in STAGE_CASES_512]
               + planned_cases(STAGE_KERNELS, [FFHQ_PLAN], FFHQ_BATCH)
               + planned_cases(STAGE_KERNELS, [LSUN_PLAN, SELF_PLAN], BATCH))
# the sigmoid pass: G's `up`, D's `down`, and the plain and 1x1-skip forms
SIGMOID_STAGE_CASES = ([("stage_sigmoid", form, c, 64, 512, FFHQ_BATCH)
                        for form, c in (("up", 64), ("down", 64), ("plain", 64), ("skip", 32))]
                       + planned_cases(("stage_sigmoid",), [SIGMOID_PLAN], FFHQ_BATCH))


def stage_key(form, res, n):
    """A stage time's key: form@res at ffhq_512's batch, form@res/N else."""
    return f"{form}@{res}" if n == FFHQ_BATCH else f"{form}@{res}/{n}"


def stage_inputs(n, hin, c, co, dtype, seed):
    """(x, a, b, wr, wc, b_col, ws) of one stage as the kernels take them:
    weights scaled to keep the stage's output of order one."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)

    def r(*shape, scale=0.1):
        return torch.randn(*shape, device="cuda", generator=g) * scale

    ws = r(c, co, scale=1 / math.sqrt(c)).to(dtype) if c != co else None
    return [r(n, hin, hin, c, scale=1.0).to(dtype), 1 + r(n, c), r(n, c),
            r(3, c, co, scale=1 / math.sqrt(3 * c)).to(dtype),
            r(3, co, co, scale=1 / math.sqrt(3 * co)).to(dtype), r(co), ws]


def stage_gate(hw, co, seed):
    """(pos_proj, w1x, b1, w2, b2), f32, making the gate vary and pass 16."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    hd = co // 4
    r = lambda *shape, scale: torch.randn(*shape, device="cuda", generator=g) * scale  # noqa
    return [r(hw, hd, scale=0.5), r(co, hd, scale=1 / math.sqrt(co)), r(hd, scale=0.1),
            r(hd, co, scale=3 / math.sqrt(hd)), r(co, scale=0.1)]


def as_f32(ts):
    return [None if t is None else t.float() for t in ts]


def run_stage(fs, kind, ops, gate, form, dw=None, stats=None, plain=False, route=None):
    """One fused-stage kernel (or its plain version) on `ops`: its outputs,
    named by STAGE_OUTPUTS[kind]. The apply pass takes x as w_pre, with
    the softmax statistics `stats` of its gate logits. `route` goes to the
    kernels of STAGE_ROUTED (None: the wrapper's choice)."""
    up, down = form == "up", form == "down"
    routed = {} if plain else dict(route=route)
    if kind == "stage_conv":
        fn = fs.stage_conv_reference if plain else fs.stage_conv
        return (fn(*ops, upsample=up, downsample=down, **STAGE_KW, **routed),)
    if kind == "stage_sigmoid":
        fn = fs.stage_sigmoid_reference if plain else fs.stage_sigmoid
        return (fn(*ops, *gate, upsample=up, downsample=down, gate_max=SIGMOID_GATE_MAX,
                   **STAGE_KW, **routed),)
    if kind == "stage_softmax_stats":
        fn = fs.stage_softmax_stats_reference if plain else fs.stage_softmax_stats
        return fn(*ops, *gate, upsample=up, **STAGE_KW, **routed)
    if kind == "stage_softmax_apply_pool":
        h, w = ops[0].shape[1:3]
        fn = fs.stage_softmax_apply_pool_reference if plain else fs.stage_softmax_apply_pool
        return (fn(ops[0], *gate, *stats, hw_scale=float(h * w), gate_max=16.0, **STAGE_KW,
                   **routed),)
    fn = fs.stage_conv_bwd_reference if plain else fs.stage_conv_bwd
    return fn(ops[0], dw, *ops[1:5], ops[6], upsample=up, **STAGE_KW, **routed)


def conv_bwd_scales(fs, ops, dw, up):
    """`stage_conv_bwd`'s outputs computed on the absolute values of their
    terms (f32): the scale each sum's rounding error grows with."""
    x, a, b, wr, wc, _, ws = as_f32(ops)
    u = fs._norm_act(x, a, b, **STAGE_KW)
    if up:
        u = fs.up2x(u)
    v = fs._conv3(u, wr, dim=2)
    dy0 = dw.float().abs() * fs.SQRT_HALF
    dv = fs._conv3(dy0, wc.abs().transpose(1, 2), dim=1, sign=-1)
    du = fs._conv3(dv, wr.abs().transpose(1, 2), dim=2, sign=-1)
    dwc = torch.einsum("nhwkj,nhwc->kjc", fs._taps(v.abs(), 1).unflatten(-1, (3, -1)), dy0)
    dwr = torch.einsum("nhwkc,nhwo->kco", fs._taps(u.abs(), 2).unflatten(-1, (3, -1)), dv)
    dbc = dy0.sum(dim=(0, 1, 2))
    if up:
        du, dy0 = fs._pool2x_sum(du), fs._pool2x_sum(dy0)
    if ws is None:
        return du, dy0, dwr, dwc, dbc, None
    return (du, dy0 @ ws.abs().t(), dwr, dwc, dbc,
            torch.einsum("nhwc,nhwo->co", x.abs(), dy0))


def stage_bound(kind, n, c, co, dtype, form, h=512):
    """(bound_ms, bound_by) of one stage kernel at (N, h, h) fine pixels:
    the bytes it must move (x, dw, w_pre in and out once, weights, f32
    statistics and weight gradients) over the memory rate, and the convs'
    and gate MLP's multiply-adds over the peak rate of the operand type."""
    es = torch.finfo(dtype).bits // 8
    up, down = form == "up", form == "down"
    pf = n * h * h                       # fine pixels
    px = pf // 4 if up else pf           # x-side pixels
    skip = c != co
    hd = co // 4
    weights = (3 * c * co + 3 * co * co + (c * co if skip else 0)) * es + co * 4 + 2 * n * c * 4
    gate_weights = 2 * co * hd * es + (h * h * hd + hd + co) * 4  # pos_proj among them
    gate_bytes = gate_weights + 2 * n * co * 4  # and the softmax statistics
    conv_flops = 2.0 * pf * 3 * (c * co + co * co) + (2.0 * px * c * co if skip else 0.0)
    gate_flops = 2.0 * pf * 2 * co * hd
    if kind == "stage_conv":
        nbytes = px * c * es + pf * co * es // (4 if down else 1) + weights
        flops = conv_flops
    elif kind == "stage_softmax_stats":
        nbytes, flops = px * c * es + pf * co * es + weights + gate_bytes, conv_flops + gate_flops
    elif kind == "stage_sigmoid":  # x in, y out (pooled under down), no statistics
        nbytes = px * c * es + pf * co * es // (4 if down else 1) + weights + gate_weights
        flops = conv_flops + gate_flops
    elif kind == "stage_softmax_apply_pool":
        nbytes, flops = pf * co * es + pf * co * es // 4 + gate_bytes, gate_flops
    else:  # recompute v; dv, du; dWr, dWc; the skip's two products
        nbytes = 3 * px * c * es + pf * co * es + weights + (3 * c * co + 3 * co * co + co) * 4
        flops = (2.0 * pf * 3 * (3 * c * co + 2 * co * co)
                 + (4.0 * px * c * co if skip else 0.0))
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_stage_kernels(fs, fa, cases=STAGE_CASES, phase="stage-kernels-vs-plain"):
    """Phase 9 (and 16 with the sigmoid cases): the fused-stage kernels
    against their plain versions at ffhq_512's 512^2 stage shapes, batch
    16, and at the smaller stages the gate profile fuses (STAGE_CASES), in
    bf16 (timed) and f32; the backward's outputs against their
    absolute-term scales, and bitwise repeatable in f32; the sigmoid pass
    at gate_max 1.5, where the clamp binds at a part of the pixels. The
    kernels of STAGE_ROUTED (all five) run bf16 on the mma route (the
    wrappers' choice) and, on the same inputs, on the simt route, both
    under the bf16 rule, each case twice and bitwise equal; the mma route
    must be the faster; f32 takes the simt route."""
    rows, times, max_err = [], {}, {}
    for i, (kind, form, c, co, res, n) in enumerate(cases):
        for dtype in (torch.bfloat16, torch.float32):
            ops = stage_inputs(n, res // 2 if form == "up" else res, c, co, dtype, seed=300 + i)
            gate = stage_gate(res * res, co, seed=400 + i)
            dw = None
            if kind == "stage_conv_bwd":
                g = torch.Generator(device="cuda")
                g.manual_seed(500 + i)
                dw = torch.randn(n, res, res, co, device="cuda", generator=g).to(dtype)
            shape = dict(kernel=kind, form=form, N=n, H=res, C=c, Co=co)
            row = dict(shape, dtype=str(dtype).replace("torch.", ""))
            with torch.no_grad():
                # the apply pass's statistics, each path's own: x's in its
                # dtype for the kernel and the plain version, f32 for the truth
                stats = truth_stats = None
                if kind == "stage_softmax_apply_pool":
                    stats, truth_stats = (fa.softmax_gate_stats_reference(
                        t.reshape(n, res * res, co), *gate, **STAGE_KW)
                        for t in (ops[0], ops[0].float()))
                routed = kind in STAGE_ROUTED
                before = read_stage_routes()
                kern = run_stage(fs, kind, ops, gate, form, dw, stats)
                if routed:
                    row["route"] = fs.MMA if dtype == torch.bfloat16 else fs.SIMT
                    want = {k: dict(before[k]) for k in STAGE_ROUTED}
                    want[kind][row["route"]] += 1
                    check(read_stage_routes() == want,
                          f"{kind} {form} {dtype}: not on the {row['route']} route")
                plain = run_stage(fs, kind, ops, gate, form, dw, stats, plain=True)
                truth = (plain if dtype == torch.float32 else
                         run_stage(fs, kind, as_f32(ops), gate, form,
                                   None if dw is None else dw.float(), truth_stats, plain=True))
                scales = ((None,) * len(kern) if dw is None
                          else conv_bwd_scales(fs, ops, dw, form == "up"))
                if routed:
                    again = run_stage(fs, kind, ops, gate, form, dw, stats)
                    for name, k, a in zip(STAGE_OUTPUTS[kind], kern, again):
                        check(k is None or torch.equal(k, a),
                              f"{kind} {form}: {name} differs bitwise between two runs")
                    row["bitwise_repeatable"] = True
                    del again
                simt = (run_stage(fs, kind, ops, gate, form, dw, stats, route=fs.SIMT)
                         if routed and dtype == torch.bfloat16 else None)
                torch.cuda.synchronize()
            for name, k, p, t, sc in zip(STAGE_OUTPUTS[kind], kern, plain, truth, scales):
                if k is None:
                    continue
                hold(name, shape, k, p, t, dtype, row, scale=sc)
                max_err[kind] = max(max_err.get(kind, 0.0), row[f"{name}_max_abs_err"])
            if simt is not None:  # the simt route on the same inputs, under the same rule
                for name, k, p, t, sc in zip(STAGE_OUTPUTS[kind], simt, plain, truth, scales):
                    if k is not None:
                        hold(f"simt_{name}", shape, k, p, t, dtype, row, scale=sc)
            if kind == "stage_sigmoid" and dtype == torch.float32:
                with torch.no_grad():
                    w = fs.stage_conv_reference(*ops, upsample=form == "up", **STAGE_KW)
                    l = fa.gate_logits_reference(w.reshape(n, res * res, co), *gate, **STAGE_KW)
                    row["clamped_share"] = float(
                        (2.0 * torch.sigmoid(l) > SIGMOID_GATE_MAX).float().mean())
                    del w, l
                check(0.05 < row["clamped_share"] < 0.95,
                      f"{kind} {form}: gate_max {SIGMOID_GATE_MAX} clamps {row['clamped_share']}")
            del kern, plain, truth, scales, simt
            if dtype == torch.bfloat16:
                with torch.no_grad():
                    ms = graph_ms(lambda: run_stage(fs, kind, ops, gate, form, dw, stats), 3, 3)
                    plain_ms = graph_ms(lambda: run_stage(fs, kind, ops, gate, form, dw, stats,
                                                          plain=True), 3, 3)
                    ms_simt = (graph_ms(lambda: run_stage(fs, kind, ops, gate, form, dw, stats,
                                                          route=fs.SIMT), 3, 3)
                               if kind in STAGE_ROUTED else None)
                b_ms, b_by = stage_bound(kind, n, c, co, dtype, form, res)
                key = (kind, stage_key(form, res, n))
                times[key] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                                  share_of_bound=b_ms / ms)
                if ms_simt is not None:
                    times[key].update(ms_simt=ms_simt, route=fs.MMA)
                    check(ms < ms_simt, f"{kind} {form} at {res}^2: the mma route ({ms:.4f} "
                                        f"ms) is not faster than the simt route "
                                        f"({ms_simt:.4f} ms)")
                row.update(times[key])
            say(phase, **row)
            rows.append(row)
            del ops, gate, dw, stats, truth_stats
            torch.cuda.empty_cache()
    return rows, times, max_err


# se of the fused stage against softmax_stats_mma's on its w: the same
# per-warp (max, sum-exp) pairs of 16 locations, merged in two orders; the
# longer chain is the merge of a 512^2 image's 2,048 tiles, plus at most
# 128 rescalings (exp, product, sum) on a term's way there: that many f32
# steps of 2^-24
SE_ORDER_TOL = (512 * 512 // 128 + 128) * 2.0 ** -24


def phase_stage_shares_l(fs, fa, phase="stage-stats-vs-gate-stats"):
    """Phase 9's last check: at ffhq_512's 512^2 stage (batch 16, bf16, G's
    `up` and D's plain form) the fused stage's statistics (m, se from
    stage_softmax_stats_mma) against softmax_stats_mma on the pre-gate w
    the stage stores, with the same gate weights. Both compute l by
    gate_mlp_mma from the same bf16 w, so m must be bitwise equal, and se
    equal up to the order of its f32 sums (SE_ORDER_TOL): the fused path
    and the unfused apply that G's 512^2 stage runs on m and se see one l."""
    n = FFHQ_BATCH
    rows = []
    for i, form in enumerate(("up", "plain")):
        ops = stage_inputs(n, 256 if form == "up" else 512, 64, 64, torch.bfloat16, seed=600 + i)
        gate = stage_gate(512 * 512, 64, seed=700 + i)
        with torch.no_grad():
            before = dict(read_stage_routes()["stage_softmax_stats"])
            w_pre, m, se = run_stage(fs, "stage_softmax_stats", ops, gate, form)
            check(read_stage_routes()["stage_softmax_stats"]["mma"] == before["mma"] + 1,
                  f"the {form} stage's statistics: not on the mma route")
            before = read_gate_routes("softmax_stats")
            m2, se2 = fa.softmax_gate_stats(w_pre.reshape(n, 512 * 512, 64), *gate, **STAGE_KW)
            check(read_gate_routes("softmax_stats")["mma"] == before["mma"] + 1,
                  f"softmax_gate_stats on the {form} stage's w: not on the mma route")
            torch.cuda.synchronize()
        se_diff = float(((se2 - se).abs() / se).max())
        row = dict(form=form, N=n, H=512, C=64, m_bitwise_equal=bool(torch.equal(m, m2)),
                   m_max_abs_diff=float((m2 - m).abs().max()), se_max_rel_diff=se_diff,
                   se_tolerance=SE_ORDER_TOL)
        say(phase, **row)
        check(row["m_bitwise_equal"], f"the {form} stage's m differs from softmax_stats_mma's on "
                                      f"its w by up to {row['m_max_abs_diff']:.3e}")
        check(se_diff <= SE_ORDER_TOL, f"the {form} stage's se differs from softmax_stats_mma's "
                                       f"by {se_diff:.3e} relative, over {SE_ORDER_TOL:.3e}")
        rows.append(row)
        del ops, gate, w_pre, m, se, m2, se2
        torch.cuda.empty_cache()
    return rows


def plain_stage_backward(fs, fa, o, gy, saved):
    """`FusedStage`'s backward chain on its saved tensors through the
    kernels' plain versions: the gradients of its twelve inputs."""
    x, gn_scale, gn_bias, w_row, w_col, b_col, w_skip, *gate = saved
    kw = dict(act=o.act, leaky_slope=o.leaky_slope)
    if o.downsample:
        gy = fs.up2x(gy.float() * 0.25).to(gy.dtype)
    a, b = fs.fold_groupnorm(x, gn_scale, gn_bias, o.groups, o.eps)
    wr, wc, ws = fs.kernel_weights(w_row, w_col, w_skip, x.dtype)
    gate_grads, dw = (None,) * 5, gy
    if o.mode is not None:
        w_pre = fs.stage_conv_reference(x, a, b, wr, wc, b_col, ws, upsample=o.upsample, **kw)
        n, h, w, co = w_pre.shape
        w2d, gy2 = w_pre.reshape(n, h * w, co), gy.reshape(n, h * w, co)
        if o.mode == "softmax":
            opts = dict(hw_scale=float(h * w), gate_max=o.gate_max, **kw)
            m, se = fa.softmax_gate_stats_reference(w2d, *gate, **kw)
            c = fa.softmax_gate_csum_reference(w2d, gy2, *gate, m, se, **opts)
            dw2d, *gate_grads = fa.softmax_gate_backward_reference(w2d, gy2, *gate, m, se, c,
                                                                   **opts)
        else:
            dw2d, *gate_grads = fa.sigmoid_gate_backward_reference(w2d, gy2, *gate,
                                                                   gate_max=o.gate_max, **kw)
        dw = dw2d.reshape(w_pre.shape)
    du, dxs, dwr, dwc, dbc, dws = fs.stage_conv_bwd_reference(x, dw, a, b, wr, wc, ws,
                                                              upsample=o.upsample, **kw)
    dx, d_scale, d_bias = fs.groupnorm_act_backward(x, du, dxs, gn_scale, gn_bias,
                                                    groups=o.groups, eps=o.eps, **kw)
    return (dx, d_scale, d_bias, dwr.permute(2, 1, 0)[:, :, None, :],
            dwc.permute(2, 1, 0)[:, :, :, None], dbc,
            None if dws is None else dws.t()[:, :, None, None], *gate_grads)


@contextlib.contextmanager
def checked_stage_backward(fs, fa, record):
    """Hold every backward of `FusedStage` run inside the block against the
    plain chain on the very tensors that call saved: in bf16 by the rule of
    phase 4 (against the f32 plain chain on the same inputs), in f32 to
    F32_TOL; a softmax gate's db2, zero in exact arithmetic, against dW2's
    scale. One row per call goes to `record`."""
    original = fs.FusedStage.backward

    def backward(ctx, gy):
        # the saved tensors are unpacked once (a checkpointed stage allows
        # no more): the kernel chain runs here on them, as the original does
        o, saved = ctx.options, ctx.saved_tensors
        check(o.hand_written, "the checked stage backward runs the kernel chain only")
        with torch.no_grad():
            grads = (None, *fs._backward(o, gy, *saved[:7], saved[7:]))
            plain = plain_stage_backward(fs, fa, o, gy, saved)
            truth = plain
            if saved[0].dtype != torch.float32:
                truth = plain_stage_backward(fs, fa, o, gy.float(), as_f32(saved))
        x = saved[0]
        shape = dict(N=x.shape[0], H=o.h, C=x.shape[-1], mode=o.mode, up=o.upsample,
                     down=o.downsample)
        row = dict(shape, dtype=str(x.dtype).replace("torch.", ""))
        names = fs._NAMES
        for name, k, p, t in zip(names, grads[1:], plain, truth):
            if k is None:
                continue
            scale = truth[names.index("w2")] if name == "b2" and o.mode == "softmax" else None
            hold(name, shape, k, p, t, x.dtype, row, scale=scale)
        record.append(row)
        return grads

    fs.FusedStage.backward = staticmethod(backward)
    try:
        yield
    finally:
        fs.FusedStage.backward = original


def phase_ffhq_serving(overrides=None, want=FFHQ_SERVE_PER_FORWARD, phase="ffhq-serving"):
    """Phase 10 (and 17 with the sigmoid gate): serving ffhq_512 (with the
    config `overrides`) through `generate_samples` and `bench-sample`, the
    kernel path against the plain path; one forward launches `want`."""
    overrides = overrides or {}
    cfg_g = ffhq_config(**overrides)
    from locate_tpu_torch.io.sampling import generate_samples
    from locate_tpu_torch.models.gan import model_config
    from locate_tpu_torch.models.generator import build_generator
    from locate_tpu_torch.ops import fused_attention as fa

    mcfg = model_config(cfg_g)
    check(mcfg.use_pallas and mcfg.resolution == 512, "ffhq_512 does not serve fused at 512^2")
    model = build_generator(mcfg, "bfloat16", "cuda", seed=0).eval()
    randomize_logit_convs(model, seed=1, scale=0.25)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    reset_counters()
    images = generate_samples(model, gen, 4)
    launches = read_counters()
    fwd_routes = dict(read_fwd_routes(), sigmoid_gate=read_gate_routes("sigmoid_gate"))
    check(images.shape == (4, 512, 512, 3) and str(images.dtype) == "uint8",
          f"ffhq_512 request: images {images.shape} {images.dtype}")
    check(float(images.std()) > 0.0, "ffhq_512 request: constant images")
    check(launches == expected(want), f"one ffhq_512 forward launched {launches}, want {want}")
    softmax = bool(want.get("softmax_stats"))
    want_routes = {k: gate_routes_per_step(fa, shapes if softmax else {}, forward=True)
                   for k, shapes in (("softmax_stats", FFHQ_STATS_SERVE),
                                     ("softmax_apply", FFHQ_APPLY_SERVE))}
    want_routes["sigmoid_gate"] = gate_routes_per_step(fa, {} if softmax else SIGMOID_SERVE,
                                                       sigmoid=True)
    check(fwd_routes == want_routes,
          f"one ffhq_512 forward's gate passes took the routes {fwd_routes}, want {want_routes}")
    plain_cfg = dataclasses.replace(mcfg, use_pallas=False)
    plain = build_generator(plain_cfg, "bfloat16", "cuda").eval()
    truth = build_generator(plain_cfg, "float32", "cuda").eval()
    plain.load_state_dict(model.state_dict())
    truth.load_state_dict(model.state_dict())
    gz = torch.Generator(device="cuda")
    gz.manual_seed(3)
    z = torch.randn(4, mcfg.latent_dim, device="cuda", generator=gz)
    with torch.inference_mode():
        yk, yp, yt = (m(z).float() for m in (model, plain, truth))
    torch.cuda.synchronize()
    for name, y in (("kernel", yk), ("plain", yp), ("f32", yt)):
        check(bool(torch.isfinite(y).all()), f"ffhq_512 {name} generator: non-finite images")
    ek, ep = rel_err(yk, yt), rel_err(yp, yt)
    check(ek <= max(BF16_FACTOR * ep, 1e-6),
          f"ffhq_512 generator: kernel path error {ek:.3e} > {BF16_FACTOR} x plain {ep:.3e}")
    idle, _ = profile_calls(lambda: generate_samples(model, gen, FFHQ_BATCH))
    del model, plain, truth
    torch.cuda.empty_cache()

    def bench_sample(use_pallas):
        torch.cuda.reset_peak_memory_stats()
        out = run_cli(["bench-sample", "ffhq_512", f"use_pallas={str(use_pallas).lower()}",
                       *(f"{k}={v}" for k, v in overrides.items()), f"--batch={FFHQ_BATCH}",
                       "--steps=3"])
        torch.cuda.empty_cache()
        return dict(out, peak_memory_bytes=torch.cuda.max_memory_allocated())

    say(phase, config="ffhq_512", overrides=overrides, launches_one_forward=launches,
        forward_routes_one_forward=fwd_routes,
        rel_err_kernel_path_vs_f32=ek, rel_err_plain_path_vs_f32=ep,
        max_abs_err_kernel_vs_plain_path=float((yk - yp).abs().max()),
        kernel_path=bench_sample(True), plain_path=bench_sample(False),
        device_idle_share_batch16=("not measured" if idle is None else idle))
    return launches


def timed_steps(step, state, batch, steps):
    """(state, metrics of each step, seconds of each step)."""
    history, seconds = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        history.append(metrics)
    return state, history, seconds


# a grad-norm guard above the random-weight ffhq_512 (softmax) G's norm of
# 2e6-2e7, so that G's Adam update runs on the card
RAISED_GRAD_NORM_LIMIT = 1e9


def raised_guard_steps(steps, phase):
    """`steps` kernel-path steps of ffhq_512 (softmax gate) from step 0 with
    train.grad_norm_limit at RAISED_GRAD_NORM_LIMIT: every update of G and
    D is applied, and G, D and the EMA move."""
    cfg = ffhq_config(**{"train.grad_norm_limit": str(RAISED_GRAD_NORM_LIMIT)})
    tcfg = cfg.train
    check(tcfg.grad_norm_limit == RAISED_GRAD_NORM_LIMIT, "the guard was not raised")
    gan, state, step = trainer(cfg)
    before = [t.clone() for t in (state.g_params.flat, state.d_params.flat, state.ema_params)]
    state, history, seconds = timed_steps(step, state, fixed_batch(FFHQ_BATCH, 512), steps)
    history = check_history(history, tcfg)
    moved = check_moved(before, state, history, tcfg)
    for net in ("g", "d"):
        norms = [m[f"{net}_grad_norm"] for m in history]
        check(max(norms) < RAISED_GRAD_NORM_LIMIT and history[-1][f"{net}_grad_limit_count"] == 0,
              f"{phase}: {net} updates skipped under the raised guard, norms {norms}")
    check(all(moved[k] > 0.0 for k in ("g", "d", "ema")),
          f"{phase}: under the raised guard not every net moved: {moved}")
    del gan, state, step, before
    torch.cuda.empty_cache()
    return dict(grad_norm_limit=RAISED_GRAD_NORM_LIMIT, seconds_per_step=seconds,
                g_grad_norms=[m["g_grad_norm"] for m in history],
                d_grad_norms=[m["d_grad_norm"] for m in history], max_param_change=moved)


def phase_ffhq_train(overrides=None, per_step=None, phase="ffhq-train"):
    """Phase 11 (and 18 with the sigmoid gate): the main path of the
    fused-stage kernels, ffhq_512 as shipped (with the config `overrides`)
    at batch 16, three steps from step 0 (lazy R1 fires), launching
    `per_step` kernels a step, then the plain path's three steps, and a
    profile of each."""
    overrides = overrides or {}
    per_step = per_step or totals(FFHQ_PLAN)
    cfg = ffhq_config(**overrides)
    tcfg = cfg.train
    check(cfg.use_pallas and cfg.model.remat and cfg.model.resolution == 512
          and tcfg.compute_dtype == "bfloat16" and tcfg.r1_gamma == 0.1
          and tcfg.grad_norm_limit == 1e6 and tcfg.max_nonfinite_skips == 200,
          "ffhq_512 is not the shipped recipe")
    gan, state, step = trainer(cfg)
    batch = fixed_batch(FFHQ_BATCH, 512)
    before = [t.clone() for t in (state.g_params.flat, state.d_params.flat, state.ema_params)]
    steps = 3
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    state, history, seconds = timed_steps(step, state, batch, steps)
    launches, stage_routes = read_counters(), read_stage_routes()
    gate_routes = {k: read_gate_routes(k) for k in ("softmax_bwd", "sigmoid_bwd", "softmax_csum",
                                                    "sigmoid_gate") + GATE_FWD_ROUTED}
    peak = torch.cuda.max_memory_allocated()
    history = check_history(history, tcfg)
    moved = check_moved(before, state, history, tcfg)
    check(launches == expected(per_step, steps),
          f"ffhq_512 steps launched {launches}, want {per_step} per step")
    # every (bf16) launch of the two routed stage kernels on the tensor cores
    check(stage_routes == stage_routes_expected(launches),
          f"ffhq_512 steps' stage kernels took the routes {stage_routes}")
    # the gate backward's launches (softmax_bwd's, or sigmoid_bwd's with the
    # sigmoid gate) on the route of each shape
    from locate_tpu_torch.ops import fused_attention as fa

    for kernel, shapes in (("softmax_bwd", FFHQ_BWD_PER_STEP),
                           ("sigmoid_bwd", SIGMOID_BWD_PER_STEP)):
        want_gate = gate_routes_per_step(fa, shapes if per_step.get(kernel) else {}, steps)
        check(gate_routes[kernel] == want_gate,
              f"ffhq_512 steps' {kernel} took the routes {gate_routes[kernel]}, want {want_gate}")
    # and the softmax forward pair's, the stats in the fused backward calls
    # too, and its csum pass's at the backward's shapes; the sigmoid gate's
    for kernel, shapes in (("softmax_stats", FFHQ_STATS_PER_STEP),
                           ("softmax_apply", FFHQ_APPLY_PER_STEP),
                           ("softmax_csum", FFHQ_BWD_PER_STEP)):
        want_gate = gate_routes_per_step(fa, shapes if per_step.get(kernel) else {}, steps,
                                         forward=True)
        check(gate_routes[kernel] == want_gate,
              f"ffhq_512 steps' {kernel} took the routes {gate_routes[kernel]}, want {want_gate}")
    want_gate = gate_routes_per_step(
        fa, SIGMOID_FWD_PER_STEP if per_step.get("sigmoid_gate") else {}, steps, sigmoid=True)
    check(gate_routes["sigmoid_gate"] == want_gate,
          f"ffhq_512 steps' sigmoid_gate took the routes {gate_routes['sigmoid_gate']}, want "
          f"{want_gate}")
    idle, top = profile_calls(lambda: step(state, batch), calls=2, top=15)
    weights = (gan.generator.state_dict(), gan.discriminator.state_dict())
    params = dict(g=state.g_params.flat.numel(), d=state.d_params.flat.numel())
    del gan, state, step, before
    torch.cuda.empty_cache()

    pcfg = ffhq_config(use_pallas="false", **overrides)
    gan, state, step = trainer(pcfg)
    torch.cuda.reset_peak_memory_stats()
    state, plain_history, plain_seconds = timed_steps(step, state, batch, steps)
    plain_peak = torch.cuda.max_memory_allocated()
    plain_history = check_history(plain_history, tcfg)
    plain_idle, plain_top = profile_calls(lambda: step(state, batch), calls=2, top=15)
    del gan, state, step
    torch.cuda.empty_cache()

    def rates(secs):
        return dict(seconds_per_step=secs,
                    images_per_sec_after_step0=FFHQ_BATCH * (len(secs) - 1) / sum(secs[1:]))

    say(phase, config="ffhq_512 as shipped, batch 16", overrides=overrides, steps=steps,
        params=params,
        launches=launches, launches_per_step={k: v / steps for k, v in launches.items()},
        stage_routes=stage_routes, gate_bwd_routes=gate_routes, metrics=history,
        max_param_change=moved,
        kernel_path=dict(rates(seconds), peak_memory_bytes=peak,
                         device_idle_share="not measured" if idle is None else idle,
                         top_kernels_2_steps=top),
        plain_path=dict(rates(plain_seconds), peak_memory_bytes=plain_peak,
                        metrics=plain_history,
                        device_idle_share=("not measured" if plain_idle is None
                                           else plain_idle),
                        top_kernels_2_steps=plain_top))
    return cfg, weights, launches, dict(stage_routes, **gate_routes)


def phase_ffhq_checked_backward(fs, fa, cfg, weights, phase="ffhq-checked-stage-backward"):
    """Phase 12 (and 19 with the sigmoid gate): one ffhq_512 step's
    gradients (R1 firing) on the kernel path, each of its fused-stage
    backward calls (G's four from 64^2 to 512^2 under the card's profile)
    held against the plain chain on its own saved tensors; each recomputes
    w (stage_conv) and runs the conv backward on the mma route, and with
    the sigmoid gate the gate's backward too (sigmoid_bwd_mma); a fused
    D stage's forward pools on the mma route. With the sigmoid gate each of
    the step's SigmoidGate backward calls (the gates the profile's ranges
    hold) is held against the plain backward on its own saved tensors too
    (phase 18's check)."""
    g = torch.Generator(device="cuda")
    g.manual_seed(6)
    z = [torch.randn(FFHQ_BATCH, cfg.model.latent_dim, device="cuda", generator=g)
         for _ in range(2)]
    calls = []

    def routes():
        return dict(read_stage_routes(), sigmoid_bwd=read_gate_routes("sigmoid_bwd"),
                    softmax_csum=read_gate_routes("softmax_csum"))

    sigmoid = cfg.model.attention.mode == "sigmoid"
    gate_calls = []
    before = routes()
    with checked_stage_backward(fs, fa, calls), (
            checked_gate_backward(fa, gate_calls, "sigmoid") if sigmoid
            else contextlib.nullcontext()):
        _, _, d_loss, g_loss, r1 = step_grads(cfg, weights, *z, 512, True, "bfloat16")
    after = routes()
    plan = SIGMOID_PLAN if sigmoid else FFHQ_PLAN
    fused = sum(plan["stage_conv_bwd"].values())
    check(len(calls) == fused, f"{len(calls)} fused-stage backward calls in one ffhq_512 step, "
                               f"want {fused}")
    moved = {k: {r: after[k][r] - before[k][r] for r in after[k]} for k in after}
    check(moved["stage_conv_bwd"] == moved["stage_conv"] == {"mma": fused, "simt": 0}
          and moved["stage_softmax_stats"]["simt"] == moved["stage_sigmoid"]["simt"] == 0
          and moved["stage_softmax_apply_pool"]["simt"] == 0
          and moved["sigmoid_bwd"] == gate_routes_per_step(
              fa, SIGMOID_BWD_PER_STEP if sigmoid else {})
          and moved["softmax_csum"] == gate_routes_per_step(
              fa, {} if sigmoid else FFHQ_BWD_PER_STEP, forward=True),
          f"the checked ffhq_512 step's stage kernels took the routes {moved}")
    if sigmoid:  # the gate's own calls, outside the fused stages
        want = gate_routes_per_step(fa, SIGMOID_PLAN["sigmoid_gate_bwd"])
        got = {r: sum(call["route"] == r for call in gate_calls) for r in want}
        check(got == want, f"the checked step's SigmoidGate calls took the routes {got}, "
                           f"want {want}")
    check(all(math.isfinite(v) for v in (d_loss, g_loss, r1)) and r1 > 0.0,
          f"ffhq_512 step losses {d_loss}, {g_loss}, r1 {r1}")
    say(phase, calls=calls, gate_calls=gate_calls, stage_routes=moved, d_loss=d_loss,
        g_loss=g_loss, r1=r1)


def phase_ffhq_grads_64(fs, fa, blocks, overrides=None, kernels=STAGE_KERNELS,
                        phase="ffhq-train-grads-64"):
    """Phase 13 (and 20 with the sigmoid gate): one step's whole gradients
    at ffhq_512's widths cut to 64^2, every stage fused (FUSE_MIN_LOCATIONS
    = 0), f32 kernel path against the f32 plain path: within
    TRAIN_F32_TOL, or ten times what 1e-7 weight noise moves the plain path
    by if larger; each fused-stage backward call within F32_TOL of the
    plain chain; each of `kernels` launched."""
    cfg = ffhq_config(**{"model.resolution": "64", "data.resolution": "64",
                         **(overrides or {})})
    gan, _, _ = trainer(cfg)
    weights = (gan.generator.state_dict(), gan.discriminator.state_dict())
    del gan
    g = torch.Generator(device="cuda")
    g.manual_seed(7)
    z = [torch.randn(FFHQ_BATCH, cfg.model.latent_dim, device="cuda", generator=g)
         for _ in range(2)]
    calls = []
    blocks.FUSE_MIN_LOCATIONS = 0
    try:
        with checked_stage_backward(fs, fa, calls):
            reset_counters()
            kernel = step_grads(cfg, weights, *z, 64, True, "float32")
            launches, stage_routes = read_counters(), read_stage_routes()
    finally:
        blocks.FUSE_MIN_LOCATIONS = None
    stages = len(cfg.model.stage_resolutions())
    check(len(calls) == 4 * stages, f"{len(calls)} fused-stage backward calls at 64^2")
    check(all(launches[k] > 0 for k in kernels), f"64^2 step launched {launches}")
    check(stage_routes == stage_routes_expected(launches, "simt"),
          f"the f32 64^2 step's stage kernels took the routes {stage_routes}")
    plain = step_grads(cfg, weights, *z, 64, False, "float32")
    noisy = step_grads(cfg, weights, *z, 64, False, "float32", perturb=1e-7)
    rows = {}
    for i, net in enumerate(("D", "G")):
        e, moved = rel_err(kernel[i], plain[i]), rel_err(noisy[i], plain[i])
        limit = max(TRAIN_F32_TOL, 10.0 * moved)
        rows[net] = dict(rel_err_kernel_vs_plain_f32=e,
                         rel_change_f32_at_1e7_weight_noise=moved)
        check(e <= limit, f"{net} gradient at 64^2 f32, every stage fused: {e:.3e} > {limit:.3e}")
    say(phase, batch=FFHQ_BATCH, fused_stages=stages, gradients=rows,
        launches=launches, stage_routes=stage_routes, stage_backward_calls_checked=len(calls),
        worst_stage_backward_rel_err=max(v for r in calls for k, v in r.items()
                                          if k.endswith("rel_err_kernel_vs_plain")),
        losses=dict(kernel=kernel[2:], plain=plain[2:]))
    return launches


def event_ms(fn, reps=5):
    """Milliseconds of one `fn()` by CUDA events over `reps` calls, after
    two warm-up calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_fusion_timing(blocks):
    """Phase 14: forward plus backward of one 512^2 G stage and one D stage
    of ffhq_512 (bf16, batch 16): fused; unfused (its layers one by one,
    the gate through its own kernels); and the plain path (use_pallas off)."""
    from locate_tpu_torch.models.gan import model_config

    mcfg = model_config(ffhq_config())
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    builds = {
        "G_512_up_pair": (lambda c: blocks.generator_stage(
            64, 64, 512, c, first=False, compute_dtype=torch.bfloat16, gen=gen),
            (FFHQ_BATCH, 256, 256, 64)),
        "D_512_down_pair": (lambda c: blocks.discriminator_stage(
            64, 64, 512, c, last=False, compute_dtype=torch.bfloat16, gen=gen),
            (FFHQ_BATCH, 512, 512, 64)),
    }
    rows = {}
    for name, (build, shape) in builds.items():
        stage = build(mcfg)
        randomize_logit_convs(stage, seed=12, scale=0.25)
        plain = build(dataclasses.replace(mcfg, use_pallas=False))
        plain.load_state_dict(stage.state_dict())
        x = torch.randn(shape, device="cuda", generator=gen).to(torch.bfloat16)
        x.requires_grad_(True)
        with torch.no_grad():
            dy = torch.randn(stage(x).shape, device="cuda", generator=gen).to(torch.bfloat16)

        def fwd_bwd(module):
            y = module(x)
            torch.autograd.grad(y, [x, *module.parameters()], dy)

        times = {}
        for mode, threshold in (("fused", 0), ("unfused", 1 << 62)):
            blocks.FUSE_MIN_LOCATIONS = threshold
            times[f"{mode}_ms"] = event_ms(lambda: fwd_bwd(stage))
        blocks.FUSE_MIN_LOCATIONS = None
        times["plain_path_ms"] = event_ms(lambda: fwd_bwd(plain))
        times["fused_over_unfused"] = times["fused_ms"] / times["unfused_ms"]
        rows[name] = times
        del stage, plain, x, dy
        torch.cuda.empty_cache()
    say("fusion-timing", batch=FFHQ_BATCH, dtype="bfloat16", stages=rows)
    return rows


def retune_script():
    """scripts/torch_retune_gates.py, imported."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_retune_gates", os.path.join(REPO, "scripts", "torch_retune_gates.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def phase_retune_table():
    """Phase 21: the gate profile's ladder again (scripts/torch_retune_gates.py's
    measurements, bf16, CUDA graphs): one sigmoid LocateAttention layer's
    kernels against the plain composition from 4^2 to 512^2, and each stage
    flavor fused against unfused from 64^2 to 512^2, forward plus backward,
    under the profile in the tree; each rung's two times, the thresholds
    the profile holds, and those this run's times would give."""
    from locate_tpu_torch.ops import gate_profile

    rt = retune_script()
    sigmoid = rt.measure_sigmoid()
    stages = rt.measure_stages()
    prof = gate_profile.load()
    held = {"min_locations": prof["min_locations"],
            "sigmoid_locations": prof["sigmoid_locations"]}
    now = {"min_locations": rt.thresholds(stages, prof["meta"].get("margin", 0.02)),
           "sigmoid_locations": rt.sigmoid_ranges_rule(
               [(r["locations"], r["kernel_ms"], r["plain_ms"]) for r in sigmoid],
               prof["meta"].get("margin", 0.02))}
    say("retune-table", profile=held, profile_measured_on=prof["meta"].get("nvidia_smi"),
        this_run_would_give=now, agrees=now == held, sigmoid_rungs=sigmoid, stage_rungs=stages)
    return held


# ---------------------------------------------------------------------------
# lsun_bedroom_128 with attention.kind=self: the flash kernels' path
# ---------------------------------------------------------------------------


def flash_inputs(b, t, s, dh, dv, dtype, seed):
    """(q, k, v, do): k and v of unit variance, q of variance 4, so the
    scaled scores have a standard deviation of 2 and no softmax row is flat."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, device="cuda", generator=g) * scale).to(dtype)

    return r(b, t, dh, scale=2.0), r(b, s, dh), r(b, s, dv), r(b, t, dv)


def batch_chunk(t, s):
    """Batch rows a plain version takes at once: its (T, S) f32 matrices,
    half a dozen of them in the backward, stay at 2 GB each."""
    return max(1, 2 ** 29 // (t * s))


def chunked(fn, tensors, chunk):
    """`fn` over `chunk` batch rows of `tensors` at a time, its outputs
    joined again (every batch row of an attention call is independent)."""
    b = tensors[0].shape[0]
    if chunk >= b:
        out = fn(*tensors)
        return out if isinstance(out, tuple) else (out,)
    parts = []
    for i in range(0, b, chunk):
        out = fn(*(x[i:i + chunk] for x in tensors))
        parts.append(out if isinstance(out, tuple) else (out,))
    return tuple(torch.cat(col) for col in zip(*parts))


def run_flash(fl, q, k, v, do, scale, plain: bool, route=None):
    """(o, ell, dq, dk, dv) through the three kernels (on `route`,
    `flash_route`'s choice unless given), or through their plain versions a
    few batch rows at a time."""
    if not plain:
        o, ell = fl.flash_fwd(q, k, v, scale, route=route)
        delta = fl.row_delta(o, do)
        return (o, ell, fl.flash_dq(q, k, v, do, ell, delta, scale, route=route),
                *fl.flash_dkv(q, k, v, do, ell, delta, scale, route=route))

    def one(q, k, v, do):
        o, ell = fl.flash_forward_reference(q, k, v, scale)
        return (o, ell, *fl.flash_backward_reference(q, k, v, o, ell, do, scale))

    return chunked(one, (q, k, v, do), batch_chunk(q.shape[1], k.shape[1]))


def flash_scales(fl, q, k, v, do, scale):
    """(None, None, dq, dk, dv): the backward outputs computed on the
    absolute values of their terms (f32), the scale each sum's rounding
    error grows with."""
    def one(q, k, v, do):
        q, k, v, do = (x.float() for x in (q, k, v, do))
        o, ell = fl.flash_forward_reference(q, k, v, scale)
        p = torch.exp(fl._scores(q, k, scale) - ell.unsqueeze(-1))
        ds = p * (torch.matmul(do.abs(), v.abs().transpose(1, 2))
                  + (do.abs() * o.abs()).sum(-1, keepdim=True))
        return (torch.matmul(ds, k.abs()) * scale,
                torch.matmul(ds.transpose(1, 2), q.abs()) * scale,
                torch.matmul(p.transpose(1, 2), do.abs()))

    return (None, None, *chunked(one, (q, k, v, do), batch_chunk(q.shape[1], k.shape[1])))


def flash_bound(kernel, b, t, s, dh, dv, dtype):
    """(bound_ms, bound_by): the bytes the kernel must move (q, k, v and,
    for the backward passes, dO, ell and delta read once; its outputs
    written once) over the memory rate, and its products' flops, 2 B T S
    times (dh + dv) forward, (2 dh + dv) for dQ, (2 dh + 2 dv) for dK/dV,
    over the peak rate of the operand type."""
    es = torch.finfo(dtype).bits // 8
    qkv = b * (t * dh + s * dh + s * dv)
    if kernel == "flash_fwd":
        nbytes, width = es * (qkv + b * t * dv) + 4 * b * t, dh + dv
    elif kernel == "flash_dq":
        nbytes, width = es * (qkv + b * t * dv + b * t * dh) + 8 * b * t, 2 * dh + dv
    else:
        nbytes = es * (qkv + b * t * dv + b * s * (dh + dv)) + 8 * b * t
        width = 2 * dh + 2 * dv
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = 2.0 * b * t * s * width / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_exp_floor(b, t, s):
    """ms of the B T S exponentials of one flash pass on every SFU lane of
    the card at once: a floor beside the bound, which each backward pass
    meets again because it recomputes P."""
    return b * t * s / (SFU_LANES * SFU_HZ) * 1e3


def flash_times(fl, q, k, v, do, scale):
    """{kernel: ms, plain_ms, bound_ms, bound_by, library_ms, exp_floor_ms}
    of the three kernels on these operands, with their route, blocks per SM
    and, where the route is mma, the simt route's time and blocks on the
    same operands. The kernels and the library call are timed as CUDA
    graphs of back-to-back launches; the plain versions, which run a few
    batch rows at a time, by events. The library yardstick is
    `F.scaled_dot_product_attention`: its forward for flash_fwd, its
    autograd backward (dQ, dK and dV in one) for flash_dq and flash_dkv
    together. Where the allocator refuses the library call, its
    time is None and the refusal is recorded."""
    import torch.nn.functional as F

    b, t, dh = q.shape
    s, dv = v.shape[1], v.shape[2]
    big = t * s >= 4096 * 4096
    reps = (3, 2) if big else (10, 5)
    chunk = batch_chunk(t, s)
    route = fl.flash_route(q.dtype, dh, dv)
    with torch.no_grad():
        o, ell = fl.flash_fwd(q, k, v, scale)
        delta = fl.row_delta(o, do)

        def kernel_ms(r):
            return {"flash_fwd": graph_ms(lambda: fl.flash_fwd(q, k, v, scale, route=r), *reps),
                    "flash_dq": graph_ms(
                        lambda: fl.flash_dq(q, k, v, do, ell, delta, scale, route=r), *reps),
                    "flash_dkv": graph_ms(
                        lambda: fl.flash_dkv(q, k, v, do, ell, delta, scale, route=r), *reps)}

        ms = kernel_ms(route)
        simt = kernel_ms(fl.SIMT) if route == fl.MMA else None
        plain = {
            "flash_fwd": event_ms(lambda: chunked(
                lambda q, k, v: fl.flash_forward_reference(q, k, v, scale), (q, k, v), chunk),
                2 if big else 5),
            "flash_dq": event_ms(lambda: chunked(
                lambda *a: fl.flash_dq_reference(*a, scale), (q, k, v, do, ell, delta), chunk),
                2 if big else 5),
            "flash_dkv": event_ms(lambda: chunked(
                lambda *a: fl.flash_dkv_reference(*a, scale), (q, k, v, do, ell, delta), chunk),
                2 if big else 5)}
    library, refusal = {"flash_fwd": None, "flash_bwd": None}, None
    try:
        with torch.no_grad():
            library["flash_fwd"] = graph_ms(
                lambda: F.scaled_dot_product_attention(q, k, v, scale=scale), *reps)
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = F.scaled_dot_product_attention(*leaves, scale=scale)
        library["flash_bwd"] = event_ms(
            lambda: torch.autograd.grad(out, leaves, do, retain_graph=True), 3 if big else 10)
        del leaves, out
    except torch.cuda.OutOfMemoryError as e:
        refusal = str(e).split(". GPU")[0]
    release_memory()
    lib = fl._library()
    is_bf16 = int(q.dtype == torch.bfloat16)
    rows = {}
    for kernel, kind in zip(FLASH_KERNELS, (fl._FWD, fl._DQ, fl._DKV)):
        b_ms, b_by = flash_bound(kernel, b, t, s, dh, dv, q.dtype)
        rows[kernel] = dict(ms=ms[kernel], plain_ms=plain[kernel], bound_ms=b_ms, bound_by=b_by,
                            share_of_bound=b_ms / ms[kernel],
                            library_ms=library["flash_fwd" if kernel == "flash_fwd"
                                               else "flash_bwd"],
                            exp_floor_ms=flash_exp_floor(b, t, s))  # phase 22's record only
        simt_tile = fl.pick_tile(kind, b, t, dh, dv, lib)
        simt_blocks = int(lib.locate_flash_blocks_per_sm(0, kind, is_bf16, dh, dv, simt_tile))
        if route == fl.MMA:
            rows[kernel].update(
                route=route, mma_widths=fl.mma_widths(dh, dv),
                blocks_per_sm=int(lib.locate_flash_blocks_per_sm(
                    1, kind, 1, *fl.mma_widths(dh, dv), 0)),
                ms_simt=simt[kernel], blocks_per_sm_simt=simt_blocks,
                simt_over_mma=simt[kernel] / ms[kernel])
        else:
            rows[kernel].update(route=route, blocks_per_sm=simt_blocks)
    rows["flash_dq"]["library_covers"] = rows["flash_dkv"]["library_covers"] = (
        "flash_dq and flash_dkv together (one autograd backward, timed by events)")
    if library["flash_bwd"] is not None:
        rows["backward_pair_over_library"] = (
            (ms["flash_dq"] + ms["flash_dkv"]) / library["flash_bwd"])
    if library["flash_fwd"] is not None:
        rows["forward_over_library"] = ms["flash_fwd"] / library["flash_fwd"]
    if refusal:
        rows["library_refused"] = refusal
    return rows


def check_flash(fl, q, k, v, do, scale, shape, row):
    """Hold the three kernels to their plain versions on these operands by
    the rules of phases 3-4, two runs bitwise equal; fills `row`."""
    dtype = q.dtype
    route = fl.flash_route(dtype, q.shape[2], v.shape[2])
    with torch.no_grad():
        kern = run_flash(fl, q, k, v, do, scale, plain=False)
        again = run_flash(fl, q, k, v, do, scale, plain=False)
        simt = (run_flash(fl, q, k, v, do, scale, plain=False, route=fl.SIMT)
                if route == fl.MMA else None)
        plain = run_flash(fl, q, k, v, do, scale, plain=True)
        truth = plain
        if dtype != torch.float32:
            truth = run_flash(fl, *(x.float() for x in (q, k, v, do)), scale, plain=True)
        scales = flash_scales(fl, q, k, v, do, scale)
        torch.cuda.synchronize()
    for name, a, b in zip(FLASH_NAMES, kern, again):
        check(torch.equal(a, b), f"{name} at {shape}: two runs differ bitwise")
    row["bitwise_repeatable"] = True
    row["route"] = route
    for name, kk, pp, tt, sc in zip(FLASH_NAMES, kern, plain, truth, scales):
        check(kk.shape == pp.shape and kk.dtype == pp.dtype, f"{name} at {shape}: {kk.shape}")
        hold(name, shape, kk, pp, tt, dtype, row, scale=sc)
    if simt is not None:  # the same inputs on the simt route, under the same rule
        for name, kk, pp, tt, sc in zip(FLASH_NAMES, simt, plain, truth, scales):
            hold(f"{name}_simt", shape, kk, pp, tt, dtype, row, scale=sc)


def softmax_peak(fl, q, k, scale):
    """Mean over the first image's rows of S times the largest probability:
    1 for a flat softmax."""
    with torch.no_grad():
        s = fl._scores(q[:1].float(), k[:1].float(), scale)
        return float((torch.softmax(s, dim=-1).amax(dim=-1) * k.shape[1]).mean())


def phase_flash_kernels(fl):
    """Phase 22: the three flash kernels against their plain versions at the
    nine (T, dh, dv) of lsun_bedroom_128's self-attention layers (G's six,
    D's three others), batch 16, plus heads = 2 at 32^2 (batch 32, dh 8,
    dv 16) and one S != T case, in bf16 and f32, with a random dO, under
    the rules of phases 3 and 4 (backward outputs against the norm of the
    sum of their absolute terms); two runs bitwise equal; in bf16 the
    backward passes on the mma route and, on the same inputs, on the simt
    route, both under that rule; each bf16 case timed beside its bound, its
    exponential floor, its plain version, the simt route and the library
    call. Then the training shapes again at the train batch (64), timed
    only: the per-step numbers of the kernels line. Fails if the mma pair
    is slower than the library's backward at D's 32^2 layer (T 1024, dh 16,
    dv 64, batch 64), or flash_fwd slower than the library's forward at
    D's 16^2 layer (T 256, dh 32, dv 128, batch 16) or at the 64^2 layers
    (T 4096, dh 8, dv 32, batch 64)."""
    cases = [(FLASH_BATCH, t, t, dh, dv, "layer") for t, dh, dv in FLASH_SHAPES]
    cases += [(2 * FLASH_BATCH, 1024, 1024, 8, 16, "heads=2"),
              (FLASH_BATCH, 1024, 4096, 8, 32, "S != T")]
    rows = []
    for i, (b, t, s, dh, dv, what) in enumerate(cases):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, do = flash_inputs(b, t, s, dh, dv, dtype, seed=700 + i)
            scale = dh ** -0.5
            shape = dict(B=b, T=t, S=s, dh=dh, dv=dv)
            row = dict(shape=shape, case=what, dtype=str(dtype).replace("torch.", ""),
                       softmax_peak=softmax_peak(fl, q, k, scale))
            check(row["softmax_peak"] > 2.0, f"flat softmax at {shape}")
            check_flash(fl, q, k, v, do, scale, shape, row)
            if dtype == torch.bfloat16:
                row.update(flash_times(fl, q, k, v, do, scale))
            say("flash-kernels-vs-plain", **row)
            rows.append(row)
            del q, k, v, do
            torch.cuda.empty_cache()
    train_rows = []
    for i, shape3 in enumerate(FLASH_FWD_PER_STEP):
        t, dh, dv = shape3
        q, k, v, do = flash_inputs(BATCH, t, t, dh, dv, torch.bfloat16, seed=750 + i)
        row = dict(shape=dict(B=BATCH, T=t, S=t, dh=dh, dv=dv), dtype="bfloat16",
                   launches_per_step=dict(flash_fwd=FLASH_FWD_PER_STEP[shape3],
                                          flash_dq=FLASH_BWD_PER_STEP[shape3],
                                          flash_dkv=FLASH_BWD_PER_STEP[shape3]),
                   **flash_times(fl, q, k, v, do, dh ** -0.5))
        say("flash-kernels-train-batch", **row)
        train_rows.append(row)
        del q, k, v, do
        torch.cuda.empty_cache()
    check_against_library(rows, train_rows)
    return rows, train_rows


def layer_row(rows, shape3):
    """The one bf16 row of a layer case at (T, dh, dv) `shape3`."""
    (row,) = [r for r in rows if r["dtype"] == "bfloat16" and r.get("case", "layer") == "layer"
              and (r["shape"]["T"], r["shape"]["dh"], r["shape"]["dv"]) == shape3]
    return row


def check_against_library(rows, train_rows):
    """Phase 22's checks against `F.scaled_dot_product_attention`: the mma
    pair faster than its backward at D's 32^2 layer at batch 64, and
    flash_fwd, on the mma route, faster than its forward at D's 16^2 layer
    at batch 16 and at the 64^2 layers at batch 64."""
    d32 = layer_row(train_rows, FLASH_D_SHAPES[32])
    pair = d32["flash_dq"]["ms"] + d32["flash_dkv"]["ms"]
    library = d32["flash_dq"]["library_ms"]
    check(d32["flash_dq"]["route"] == "mma" and library is not None and pair < library,
          f"flash_dq + flash_dkv at {d32['shape']}: {pair:.4f} ms on the "
          f"{d32['flash_dq']['route']} route, the library's backward {library} ms")
    for r in (layer_row(rows, FLASH_D_SHAPES[16]), layer_row(train_rows, FLASH_D_SHAPES[64])):
        fwd = r["flash_fwd"]
        check(fwd["route"] == "mma" and fwd["library_ms"] is not None
              and fwd["ms"] < fwd["library_ms"],
              f"flash_fwd at {r['shape']}: {fwd['ms']:.4f} ms on the {fwd['route']} route, "
              f"the library's forward {fwd['library_ms']} ms")


def self_config(**overrides):
    from locate_tpu_torch.config import get_config

    return get_config("lsun_bedroom_128", {"use_pallas": "true", **SELF, **overrides})


def check_self_attention_layers(fl, captured):
    """Each self-attention layer of a served request, held against the
    plain composition on the very q, k, v it computed (the bf16 rule)."""
    out = []
    for layer, (q, k, v), o in captured:
        with torch.inference_mode():
            chunk = batch_chunk(q.shape[1], k.shape[1])
            (plain,) = chunked(lambda *a: fl.attention_reference(*a, scale=layer.scale),
                               (q, k, v), chunk)
            (truth,) = chunked(lambda *a: fl.attention_reference(
                *(x.float() for x in a), scale=layer.scale), (q, k, v), chunk)
        ek, ep = rel_err(o, truth), rel_err(plain, truth)
        row = dict(B=q.shape[0], T=q.shape[1], dh=q.shape[2], dv=v.shape[2],
                   rel_err_kernel_vs_f32=ek, rel_err_plain_vs_f32=ep,
                   softmax_peak=softmax_peak(fl, q, k, layer.scale))
        check(ek <= max(BF16_FACTOR * ep, BF16_FLOOR),
              f"self-attention layer at T={q.shape[1]}: kernel error {ek:.3e} > "
              f"{BF16_FACTOR} x plain error {ep:.3e}")
        check(row["softmax_peak"] > 1.5, f"self-attention layer at T={q.shape[1]}: flat softmax")
        out.append(row)
    return out


def phase_self_serving(fl):
    """Phase 23: serving lsun_bedroom_128 with attention.kind=self, all six
    layers (T up to 16384). Requests of batch 1, 16 and 64 through
    `generate_samples`: 6 flash_fwd launches a forward, all on the mma
    route, and no other kernel;
    each layer of the batch-16 request held against the plain composition
    on the q, k, v it computed; the kernel path, the plain path and an f32
    plain generator on the same 4 latents; `bench-sample` at batch 1, 16 and
    64 on the kernel path with peak memory, and on the plain path at batch
    16 (halved while the allocator refuses it) and at batch 64, where one
    f32 score tensor alone is 68.7 GB: that refusal is caught and recorded;
    the idle share and top kernels of a batch-16 request."""
    from locate_tpu_torch.io.sampling import generate_samples
    from locate_tpu_torch.models.gan import model_config
    from locate_tpu_torch.models.generator import build_generator
    from locate_tpu_torch.ops.self_attention import SelfAttention

    cfg = self_config()
    mcfg = model_config(cfg)
    check(mcfg.attention.kind == "self" and mcfg.attention_stages == "all"
          and mcfg.use_pallas and mcfg.attention.heads == 1, "not the self-attention preset")
    model = build_generator(mcfg, "bfloat16", "cuda", seed=0).eval()
    randomize_logit_convs(model, seed=1, scale=0.25)
    stages = len(mcfg.stage_resolutions())
    check(fill_gammas(model) == stages, "a stage has no self-attention layer")
    captured = []
    original = SelfAttention.attend

    def attend(layer, q, k, v):
        o = original(layer, q, k, v)
        if q.shape[0] == FLASH_BATCH:
            captured.append((layer, (q, k, v), o))
        return o

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    requests = (1, FLASH_BATCH, BATCH)
    SelfAttention.attend = attend
    try:
        reset_counters()
        images = [generate_samples(model, gen, b) for b in requests]
        launches, routes = read_counters(), read_route_counters()
    finally:
        SelfAttention.attend = original
    want = {"flash_fwd": stages, **totals(SELF_SERVE_PLAN)}
    check(launches == expected(want, len(requests)),
          f"serving launched {launches} for {len(requests)} forwards, want {want} each")
    check(routes == routes_expected(launches),
          f"serving's flash_fwd launches took {routes['flash_fwd']}, want all on mma")
    for b, img in zip(requests, images):
        check(img.shape == (b, 128, 128, 3) and str(img.dtype) == "uint8",
              f"request of {b}: images {img.shape} {img.dtype}")
        check(float(img.std()) > 0.0, f"request of {b}: constant images")
    check([tuple(c[1][0].shape[1:]) + (c[1][2].shape[2],) for c in captured]
          == list(FLASH_G_SHAPES.values()), "the layers' (T, dh, dv) are not FLASH_G_SHAPES")
    layers = check_self_attention_layers(fl, captured)
    del captured, images

    plain = build_generator(dataclasses.replace(mcfg, use_pallas=False), "bfloat16", "cuda").eval()
    truth = build_generator(dataclasses.replace(mcfg, use_pallas=False), "float32", "cuda").eval()
    plain.load_state_dict(model.state_dict())
    truth.load_state_dict(model.state_dict())
    gz = torch.Generator(device="cuda")
    gz.manual_seed(3)
    z = torch.randn(4, mcfg.latent_dim, device="cuda", generator=gz)
    with torch.inference_mode():
        yk, yp, yt = (m(z).float() for m in (model, plain, truth))
    torch.cuda.synchronize()
    for name, y in (("kernel", yk), ("plain", yp), ("f32", yt)):
        check(bool(torch.isfinite(y).all()), f"self-attention {name} generator: non-finite")
        check(float(y.abs().max()) <= 1.0, f"self-attention {name} generator: outside [-1, 1]")
    ek, ep = rel_err(yk, yt), rel_err(yp, yt)
    check(ek <= max(BF16_FACTOR * ep, 1e-6),
          f"self-attention generator: kernel path error {ek:.3e} > {BF16_FACTOR} x plain {ep:.3e}")
    idle, top = profile_calls(lambda: generate_samples(model, gen, FLASH_BATCH), top=8)
    del model, plain, truth
    torch.cuda.empty_cache()

    def bench_sample(use_pallas, batch, steps):
        torch.cuda.reset_peak_memory_stats()
        out = run_cli(["bench-sample", "lsun_bedroom_128", "model.attention.kind=self",
                       f"use_pallas={str(use_pallas).lower()}", f"--batch={batch}",
                       f"--steps={steps}"])
        torch.cuda.empty_cache()
        return dict(out, batch=batch, peak_memory_bytes=torch.cuda.max_memory_allocated())

    kernel_path = [bench_sample(True, b, steps) for b, steps in ((1, 10), (FLASH_BATCH, 5),
                                                                 (BATCH, 3))]
    plain_path, refusals = None, []
    for b in (BATCH, FLASH_BATCH, FLASH_BATCH // 2, FLASH_BATCH // 4):
        # the one place a refusal of the allocator is expected: the plain
        # path's (T, T) f32 scores at 128^2
        release_memory()
        try:
            plain_path = bench_sample(False, b, 3)
            break
        except torch.cuda.OutOfMemoryError as e:
            refusals.append(dict(batch=b, refused=str(e).split(". GPU")[0]))
    release_memory()
    check(plain_path is not None, f"the plain path served no batch: {refusals}")
    say("self-serving", config="lsun_bedroom_128, attention.kind=self, all six layers",
        requests=list(requests), launches=launches, routes=routes,
        attention_layers_batch_16=layers,
        rel_err_kernel_path_vs_f32=ek, rel_err_plain_path_vs_f32=ep,
        max_abs_err_kernel_vs_plain_path=float((yk - yp).abs().max()), image_std=float(yt.std()),
        kernel_path=kernel_path, plain_path=plain_path, plain_path_refused=refusals,
        device_idle_share_batch16=("not measured" if idle is None else idle),
        top_kernels_batch16=top)
    return launches


def release_memory():
    """Drop what a refused call left behind (its frames hold tensors until
    the exception is gone) and hand the cached blocks back."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def self_train_attempt(cfg, batch_size, steps=3):
    """`steps` preset steps from step 0 at `batch_size`, checked: (times,
    memory, metrics and profile; the launches; the GAN's weights). The
    allocator's refusal is the caller's to catch."""
    tcfg = cfg.train
    gan, state, step = trainer(cfg)
    batch = fixed_batch(batch_size)
    before = [t.clone() for t in (state.g_params.flat, state.d_params.flat, state.ema_params)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    state, history, seconds = timed_steps(step, state, batch, steps)
    launches = read_counters()
    routes = read_route_counters()
    peak = torch.cuda.max_memory_allocated()
    history = check_history(history, tcfg)
    moved = check_moved(before, state, history, tcfg)
    idle, top = profile_calls(lambda: step(state, batch), calls=2, top=12)
    out = dict(batch=batch_size, seconds_per_step=seconds, routes=routes,
               images_per_sec_after_step0=batch_size * (steps - 1) / sum(seconds[1:]),
               peak_memory_bytes=peak, metrics=history, max_param_change=moved,
               device_idle_share="not measured" if idle is None else idle,
               top_kernels_2_steps=top,
               params=dict(g=state.g_params.flat.numel(), d=state.d_params.flat.numel()))
    weights = (gan.generator.state_dict(), gan.discriminator.state_dict())
    return out, launches, weights


def halving(run, first):
    """`run(batch)` at `first`, halved while the allocator refuses it:
    (result, batch, the refusals)."""
    refusals, batch = [], first
    while batch >= 1:
        release_memory()
        try:
            return run(batch), batch, refusals
        except torch.cuda.OutOfMemoryError as e:
            refusals.append(dict(batch=batch, refused=str(e).split(". GPU")[0]))
        batch //= 2
    raise SmokeFailure(f"no batch fits: {refusals}")


def phase_self_train():
    """Phase 24: the flash kernels' main path. lsun_bedroom_128 as shipped
    (batch 64, R1 gamma 1 every 16 steps, both guards, EMA) with
    attention.kind=self at the stages 4^2..64^2 (five layers a net), 3 steps
    from step 0 (R1 fires, through the kernel-free twin of D): the checks of
    phase 6, launches per step 25 / 20 / 20 of flash_fwd / flash_dq /
    flash_dkv and no other kernel, every launch on the mma route,
    sec/step, images/sec, peak memory, idle
    share and top kernels; then the plain path's 3 steps alike. A batch the
    allocator refuses is halved and the refusal recorded."""
    cfg = self_config(**{"model.attention_stages": SELF_TRAIN_STAGES})
    tcfg = cfg.train
    check(tcfg.global_batch == BATCH and tcfg.compute_dtype == "bfloat16"
          and tcfg.r1_gamma == 1.0 and tcfg.r1_interval == 16 and tcfg.r1_remat
          and tcfg.grad_norm_limit == 1e6 and tcfg.max_nonfinite_skips == 200
          and tcfg.ema_decay == 0.999 and not cfg.model.remat,
          "lsun_bedroom_128 is not the shipped recipe")
    check([r for r in cfg.model.stage_resolutions() if cfg.model.attention_at(r)]
          == list(FLASH_TRAIN_RES), "attention stages are not 4..64")
    steps = 3
    (kernel, launches, weights), batch, refusals = halving(
        lambda b: self_train_attempt(cfg, b, steps), BATCH)
    want = {**FLASH_PER_STEP, **totals(SELF_PLAN)}
    check(launches == expected(want, steps),
          f"self-attention train steps launched {launches}, want {want} per step")
    want_routes = routes_expected(launches)
    check(kernel["routes"] == want_routes,
          f"the steps' flash launches took {kernel['routes']}, want {want_routes}")
    torch.cuda.empty_cache()
    pcfg = self_config(**{"model.attention_stages": SELF_TRAIN_STAGES, "use_pallas": "false"})
    (plain, _, _), plain_batch, plain_refusals = halving(
        lambda b: self_train_attempt(pcfg, b, steps), batch)
    torch.cuda.empty_cache()
    say("self-train", config="lsun_bedroom_128 as shipped, attention.kind=self at 4..64",
        steps=steps, launches=launches,
        launches_per_step={k: v / steps for k, v in launches.items()},
        kernel_path=kernel, kernel_path_refused=refusals,
        plain_path=plain, plain_path_refused=plain_refusals)
    return cfg, weights, launches, batch, kernel["routes"]


@contextlib.contextmanager
def checked_flash_backward(fl, record):
    """Hold every backward of `FlashAttention` run inside the block against
    the plain backward on the very tensors that call saved: in bf16 by the
    rule of phase 4 (against an f32 plain backward from an f32 plain
    forward of the same q, k, v), in f32 to F32_TOL; each output against
    the norm of the sum of its absolute terms. One row per call goes to
    `record`."""
    original = fl.FlashAttention.backward

    def backward(ctx, do):
        q, k, v, o, ell = ctx.saved_tensors  # unpacked once
        scale = ctx.scale
        with torch.no_grad():
            grads = fl.flash_backward(q, k, v, o, ell, do, scale)
            chunk = batch_chunk(q.shape[1], k.shape[1])
            plain = chunked(lambda *a: fl.flash_backward_reference(*a, scale),
                            (q, k, v, o, ell, do), chunk)
            truth = plain
            if q.dtype != torch.float32:
                def f32(q, k, v, do):
                    q, k, v, do = (x.float() for x in (q, k, v, do))
                    return fl.flash_backward_reference(
                        q, k, v, *fl.flash_forward_reference(q, k, v, scale), do, scale)

                truth = chunked(f32, (q, k, v, do), chunk)
            scales = flash_scales(fl, q, k, v, do, scale)[2:]
        shape = dict(B=q.shape[0], T=q.shape[1], dh=q.shape[2], dv=v.shape[2])
        row = dict(shape, dtype=str(q.dtype).replace("torch.", ""))
        for name, kk, pp, tt, sc in zip(FLASH_NAMES[2:], grads, plain, truth, scales):
            hold(name, shape, kk, pp, tt, q.dtype, row, scale=sc)
        record.append(row)
        return (*grads, None)

    fl.FlashAttention.backward = staticmethod(backward)
    try:
        yield
    finally:
        fl.FlashAttention.backward = original


def phase_self_train_grads(fl, cfg, weights, batch):
    """Phase 25: one step's gradients (R1 firing) of the training
    configuration on the kernel path, each of its 20 flash backward calls
    on the mma route and held against the plain backward on its own saved
    tensors (bf16 rule);
    then at 64^2 with all five layers, f32, batch 16: the kernel path's
    whole gradients within TRAIN_F32_TOL of the plain path's (or ten times
    what 1e-7 weight noise moves the plain path by, if larger), each flash
    backward call on the simt route and within F32_TOL."""
    g = torch.Generator(device="cuda")
    g.manual_seed(8)
    z_d = torch.randn(batch, cfg.model.latent_dim, device="cuda", generator=g)
    z_g = torch.randn(batch, cfg.model.latent_dim, device="cuda", generator=g)
    calls = []
    with checked_flash_backward(fl, calls):
        reset_counters()
        _, _, d_loss, g_loss, r1 = step_grads(cfg, weights, z_d, z_g, 128, True, "bfloat16")
        launches, routes = read_counters(), read_route_counters()
    want = FLASH_PER_STEP["flash_dq"]
    check(len(calls) == want, f"{len(calls)} flash backward calls in one step, want {want}")
    check(launches == expected({**FLASH_PER_STEP, **totals(SELF_PLAN)}),
          f"one step's gradients launched {launches}")
    check(routes == routes_expected(FLASH_PER_STEP), f"one step's flash launches took {routes}")
    check(all(math.isfinite(x) for x in (d_loss, g_loss, r1)) and r1 > 0.0,
          f"self-attention step losses {d_loss}, {g_loss}, r1 {r1}")
    # over the calls whose errors are above the rounding-noise floor
    worst = {name: max([r[f"{name}_rel_err_kernel_vs_f32"] / r[f"{name}_rel_err_plain_vs_f32"]
                        for r in calls if r[f"{name}_rel_err_plain_vs_f32"] > BF16_FLOOR],
                       default=None)
             for name in FLASH_NAMES[2:]}

    cfg64 = self_config(**{"model.resolution": "64", "data.resolution": "64"})
    gan, _, _ = trainer(cfg64)
    w64 = (gan.generator.state_dict(), gan.discriminator.state_dict())
    del gan
    z = [t[:FLASH_BATCH] for t in (z_d, z_g)]  # the whole batch where it is smaller
    calls64 = []
    with checked_flash_backward(fl, calls64):
        reset_counters()
        k64 = step_grads(cfg64, w64, *z, 64, True, "float32")
        routes64 = read_route_counters()
    check(routes64 == routes_expected(FLASH_PER_STEP, "simt"),
          f"the f32 step's flash launches took {routes64}")
    p64 = step_grads(cfg64, w64, *z, 64, False, "float32")
    noisy64 = step_grads(cfg64, w64, *z, 64, False, "float32", perturb=1e-7)
    check(len(calls64) == want, f"{len(calls64)} flash backward calls at 64^2, want {want}")
    rows = {}
    for i, net in enumerate(("D", "G")):
        e, moved = rel_err(k64[i], p64[i]), rel_err(noisy64[i], p64[i])
        limit = max(TRAIN_F32_TOL, 10.0 * moved)
        rows[net] = dict(rel_err_kernel_vs_plain_f32_at_64=e,
                         rel_change_f32_at_64_at_1e7_weight_noise=moved)
        check(e <= limit, f"{net} gradient at 64^2 f32, self-attention: {e:.3e} > {limit:.3e}")
    say("self-train-grads", batch=batch, r1_fired=True, d_loss=d_loss, g_loss=g_loss, r1=r1,
        flash_backward_calls_checked={"bf16_128": len(calls), "f32_64": len(calls64)},
        routes={"bf16_128": routes, "f32_64": routes64},
        worst_kernel_over_plain_error_ratio_bf16=worst,
        worst_flash_backward_rel_err_f32=max(v for r in calls64 for k, v in r.items()
                                             if k.endswith("rel_err_kernel_vs_plain")),
        gradients_f32_at_64=rows, losses_at_64=dict(kernel=k64[2:], plain=p64[2:]),
        calls_bf16=calls)


def flash_entry(kernel, rows, train_rows, launches, serve_launches, routes):
    """The {"kernels": [...]} entry of a flash kernel: per self-attention
    train step at batch 64, each shape's time times its launches a step
    (timed at batch 64 in phase 22's second half), beside the simt route's
    time of the same launches, and the launches the main path's run made
    on the mma route."""
    mult = FLASH_FWD_PER_STEP if kernel == "flash_fwd" else FLASH_BWD_PER_STEP
    names = {"flash_fwd": ("o", "ell"), "flash_dq": ("dq",), "flash_dkv": ("dk", "dv")}[kernel]

    def total(key):
        vals = [r[kernel][key] for r in train_rows]
        if any(v is None for v in vals):
            return None
        return sum(mult[(r["shape"]["T"], r["shape"]["dh"], r["shape"]["dv"])] * v
                   for r, v in zip(train_rows, vals))

    by_ops = sum(mult[(r["shape"]["T"], r["shape"]["dh"], r["shape"]["dv"])]
                 * r[kernel]["bound_ms"] for r in train_rows
                 if r[kernel]["bound_by"] == "operations")
    entry = {
        "name": kernel,
        "route": "cuda",
        "source": FLASH_SOURCE,
        "replaces": REPLACES[kernel],
        "launches": launches[kernel],  # the self-attention configuration's three train steps
        "max_abs_err": max(r[f"{n}_max_abs_err"] for r in rows for n in names),
        "ms": total("ms"),
        "plain_ms": total("plain_ms"),
        "bound_ms": total("bound_ms"),
        "bound_by": "operations" if by_ops >= total("bound_ms") / 2 else "bytes",
        "library_ms": total("library_ms"),
        "shapes": [dict(r["shape"], dtype=r["dtype"],
                        **{k: r[kernel][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                     "library_ms", "ms_simt")
                           if k in r[kernel]})
                   for r in rows + train_rows if kernel in r],
    }
    if kernel == "flash_fwd":
        entry["launches_serving"] = serve_launches[kernel]
    else:
        entry["library_covers"] = train_rows[0][kernel]["library_covers"]
    entry["routes"] = sorted({r[kernel]["route"] for r in train_rows})
    entry["launches_mma"] = routes[kernel]["mma"]
    entry["ms_simt"] = total("ms_simt")  # the same launches on the simt route
    return entry


def sigmoid_entry(kernel, rows, launches, serve_launches, routes):
    """The {"kernels": [...]} entry of a sigmoid gate kernel: per
    ffhq_512-sigmoid train step at batch 16, each shape's time times its
    launches a step, beside the simt route's time of the same launches,
    with the launches the main path's run made on the mma route (`routes`,
    phase 18's counters)."""
    mult = SIGMOID_FWD_PER_STEP if kernel == "sigmoid_gate" else SIGMOID_BWD_PER_STEP
    names = ("y",) if kernel == "sigmoid_gate" else GRAD_NAMES[1:]
    timed_rows = [r for r in rows if kernel in r]
    entry = {
        "name": kernel,
        "route": "cuda",
        "source": SOURCE,
        "replaces": REPLACES[kernel],
        "launches": launches[kernel],  # ffhq_512-sigmoid's three train steps
        "max_abs_err": max(r[f"{n}_max_abs_err"] for r in timed_rows for n in names),
        "ms": per_step(timed_rows, kernel, mult, "ms"),
        "plain_ms": per_step(timed_rows, kernel, mult, "plain_ms"),
        "bound_ms": per_step(timed_rows, kernel, mult, "bound_ms"),
        "bound_by": ("bytes" if all(r[kernel]["bound_by"] == "bytes" for r in timed_rows
                                    if r["dtype"] == "bfloat16") else "operations"),
        "library_ms": None,
        "shapes": [dict(N=r["shape"]["N"], HW=r["shape"]["HW"], C=r["shape"]["C"],
                        dtype=r["dtype"], launches_per_step=mult.get((
                            r["shape"]["HW"], r["shape"]["C"], r["shape"]["Hd"]), 0),
                        **{k: r[kernel][k] for k in ("ms", "plain_ms", "bound_ms", "route",
                                                     "ms_simt", "ms_unsplit", "splits")
                           if k in r[kernel]})
                   for r in timed_rows],
    }
    if kernel == "sigmoid_gate":
        entry["launches_serving"] = serve_launches[kernel]
        entry["ms_per_served_forward"] = per_step(timed_rows, kernel, SIGMOID_SERVE, "ms")
    # two routes: the mma shapes beside their simt time
    bf16 = [r for r in timed_rows if r["dtype"] == "bfloat16"]
    entry["routes"] = sorted({r[kernel]["route"] for r in bf16})
    entry["launches_mma"] = routes[kernel]["mma"]
    entry["ms_simt"] = sum(mult.get((r["shape"]["HW"], r["shape"]["C"], r["shape"]["Hd"]), 0)
                           * r[kernel].get("ms_simt", r[kernel]["ms"]) for r in bf16)
    return entry


def stage_entry(kernel, times, max_err, launches, forms=None, routes=None, forced=None):
    """The {"kernels": [...]} entry of a fused-stage kernel: per ffhq_512
    train step at batch 16 (ffhq_512-sigmoid for stage_sigmoid), each
    form's time times its launches a step; for the kernels of
    STAGE_ROUTED beside the simt route's time of the same launches, with
    the launches the main path's run made on the mma route (`routes`,
    read_stage_routes()). A kernel the profile takes off the main path
    reports the launches of the run with every stage fused (`forced`)."""
    forms = FFHQ_STAGE_PER_STEP[kernel] if forms is None else forms
    off_path = not forms
    if off_path:  # the profile fuses no stage of this form: one launch at 512^2
        forms = {"plain@512": 1}

    def total(key):
        return sum(times[(kernel, f)][key] * k for f, k in forms.items())

    by_ops = sum(times[(kernel, f)]["bound_ms"] * k for f, k in forms.items()
                 if times[(kernel, f)]["bound_by"] == "operations")
    keys = ("ms", "plain_ms", "bound_ms", "bound_by") + (("ms_simt",) if kernel in STAGE_ROUTED
                                                       else ())
    entry = {
        "name": kernel,
        "route": "cuda",
        "source": STAGE_SOURCE,
        "replaces": REPLACES[kernel],
        "launches": launches[kernel],  # ffhq_512's three train steps
        "max_abs_err": max_err[kernel],
        "ms": total("ms"),
        "plain_ms": total("plain_ms"),
        "bound_ms": total("bound_ms"),
        "bound_by": "operations" if by_ops >= total("bound_ms") / 2 else "bytes",
        "library_ms": None,
        "forms": [dict(form=f, launches_per_step=k,
                       **{key: times[(kernel, f)][key] for key in keys})
                  for f, k in forms.items()],
    }
    if kernel in STAGE_ROUTED:
        entry["routes"] = ["mma"]
        entry["launches_mma"] = routes[kernel]["mma"]
        entry["ms_simt"] = total("ms_simt")  # the same launches on the simt route
    if off_path:
        entry.update(launches=forced[kernel], main_path=False, launches_source=(
            "phase 13: ffhq_512's widths at 64^2 with every stage fused; the gate profile "
            "fuses no stage that launches it on ffhq_512's path, so ms, plain_ms and "
            "bound_ms are one launch at 512^2"))
    return entry


def per_step(rows, kind, mult, key):
    """Each bf16 row's `key` times its shape's launches in `mult` (none
    where `mult` does not name the shape), summed."""
    return sum(mult.get((r["shape"]["HW"], r["shape"]["C"], r["shape"]["Hd"]), 0)
               * r[kind][key] for r in rows if r["dtype"] == "bfloat16")


# ---------------------------------------------------------------------------
# CUDA graphs: several steps a call (make_multi_step) and sampling
# ---------------------------------------------------------------------------


def stacked_batch(k, n, res=128, seed=0, lead=(), classes=0):
    """k different uint8 batches of n images, [k, *lead, n, res, res, 3]
    (`lead` = (d_steps,) for the multi-critic step), and their labels
    (uniform over `classes`, or zeros), on the card."""
    import numpy as np

    rng = np.random.default_rng(seed)
    shape = (k, *lead, n)
    host = rng.integers(0, 256, shape + (res, res, 3), dtype=np.uint8)
    labels = rng.integers(0, max(classes, 1), shape)
    return {"image": torch.from_numpy(host).to("cuda"),
            "label": torch.from_numpy(labels).to("cuda")}


def state_values(state):
    """A copy of a train state's tensors, step and generator state."""
    from locate_tpu_torch.train.state import state_tensors

    torch.cuda.synchronize()
    return ({k: t.clone() for k, t in state_tensors(state).items()}, state.step,
            state.rng.get_state())


def differences(a, b) -> dict:
    """{name: largest |a - b|} of two state_values' tensors and two lists of
    call metrics, only where they differ; the step count and the generator
    state under "step" and "rng"."""
    out = {}
    for k in a[0]:
        if not torch.equal(a[0][k], b[0][k]):
            out[k] = float((a[0][k].double() - b[0][k].double()).abs().max())
    if a[1] != b[1]:
        out["step"] = abs(a[1] - b[1])
    if not torch.equal(a[2], b[2]):
        out["rng"] = 1.0
    for i, (ma, mb) in enumerate(zip(a[3], b[3])):
        for k in ma:
            if not torch.equal(ma[k], mb[k]):
                out[f"call{i}.{k}"] = float((ma[k].double() - mb[k].double()).abs().max())
    return out


def graph_vs_eager(cfg, k, calls, n, res, phase):
    """One state, `calls` calls of `make_multi_step(step, k)` on the card
    (CUDA graphs of the step, R1's steps a second graph) against calls * k
    eager steps on the same k batches, twice: params, optimizer states,
    EMA, guard counters, step, generator state and each call's reduced
    metrics bitwise equal to the eager run's, or, where two eager runs
    already differ, the graph's differences within the eager runs' own;
    each captured variant (one a set of lazy flags: R1, PL) launches the
    kernels of one eager step."""
    from locate_tpu_torch.train.graph import StepGraphs
    from locate_tpu_torch.train.state import restore, snapshot
    from locate_tpu_torch.train.step import make_multi_step, reduce_metrics

    gan, state, step = trainer(cfg)
    lead = (cfg.train.d_steps,) if cfg.train.d_steps > 1 else ()
    batches = stacked_batch(k, n, res, lead=lead, classes=cfg.model.num_classes)
    saved = snapshot(state)

    def eager():
        restore(state, saved)
        metrics = []
        t0 = time.perf_counter()
        for _ in range(calls):
            history = [step(state, {name: t[i] for name, t in batches.items()})[1]
                       for i in range(k)]
            metrics.append(reduce_metrics({key: torch.stack([m[key] for m in history])
                                           for key in history[0]}))
        values = state_values(state)
        return (*values, metrics), time.perf_counter() - t0

    reset_counters()
    first, eager_s = eager()
    steps = calls * k
    launches = read_counters()
    check(all(v % steps == 0 for v in launches.values()),
          f"{phase}: eager launches {launches} over {steps} steps")
    per_step = {name: v // steps for name, v in launches.items()}

    restore(state, saved)
    multi = make_multi_step(step, k)
    graphs = multi.graphs = StepGraphs(step, k, state, batches, {})
    graphs.load(batches, {})
    flags = sorted({step.lazy_flags(saved.step + c * k + i) for c in range(calls)
                    for i in range(k)})
    graphs.warm_up(flags)
    captured = {}
    for f in flags:
        reset_counters()
        graphs.capture(f)
        name = "+".join(n for n, on in zip(("r1", "pl"), f) if on) or "plain"
        captured[name] = read_counters()
        check(captured[name] == per_step,
              f"{phase}: the {name} step's capture launched {captured[name]}, an eager "
              f"step {per_step}")
    reset_counters()
    metrics = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        metrics.append(multi(state, batches)[1])
    graph = (*state_values(state), metrics)
    graph_s = time.perf_counter() - t0
    check(read_counters() == expected({}), f"{phase}: replays called a wrapper")
    diff = differences(first, graph)
    # a second eager run only where the graph's differs: if two eager runs
    # differ too, an op of the step is not repeatable
    spread = differences(first, eager()[0]) if diff else {}
    if spread:
        # an op of the eager step is not repeatable: the graph's differences
        # from the first eager run within the second run's
        check(set(diff) <= set(spread) and all(diff[k] <= spread[k] for k in diff),
              f"{phase}: graph vs eager {diff}, beyond the eager runs' spread {spread}")
    else:
        check(not diff, f"{phase}: graph vs eager differ bitwise: {diff}")
    history = [{key: float(v) for key, v in m.items()} for m in metrics]
    for m in history:
        check(all(math.isfinite(v) for v in m.values()), f"{phase}: metrics {m}")
    out = dict(config=cfg.name, batch=n, steps_per_call=k, calls=calls,
               graph_variants=sorted(captured), launches_per_step=per_step,
               bitwise_equal=not diff, eager_spread=spread, graph_vs_eager=diff,
               eager_seconds_per_step=eager_s / steps, graph_seconds_per_step=graph_s / steps,
               metrics=history)
    del gan, state, step, multi, graphs, batches, first, graph, saved
    release_memory()
    return out


def phase_step_graphs():
    """The CUDA-graph step against eager steps: lsun_bedroom_128's bench
    config at batch 64, spc=4; the preset as shipped (R1 every 16, both
    guards) at spc=16, two calls from step 0; ffhq_512 with each gate at
    spc=2 under the raised guard; lsun_bedroom_128 with self-attention at
    phase 24's config, spc=2."""
    from locate_tpu_torch import cli

    rows = {}
    rows["lsun_bench_config"] = graph_vs_eager(cli.bench_config(BATCH, []), 4, 1, BATCH, 128,
                                               "graph-lsun-bench")
    shipped = lsun_config()
    check(shipped.train.r1_interval == 16 and shipped.train.r1_gamma > 0
          and shipped.train.grad_norm_limit > 0 and shipped.train.max_nonfinite_skips > 0,
          "lsun_bedroom_128 is not the shipped recipe")
    rows["lsun_shipped"] = graph_vs_eager(shipped, 16, 2, BATCH, 128, "graph-lsun-shipped")
    check(rows["lsun_shipped"]["graph_variants"] == ["plain", "r1"],
          "the shipped preset's calls did not capture an R1 step")
    for name, overrides in (("ffhq_softmax", {}), ("ffhq_sigmoid", SIGMOID)):
        cfg = ffhq_config(**{"train.grad_norm_limit": str(RAISED_GRAD_NORM_LIMIT), **overrides})
        rows[name] = graph_vs_eager(cfg, 2, 1, FFHQ_BATCH, 512, f"graph-{name}")
    rows["self_attention"] = graph_vs_eager(
        self_config(**{"model.attention_stages": SELF_TRAIN_STAGES}), 2, 1, BATCH, 128,
        "graph-self-attention")
    say("step-graphs", **rows)
    return rows


def phase_sample_graph():
    """bench-sample's CUDA graph (draw, forward, uint8) against eager
    `generate_samples` from the same seed: lsun_bedroom_128 at batch 64,
    ffhq_512 at 16, three batches each, bitwise."""
    from locate_tpu_torch.io.sampling import generate_samples
    from locate_tpu_torch.models.gan import model_config
    from locate_tpu_torch.models.generator import build_generator
    from locate_tpu_torch.train.graph import SampleGraph

    rows = {}
    for name, cfg, n in (("lsun_bedroom_128", lsun_config(), BATCH),
                         ("ffhq_512", ffhq_config(), FFHQ_BATCH)):
        model = build_generator(model_config(cfg), cfg.train.compute_dtype, "cuda").eval()
        randomize_logit_convs(model, seed=1, scale=0.25)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(5)
        eager = [generate_samples(model, gen, n) for _ in range(3)]
        gen.manual_seed(5)
        sample = SampleGraph(model, gen, n)
        graph = [sample() for _ in range(3)]
        same = all((a == b).all() for a, b in zip(eager, graph))
        check(same, f"{name}: graph sampling differs from eager sampling")
        check(len({a.tobytes() for a in graph}) == 3, f"{name}: replays drew the same latents")
        idle, _ = profile_calls(sample, calls=3)
        rows[name] = dict(batch=n, bitwise_equal=same, images=list(graph[0].shape),
                          device_idle_share_graph="not measured" if idle is None else idle)
        del model, sample, eager, graph
        release_memory()
    say("sample-graphs", **rows)
    return rows


# ---------------------------------------------------------------------------
# The input path: packed shards, the producer thread and the device prefetch
# ---------------------------------------------------------------------------

E2E_BATCH = 128
# bench.py:146-170 packs max(4 batch, 2048) at batch 128; cut to 1024 to pay
# for phases 37-38 (CUTS)
E2E_PACK_LENGTH = 1024
E2E_PREFETCHED = 4


def host_batch_on_card(batch, lead=()):
    """A producer's host batch as tensors on the card, labels int64, with
    `lead` leading axes split off the batch axis."""
    import numpy as np

    return {k: torch.from_numpy(np.ascontiguousarray(
        v.reshape(*lead, -1, *v.shape[1:]).astype(np.int64 if k == "label" else v.dtype)))
        .to("cuda") for k, v in batch.items()}


def phase_e2e_input_path():
    """Phase 28: the pack's rate and the native loader's state on this
    host; `bench 128 BENCH_CALLS e2e` on the kernel path (reconciliation held, the
    input path alone faster than the device-only rate); the idle share and
    top kernels of PROFILED_EAGER_STEPS eager step(s) fed by the pipeline
    (beside as many fed batches pulled before the window, and as many on
    one fixed batch); 8 prefetched batches,
    the step run between them, copied back and held byte for byte against
    a second producer's host batches from the same seed; two spc=4 graph
    calls fed from the prefetch against the same calls fed host-made
    tensors, bitwise."""
    import shutil
    import tempfile

    from locate_tpu_torch import cli
    from locate_tpu_torch.data import native
    from locate_tpu_torch.data.datasets import SyntheticImages
    from locate_tpu_torch.data.packed import PackedDataset, pack_dataset
    from locate_tpu_torch.data.pipeline import BatchProducer, make_input_pipeline
    from locate_tpu_torch.train.state import restore, snapshot
    from locate_tpu_torch.train.step import make_multi_step

    scratch = tempfile.mkdtemp(prefix="smoke_pack_")
    pack = os.path.join(scratch, "pack128")
    t0 = time.perf_counter()
    pack_dataset(SyntheticImages(128, 3, length=E2E_PACK_LENGTH), pack)
    pack_s = time.perf_counter() - t0
    loader = dict(native_loader_built=native.available(), native_error=native.load_error(),
                  packed_flip="native" if native.available() else "numpy reversed-W gather",
                  pack_images=E2E_PACK_LENGTH, pack_seconds=pack_s,
                  pack_images_per_sec=E2E_PACK_LENGTH / pack_s)
    say("input-path-host", **loader)

    e2e = run_cli(["bench", str(E2E_BATCH), BENCH_CALLS, "e2e", f"--pack={pack}"])
    release_memory()
    rec = e2e["reconciliation"]
    check(rec["ok"], f"bench e2e: reconciliation failed {rec}")
    check(e2e["input_path_images_per_sec"] > e2e["device_only_images_per_sec"],
          f"bench e2e: the input path alone ({e2e['input_path_images_per_sec']} img/s) is "
          f"slower than the device-only step ({e2e['device_only_images_per_sec']})")

    # the idle share of eager steps fed by the live pipeline, by its
    # batches pulled first (the producer then blocked on a full queue), and
    # by one fixed batch: what the producer thread's work costs the launches
    cfg = cli.bench_pack(cli.bench_config(E2E_BATCH, ["e2e"]), E2E_BATCH, pack)
    gan, state, step = trainer(cfg)
    with make_input_pipeline(cfg.data, E2E_BATCH, device="cuda", seed=0) as pipe:
        idle, top = profile_calls(lambda: step(state, next(pipe)), calls=PROFILED_EAGER_STEPS,
                                  top=12)
        pulled = [next(pipe) for _ in range(4)]
        time.sleep(1.0)  # the producer refills its queue and blocks
        idle_pulled, _ = profile_calls(lambda: step(state, pulled.pop()),
                                       calls=PROFILED_EAGER_STEPS)
    fixed = fixed_batch(E2E_BATCH)
    idle_fixed, _ = profile_calls(lambda: step(state, fixed), calls=PROFILED_EAGER_STEPS)
    idles = {name: "not measured" if v is None else v for name, v in
             (("live_pipeline", idle), ("pulled_batches", idle_pulled),
              ("fixed_batch", idle_fixed))}

    # prefetched batches under a running step, against host batches
    ref = BatchProducer(PackedDataset(pack), E2E_BATCH, seed=7, random_flip=True)
    ref_it = iter(ref)
    mismatched = []
    with make_input_pipeline(cfg.data, E2E_BATCH, device="cuda", seed=7) as pipe:
        for i in range(E2E_PREFETCHED):
            b = next(pipe)
            state, _ = step(state, b)
            got = {k: v.cpu().numpy() for k, v in b.items()}
            want = next(ref_it)
            if not all((got[k] == want[k]).all() and got[k].shape == want[k].shape
                       for k in want):
                mismatched.append(i)
    ref.close()
    check(not mismatched, f"prefetched batches {mismatched} differ from the host batches")
    del gan, state, step
    release_memory()

    # two spc=4 graph calls: fed from the prefetch, and fed host-made tensors
    k, n = 4, BATCH
    cfg4 = cli.bench_pack(cli.bench_config(n, ["e2e", f"spc={k}"]), n, pack)
    gan, state, step = trainer(cfg4)
    multi = make_multi_step(step, k)
    saved = snapshot(state)

    def two_calls(fed):
        restore(state, saved)
        metrics = []
        if fed == "prefetch":
            with make_input_pipeline(cfg4.data, n, device="cuda", seed=3,
                                     steps_per_call=k) as pipe:
                for _ in range(2):
                    metrics.append(multi(state, next(pipe))[1])
        else:
            prod = BatchProducer(PackedDataset(pack), n * k, seed=3, random_flip=True)
            it = iter(prod)
            for _ in range(2):
                metrics.append(multi(state, host_batch_on_card(next(it), (k,)))[1])
            prod.close()
        return (*state_values(state), metrics)

    prefetched, host = two_calls("prefetch"), two_calls("host")
    diff = differences(prefetched, host)
    # where they differ, a second host-fed run shows whether the step itself repeats
    spread = differences(host, two_calls("host")) if diff else {}
    check(not diff, f"prefetch-fed graph calls differ from host-fed ones: {diff} "
                    f"(two host-fed runs: {spread})")
    del gan, state, step, multi, saved, prefetched, host
    release_memory()
    shutil.rmtree(scratch)
    say("e2e-input-path", bench_e2e=e2e,
        e2e_eager_steps=dict(steps=PROFILED_EAGER_STEPS, device_idle_share=idles,
                             top_kernels=top),
        prefetch_byte_exact_batches=E2E_PREFETCHED, graph_spc4_prefetch_vs_host="bitwise equal")
    return e2e, loader


# ---------------------------------------------------------------------------
# The train loop: checkpoints, a SIGKILL and resume, export and sampling
# ---------------------------------------------------------------------------

LOOP_STEPS = 32
LOOP_SPC = 8
# lsun_bedroom_128 as shipped (R1 every 16, both guards, EMA) at full
# width, batch 64, bf16, on the kernels; only the data source is cut (the
# preset's folder holds no images on the card's machine)
LOOP_ARGS = ["lsun_bedroom_128", "use_pallas=true", "data.dataset=synthetic",
             f"train.global_batch={BATCH}", "train.compute_dtype=bfloat16",
             f"train.steps_per_call={LOOP_SPC}", f"train.total_steps={LOOP_STEPS}",
             f"train.log_every={LOOP_SPC}", f"train.checkpoint_every={LOOP_SPC}",
             f"train.sample_every={LOOP_STEPS}", "train.async_checkpoint=true",
             f"train.eval_every={2 * LOOP_SPC}"]
LOOP_KERNELS = ("softmax_stats", "softmax_apply", "softmax_csum", "softmax_bwd",
                "stage_conv", "stage_conv_bwd")
# a child that trains through the CLI with cuDNN held to deterministic
# algorithms (the drill's own setting, no option of the port)
DETERMINISTIC_CHILD = ("import sys, torch\n"
                       "torch.backends.cudnn.deterministic = True\n"
                       "from locate_tpu_torch import cli\n"
                       "sys.exit(cli.main(sys.argv[1:]))\n")
TIMING_KEYS = ("images_per_sec", "sec_per_step")


def train_child(workdir, deterministic, wait=True):
    """`train` of LOOP_ARGS in `workdir`, in a child process (output to
    <workdir>.log): `python -m locate_tpu_torch train ...`, or the same
    command with cuDNN deterministic. Waits for it unless `wait` is
    False (then returns the process)."""
    cmd = ([sys.executable, "-c", DETERMINISTIC_CHILD] if deterministic
           else [sys.executable, "-m", "locate_tpu_torch"])
    cmd += ["train", *LOOP_ARGS, f"workdir={workdir}"]
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    log = open(workdir + ".log", "a")
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT)
    log.close()
    if not wait:
        return proc
    try:
        rc = proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    with open(workdir + ".log") as f:
        out = f.read()
    check(rc == 0, f"train in {workdir} exited {rc}: {out[-3000:]}")
    return out


def loop_records(workdir):
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def checkpoint_payload(workdir, step):
    return torch.load(os.path.join(workdir, "checkpoints", str(step), "state.pt"),
                      map_location="cpu", weights_only=True)


def run_differences(a, b) -> dict:
    """Where two runs' final checkpoints, sample grids and logged records
    (but their timing fields) differ: {what: largest |a - b| or a note}."""
    pa, pb = checkpoint_payload(a, LOOP_STEPS), checkpoint_payload(b, LOOP_STEPS)
    out = {}
    for k, t in pa["tensors"].items():
        if not torch.equal(t, pb["tensors"][k]):
            out[k] = float((t.double() - pb["tensors"][k].double()).abs().max())
    if pa["step"] != pb["step"]:
        out["step"] = [pa["step"], pb["step"]]
    if not torch.equal(pa["rng"], pb["rng"]):
        out["rng"] = "differs"
    grid = os.path.join("samples", f"step_{LOOP_STEPS:08d}.png")
    with open(os.path.join(a, grid), "rb") as fa, open(os.path.join(b, grid), "rb") as fb:
        if fa.read() != fb.read():
            out["sample_grid"] = "differs"
    ra, rb = loop_records(a), loop_records(b)
    for x, y in zip(ra, rb):
        for k in x:
            if k not in TIMING_KEYS and x[k] != y.get(k):
                out[f"step{x['step']}.{k}"] = [x[k], y.get(k)]
    if [r["step"] for r in ra] != [r["step"] for r in rb]:
        out["logged_steps"] = [[r["step"] for r in ra], [r["step"] for r in rb]]
    best = [os.path.join(run, "best.json") for run in (a, b)]
    if not all(os.path.isfile(p) for p in best):
        out["best_json"] = "missing"
        return out
    with open(best[0]) as fa, open(best[1]) as fb:
        ba, bb = json.load(fa), json.load(fb)
    if ba != bb:
        out["best_json"] = [ba, bb]
    pa, pb = (torch.load(os.path.join(run, "checkpoints_best", str(ba["step"]), "state.pt"),
                         map_location="cpu", weights_only=True) for run in (a, b))
    for k, t in pa["tensors"].items():
        if not torch.equal(t, pb["tensors"][k]):
            out[f"best.{k}"] = float((t.double() - pb["tensors"][k].double()).abs().max())
    return out


def train_records(records):
    """The step records of a metrics.jsonl, its eval records left out."""
    return [r for r in records if "eval_rfid" not in r]


def killed_and_resumed(workdir, deterministic):
    """Run B: the loop in a child SIGKILLed as soon as checkpoints/16 is
    complete (renamed into place), then resumed to the end by another."""
    proc = train_child(workdir, deterministic, wait=False)
    target = os.path.join(workdir, "checkpoints", str(2 * LOOP_SPC))
    deadline = time.time() + 600
    try:
        while not os.path.isdir(target) and proc.poll() is None and time.time() < deadline:
            time.sleep(0.02)
        check(os.path.isdir(target), f"run B never wrote {target}")
        os.kill(proc.pid, 9)
    finally:
        rc = proc.wait()
    check(rc == -9, f"run B ended before the kill ({rc})")
    killed_at = sorted(int(n) for n in os.listdir(os.path.join(workdir, "checkpoints"))
                       if n.isdigit())
    out = train_child(workdir, deterministic)
    resumed = re.search(r"resumed from step (\d+)", out)
    check(resumed is not None, f"run B did not resume: {out[-2000:]}")
    return killed_at, int(resumed.group(1))


class WindowProfile:
    """torch.profiler over the loop's log boundaries `start` to `stop`
    (the hook "on_metrics" at each): one logged window. Its readings are
    taken after the run (`result`), outside the loop's clock."""

    def __init__(self, start, stop):
        from torch.profiler import ProfilerActivity, profile

        self.start, self.stop = start, stop
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.wall = None

    def __call__(self, step, metrics):
        if step == self.start:
            torch.cuda.synchronize()
            self.prof.start()
            self.t0 = time.perf_counter()
        elif step == self.stop:
            torch.cuda.synchronize()
            self.wall = time.perf_counter() - self.t0
            self.prof.stop()

    def result(self) -> dict:
        check(self.wall is not None, f"the loop never reached log step {self.stop}")
        idle, top = idle_and_top(self.prof, self.wall, 1, top=8)
        return dict(steps=[self.start + 1, self.stop], wall_seconds=self.wall,
                    device_idle_share="not measured" if idle is None else idle,
                    top_kernels=top)


def save_cost(state):
    """An async save of `state` on the step's stream: the device time of
    its device-to-host copies (CUDA events around `save`), the host time
    of the call, the first save's (which pins the host buffers), bytes."""
    import shutil
    import tempfile

    from locate_tpu_torch.io.checkpoint import CheckpointManager
    from locate_tpu_torch.train.state import state_tensors

    scratch = tempfile.mkdtemp(prefix="smoke_ckpt_")
    mgr = CheckpointManager(scratch, keep=1, async_save=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr.save(state, step=1)
    first_host_ms = (time.perf_counter() - t0) * 1e3
    mgr.wait()
    rows = []
    for step in (2, 3, 4):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        t0 = time.perf_counter()
        mgr.save(state, step=step)
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        end.synchronize()
        rows.append((start.elapsed_time(end), host_ms))
        mgr.wait()
    mgr.close()
    shutil.rmtree(scratch)
    nbytes = sum(t.numel() * t.element_size() for t in state_tensors(state).values())
    device_ms = min(r[0] for r in rows)
    return dict(state_bytes=nbytes, stream_ms=[r[0] for r in rows],
                host_ms=[r[1] for r in rows], first_save_host_ms=first_host_ms,
                copy_gb_per_s=nbytes / device_ms / 1e6)


def phase_train_loop():
    """Phase 29: the train loop of lsun_bedroom_128 at full width (LOOP_ARGS,
    an in-training eval every 16 steps) in child processes through
    `python -m locate_tpu_torch train` with cuDNN deterministic: run A,
    its logged images/sec the loop's rate (the eval's time left out);
    run B SIGKILLed as soon as checkpoints/16 is complete and resumed to
    the end: its final checkpoint (every tensor, step, generator), sample
    grid, metrics.jsonl (one monotone trajectory; every record but its
    timing fields), best.json and best checkpoint equal A's. The loop's
    rate is run A's over its last R1 period (steps 17-32, R1 at the first
    of them: two logged calls at spc 8). In this process: the loop once
    more, without the eval, with the counters from 0
    (every kernel of the step launched) and the device's idle share over
    that period; an async save's cost on the step's stream; `bench 64
    LOOP_BENCH_CALLS`'s fixed-batch rate at spc=8 and the loop's recipe on
    a fixed batch (LOOP_BENCH_CALLS calls) beside the loop's rate.
    Then `export` of A's checkpoint: `sample --generator` on the export
    and `sample --checkpoint` on A write the same PNG bytes. Returns (its
    line, the loop's launches, the phase's directory: run A's checkpoint
    for phase 36, which removes it)."""
    import tempfile

    from locate_tpu_torch import cli
    from locate_tpu_torch.config import get_config, parse_cli_overrides
    from locate_tpu_torch.train.loop import train

    scratch = tempfile.mkdtemp(prefix="smoke_loop_")
    run_a, run_b = (os.path.join(scratch, n) for n in ("a", "b"))
    t0 = time.perf_counter()
    train_child(run_a, True)
    child_seconds = time.perf_counter() - t0
    killed_at, resumed_from = killed_and_resumed(run_b, True)
    check(resumed_from >= 2 * LOOP_SPC, f"run B resumed from step {resumed_from}")
    all_b = loop_records(run_b)
    steps_b = [r["step"] for r in train_records(all_b)]
    check(steps_b == sorted(set(steps_b)) == list(range(LOOP_SPC, LOOP_STEPS + 1, LOOP_SPC)),
          f"run B's metrics.jsonl steps {steps_b}")
    evals_b = [r["step"] for r in all_b if "eval_rfid" in r]
    check(evals_b == list(range(2 * LOOP_SPC, LOOP_STEPS + 1, 2 * LOOP_SPC)),
          f"run B's eval records at steps {evals_b}")
    diff = run_differences(run_a, run_b)
    check(not diff, f"the killed and resumed run differs from the uninterrupted one: {diff}")
    all_a = loop_records(run_a)
    check(all(math.isfinite(v) for r in all_a for v in r.values() if v is not None)
          and all(v is not None for r in all_a for v in r.values()),
          f"run A logged non-finite metrics: {all_a}")
    logged, evals = train_records(all_a), [r for r in all_a if "eval_rfid" in r]
    with open(os.path.join(run_a, "best.json")) as f:
        best = json.load(f)

    # the loop in this process: its launches, one logged window's idle
    # share, its rate beside bench 64 LOOP_BENCH_CALLS's
    cfg = dataclasses.replace(get_config(LOOP_ARGS[0], parse_cli_overrides(LOOP_ARGS[1:])),
                              workdir=os.path.join(scratch, "p"))
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, sample_every=0,
                                                             eval_every=0))
    period = cfg.train.r1_interval  # a whole R1 period, its R1 step at its start
    check(period % LOOP_SPC == 0 and LOOP_STEPS % period == 0,
          f"LOOP_STEPS {LOOP_STEPS} and spc {LOOP_SPC} do not tile R1's period {period}")
    window = WindowProfile(LOOP_STEPS - period, LOOP_STEPS)
    reset_counters()
    state = train(cfg, hooks={"on_metrics": window}, device="cuda")
    launches = read_counters()
    for name, n in launches.items():
        check((n > 0) == (name in LOOP_KERNELS),
              f"the loop launched {name} {n} times (its step's kernels: {LOOP_KERNELS})")
    window_readings = window.result()
    cost = save_cost(state)
    del state, window
    release_memory()
    # the same step on one fixed batch: bench's pins (no R1, no guards), and
    # the loop's own recipe (R1 every 16, both guards)
    bench = cli.bench_images_per_sec(cli.bench_config(BATCH, [f"spc={LOOP_SPC}"]),
                                     torch.device("cuda"), BATCH, LOOP_BENCH_CALLS)
    release_memory()
    recipe = cli.bench_images_per_sec(cfg, torch.device("cuda"), BATCH, LOOP_BENCH_CALLS)
    release_memory()
    # run A's (unprofiled) over the window's calls, each of LOOP_SPC steps
    calls = logged[-(period // LOOP_SPC):]
    loop_rate = len(calls) / sum(1.0 / r["images_per_sec"] for r in calls)

    # export A's checkpoint; both sample paths on one seed
    base = os.path.join(scratch, "export", "gen")
    cli_text(["export", *LOOP_ARGS, f"workdir={run_a}", f"--out={base}"])
    sample = ["sample", *LOOP_ARGS, "--seed=7", "--count=16"]
    cli_text([*sample, f"--generator={base}.npz", f"--out={scratch}/export.png"])
    cli_text([*sample, f"--checkpoint={run_a}/checkpoints", f"--out={scratch}/ckpt.png"])
    with open(f"{scratch}/export.png", "rb") as fa, open(f"{scratch}/ckpt.png", "rb") as fb:
        same_png = fa.read() == fb.read()
    check(same_png, "sample --generator on the export and sample --checkpoint differ")
    release_memory()
    out = dict(config=" ".join(LOOP_ARGS), child_run_seconds=child_seconds,
               cudnn_deterministic=True,
               evals_run_a=[{k: r[k] for k in ("step", "eval_rfid", "eval_rkid")}
                            for r in evals], best_json=best,
               run_b=dict(complete_checkpoints_at_kill=killed_at, resumed_from=resumed_from,
                          equal_to_run_a=True),
               logged_images_per_sec_run_a=[r["images_per_sec"] for r in logged],
               loop_images_per_sec=loop_rate, bench_64_spc8_images_per_sec=bench,
               bench_calls=LOOP_BENCH_CALLS,
               fixed_batch_loop_recipe_images_per_sec=recipe,
               loop_over_bench=loop_rate / bench, loop_over_fixed_recipe=loop_rate / recipe,
               logged_window=window_readings,
               async_save=cost, launches=launches, export_png_equals_checkpoint_png=same_png)
    say("train-loop", **out)
    return out, launches, scratch


EVAL_SAMPLES = 1024
# served forwards of the eval at batch 64: evaluate_generator's, then swd_generator's
EVAL_FORWARDS = 2 * -(-EVAL_SAMPLES // BATCH)
EVAL_METRICS = ("fid", "kid", "swd_avg", "precision", "recall", "density", "coverage")
# The card's and the CPU's random-conv features are both f32 sums (TF32
# off) in other orders: a feature moves by about sqrt(2304) f32 ulps,
# ~3e-6 of its size. rFID reads them through f64 moments and a matrix
# square root, so the two devices' rFID may differ by a few 1e-6 of it;
# 1e-3 leaves room for the square root of the near-singular covariances
# (1024 features, 1024 samples) and is far below any rFID gap a user reads.
RFID_DEVICE_RTOL = 1e-3
COMPARE_IMAGES = 256
INCEPTION_BATCH = 64
INCEPTION_REPS = 5
INCEPTION_CPU_IMAGES = 8


def phase_eval(run_a):
    """Phase 36: the eval of phase 29's run A checkpoint through the CLI
    (`eval`, 1024 samples, SWD, PRDC k 5; the serving generator on the
    gate kernels, the counters from 0: exactly 32 served forwards'
    launches), the rFID of one fixed uint8 set with the card's features
    against the CPU's, `compare` of a folder against itself, and an
    InceptionV3 extractor with random weights (images/sec at batch 64,
    card against CPU features). Returns the eval's launches."""
    import shutil
    import tempfile

    import numpy as np
    from PIL import Image

    from locate_tpu_torch import cli
    from locate_tpu_torch.config import get_config, parse_cli_overrides
    from locate_tpu_torch.data.datasets import make_dataset
    from locate_tpu_torch.io import fid
    from locate_tpu_torch.io.inception import InceptionExtractor, random_archive
    from locate_tpu_torch.io.sampling import serving_generator

    args = [*LOOP_ARGS, f"workdir={run_a}"]
    reset_counters()
    t0 = time.perf_counter()
    scores = run_cli(["eval", *args, f"--samples={EVAL_SAMPLES}", "--swd", "--prdc-k=5"])
    eval_seconds = time.perf_counter() - t0
    launches = read_counters()
    want = expected(totals(LSUN_SERVE_PLAN), EVAL_FORWARDS)
    check(launches == want, f"the eval launched {launches}; its {EVAL_FORWARDS} served "
                            f"forwards launch {want}")
    check(all(math.isfinite(scores[k]) for k in EVAL_METRICS), f"eval scores {scores}")
    check(scores["n_fake"] == scores["n_real"] == EVAL_SAMPLES, f"eval counts {scores}")
    sec = scores["seconds"]
    rates = dict(generate=EVAL_SAMPLES / sec["generate"],
                 features=2 * EVAL_SAMPLES / sec["features"],
                 evaluate_generator=EVAL_SAMPLES / sum(sec[k] for k in
                                                       ("generate", "features", "data",
                                                        "metrics")),
                 swd=EVAL_SAMPLES / sec["swd"], whole_command=EVAL_SAMPLES / eval_seconds)

    # one fixed uint8 set: the checkpoint's fakes and the eval's reals
    cfg = get_config(args[0], parse_cli_overrides(args[1:]))
    gan, state = cli._restore(cfg, os.path.join(run_a, "checkpoints"), torch.device("cuda"))
    model = serving_generator(gan, state)
    del gan, state
    fake = torch.cat(list(fid.generate_fakes(model, EVAL_SAMPLES, BATCH, 0))).cpu().numpy()
    real = fid.real_examples(make_dataset(cfg.data), EVAL_SAMPLES, 0)
    del model
    release_memory()
    fixed = {}
    for dev in ("cuda", "cpu"):
        ex = fid.RandomConvFeatures(device=dev)
        t = time.perf_counter()
        fr, ff = (fid.features_in_batches(x, ex, BATCH) for x in (real, fake))
        fixed[dev] = dict(real=fr, fake=ff, seconds=time.perf_counter() - t,
                          rfid=fid.frechet_distance(*fid.feature_stats(ff),
                                                    *fid.feature_stats(fr)))
    card, cpu = fixed["cuda"], fixed["cpu"]
    feature_err = max(float(np.abs(card[s] - cpu[s]).max() / np.abs(cpu[s]).max())
                      for s in ("real", "fake"))
    rfid_rel = abs(card["rfid"] - cpu["rfid"]) / abs(cpu["rfid"])
    check(rfid_rel <= RFID_DEVICE_RTOL,
          f"rFID of one set: card {card['rfid']} against CPU {cpu['rfid']} ({rfid_rel:.3g})")

    scratch = tempfile.mkdtemp(prefix="smoke_eval_")
    folder = os.path.join(scratch, "real")
    os.makedirs(folder)
    for i, img in enumerate(real[:COMPARE_IMAGES]):
        Image.fromarray(img).save(os.path.join(folder, f"im{i:04d}.png"))
    same = run_cli(["compare", f"--a={folder}", f"--b={folder}", "--resolution=128",
                    f"--samples={COMPARE_IMAGES}", "--swd"])
    check(abs(same["fid"]) < 1e-3 and same["swd_avg"] == 0.0,
          f"compare of a folder against itself: {same}")

    path = random_archive(os.path.join(scratch, "inception.npz"), seed=5, variant="fid",
                          fc_classes=1008)
    inception = InceptionExtractor(path, device="cuda")
    batch = real[:INCEPTION_BATCH]
    inception(batch)  # cuDNN picks its algorithms
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(INCEPTION_REPS):
        feats = inception(batch)
    inception_rate = INCEPTION_REPS * INCEPTION_BATCH / (time.perf_counter() - t)
    on_cpu = InceptionExtractor(path, device="cpu")(batch[:INCEPTION_CPU_IMAGES])
    got = feats[:INCEPTION_CPU_IMAGES]
    inception_err = float(np.abs(got - on_cpu).max())
    check(feats.shape == (INCEPTION_BATCH, 2048) and np.isfinite(feats).all()
          and np.allclose(got, on_cpu, rtol=2e-3, atol=2e-4),
          f"Inception features card vs CPU: max |diff| {inception_err}")
    w, b = inception.fc
    is_mean, is_std = fid.inception_score(feats @ w + b, splits=4)
    del inception
    release_memory()
    shutil.rmtree(scratch)
    say("eval", config=" ".join(args[:-1]), samples=EVAL_SAMPLES,
        **{k: scores[k] for k in EVAL_METRICS}, kid_subsets="10 of 512",
        swd_levels={k: v for k, v in scores.items() if k.startswith("swd_")},
        seconds=sec, command_seconds=eval_seconds, images_per_sec=rates,
        launches_eval=launches,
        fixed_set=dict(rfid_card=card["rfid"], rfid_cpu=cpu["rfid"], rfid_rel_diff=rfid_rel,
                       tolerance=RFID_DEVICE_RTOL, feature_max_rel_err=feature_err,
                       cli_rfid=scores["fid"],
                       features_images_per_sec_card=2 * EVAL_SAMPLES / card["seconds"],
                       features_images_per_sec_cpu=2 * EVAL_SAMPLES / cpu["seconds"]),
        compare_same_folder={k: same[k] for k in ("fid", "kid", "swd_avg")},
        inception=dict(images_per_sec_batch_64=inception_rate, max_abs_err_vs_cpu=inception_err,
                       feature_scale=float(np.abs(on_cpu).max()), is_mean=is_mean,
                       is_std=is_std, weights="random, default_rng(5)"))
    return launches


# ---------------------------------------------------------------------------
# Data parallelism: a group of one NCCL rank, and two gloo ranks on one card
# ---------------------------------------------------------------------------

DP_STEPS = 8  # one call of 8 steps, R1 (every 16) at its first
DP_KERNELS = LOOP_KERNELS
# lsun_bedroom_128 as shipped at full width, batch 64, bf16, as 29's loop
DP_ARGS = ["lsun_bedroom_128", "use_pallas=true", "data.dataset=synthetic",
           f"train.global_batch={BATCH}", "train.compute_dtype=bfloat16",
           f"train.steps_per_call={DP_STEPS}", f"train.total_steps={DP_STEPS}",
           f"train.log_every={DP_STEPS}", f"train.checkpoint_every={DP_STEPS}",
           "train.sample_every=0", "train.eval_every=0", "train.async_checkpoint=false"]
# two eager steps (R1 at the first) of two gloo ranks, 32 images each, and
# of one process on the same global batch: the reals' order differs, so the
# data path's flips are off
DP2_STEPS = 2
DP2_ARGS = ["lsun_bedroom_128", "use_pallas=true", "data.dataset=synthetic",
            "data.random_flip=false", f"train.global_batch={BATCH}",
            "train.compute_dtype=bfloat16", "train.steps_per_call=1",
            f"train.total_steps={DP2_STEPS}", "train.log_every=1", "train.checkpoint_every=0",
            "train.sample_every=0", "train.eval_every=0"]
DP2_RTOL = 1e-2
SAMPLER_COUNT = BATCH + 3


def dp_config(args, workdir, **parallel):
    from locate_tpu_torch.config import get_config, parse_cli_overrides

    cfg = get_config(args[0], parse_cli_overrides(args[1:]))
    return dataclasses.replace(cfg, workdir=workdir,
                               parallel=dataclasses.replace(cfg.parallel, **parallel))


def dp_child(kind, *args):
    """A child process running `dp_nccl_child` or `dp_gloo_child` of this
    file (output to <out>.log); returns the process."""
    code = f"import sys, chip_smoke; chip_smoke.dp_{kind}_child(*sys.argv[1:])"
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    log = open(args[-1] + ".log", "w")
    proc = subprocess.Popen([sys.executable, "-c", code, *map(str, args)], cwd=REPO, env=env,
                            stdout=log, stderr=subprocess.STDOUT)
    log.close()
    return proc


def wait_children(procs, outs, timeout=900):
    """Wait for the children; raise with a log's tail if one failed."""
    try:
        for proc, out in zip(procs, outs):
            rc = proc.wait(timeout=timeout)
            with open(out + ".log") as f:
                log = f.read()
            check(rc == 0, f"a data-parallel child exited {rc}: {log[-4000:]}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    results = []
    for out in outs:
        with open(out) as f:
            results.append(json.load(f))
    return results


def step_times(mesh, calls=2):
    """ms a step of lsun_bedroom_128's step at batch 64 on `mesh`, on
    bench's config (no R1, no guards: one graph variant): eager steps
    (after two warm ones) and a DP_STEPS-step graph call (after the call
    that captures it), on one fixed batch."""
    from locate_tpu_torch import cli
    from locate_tpu_torch.models.gan import build_gan
    from locate_tpu_torch.parallel.sharding import make_step_for
    from locate_tpu_torch.train.state import create_train_state
    from locate_tpu_torch.train.step import make_multi_step

    cfg = cli.bench_config(BATCH, [f"spc={DP_STEPS}"])
    gan = build_gan(cfg, "cuda", seed=0)
    state = create_train_state(cfg, gan, mesh=mesh if mesh.group is not None else None)
    step = make_step_for(cfg, gan, mesh)
    batch = fixed_batch(BATCH)
    for _ in range(2):
        state, _ = step(state, batch)
    out = {}
    for name, fn, n, reps in (("eager", lambda: step(state, batch), 1, calls),
                              ("graph", None, DP_STEPS, 1)):
        if fn is None:
            multi = make_multi_step(step, DP_STEPS)
            batches = stacked_batch(DP_STEPS, BATCH)
            multi(state, batches)  # captures

            def fn():
                return multi(state, batches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        out[f"{name}_ms_per_step"] = (time.perf_counter() - t0) * 1e3 / (reps * n)
    del gan, state, step
    release_memory()
    return out


def dp_nccl_child(out):
    """The NCCL phase's child: `train()` of DP_ARGS without a group, then
    in a world-size-1 NCCL group at zero_stage 0, 1 and 3 (each run's
    launches counted), `ShardedSampler` against `generate_samples`, the
    step's times on both meshes. Writes its readings to `out`."""
    from locate_tpu_torch.io.sampling import ShardedSampler, generate_samples
    from locate_tpu_torch.models.gan import build_gan
    from locate_tpu_torch.parallel.distributed import initialize_from_env
    from locate_tpu_torch.parallel.dryrun import free_port
    from locate_tpu_torch.parallel.mesh import Mesh, make_mesh
    from locate_tpu_torch.train.loop import train

    torch.backends.cudnn.deterministic = True  # two runs of the loop, bit for bit
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    scratch = os.path.dirname(out)

    def run(name, **parallel):
        workdir = os.path.join(scratch, name)
        reset_counters()
        train(dp_config(DP_ARGS, workdir, **parallel), device="cuda")
        torch.cuda.synchronize()
        return (read_counters(), [{k: v for k, v in r.items() if k not in TIMING_KEYS}
                                  for r in loop_records(workdir)],
                checkpoint_payload(workdir, DP_STEPS))

    _, ref_records, ref = run("no_group")
    os.environ.update(COORDINATOR_ADDRESS=f"localhost:{free_port()}", NUM_PROCESSES="1",
                      PROCESS_ID="0", LOCAL_RANK="0")
    grouped = initialize_from_env()
    mesh = make_mesh(dp_config(DP_ARGS, scratch).parallel)
    result = dict(group=grouped, backend=torch.distributed.get_backend(), world=mesh.world,
                  runs={})
    for zero in (0, 1, 3):
        launches, records, payload = run(f"nccl_zero{zero}", zero_stage=zero)
        diff = {k: float((t.double() - ref["tensors"][k].double()).abs().max())
                for k, t in payload["tensors"].items() if not torch.equal(t, ref["tensors"][k])}
        if not torch.equal(payload["rng"], ref["rng"]):
            diff["rng"] = "differs"
        if records != ref_records:
            diff["metrics"] = [records, ref_records]
        result["runs"][f"zero{zero}"] = dict(launches=launches, differences=diff)
    cfg = dp_config(DP_ARGS, scratch)
    gan = build_gan(cfg, "cuda", seed=3)
    model = gan.generator.eval()
    sampled = ShardedSampler(model, None, mesh)(torch.Generator("cuda").manual_seed(5),
                                                SAMPLER_COUNT)
    want = generate_samples(model, torch.Generator("cuda").manual_seed(5), SAMPLER_COUNT)
    result["sampler_equal"] = bool(sampled.shape == want.shape and (sampled == want).all())
    del gan, model
    release_memory()
    result["times"] = {"no_group": step_times(Mesh()), "nccl_group": step_times(mesh)}
    torch.distributed.destroy_process_group()
    with open(out, "w") as f:
        json.dump(result, f)


def phase_dp_nccl():
    """Phase 37, "dp-one-rank-nccl": in one child, `initialize_from_env()`
    makes a world-size-1 NCCL group on the card; `train()` of
    lsun_bedroom_128 as shipped (DP_ARGS: 8 steps in one call of a CUDA
    graph, R1 at step 0) in the group, whose collectives the graph
    captures, at zero_stage 0, 1 and 3, each equal bit for bit (final
    checkpoint, generator, every logged metric) to the same run without a
    group, each launching the step's six kernels; `ShardedSampler` equal
    to `generate_samples` at a count of 67; the step's ms eager and as a
    graph, with and without the group."""
    import tempfile

    scratch = tempfile.mkdtemp(prefix="smoke_dp1_")
    out = os.path.join(scratch, "result.json")
    t0 = time.perf_counter()
    (res,) = wait_children([dp_child("nccl", out)], [out])
    check(res["group"] and res["backend"] == "nccl" and res["world"] == 1,
          f"the child's group: {res}")
    for name, run in res["runs"].items():
        check(not run["differences"], f"the NCCL run at {name} differs from the run without a "
                                      f"group: {run['differences']}")
        for kernel in DP_KERNELS:
            check(run["launches"][kernel] > 0, f"the NCCL run at {name} never launched {kernel}")
    check(res["sampler_equal"], "ShardedSampler differs from generate_samples")
    shutil.rmtree(scratch)
    say("dp-one-rank-nccl", config=" ".join(DP_ARGS), runs=res["runs"],
        sampler_count=SAMPLER_COUNT, sampler_equal=True, step_ms=res["times"],
        child_seconds=time.perf_counter() - t0)
    return res


def dp_gloo_child(rank, port, workdir, out):
    """One rank of the gloo phase: `train()` of DP2_ARGS on the card in a
    gloo group of two; writes its launches and each logged metric (the
    hook "on_metrics") to `out`."""
    from locate_tpu_torch.parallel.distributed import initialize_from_env
    from locate_tpu_torch.train.loop import train

    os.environ.update(COORDINATOR_ADDRESS=f"localhost:{port}", NUM_PROCESSES="2",
                      PROCESS_ID=str(rank), LOCAL_RANK="0")
    check(initialize_from_env(backend="gloo"), "no group")
    logged, clock = [], []
    reset_counters()
    t0 = time.perf_counter()
    train(dp_config(DP2_ARGS, workdir), device="cuda", hooks={"on_metrics": logger(logged, clock)})
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    torch.distributed.destroy_process_group()
    with open(out, "w") as f:
        json.dump(dict(rank=int(rank), launches=read_counters(), logged=logged,
                       train_seconds=seconds, step2_seconds=clock[1] - clock[0]), f)


def logger(logged, clock):
    """A hook "on_metrics" that keeps each step's metrics and the time it
    was called (every step logs: the metrics' copy to the host has waited
    for the step, so the difference of two readings is a step's time)."""
    def hook(step, metrics):
        clock.append(time.perf_counter())
        logged.append(dict(metrics, step=step))
    return hook


def phase_dp_gloo():
    """Phase 38, "dp-two-ranks-gloo" (returns its line and rank 0's
    launches): two children on the one card, a gloo
    group ("gspmd", zero_stage 0, the preset's options: all_reduce and
    broadcast only), `train()` of DP2_ARGS (global batch 64, 32 a rank, 2
    eager steps, R1 at the first); in this process the same run without a
    group. Every metric bitwise equal on both ranks, each within 1e-2
    relative of the one-process run's (bf16, half the batch a launch; the
    worst ratio printed), metrics.jsonl written by rank 0 alone (each step
    once), the six kernels launched on both ranks."""
    import tempfile

    from locate_tpu_torch.parallel.dryrun import free_port
    from locate_tpu_torch.train.loop import train

    scratch = tempfile.mkdtemp(prefix="smoke_dp2_")
    workdir = os.path.join(scratch, "run")
    outs = [os.path.join(scratch, f"rank{r}.json") for r in range(2)]
    port = free_port()
    t0 = time.perf_counter()
    ranks = wait_children([dp_child("gloo", r, port, workdir, o) for r, o in enumerate(outs)],
                          outs)
    child_seconds = time.perf_counter() - t0
    one = dp_config(DP2_ARGS, os.path.join(scratch, "one"))
    one_clock = []
    train(one, device="cuda", hooks={"on_metrics": logger([], one_clock)})
    release_memory()
    strip = [{k: v for k, v in r.items() if k not in TIMING_KEYS} for r in ranks[0]["logged"]]
    check(strip == [{k: v for k, v in r.items() if k not in TIMING_KEYS}
                    for r in ranks[1]["logged"]], "the two ranks logged different metrics")
    written = loop_records(workdir)
    check([r["step"] for r in written] == list(range(1, DP2_STEPS + 1)),
          f"metrics.jsonl holds steps {[r['step'] for r in written]}")
    want = loop_records(one.workdir)
    worst, where = 0.0, None
    for got, ref in zip(written, want):
        for k, v in ref.items():
            if k in TIMING_KEYS or k == "step":
                continue
            ratio = abs(got[k] - v) / max(abs(got[k]), abs(v), 1e-30)
            if ratio > worst:
                worst, where = ratio, f"step {ref['step']} {k}"
    check(worst <= DP2_RTOL, f"two gloo ranks against one process: {where} off by {worst}")
    for r in ranks:
        for kernel in DP_KERNELS:
            check(r["launches"][kernel] > 0, f"rank {r['rank']} never launched {kernel}")
    shutil.rmtree(scratch)
    out = dict(config=" ".join(DP2_ARGS), worst_relative_difference=worst, worst_at=where,
               rtol=DP2_RTOL, metrics_rank0=written,
               step2_seconds={**{r["rank"]: r["step2_seconds"] for r in ranks},
                              "one_process": one_clock[1] - one_clock[0]},
               launches={r["rank"]: {k: r["launches"][k] for k in DP_KERNELS} for r in ranks},
               train_seconds={r["rank"]: r["train_seconds"] for r in ranks},
               child_seconds=child_seconds)
    say("dp-two-ranks-gloo", **out)
    return out, ranks[0]["launches"]


def cuobjdump_path() -> str:
    """The toolkit's cuobjdump (CUDA_HOME, /usr/local/cuda, PATH), else the
    copy Triton's package carries; None where there is none."""
    import shutil

    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "cuobjdump")):
            return os.path.join(root, "bin", "cuobjdump")
    found = shutil.which("cuobjdump")
    if found:
        return found
    try:
        import triton
    except ImportError:
        return None
    path = os.path.join(os.path.dirname(triton.__file__), "backends", "nvidia", "bin",
                        "cuobjdump")
    return path if os.path.isfile(path) else None


def sass_tensor_ops(library) -> dict:
    """{kernel: tensor-core instructions (HMMA or HGMMA) in its SASS} of a
    built library, read with `cuobjdump -sass`."""
    tool = cuobjdump_path()
    check(tool is not None, "no cuobjdump: the SASS of the mma kernels cannot be read")
    out = subprocess.run([tool, "-sass", str(library)], capture_output=True, text=True,
                         timeout=300, check=True).stdout
    counts, current = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = kernel_name(m.group(1))
            counts[current] = 0
        elif current and re.search(r"\bHG?MMA\b", line):
            counts[current] += 1
    return counts


def gate_mma_instances(fa) -> dict:
    """{GATE_MMA_KERNELS' instances, as ptxas and the SASS name them: (kind
    of the blocks-per-SM query, (C, Hd, Cout))}; the wide template's kernels
    carry their widths, and its location pass's shared memory is the
    softmax's (kinds 0 and 1), the weight-gradient pass's (2) static."""
    wide = ",".join(map(str, fa.GATE_WIDE))
    narrow = (64, 16, 64)
    return {"softmax_bwd_mma": (0, narrow), "sigmoid_bwd_mma": (1, narrow),
            f"softmax_bwd_wide_mma<{wide}>": (0, fa.GATE_WIDE),
            f"sigmoid_bwd_wide_mma<{wide}>": (1, fa.GATE_WIDE),
            f"gate_wgrad_wide_mma<{wide}>": (2, fa.GATE_WIDE)}


def phase_build(fa, fs, fl, build):
    """Phase 2: the three libraries, one nvcc each, started together; the
    flash library's mma kernels hold tensor-core instructions and spill
    at most FLASH_MMA_SPILL_LIMIT bytes; shared memory and blocks per SM
    of the flash kernels at each (T, dh, dv), both routes."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    names = ("fused_attention", "fused_stage", "flash_attention")
    with ThreadPoolExecutor(len(names)) as pool:
        libs = dict(zip(names, pool.map(build.build, names)))
    reports = {name: parse_ptxas(build.ptxas_report(name)) for name in names}
    for name, wanted in (("fused_attention", CUDA_KERNELS + GATE_MMA_KERNELS
                          + GATE_FWD_MMA_KERNELS + SIGMOID_MMA_KERNELS),
                         ("fused_stage", STAGE_CUDA_KERNELS + STAGE_MMA_KERNELS),
                         ("flash_attention", FLASH_KERNELS + FLASH_MMA_KERNELS)):
        for k in wanted:
            check(any(n.startswith(k) for n in reports[name]), f"ptxas reported no {k}")
    sass = sass_tensor_ops(libs["flash_attention"])
    mma = {}
    for k in FLASH_MMA_KERNELS:
        want = {f"{k}<{a},{b}>" for a, b in fl.MMA_WIDTHS}
        check(want <= set(sass), f"the SASS lists {sorted(n for n in sass if n.startswith(k))}, "
                                 f"want {sorted(want)}")
        for n in sorted(want):
            ptx = reports["flash_attention"].get(n, {})
            mma[n] = dict(ptx, tensor_core_instructions=sass[n])
            check(sass[n] > 0, f"{n}: no HMMA or HGMMA instruction in its SASS")
            check(max(ptx.get("spill_stores", 0), ptx.get("spill_loads", 0))
                  <= FLASH_MMA_SPILL_LIMIT, f"{n} spills: {ptx}")
    simt_names = tuple(f"{k}<bf16" for k in FLASH_KERNELS)
    simt_bf16 = {n: c for n, c in sass.items() if n.startswith(simt_names)}
    smem = {f"C={c},Hd={hd}": dict(
        forward=int(fa._library().locate_softmax_smem_bytes(c, hd, c, fa.tile_rows(c))),
        backward=int(fa._library().locate_softmax_bwd_smem_bytes(
            c, hd, c, fa.bwd_grid(BATCH, hw, c)[0])))
        for hw, c, hd in SHAPES}
    stage_lib = fs._library()
    stage_smem = {}
    for kind, k in (("conv", fs._CONV), ("stats", fs._STATS), ("apply_pool", fs._APPLY_POOL),
                    ("bwd", fs._BWD), ("sigmoid", fs._SIGMOID)):
        th, tw = fs.pick_tile(k, 512, 512, 64, 64, 16, 64, lib=stage_lib)
        stage_smem[kind] = dict(route="simt", tile=f"{th}x{tw}", bytes=int(
            stage_lib.locate_stage_smem_bytes(0, k, 64, 64, 16, 64, th, tw)), blocks_per_sm=int(
            stage_lib.locate_stage_blocks_per_sm(0, k, 64, 64, 16, 64, th, tw)))
    # the mma kernels of the routed wrappers: HMMA in the SASS, no spill,
    # their shared memory and blocks an SM at each template (the apply-pool
    # pass's only at (64, 64), and not a template)
    stage_sass = sass_tensor_ops(libs["fused_stage"])
    stage_mma = {}
    kinds = (fs._STATS, fs._BWD, fs._CONV, fs._SIGMOID, fs._APPLY_POOL)
    for k, kind in zip(STAGE_MMA_KERNELS, kinds):
        pool = kind == fs._APPLY_POOL
        for c, co in ([(64, 64)] if pool else fs.STAGE_MMA_WIDTHS):
            n = k if pool else f"{k}<{c},{co}>"
            ptx = reports["fused_stage"].get(n, {})
            check(stage_sass.get(n, 0) > 0, f"{n}: no HMMA or HGMMA instruction in its SASS")
            check(bool(ptx) and ptx.get("spill_stores", 0) == 0 and ptx.get("spill_loads", 0) == 0,
                  f"{n} spills: {ptx}")
            gated = kind in (fs._STATS, fs._SIGMOID, fs._APPLY_POOL)
            hd, cout = (fs.MMA_HD, co) if gated else (0, 0)
            stage_mma[n] = dict(ptx, tensor_core_instructions=stage_sass[n], bytes=int(
                stage_lib.locate_stage_smem_bytes(1, kind, c, co, hd, cout, *fs._MMA_TILE)),
                blocks_per_sm=int(stage_lib.locate_stage_blocks_per_sm(
                    1, kind, c, co, hd, cout, *fs._MMA_TILE)))
            check(stage_mma[n]["blocks_per_sm"] >= 1, f"{n}: no block fits on an SM")
    # the gate backward's mma kernels alike, each at its own occupancy,
    # with the simt kernels' shared memory at the same widths (their tile at
    # lsun's 16384 locations)
    gate_sass = sass_tensor_ops(libs["fused_attention"])
    gate_lib = fa._library()
    gate_bwd = {}
    for k, (kind, widths) in gate_mma_instances(fa).items():
        ptx = reports["fused_attention"].get(k, {})
        check(gate_sass.get(k, 0) > 0, f"{k}: no HMMA or HGMMA instruction in its SASS")
        check(bool(ptx) and ptx.get("spill_stores", 0) == 0 and ptx.get("spill_loads", 0) == 0,
              f"{k} spills: {ptx}")
        gate_bwd[k] = dict(ptx, tensor_core_instructions=gate_sass[k], widths=widths,
                           bytes=int(gate_lib.locate_softmax_bwd_mma_smem_bytes(*widths)
                                     if kind < 2 else 0),
                           blocks_per_sm=int(gate_lib.locate_softmax_bwd_mma_blocks_per_sm(
                               kind, *widths)))
        check(gate_bwd[k]["blocks_per_sm"] >= 1, f"{k}: no block fits on an SM")
    # the forward body's mma kernels alike, beside the simt kernels'
    # registers: the stats and apply passes at FWD_MMA_BLOCKS blocks an SM
    # (the csum pass's stages hold dy too); the sigmoid gate's wide forward
    gate_fwd = {}
    for k in GATE_FWD_MMA_KERNELS + SIGMOID_MMA_KERNELS:
        wide = k in SIGMOID_MMA_KERNELS
        name = f"{k}<{','.join(map(str, fa.GATE_WIDE))}>" if wide else k
        widths = fa.GATE_WIDE if wide else fa.GATE_FWD_MMA_WIDTHS
        ptx = reports["fused_attention"].get(name, {})
        check(gate_sass.get(name, 0) > 0, f"{name}: no HMMA or HGMMA instruction in its SASS")
        check(bool(ptx) and ptx.get("spill_stores", 0) == 0 and ptx.get("spill_loads", 0) == 0,
              f"{name} spills: {ptx}")
        if wide:
            smem_bytes = gate_lib.locate_sigmoid_gate_mma_smem_bytes(*widths)
            per_sm = gate_lib.locate_sigmoid_gate_mma_blocks_per_sm(*widths)
        else:
            smem_bytes = gate_lib.locate_softmax_fwd_mma_smem_bytes(FWD_MMA_PASS[k], *widths)
            per_sm = gate_lib.locate_softmax_fwd_mma_blocks_per_sm(FWD_MMA_PASS[k], *widths)
        gate_fwd[name] = dict(ptx, tensor_core_instructions=gate_sass[name], widths=widths,
                              bytes=int(smem_bytes), blocks_per_sm=int(per_sm))
        check(per_sm >= 1, f"{name}: no block fits on an SM")
        if k in ("softmax_stats_mma", "softmax_apply_mma"):
            check(per_sm == FWD_MMA_BLOCKS, f"{name}: {per_sm} blocks an SM, want {FWD_MMA_BLOCKS}")
    for k in ("softmax_stats_partial<bf16>", "softmax_apply<bf16>", "softmax_csum_partial<bf16>",
              "sigmoid_gate<bf16>"):
        gate_fwd[k] = dict(reports["fused_attention"].get(k, {}),
                           tensor_core_instructions=gate_sass.get(k, 0))
    simt_tile = fa.bwd_grid(BATCH, 16384, 64)[0]
    for k in ("softmax_bwd<bf16>", "sigmoid_bwd<bf16>"):
        gate_bwd[k] = dict(reports["fused_attention"].get(k, {}),
                           tensor_core_instructions=gate_sass.get(k, 0),
                           bytes=int(gate_lib.locate_softmax_bwd_smem_bytes(64, 16, 64, simt_tile)))
    flash_lib = fl._library()
    flash_smem = {}
    for t, dh, dv in FLASH_SHAPES + [(1024, 8, 16)]:
        row = {}
        for k, kind in zip(FLASH_KERNELS, (fl._FWD, fl._DQ, fl._DKV)):
            bq = fl.pick_tile(kind, FLASH_BATCH, t, dh, dv, flash_lib)
            row[k] = dict(route="simt", q_tile=bq,
                          bytes=int(flash_lib.locate_flash_smem_bytes(kind, dh, dv, bq)),
                          blocks_per_sm=int(flash_lib.locate_flash_blocks_per_sm(
                              0, kind, 1, dh, dv, bq)))
        for k, kind in zip(FLASH_MMA_KERNELS, (fl._FWD, fl._DQ, fl._DKV)):
            wide = fl.mma_widths(dh, dv)
            row[k] = dict(route="mma", widths=wide,
                          bytes=int(flash_lib.locate_flash_mma_smem_bytes(kind, *wide)),
                          blocks_per_sm=int(flash_lib.locate_flash_blocks_per_sm(
                              1, kind, 1, *wide, 0)))
            check(row[k]["blocks_per_sm"] >= 1, f"{k} at dh={dh}, dv={dv}: {row[k]}")
        flash_smem[f"T={t},dh={dh},dv={dv}"] = row
    d32 = flash_smem["T=1024,dh=16,dv=64"]["flash_dkv_mma"]["blocks_per_sm"]
    check(d32 >= 2, f"flash_dkv_mma at dh 16, dv 64: {d32} block(s) an SM, want at least 2")
    say("build", libraries={n: os.path.relpath(str(p), REPO) for n, p in libs.items()},
        seconds=time.perf_counter() - t0, kernels=reports, dynamic_smem_bytes=smem,
        flash_mma_kernels=mma, flash_simt_bf16_tensor_core_instructions=simt_bf16,
        flash_dynamic_smem_at_batch_16=flash_smem,
        stage_dynamic_smem_at_512x512x64=stage_smem, stage_mma_kernels=stage_mma,
        gate_bwd_kernels=gate_bwd, gate_fwd_kernels=gate_fwd,
        stage_conv_bwd_blocks=fs.bwd_blocks(FFHQ_BATCH, 512, 512, *fs.pick_tile(
            fs._BWD, 512, 512, 64, 64, lib=stage_lib)))


def gate_entry(kernel, fwd_rows, bwd_rows, train_launches, serve_launches, ffhq_launches,
               gate_routes=None):
    rows = fwd_rows if kernel in ("softmax_stats", "softmax_apply") else bwd_rows
    mult = FWD_PER_STEP if rows is fwd_rows else BWD_PER_STEP
    names = {"softmax_stats": ("m", "se"), "softmax_apply": ("y",),
             "softmax_csum": ("c",)}.get(kernel, GRAD_NAMES[1:])
    lsun = [r for r in rows if r["shape"]["N"] == BATCH]
    entry = {
        "name": kernel,
        "route": "cuda",
        "source": SOURCE,
        "replaces": REPLACES[kernel],
        # launches of the main path's run (3 lsun_bedroom_128 train steps)
        "launches": train_launches[kernel],
        "max_abs_err": max(r[f"{n}_max_abs_err"] for r in rows for n in names),
        # per lsun_bedroom_128 train step at batch 64: each shape's time
        # times its launches
        "ms": per_step(lsun, kernel, mult, "ms"),
        "plain_ms": per_step(lsun, kernel, mult, "plain_ms"),
        "bound_ms": per_step(lsun, kernel, mult, "bound_ms"),
        "bound_by": ("bytes" if all(r[kernel]["bound_by"] == "bytes" for r in lsun)
                     else "operations"),
        "library_ms": None,
        "launches_ffhq_512_train": ffhq_launches[kernel],
        "shapes": [dict(N=r["shape"]["N"], HW=r["shape"]["HW"], C=r["shape"]["C"],
                        dtype=r["dtype"],
                        **{k: r[kernel][k] for k in ("ms", "plain_ms", "bound_ms")})
                   for r in rows],
    }
    if rows is fwd_rows:
        entry["launches_serving"] = serve_launches[kernel]
        entry["ms_per_served_forward"] = per_step(lsun, kernel, SERVE, "ms")
    if gate_routes is not None:  # two routes: the mma shapes beside their simt time
        entry["routes"] = sorted({r[kernel]["route"] for r in lsun})
        entry["launches_mma"] = gate_routes["mma"]
        entry["ms_simt"] = sum(mult.get((r["shape"]["HW"], r["shape"]["C"], r["shape"]["Hd"]), 0)
                               * r[kernel].get("ms_simt", r[kernel]["ms"])
                               for r in lsun if r["dtype"] == "bfloat16")
        for shape, r in zip(entry["shapes"], rows):
            shape.update({k: r[kernel][k] for k in ("route", "ms_simt") if k in r[kernel]})
    return entry


# ---------------------------------------------------------------------------
# Every option of the train step: three presets at full width, and six
# recipes at lsun_bedroom_128's
# ---------------------------------------------------------------------------

PRESETS = ("cifar10_32", "celeba_64", "ffhq_256")
PRESET_STEPS = 4
# the batch of the kernel-path steps held call by call and of the f32
# comparison; each preset's own batch runs the graph call (ffhq_256's
# halved while the allocator refuses it with R1). ffhq_256's checked
# calls at batch 128 would take tens of seconds (f32 references of every
# call at 256^2): the comparison runs at 16 there (printed as a cut)
PRESET_COMPARE_BATCH = {"cifar10_32": 64, "celeba_64": 64, "ffhq_256": 16}
RECIPES = {
    "limited_data": {"train.ada_target": "0.6", "train.bcr_gamma": "10",
                     "train.lecam_gamma": "0.3"},
    "r3gan": {"train.loss": "rpgan", "train.r1_gamma": "0.1", "train.r2_gamma": "0.1"},
    "wgan_gp": {"train.loss": "wgan", "train.gp_gamma": "10", "train.d_steps": "5"},
    "fused": {"train.fused_step": "true"},
    "pl_ortho": {"train.pl_gamma": "2", "train.ortho_gamma": "1e-4"},
    "accum_bf16_ema_schedule": {"train.grad_accum": "2", "train.ema_dtype": "bfloat16",
                                "train.lr_schedule": "linear_warmup_cosine",
                                "train.ema_rampup": "0.05"},
}
RECIPE_STEPS = 2
RECIPE_GRAPH_STEPS = 2
LOSS_KEYS = ("d_loss", "g_loss", "real_logits", "fake_logits")
SOFTMAX_GATE = ("softmax_stats", "softmax_apply", "softmax_csum", "softmax_bwd")


def path_config(cfg, use_pallas, dtype=None):
    """`cfg` on the kernel path or the plain path, in `dtype` compute, with
    both optimizers' learning rate at 0."""
    t = cfg.train if dtype is None else dataclasses.replace(cfg.train, compute_dtype=dtype)
    t = dataclasses.replace(t, g_opt=dataclasses.replace(t.g_opt, lr=0.0),
                            d_opt=dataclasses.replace(t.d_opt, lr=0.0))
    return dataclasses.replace(cfg, use_pallas=use_pallas, train=t,
                               model=dataclasses.replace(cfg.model, use_pallas=use_pallas))


def recorded_gradients(step):
    """Record every flat gradient `step` hands its two optimizers, in
    order: {"d": [...], "g": [...]}."""
    rec = {"d": [], "g": []}
    for name, opt in (("d", step.d_opt), ("g", step.g_opt)):
        def update(grads, state, _orig=opt.update, _name=name):
            rec[_name].append(grads.detach().clone())
            return _orig(grads, state)
        opt.update = update
    return rec


GRAD_NOISE = 1e-7


def worst_call(rows):
    """The worst of held gate backward calls: the largest kernel / plain
    error ratio (bf16) or kernel-vs-plain error (f32), with its call."""
    worst = None
    for row in rows:
        for key, v in row.items():
            if key.endswith("_rel_err_kernel_vs_f32"):
                ratio = v / max(row[key.replace("kernel", "plain")], 1e-30)
            elif key.endswith("_rel_err_kernel_vs_plain"):
                ratio = v
            else:
                continue
            if worst is None or ratio > worst["value"]:
                worst = dict(value=ratio, output=key.split("_rel_err")[0],
                             shape=(row["N"], row["HW"], row["C"]), dtype=row["dtype"])
    return worst


def perturbed(weights, scale, seed=9):
    """G's and D's state_dicts with every weight times 1 + scale N(0, 1)."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return tuple({k: v * (1.0 + scale * torch.randn(v.shape, device="cuda", generator=g))
                  for k, v in sd.items()} for sd in weights)


# the resolution of the whole-step f32 comparison: at 128^2 and up the
# random-weight model's f32 gradient moves by 10-70 % under 1e-7 weight
# noise (PERF.md §6), at 64^2 it is phase 6's check
F32_STEP_RES = 64


def at_resolution(cfg, res):
    """`cfg` with the model and the data at `res` (one stage fewer a
    halving, the same widths)."""
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, resolution=res),
                               data=dataclasses.replace(cfg.data, resolution=res))


def paths_from_one_state(cfg, n, steps, res, phase):
    """Steps from one seeded state with the same draws (the state's
    generator, seeded alike) on one fixed batch, with both learning rates
    at 0, so that every step reads the same weights and no Adam step turns
    rounding into diverging trajectories:
    - `steps` steps on the kernel path in the config's compute dtype,
      step 0 inside `checked_gate_backward`: each gate backward call of the
      step (under ADA's augmentation, the fused step's second pass, every
      critic, the regularizers' extra D forwards) held to the plain
      backward on its own saved tensors by the rule of 3 (bf16: error
      against f32 at most twice the plain bf16 version's; f32 within
      F32_TOL); its seconds a step and the device's idle share over one
      more step;
    - one whole step in f32 at F32_STEP_RES or below, on the
      kernel path, the plain path, and the plain path from weights moved
      by GRAD_NOISE: D's and G's gradients as handed to the optimizers
      (every critic's under d_steps) and the loss metrics of every step,
      norm-relative to the plain path; the kernel path within 1e-4 of it,
      or within ten times the plain path's own move under the noise
      (phase 6's rule). With these random weights a bf16 step's gradients
      are 100-800 % off the f32 step's on either path (PERF.md §6), so
      the bf16 rule is held call by call."""
    from locate_tpu_torch.ops import fused_attention as fa

    small = at_resolution(cfg, min(res, F32_STEP_RES))
    variants = {"kernel": (path_config(cfg, True), res, steps),
                "kernel_f32": (path_config(small, True, "float32"),
                               small.model.resolution, 1)}
    variants["plain_f32"] = (path_config(small, False, "float32"),
                             small.model.resolution, 1)
    variants["plain_f32_noise"] = variants["plain_f32"]
    lead = (cfg.train.d_steps,) if cfg.train.d_steps > 1 else ()
    runs, idle, weights, gate_calls = {}, None, None, []
    for name, (c, r, k) in variants.items():
        start = perturbed(weights, GRAD_NOISE) if name.endswith("noise") else weights
        gan, state, step = trainer(c, weights=start if name != "kernel" else None)
        if name == "kernel_f32":  # the f32 paths start from these weights
            weights = ({k_: v.clone() for k_, v in gan.generator.state_dict().items()},
                       {k_: v.clone() for k_, v in gan.discriminator.state_dict().items()})
        batch = {key: v[0] for key, v in stacked_batch(1, n, r, lead=lead,
                                                       classes=c.model.num_classes).items()}
        rec = recorded_gradients(step)
        if name == "kernel":
            with checked_gate_backward(fa, gate_calls):
                state, history, seconds = timed_steps(step, state, batch, 1)
            state, more, later = timed_steps(step, state, batch, k - 1)
            history, seconds = history + more, seconds + later
            idle, _ = profile_calls(lambda: step(state, batch), calls=1)
        else:
            state, history, seconds = timed_steps(step, state, batch, k)
        metrics = [{key: float(v) for key, v in m.items()} for m in history]
        for i, m in enumerate(metrics):
            check(all(math.isfinite(v) for v in m.values()), f"{phase} {name} step {i}: {m}")
        runs[name] = dict(d=torch.cat(rec["d"][:k * c.train.d_steps]),
                          g=torch.cat(rec["g"][:k]), metrics=metrics, seconds=seconds)
        del gan, state, step, rec, batch
        release_memory()
    check(gate_calls, f"{phase}: no gate backward call in the kernel path's step 0")
    ref = runs["plain_f32"]

    def vec(run):
        return torch.tensor([[m[key] for key in LOSS_KEYS] for m in run["metrics"]],
                            dtype=torch.float64)

    def err(a, b):
        return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30))

    out = {name: dict(d_grads=err(runs[name]["d"], ref["d"]),
                      g_grads=err(runs[name]["g"], ref["g"]),
                      losses=err(vec(runs[name]), vec(ref)))
           for name in ("kernel_f32", "plain_f32_noise")}
    for key, k in out["kernel_f32"].items():
        noise = out["plain_f32_noise"][key]
        check(k <= max(1e-4, 10 * noise),
              f"{phase}: the f32 kernel path's {key} error {k:.3e} against the plain path is "
              f"over 1e-4 and over ten times the plain path's own move {noise:.3e} under "
              f"{GRAD_NOISE:g} weight noise")
    return dict(batch=n, steps=steps, f32_steps=1, learning_rate=0.0,
                f32_resolution=small.model.resolution, errors_against_plain_f32=out,
                gate_backward_calls_held=len(gate_calls), worst_gate_call=worst_call(gate_calls),
                seconds_per_step_kernel=runs["kernel"]["seconds"],
                device_idle_share_kernel=("not measured" if idle is None else idle),
                loss_metrics_kernel=[{key: m[key] for key in LOSS_KEYS}
                                     for m in runs["kernel"]["metrics"]])


@contextlib.contextmanager
def deterministic_convs():
    """cuDNN's deterministic algorithms for a graph-vs-eager comparison:
    f32 convolutions' weight gradients otherwise sum with atomics, and two
    eager runs of a few steps already differ (cifar10_32, phase 30)."""
    before = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = before


def check_gate_launches(row, phase):
    per = row["launches_per_step"]
    check(all(per.get(k, 0) > 0 for k in SOFTMAX_GATE),
          f"{phase}: a softmax gate kernel never launched a step: {per}")


def preset_serving(cfg, n, phase):
    """A batch of `n` served through `generate_samples` on the kernel path:
    uint8 images of the preset's shape, the forward gate kernels launched."""
    from locate_tpu_torch.io.sampling import generate_samples
    from locate_tpu_torch.models.gan import model_config
    from locate_tpu_torch.models.generator import build_generator

    model = build_generator(model_config(cfg), cfg.train.compute_dtype, "cuda").eval()
    randomize_logit_convs(model, seed=1, scale=0.25)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    reset_counters()
    images = generate_samples(model, gen, n)
    launches = read_counters()
    res = cfg.model.resolution
    check(images.shape == (n, res, res, 3) and images.dtype.name == "uint8",
          f"{phase}: served {images.shape} {images.dtype}")
    check(launches["softmax_stats"] > 0 and launches["softmax_apply"] > 0,
          f"{phase}: serving launched {launches}")
    check(len({images[i].tobytes() for i in range(min(n, 4))}) == min(n, 4),
          f"{phase}: served images repeat")
    del model
    release_memory()
    return dict(batch=n, launches=launches)


def phase_presets():
    """Phase 30: cifar10_32 (f32 compute), celeba_64 (attention at every
    stage) and ffhq_256 (class-conditional, the projection D) as shipped,
    at full width: a served batch; 4 steps from one state on the kernel
    path against the plain path (`paths_from_one_state`); a graph call of
    4 steps at the preset's batch, bitwise equal to the same 4 eager steps
    (R1 fires at step 0); each gate kernel's launches a step."""
    from locate_tpu_torch.config import get_config

    rows = {}
    for name in PRESETS:
        t0 = time.perf_counter()
        cfg = get_config(name, {"use_pallas": "true"})
        n, res = cfg.train.global_batch, cfg.model.resolution
        row = dict(serving=preset_serving(cfg, min(n, 64), f"preset-{name}-serving"))
        row["kernel_vs_plain"] = paths_from_one_state(
            cfg, PRESET_COMPARE_BATCH[name], PRESET_STEPS, res, f"preset-{name}")
        t1 = time.perf_counter()
        with deterministic_convs():
            graph, fitted, refusals = halving(
                lambda b: graph_vs_eager(cfg, PRESET_STEPS, 1, b, res, f"preset-{name}-graph"),
                n)
        check(graph["bitwise_equal"] and "r1" in graph["graph_variants"],
              f"preset {name}: the graph call {graph['graph_variants']} is not bitwise its "
              "eager steps or crossed no R1 step")
        check_gate_launches(graph, f"preset-{name}")
        row.update(graph=graph, batch_cut=None if fitted == n else dict(
            preset_batch=n, batch=fitted, refusals=refusals),
                   seconds=dict(serving_and_paths=t1 - t0, graph=time.perf_counter() - t1))
        if PRESET_COMPARE_BATCH[name] != n:
            row["compare_batch_cut"] = dict(preset_batch=n, batch=PRESET_COMPARE_BATCH[name],
                                            why="the checked calls' f32 references at 256^2")
        rows[name] = row
        say(f"preset-{name}", **row)
    return rows


def phase_recipes(bench_kernel):
    """Phase 31: lsun_bedroom_128 as shipped at full width and batch 64
    under each of six recipes of docs/GUIDE.md (`RECIPES`): 2 steps from
    one state on the kernel path against the plain path
    (`paths_from_one_state`); a graph call of 2 steps bitwise equal to its
    eager steps (cuDNN deterministic for the comparison), crossing an R1
    step (and a PL step);
    the softmax gate kernels' launches a step (none 0); step times and the
    idle share. Then `bench 128 BENCH_CALLS fused` (16 steps a call) beside
    phase 7's bench."""
    from locate_tpu_torch.config import get_config

    rows = {}
    for name, overrides in RECIPES.items():
        t0 = time.perf_counter()
        cfg = get_config("lsun_bedroom_128", {"use_pallas": "true", **overrides})
        row = dict(overrides=overrides)
        row["kernel_vs_plain"] = paths_from_one_state(cfg, BATCH, RECIPE_STEPS, 128,
                                                      f"recipe-{name}")
        t1 = time.perf_counter()
        with deterministic_convs():
            graph = graph_vs_eager(cfg, RECIPE_GRAPH_STEPS, 1, BATCH, 128,
                                   f"recipe-{name}-graph")
        check(graph["bitwise_equal"] and any("r1" in v for v in graph["graph_variants"]),
              f"recipe {name}: the graph call {graph['graph_variants']} is not bitwise its "
              "eager steps or crossed no R1 step")
        if cfg.train.pl_gamma > 0:
            check("r1+pl" in graph["graph_variants"], f"recipe {name}: no PL step captured")
        check_gate_launches(graph, f"recipe-{name}")
        row.update(graph=graph, seconds=dict(paths=t1 - t0, graph=time.perf_counter() - t1))
        rows[name] = row
        say(f"recipe-{name}", **row)
    t0 = time.perf_counter()
    fused = run_cli(["bench", "128", BENCH_CALLS, "fused"])
    check(fused["steps_per_call"] == 16 and fused["value"] > 0, f"bench fused: {fused}")
    say("bench-fused", fused=fused, alternating=bench_kernel,
        fused_over_alternating=fused["value"] / bench_kernel["value"],
        seconds=time.perf_counter() - t0)
    return rows, fused


# ---------------------------------------------------------------------------
# The style generator family, spectral norm, the skip head and projection
# ---------------------------------------------------------------------------

# docs/GUIDE.md:30-34's style recipe on celeba_64 (its R1 gamma, 0.1, is
# the preset's), and a StyleGAN2 variant with every style option on
STYLE_RECIPE = {"model.arch": "style", "model.style.mapping_layers": "8"}
STYLE_TRAIN = {**STYLE_RECIPE, "train.pl_gamma": "2.0", "train.r1_gamma": "0.1"}
STYLEGAN2 = {**STYLE_TRAIN, "model.g_rgb": "skip", "model.style.mixing_prob": "0.9",
             "model.style.noise": "random"}
STYLE_PSI = 0.7
STYLE_STEPS = 2
STYLE_GRAPH_STEPS = 2
SERVE_REPLAYS = 10
# lsun_bedroom_128 with spectral norm (docs/GUIDE.md:251-255) and with the
# skip head (:43-50)
SN_SKIP = {"spectral_norm": {"model.spectral_norm": "true"},
           "skip_rgb": {"model.g_rgb": "skip"}}
SN_SKIP_STEPS = 2
PROJECT_IMAGES = 16
PROJECT_STEPS = 32
PROJECT_BITWISE_STEPS = 4
PROJECTIONS = (("lsun_bedroom_128_z", "lsun_bedroom_128", {}, "z"),
               ("style_w+", "celeba_64", STYLE_RECIPE, "w+"))


def style_config(**overrides):
    """celeba_64 on the kernel path with the style recipe and `overrides`."""
    from locate_tpu_torch.config import get_config

    return get_config("celeba_64", {"use_pallas": "true", **STYLE_RECIPE, **overrides})


def check_both_routes(routes, phase):
    """A path whose softmax gates run on both routes: the C = 64 gates on the
    tensor cores, the wider ones on the simt kernels."""
    for kernel, by_route in routes.items():
        check(by_route.get("mma", 0) > 0 and by_route.get("simt", 0) > 0,
              f"{phase}: {kernel} took the routes {by_route}, want both")


def phase_style_serving():
    """Phase 32: celeba_64 with the style recipe, bf16, batch 64, w-space
    truncation at psi 0.7 around the mean w of 4096 draws, on the kernel
    path and on the plain path: `generate_samples` from a seed equals the
    first replay of `SampleGraph` from that seed, bitwise; three replays
    equal three eager batches around the graph's kept centre, bitwise;
    the served forward's gate launches (both routes on the kernel path,
    none on the plain one); img/s over SERVE_REPLAYS replays of each and
    the idle share of three replays."""
    from locate_tpu_torch.io.sampling import (generate_samples, sample_latents,
                                              to_uint8_tensor, truncation_centre)
    from locate_tpu_torch.models.gan import model_config
    from locate_tpu_torch.models.generator import build_generator
    from locate_tpu_torch.models.style_generator import apply_truncated
    from locate_tpu_torch.train.graph import SampleGraph

    def kept_centre_batch(model, gen, w_avg):
        """What a replay after the first computes: z alone, around w_avg."""
        with torch.inference_mode():
            z = sample_latents(gen, n, model.config.latent_dim)
            imgs = apply_truncated(model, z, psi=STYLE_PSI, w_avg=w_avg)
            return to_uint8_tensor(imgs).cpu().numpy()

    cfg = style_config()
    n = BATCH
    rows, per_forward = {}, None
    for name, use_pallas in (("kernel_path", True), ("plain_path", False)):
        model = build_generator(dataclasses.replace(model_config(cfg), use_pallas=use_pallas),
                                cfg.train.compute_dtype, "cuda").eval()
        randomize_logit_convs(model, seed=1, scale=0.25)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(5)
        reset_counters()
        first = generate_samples(model, gen, n, truncation_psi=STYLE_PSI)
        forward, routes = read_counters(), read_fwd_routes()
        gen.manual_seed(5)
        w_avg = truncation_centre(model, gen)
        eager = [kept_centre_batch(model, gen, w_avg) for _ in range(3)]
        gen.manual_seed(5)
        sample = SampleGraph(model, gen, n, truncation_psi=STYLE_PSI)
        check(torch.equal(sample.w_avg, w_avg), f"style-serving {name}: another w_avg")
        graph = [sample() for _ in range(3)]
        check((first == graph[0]).all(),
              f"style-serving {name}: SampleGraph's first batch differs from generate_samples'")
        same = all((a == b).all() for a, b in zip(eager, graph))
        check(same, f"style-serving {name}: graph sampling differs from eager sampling")
        check(len({a.tobytes() for a in graph}) == 3, f"style-serving {name}: replays repeat")
        check(graph[0].shape == (n, 64, 64, 3), f"style-serving {name}: {graph[0].shape}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SERVE_REPLAYS):
            sample()
        rate = SERVE_REPLAYS * n / (time.perf_counter() - t0)
        idle, _ = profile_calls(sample, calls=3)
        if use_pallas:
            check(forward["softmax_stats"] > 0 and forward["softmax_apply"] > 0,
                  f"style-serving: launched {forward}")
            check_both_routes(routes, "style-serving")
            per_forward = forward
        else:
            check(forward == expected({}), f"style-serving plain path launched {forward}")
        rows[name] = dict(images_per_sec=rate, bitwise_equal=same, launches_per_forward=forward,
                          gate_routes=routes,
                          device_idle_share_graph="not measured" if idle is None else idle)
        del model, sample, first, eager, graph
        release_memory()
    say("style-serving", config="celeba_64 " + " ".join(f"{k}={v}" for k, v in
                                                         STYLE_RECIPE.items()),
        batch=n, truncation_psi=STYLE_PSI,
        kernel_over_plain=rows["kernel_path"]["images_per_sec"]
        / rows["plain_path"]["images_per_sec"], **rows)
    return per_forward


def phase_style_train():
    """Phase 33: celeba_64 with the style recipe and PL, and the StyleGAN2
    variant (the skip head, mixing at 0.9, random noise), bf16 at batch 64:
    steps from one state on the kernel path against the plain path
    (`paths_from_one_state`: every gate backward of step 0 held to its
    plain version, one f32 step within max(1e-4, 10x the plain path's move
    under 1e-7 weight noise), seconds a step, the idle share); a graph call
    of 2 steps bitwise its eager steps, crossing R1's and PL's step; each
    gate kernel's launches a step, both routes. Returns the recipe's
    launches a step."""
    rows = {}
    for name, overrides in (("style_recipe", STYLE_TRAIN), ("stylegan2", STYLEGAN2)):
        t0 = time.perf_counter()
        cfg = style_config(**overrides)
        check(cfg.train.global_batch == BATCH and cfg.train.compute_dtype == "bfloat16",
              f"style-{name}: batch {cfg.train.global_batch} {cfg.train.compute_dtype}")
        row = dict(overrides=overrides)
        reset_counters()
        row["kernel_vs_plain"] = paths_from_one_state(cfg, BATCH, STYLE_STEPS, 64,
                                                      f"style-{name}")
        t1 = time.perf_counter()
        with deterministic_convs():
            graph = graph_vs_eager(cfg, STYLE_GRAPH_STEPS, 1, BATCH, 64, f"style-{name}-graph")
        check(graph["bitwise_equal"] and "r1+pl" in graph["graph_variants"],
              f"style {name}: the graph call {graph['graph_variants']} is not bitwise its "
              "eager steps or crossed no R1 + PL step")
        check_gate_launches(graph, f"style-{name}")
        row.update(graph=graph, seconds=dict(paths=t1 - t0, graph=time.perf_counter() - t1))
        rows[name] = row
        say(f"style-train-{name}", **row)
    return rows["style_recipe"]["graph"]["launches_per_step"]


def phase_sn_and_skip():
    """Phase 34: lsun_bedroom_128 as shipped with spectral norm, and with the
    skip head, bf16 at batch 64: steps from one state on the kernel path
    against the plain path (`paths_from_one_state`), a graph call of 2 steps
    bitwise its eager steps crossing R1's step, each gate kernel's launches
    a step."""
    from locate_tpu_torch.config import get_config

    rows = {}
    for name, overrides in SN_SKIP.items():
        t0 = time.perf_counter()
        cfg = get_config("lsun_bedroom_128", {"use_pallas": "true", **overrides})
        row = dict(overrides=overrides)
        row["kernel_vs_plain"] = paths_from_one_state(cfg, BATCH, SN_SKIP_STEPS, 128,
                                                      f"sn-and-skip-{name}")
        t1 = time.perf_counter()
        with deterministic_convs():
            graph = graph_vs_eager(cfg, SN_SKIP_STEPS, 1, BATCH, 128, f"sn-and-skip-{name}-graph")
        check(graph["bitwise_equal"] and "r1" in graph["graph_variants"],
              f"{name}: the graph call {graph['graph_variants']} is not bitwise its eager "
              "steps or crossed no R1 step")
        check_gate_launches(graph, f"sn-and-skip-{name}")
        row.update(graph=graph, seconds=dict(paths=t1 - t0, graph=time.perf_counter() - t1))
        rows[name] = row
        say(f"sn-and-skip-{name}", **row)
    return rows


def projector_tensors_differ(a, b) -> dict:
    names = ("v", "mu", "nu", "count", "hist", "idx")
    return {k: float((x.double() - y.double()).abs().max())
            for k, x, y in zip(names, a.tensors(), b.tensors()) if not torch.equal(x, y)}


def phase_project(fa):
    """Phase 35: the CLI's `project` of 16 random images (a .npy) for 32
    steps, replays of one captured step, from a checkpoint of a seeded
    state: lsun_bedroom_128 in the z space (its bf16 generator) and the
    style recipe (celeba_64) in the w+ space (the f32 synthesis); the loss
    falls and the gate kernels launch. Then, on the checkpoint's serving
    generator: every gate backward call of one eager projection step held
    to its plain version (bf16 rule, or F32_TOL in f32), and 4 eager steps
    against 4 graph replays from the same start, bitwise."""
    import shutil
    import tempfile

    import numpy as np

    from locate_tpu_torch.config import get_config
    from locate_tpu_torch.io.checkpoint import CheckpointManager
    from locate_tpu_torch.io.projection import projector
    from locate_tpu_torch.io.sampling import serving_generator

    scratch = tempfile.mkdtemp(prefix="smoke_project_")
    rows = {}
    for name, preset, overrides, space in PROJECTIONS:
        t0 = time.perf_counter()
        cfg = get_config(preset, {"use_pallas": "true", **overrides})
        args = [preset, "use_pallas=true", *[f"{k}={v}" for k, v in overrides.items()]]
        gan, state, _ = trainer(cfg)
        ckpt = os.path.join(scratch, name)
        mgr = CheckpointManager(ckpt, keep=1)
        mgr.save(state)
        mgr.close()
        res = cfg.model.resolution
        imgs = np.random.default_rng(0).integers(0, 256, (PROJECT_IMAGES, res, res, 3),
                                                 dtype=np.uint8)
        npy, out = os.path.join(scratch, name + ".npy"), os.path.join(scratch, name + ".npz")
        np.save(npy, imgs)
        reset_counters()
        t1 = time.perf_counter()
        text = cli_text(["project", *args, f"--checkpoint={ckpt}", f"--images={npy}",
                         f"--count={PROJECT_IMAGES}", f"--steps={PROJECT_STEPS}",
                         f"--space={space}", f"--out={out}",
                         f"--recon={os.path.join(scratch, name + '.png')}"])
        cli_seconds = time.perf_counter() - t1
        launches = read_counters()
        with np.load(out) as npz:
            hist, z = npz["loss_history"], npz["z"]
        check(np.isfinite(hist).all() and hist[-1] < hist[0],
              f"project {name}: the loss went {hist[0]} -> {hist[-1]}")
        check(all(launches[k] > 0 for k in SOFTMAX_GATE),
              f"project {name}: launched {launches}")
        model = serving_generator(gan, state)
        targets = imgs.astype(np.float32) / 127.5 - 1.0
        gen = torch.Generator(device="cuda")

        def fresh():
            gen.manual_seed(0)
            return projector(model, targets, steps=PROJECT_BITWISE_STEPS, space=space, gen=gen)

        calls = []
        with deterministic_convs():
            with checked_gate_backward(fa, calls):
                fresh().step()
            eager = fresh()
            for _ in range(PROJECT_BITWISE_STEPS):
                eager.step()
            graph = fresh()
            graph.run(PROJECT_BITWISE_STEPS)
            torch.cuda.synchronize()
        check(calls, f"project {name}: no gate backward call in the checked step")
        diff = projector_tensors_differ(eager, graph)
        check(not diff, f"project {name}: graph replays differ from eager steps: {diff}")
        rows[name] = dict(space=space, images=PROJECT_IMAGES, steps=PROJECT_STEPS,
                          latents=list(z.shape), loss_first=float(hist[0]),
                          loss_last=float(hist[-1]), cli_seconds=cli_seconds,
                          launches=launches, gate_backward_calls_held=len(calls),
                          worst_gate_call=worst_call(calls),
                          graph_vs_eager_bitwise_steps=PROJECT_BITWISE_STEPS,
                          cli_output=text.strip().splitlines()[-2:],
                          seconds=time.perf_counter() - t0)
        del gan, state, model, eager, graph
        release_memory()
    shutil.rmtree(scratch)
    say("project", **rows)
    return rows


def launch_columns(out, columns: dict) -> None:
    """Each kernels-line entry's launches on other paths: `columns` maps a
    column name to {kernel: launches}."""
    for entry in out:
        for column, launches in columns.items():
            entry[column] = launches[entry["name"]]


def check_style_launches(out) -> None:
    """The style family's train step launched every softmax gate kernel."""
    for entry in out:
        if entry["name"] in SOFTMAX_GATE:
            check(entry["launches_style_train"] > 0,
                  f"{entry['name']} never launched in a style train step")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from locate_tpu_torch.config import get_config
    from locate_tpu_torch.nn import blocks
    from locate_tpu_torch.ops import flash_attention as fl
    from locate_tpu_torch.ops import fused_attention as fa
    from locate_tpu_torch.ops import fused_stage as fs
    from locate_tpu_torch.ops.cuda import build

    t_start = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    say("card", torch_name=kind, nvidia_smi=smi, count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)
    phase_build(fa, fs, fl, build)
    for phase, cut in CUTS.items():
        say("cut", where=phase, cut=cut)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    # the gate kernels at lsun_bedroom_128's shapes, then at ffhq_512's new ones
    fwd_rows = phase_forward(fa, cases(), BATCH)
    fwd_rows += phase_forward(fa, ffhq_gate_cases(), FFHQ_BATCH, "ffhq-gate-forward")
    bwd_rows = phase_backward(fa, cases(), BATCH)
    bwd_rows += phase_backward(fa, ffhq_gate_cases(wide=True), FFHQ_BATCH, "ffhq-gate-backward")

    # lsun_bedroom_128: serving and training (no stage fuses at 128^2)
    cfg = get_config("lsun_bedroom_128", {"use_pallas": "true"})
    serve_launches = phase_generator(fa, cfg)
    phase_serving(cfg)
    train_cfg, weights, train_launches, gate_routes = phase_train(fa)
    phase_train_grads(fa, train_cfg, weights)
    del weights
    bench_kernel, _ = phase_train_throughput()

    # ffhq_512: the fused-stage kernels, serving, training (their main path)
    stage_rows, stage_times, stage_err = phase_stage_kernels(fs, fa)
    phase_stage_shares_l(fs, fa)
    phase_ffhq_serving()
    ffhq_cfg, ffhq_weights, ffhq_launches, ffhq_routes = phase_ffhq_train()
    # with the softmax gate random weights give G a norm above the shipped
    # guard: only with it raised does G's Adam update run on the card
    say("ffhq-train-raised-guard", **raised_guard_steps(3, "ffhq-train-raised-guard"))
    phase_ffhq_checked_backward(fs, fa, ffhq_cfg, ffhq_weights)
    del ffhq_weights
    forced_launches = phase_ffhq_grads_64(fs, fa, blocks)
    phase_fusion_timing(blocks)

    # ffhq_512 with the sigmoid gate: its three kernels, serving, training
    sigmoid_rows = phase_sigmoid_gate(fa)
    _, sig_stage_times, sig_stage_err = phase_stage_kernels(
        fs, fa, SIGMOID_STAGE_CASES, "sigmoid-stage-kernels-vs-plain")
    sig_serve = phase_ffhq_serving(SIGMOID, SIGMOID_SERVE_PER_FORWARD, "ffhq-sigmoid-serving")
    sig_cfg, sig_weights, sig_launches, sig_routes = phase_ffhq_train(
        SIGMOID, SIGMOID_PER_STEP, "ffhq-sigmoid-train")
    phase_ffhq_checked_backward(fs, fa, sig_cfg, sig_weights,
                                "ffhq-sigmoid-checked-stage-backward")
    del sig_weights
    phase_ffhq_grads_64(fs, fa, blocks, SIGMOID,
                        ("stage_sigmoid", "stage_conv", "stage_conv_bwd", "sigmoid_bwd"),
                        "ffhq-sigmoid-train-grads-64")
    phase_retune_table()

    # lsun_bedroom_128 with full self-attention: the three flash kernels,
    # serving (all six layers), training (five layers a net, their main path)
    flash_rows, flash_train_rows = phase_flash_kernels(fl)
    self_serve = phase_self_serving(fl)
    self_cfg, self_weights, self_launches, self_batch, self_routes = phase_self_train()
    phase_self_train_grads(fl, self_cfg, self_weights, self_batch)
    del self_weights

    # several steps a call: CUDA graphs of the step against eager steps on
    # each path; bench-sample's graph against eager sampling
    phase_step_graphs()
    phase_sample_graph()

    # the input path: packed shards through the producer and the prefetch
    phase_e2e_input_path()

    # the train loop: a SIGKILLed run resumed against an uninterrupted one,
    # export and sampling from the checkpoint
    _, loop_launches, loop_dir = phase_train_loop()

    # every option of the train step: three more presets at full width, six
    # recipes at lsun_bedroom_128's, and the fused step's bench line
    phase_presets()
    phase_recipes(bench_kernel)

    # the style family (serving with truncation, training with mixing and
    # noise), spectral norm and the skip head, projection
    style_serve = phase_style_serving()
    style_train = phase_style_train()
    phase_sn_and_skip()
    phase_project(fa)

    # the eval of the loop's checkpoint, and the extractors on the card
    eval_launches = phase_eval(os.path.join(loop_dir, "a"))
    shutil.rmtree(loop_dir)
    for kernel in ("softmax_stats", "softmax_apply"):
        check(eval_launches[kernel] > 0, f"the eval never launched {kernel}")

    # data parallelism: a world-size-1 NCCL group, and two gloo ranks
    dp_nccl = phase_dp_nccl()
    _, dp_gloo_launches = phase_dp_gloo()

    out = [gate_entry(k, fwd_rows, bwd_rows, train_launches, serve_launches, ffhq_launches,
                      gate_routes.get(k)) for k in KERNELS]
    out += [stage_entry(k, stage_times, stage_err, ffhq_launches, routes=ffhq_routes,
                        forced=forced_launches) for k in STAGE_KERNELS]
    out += [sigmoid_entry(k, sigmoid_rows, sig_launches, sig_serve, sig_routes)
            for k in SIGMOID_KERNELS]
    out.append(stage_entry("stage_sigmoid", sig_stage_times, sig_stage_err, sig_launches,
                           SIGMOID_STAGE_PER_STEP["stage_sigmoid"], sig_routes))
    out += [flash_entry(k, flash_rows, flash_train_rows, self_launches, self_serve,
                        self_routes) for k in FLASH_KERNELS]
    launch_columns(out, {"launches_ffhq_512_sigmoid_train": sig_launches,
                         "launches_self_attention_train": self_launches,
                         "launches_train_loop": loop_launches,
                         "launches_style_train": style_train,
                         "launches_style_serve": style_serve,
                         "launches_eval": eval_launches,
                         "launches_dp_nccl": dp_nccl["runs"]["zero0"]["launches"],
                         "launches_dp_gloo_rank0": dp_gloo_launches})
    check_style_launches(out)
    for entry in out:
        check(entry["launches"] > 0, f"{entry['name']} never launched on its main path")
    check(len(out) == 14, f"{len(out)} kernels listed")
    print(json.dumps({"kernels": out}), flush=True)
    say("done", seconds=time.perf_counter() - t_start)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
