"""The train loop, counterpart of `locate_tpu/train/loop.py`: config ->
data -> models -> step, with periodic logging, sample grids and
checkpoints, and resume from the latest checkpoint.

The loop reads the device once a log boundary (every metric in one
copy to the host) and nowhere else: the step, the input prefetch and an
async checkpoint's copies all queue on the card. With
`train.steps_per_call` = k > 1 each call runs k steps (on the card the
replays of a CUDA graph of one step, `train/step.py:make_multi_step`),
and every cadence is a multiple of k.

A resumed run continues bit for bit: the checkpoint restores the state's
tensors in place, its step and its generator before the first call (so
before any graph is captured), the input stream skips the batches the
restored steps consumed, and sample grids draw from a generator of their
own, reseeded before each grid, never from the state's.

Every flavor of the step runs: with `train.d_steps` = c each step takes c
batches (the pipeline stacks them) and the rate counts the c batches'
images. ADA's `augment_p`, the path-length mean `pl_mean` and LeCam's
penalty `lecam` are step metrics, logged with the others.

Every `train.eval_every` steps the loop evaluates the EMA's serving
weights (`io/fid.py:evaluate_generator`, rFID and rKID with the random-conv
extractor on the run's device, and SWD with `train.eval_swd`), logs
`eval_rfid`, `eval_rkid` and `eval_swd_*`, and calls the hook "on_eval".
The check sits where sample grids are made, after a call of
`steps_per_call` steps, and the config holds `eval_every` to a multiple
of `steps_per_call`, so every eval falls on a call's end. The eval draws
its latents from the JAX package's key scheme on the host and nothing
from the state's generators, so a resumed run still continues bit for
bit; its time is left out of the logged rate. With `train.keep_best` the
state of the best rFID so far is saved (synchronously) to
<workdir>/checkpoints_best, and best.json records its fid, kid and step;
a resumed run reads best.json back, so a better incumbent is never
demoted, and `regress_warn_evals` evals without a new best print a
warning.

`cfg.compile_cache` has no effect here: the kernels' build cache of
`ops/cuda/build.py`, keyed by a digest of sources and flags, does that
work.

In a process group (`parallel/distributed.py:initialize_from_env`, one
process a device) every rank runs this loop on the mesh of
`cfg.parallel` (`parallel/mesh.py`): the step of `parallel.backend`
(`parallel/sharding.py`), the state sharded as `parallel.zero_stage`
says, each rank's input the JAX process-local batch of its index. Rank 0
alone holds the run lock and writes metrics.jsonl, the config, sample
grids, checkpoints and best.json; every rank joins the collectives of
saves, sample grids and evals, and the eval's scores, computed once,
reach every rank, so keep_best decides alike everywhere.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Dict, Optional

import torch

from locate_tpu_torch.config import Config
from locate_tpu_torch.data.pipeline import make_input_pipeline
from locate_tpu_torch.device import resolve_device
from locate_tpu_torch.io.checkpoint import CheckpointManager
from locate_tpu_torch.io.sampling import (generate_samples, load_weights, save_image_grid,
                                          serving_generator)
from locate_tpu_torch.models.gan import build_gan
from locate_tpu_torch.parallel.distributed import local_device
from locate_tpu_torch.parallel.mesh import Mesh, make_mesh
from locate_tpu_torch.parallel.sharding import make_step_for, place_train_state
from locate_tpu_torch.train.state import TrainState, create_train_state
from locate_tpu_torch.train.step import make_multi_step
from locate_tpu_torch.utils.metrics import PREFIX, MetricsLogger
from locate_tpu_torch.utils.profiling import StepTimer, trace_annotation
from locate_tpu_torch.utils.runlock import RunLock


def _dump_config(cfg: Config) -> None:
    """The resolved config as <workdir>/config.json (tuples and other
    non-JSON leaves as strings)."""
    os.makedirs(cfg.workdir, exist_ok=True)
    with open(os.path.join(cfg.workdir, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2, default=str)


def train(
    cfg: Config,
    total_steps: Optional[int] = None,
    hooks: Optional[Dict[str, Callable]] = None,
    resume: bool = True,
    device=None,
) -> TrainState:
    """Run (or resume) training on `device` (the card unless "cpu");
    returns the final TrainState.

    `hooks` may give "on_metrics(step, metrics)",
    "on_samples(step, images_u8)" and "on_eval(step, scores)". The
    workdir is locked for the run (`utils/runlock.py`; by rank 0 in a
    group): a second `train()` on it raises instead of tearing
    metrics.jsonl and racing checkpoint writes."""
    mesh = make_mesh(cfg.parallel)
    check_batch(cfg, mesh)
    device = local_device(resolve_device(device))
    lock = RunLock.acquire(cfg.workdir) if mesh.primary else None
    try:
        return _train_locked(cfg, total_steps, hooks or {}, resume, device, mesh)
    finally:
        if lock is not None:
            lock.release()


def check_batch(cfg: Config, mesh: Mesh) -> None:
    """Raise where the global batch does not split over the mesh's ranks,
    or the minibatch-stddev group does not divide a rank's batch, with
    the JAX package's words (`locate_tpu/data/pipeline.py`,
    `locate_tpu/ops/norm.py:minibatch_stddev`)."""
    gb = cfg.train.global_batch
    if gb % mesh.world:
        raise ValueError(f"global_batch {gb} not divisible by {mesh.world} hosts")
    n, group = gb // mesh.world, cfg.model.mbstd_group
    g = min(group, n)
    if group and n % g:
        raise ValueError(f"minibatch_stddev: batch {n} not divisible by group {g} "
                         "(pick mbstd_group dividing the per-replica batch)")


def _train_locked(cfg: Config, total_steps: Optional[int], hooks: Dict[str, Callable],
                  resume: bool, device: torch.device, mesh: Mesh) -> TrainState:
    tcfg = cfg.train
    total_steps = total_steps or tcfg.total_steps
    primary = mesh.primary
    gan = build_gan(cfg, device, seed=tcfg.seed)
    step_fn = make_multi_step(make_step_for(cfg, gan, mesh), tcfg.steps_per_call)
    state = create_train_state(cfg, gan, seed=tcfg.seed,
                               mesh=mesh if mesh.group is not None else None)
    place_train_state(state, mesh, cfg.parallel.zero_stage)

    ckpt = CheckpointManager(os.path.join(cfg.workdir, "checkpoints"),
                             keep=tcfg.keep_checkpoints, async_save=tcfg.async_checkpoint,
                             mesh=mesh)
    if resume and ckpt.latest_step() is not None:
        ckpt.restore(state)  # before the first call: the graphs capture restored tensors
        if primary:
            print(f"{PREFIX} resumed from step {state.step}", flush=True)

    k = tcfg.steps_per_call
    if k > 1 and (total_steps % k or state.step % k):
        raise ValueError(
            f"total_steps={total_steps} and the resume step {state.step} must both be "
            f"multiples of train.steps_per_call={k}")
    batches = make_input_pipeline(cfg.data, tcfg.global_batch, device=device, seed=tcfg.seed,
                                  process_index=mesh.rank, process_count=mesh.world,
                                  skip_batches=state.step,  # resume replays the exact stream
                                  steps_per_call=k, d_steps=tcfg.d_steps)
    # throughput counts the real images consumed
    timer = StepTimer(tcfg.global_batch * k * tcfg.d_steps)
    # metrics.jsonl appends on resume and truncates on a fresh run, so the
    # file describes one trajectory
    logger = MetricsLogger(os.path.join(cfg.workdir, "tb") if tcfg.tensorboard and primary
                           else None,
                           jsonl_path=os.path.join(cfg.workdir, "metrics.jsonl") if primary
                           else None,
                           append=state.step > 0, resume_step=state.step)
    if primary:
        _dump_config(cfg)
    # sample grids: fixed latents from a generator of their own, reseeded
    # before every grid, and the EMA weights in a serving module
    sample_gen = torch.Generator(device=device)
    server = None
    # A lazy term's value at a log boundary is 0 unless it fired in that
    # call: keep the metrics of the latest call whose steps held a fire
    # step of each (R1, R2 on R1's cadence, PL) and log its value as
    # <name>_last_fire (with k > 1 the call's mean, the penalty diluted by
    # k). The tracks live in this process, as the JAX loop's do: a resumed
    # run logs them from its first fire step on.
    lazy = [[name, every, None] for name, gamma, every in (
        ("r1", tcfg.r1_gamma, tcfg.r1_interval), ("r2", tcfg.r2_gamma, tcfg.r1_interval),
        ("pl", tcfg.pl_gamma, tcfg.pl_interval)) if gamma > 0 and every > 1]
    grad_limit_seen = 0  # grad-norm-limit skips already warned about
    evaluator = InTrainingEval(cfg, batches.dataset, resume, mesh) if tcfg.eval_every else None

    def serve():  # the EMA's serving weights, in one module for the whole run
        nonlocal server
        if server is None:
            server = serving_generator(gan, state)
        else:
            load_weights(server, state)
        return server

    try:
        for step_idx in range(state.step, total_steps, k):
            batch = next(batches)
            with trace_annotation("train_step"):
                state, metrics = step_fn(state, batch)
            # wait for the device only while warming up: the clock starts
            # from a synchronized point, the steady state stays asynchronous
            timer.tick(metrics if timer.warming_up else None)
            for track in lazy:  # a fire step in [step_idx, step_idx + k)
                if step_idx % track[1] == 0 or step_idx % track[1] + k > track[1]:
                    track[2] = metrics

            step_num = step_idx + k
            if step_num % tcfg.log_every == 0 or step_num == total_steps:
                host_metrics = _read_metrics(metrics, lazy)
                host_metrics["images_per_sec"] = timer.images_per_sec
                host_metrics["sec_per_step"] = timer.sec_per_step / k
                logger.log_scalars(step_num, host_metrics)
                if "on_metrics" in hooks:
                    hooks["on_metrics"](step_num, host_metrics)
                grad_limit_seen = _check_guards(tcfg, step_num, host_metrics, grad_limit_seen)

            if tcfg.sample_every and (step_num % tcfg.sample_every == 0
                                      or step_num == total_steps):
                model = serve()  # every rank: a ZeRO shadow is all-gathered
                if primary:
                    sample_gen.manual_seed(tcfg.seed + 1)
                    imgs = generate_samples(model, sample_gen, min(64, tcfg.global_batch))
                    save_image_grid(imgs, os.path.join(cfg.workdir, "samples",
                                                       f"step_{step_num:08d}.png"))
                    logger.log_images(step_num, "samples", imgs)
                    if "on_samples" in hooks:
                        hooks["on_samples"](step_num, imgs)

            if evaluator is not None and step_num % tcfg.eval_every == 0:
                with timer.paused(metrics):
                    scores = evaluator(step_num, serve(), state)
                logger.log_scalars(step_num, {
                    "eval_rfid": scores["fid"], "eval_rkid": scores["kid"],
                    **{f"eval_{k}": v for k, v in scores.items() if k.startswith("swd")}})
                if "on_eval" in hooks:
                    hooks["on_eval"](step_num, scores)

            if tcfg.checkpoint_every and (step_num % tcfg.checkpoint_every == 0
                                          or step_num == total_steps):
                ckpt.save(state)
    finally:
        batches.close()  # stops the producer thread, drops the prefetched batches
        logger.close()
        ckpt.close()
        if evaluator is not None:
            evaluator.close()
        if primary:
            _print_digest(cfg.workdir)
    return state


class InTrainingEval:
    """The loop's eval (`locate_tpu/train/loop.py`'s eval block): rFID and
    rKID of the serving generator against `train.eval_samples` examples of
    the training set (their features computed once, in `cache`), SWD with
    `train.eval_swd`, and with `train.keep_best` the best checkpoint, its
    best.json and the quality-regression warning. On a mesh of several
    ranks the eval splits over them and every rank gets the same scores."""

    def __init__(self, cfg: Config, dataset, resume: bool, mesh: Optional[Mesh] = None):
        self.cfg, self.dataset = cfg, dataset
        self.mesh = mesh or Mesh()
        self.extractor = None  # on the serving generator's device, at the first eval
        self.cache: dict = {}
        self.best_fid, self.best_step = float("inf"), 0
        self.evals_since_best = 0
        self.best_path = os.path.join(cfg.workdir, "best.json")
        self.best_ckpt = None
        if cfg.train.keep_best:
            self.best_ckpt = CheckpointManager(os.path.join(cfg.workdir, "checkpoints_best"),
                                               keep=1, async_save=False, mesh=self.mesh)
            if resume and os.path.exists(self.best_path):
                with open(self.best_path) as f:
                    best = json.load(f)
                self.best_fid, self.best_step = float(best["fid"]), int(best.get("step", 0))

    def __call__(self, step_num: int, model, state: TrainState) -> dict:
        from locate_tpu_torch.io.fid import RandomConvFeatures, evaluate_generator, model_device

        tcfg = self.cfg.train
        if self.extractor is None:
            self.extractor = RandomConvFeatures(device=model_device(model))
        scores = evaluate_generator(model, self.dataset, n_samples=tcfg.eval_samples,
                                    seed=tcfg.seed, extractor=self.extractor, cache=self.cache,
                                    mesh=self.mesh)
        if tcfg.eval_swd:
            from locate_tpu_torch.io.swd import swd_generator

            swd = (swd_generator(model, self.dataset, n_samples=tcfg.eval_samples,
                                 seed=tcfg.seed) if self.mesh.primary else None)
            scores.update(self.mesh.broadcast_object(swd))
        if self.best_ckpt is None:
            return scores
        if scores["fid"] < self.best_fid:
            self.best_fid, self.best_step = float(scores["fid"]), step_num
            self.evals_since_best = 0
            self.best_ckpt.save(state)
            self.best_ckpt.wait()
            if self.mesh.primary:
                with open(self.best_path, "w") as f:
                    json.dump({"fid": self.best_fid, "kid": float(scores["kid"]),
                               "step": step_num}, f)
        else:
            # advisory: rFID is noisy, and the best state is already saved
            self.evals_since_best += 1
            warn_after = tcfg.regress_warn_evals
            if warn_after and self.evals_since_best >= warn_after and self.mesh.primary:
                print(f"{PREFIX} WARNING step {step_num}: quality regressing — best rFID "
                      f"{self.best_fid:.2f} was at step {self.best_step}, "
                      f"{self.evals_since_best} evals ago (current {scores['fid']:.2f})",
                      flush=True)
        return scores

    def close(self) -> None:
        if self.best_ckpt is not None:
            self.best_ckpt.close()


def _read_metrics(metrics: Dict[str, torch.Tensor], lazy) -> Dict[str, float]:
    """The call's metrics (and each lazy term's <name>_last_fire) on the
    host, in one copy."""
    values = dict(metrics)
    for name, _, fired in lazy:
        if fired is not None and name in fired:
            values[name + "_last_fire"] = fired[name]
    names = list(values)
    host = torch.stack([values[n].detach().reshape(()).float() for n in names]).cpu()
    return dict(zip(names, host.tolist()))


def _check_guards(tcfg, step_num: int, m: Dict[str, float], grad_limit_seen: int) -> int:
    """Warn when grad-norm-limit skips start; abort on a streak of
    non-finite or over-limit updates at `max_nonfinite_skips` (params are
    never poisoned, but such a streak means training is dead). Returns the
    skips warned about so far."""
    if tcfg.grad_norm_limit > 0.0:
        n_skips = int(m.get("d_grad_limit_count", 0) + m.get("g_grad_limit_count", 0))
        if n_skips > grad_limit_seen:
            print(f"{PREFIX} WARNING step {step_num}: {n_skips - grad_limit_seen} update(s) "
                  f"skipped for |grad| > {tcfg.grad_norm_limit:g} ({n_skips} total; window "
                  f"norms d={m.get('d_grad_norm', 0):.3g} g={m.get('g_grad_norm', 0):.3g})",
                  flush=True)
            grad_limit_seen = n_skips
    limit = tcfg.max_nonfinite_skips
    if limit > 0:
        streak = max(m.get("d_nonfinite_streak", 0), m.get("g_nonfinite_streak", 0))
        if streak >= limit:
            raise RuntimeError(f"aborting at step {step_num}: {int(streak)} consecutive "
                               f"non-finite gradient steps (limit {limit})")
        lim_streak = max(m.get("d_grad_limit_streak", 0), m.get("g_grad_limit_streak", 0))
        if lim_streak >= limit:
            raise RuntimeError(f"aborting at step {step_num}: {int(lim_streak)} consecutive "
                               f"updates over grad_norm_limit={tcfg.grad_norm_limit:g} "
                               f"(limit {limit})")
    return grad_limit_seen


def _print_digest(workdir: str) -> None:
    """The end-of-run stability digest (`utils/digest.py`), aborted runs
    included. Best effort: a digest failure never masks the run's own
    outcome."""
    from locate_tpu_torch.utils.digest import format_digest, load_metrics_jsonl, stability_digest

    path = os.path.join(workdir, "metrics.jsonl")
    try:
        if os.path.exists(path):
            dig = stability_digest(load_metrics_jsonl(path))
            if dig is not None:
                print(f"{PREFIX} run stability digest:", flush=True)
                for line in format_digest(dig):
                    print("  " + line, flush=True)
    except Exception as e:  # pragma: no cover
        print(f"{PREFIX} (stability digest failed: {e!r})", flush=True)
