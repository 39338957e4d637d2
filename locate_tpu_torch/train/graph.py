"""CUDA graphs of the train step and of sampling, the port's counterpart of
one compiled `lax.scan` call of k steps (`locate_tpu/train/step.py`
`make_multi_step`) and of a jitted sampler.

`StepGraphs` captures one whole step of any flavor (D's updates, G's, the
EMA, the guards' and the options' decisions, every draw) reading row `idx`
of static [k, ...] input buffers, and replays it k times a call; each set
of lazy flags (`TrainStep.lazy_flags`: R1 and R2 firing, PL firing) has a
graph of its own, picked on the host from the step count. What else moves
from step to step lives in the state's tensors and is decided on the card
(ADA's p, LeCam's trackers, the path-length mean, the LR schedule's and
grad_accum's counts, the device step of ema_rampup), so a replay moves
it. Nothing between two replays waits
for the host. Before a capture, the variant runs once eagerly on a side
stream (the kernel libraries load, cuDNN and cuBLAS pick their plans, the
kernels' `cudaFuncSetAttribute` and occupancy queries run, the caches of
device constants fill) from a snapshot of the state that is then put
back, so the warm-up leaves no trace in the trajectory. The state's
generator is registered with each graph, so every replay draws the next
latents, as an eager step would. A failed capture or replay raises; there
is no eager fallback. Under a process group the step's collectives are
captured too: every graph is captured on one stream of its own, on which
a collective of every group the step uses (the world's, the data and
the model group of a (data, model) mesh) has run before the first capture
(NCCL makes a group's communicator at its first collective, which a
capture cannot hold).

`SampleGraph` captures `io/sampling.py:generate_samples`'s device work
(the latent draw, the generator's forward, the uint8 conversion; with
`truncation_psi` the style family's truncated forward around a w_avg
estimated once, before the capture) and copies the images to the host
after each replay.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.distributed

from locate_tpu_torch.train.state import TrainState, restore, snapshot, state_tensors
from locate_tpu_torch.train.step import reduce_metrics


def _addresses(state: TrainState) -> Dict[str, int]:
    return {k: t.data_ptr() for k, t in state_tensors(state).items()}


def _on_side_stream(fn) -> None:
    """Run `fn()` on a side stream and wait for it (the warm-up before a
    capture, as torch.cuda.graphs recommends)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()


class StepGraphs:
    """The graphs of `step` for `state`, k steps a call. `batches` and
    `draws` ({name: [k, ...] tensor}) give the static buffers' shapes; a
    call copies its own into them. The graphs are bound to `state`'s
    tensors: another state, or one whose tensors moved, raises."""

    def __init__(self, step, k: int, state: TrainState, batches: Dict[str, torch.Tensor],
                 draws: Dict[str, torch.Tensor]):
        self.step, self.k, self.state = step, k, state
        device = state.g_params.flat.device
        self.inputs = {n: torch.empty_like(t, device=device) for n, t in batches.items()}
        self.draws = {n: torch.empty_like(t, device=device) for n, t in draws.items()}
        for n, t in {**self.inputs, **self.draws}.items():
            if t.shape[0] != k:
                raise ValueError(f"{n}: leading axis {t.shape[0]}, want steps_per_call {k}")
        self.idx = torch.zeros(1, dtype=torch.long, device=device)
        self.out: Dict[str, torch.Tensor] = {}
        self.graphs: Dict[Tuple[bool, bool], torch.cuda.CUDAGraph] = {}
        self.pool = None  # one memory pool for every graph, made at the first capture
        self.stream = None  # every capture's stream, made at the first capture
        self.addresses = _addresses(state)

    def body(self, flags: Tuple[bool, bool]) -> None:
        """One step with lazy `flags` on row `idx` of the static inputs;
        its metrics go to row `idx` of `out`, and `idx` moves on (mod k).
        What the graphs capture."""
        state, i = self.state, self.idx
        batch = {n: t.index_select(0, i)[0] for n, t in self.inputs.items()}
        draws = {n: t.index_select(0, i)[0] for n, t in self.draws.items()}
        real, labels, prepared = self.step.prepare(state, batch, flags, **draws)
        metrics = self.step.update(state, real, labels, prepared, *flags)
        for n, v in metrics.items():
            if n not in self.out:  # the eager warm-up's first run allocates
                self.out[n] = torch.zeros(self.k, dtype=v.dtype, device=v.device)
            self.out[n].index_copy_(0, i, v.reshape(1))
        i.copy_(torch.remainder(i + 1, self.k))

    def prepare(self, flags) -> None:
        """Warm up and capture the variants in `flags` (each a set of lazy
        flags) that have no graph yet."""
        flags = sorted(set(flags) - set(self.graphs))
        if flags:
            self.warm_up(flags)
            for f in flags:
                self.capture(f)

    def warm_up(self, flags) -> None:
        """Run each variant in `flags` once, eagerly, on a side stream, from
        a snapshot of the state that is then put back."""
        saved = snapshot(self.state)

        def run():
            for f in flags:
                self.body(f)

        _on_side_stream(run)
        restore(self.state, saved)
        self.idx.zero_()

    def capture(self, flags: Tuple[bool, bool]) -> None:
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(self.idx.device)
            mesh = self.step.mesh
            if mesh.group is not None:  # a collective of every group on the stream first
                self.stream.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(self.stream):
                    for group in mesh.groups():
                        torch.distributed.all_reduce(
                            torch.zeros(1, device=self.idx.device), group=group)
                torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.state.rng)
        with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
            self.body(flags)
        self.graphs[flags] = graph

    def __call__(self, state: TrainState, batches: Dict[str, torch.Tensor],
                 draws: Dict[str, torch.Tensor]):
        if state is not self.state or _addresses(state) != self.addresses:
            raise ValueError("a step graph runs the state it was captured for, "
                             "in its own tensors")
        self.load(batches, draws)
        flags = [self.step.lazy_flags(state.step + i) for i in range(self.k)]
        self.prepare(flags)
        for f in flags:
            self.graphs[f].replay()
        state.step += self.k
        return state, reduce_metrics(self.out)

    def load(self, batches: Dict[str, torch.Tensor], draws: Dict[str, torch.Tensor]) -> None:
        """Copy a call's [k, ...] batches and draws into the static buffers."""
        if set(batches) != set(self.inputs) or set(draws) != set(self.draws):
            raise ValueError(f"inputs {sorted(batches)} and draws {sorted(draws)}; the "
                             f"graph was captured for {sorted(self.inputs)}, "
                             f"{sorted(self.draws)}")
        for n, t in {**batches, **draws}.items():
            static = self.inputs[n] if n in self.inputs else self.draws[n]
            if t.shape != static.shape:
                raise ValueError(f"{n}: shape {tuple(t.shape)}, the graph's is "
                                 f"{tuple(static.shape)}")
            static.copy_(t)


class SampleGraph:
    """`generate_samples(model, gen, count, truncation_psi=...)` as one
    graph: each call replays the latent draw from `gen` (registered with
    the graph, so it moves on as an eager draw does), the forward and the
    uint8 conversion, and copies the images to the host. With
    `truncation_psi` the truncation centre (`truncation_centre`) is drawn
    from `gen` once, here, before the capture: the first replay equals
    `generate_samples` from the same seed, and later replays keep that
    centre (`self.w_avg`)."""

    def __init__(self, model, gen: torch.Generator, count: int, truncation_psi: float = 0.0):
        from locate_tpu_torch.io.sampling import (check_truncation_psi, sample_latents,
                                                  to_uint8_tensor, truncation_centre)
        from locate_tpu_torch.models.style_generator import apply_truncated

        cfg = model.config
        check_truncation_psi(model, truncation_psi)
        self.w_avg = w_avg = truncation_centre(model, gen) if truncation_psi > 0.0 else None

        def run():
            with torch.inference_mode():
                z = sample_latents(gen, count, cfg.latent_dim)
                lab = (torch.arange(count, device=gen.device) % cfg.num_classes
                       if cfg.num_classes else None)
                if truncation_psi > 0.0:
                    return to_uint8_tensor(apply_truncated(model, z, lab, psi=truncation_psi,
                                                           w_avg=w_avg))
                return to_uint8_tensor(model(z, lab))

        state = gen.get_state()
        _on_side_stream(run)
        gen.set_state(state)
        self.graph = torch.cuda.CUDAGraph()
        self.graph.register_generator_state(gen)
        with torch.cuda.graph(self.graph):
            self.images = run()

    def __call__(self) -> np.ndarray:
        self.graph.replay()
        return self.images.cpu().numpy()
