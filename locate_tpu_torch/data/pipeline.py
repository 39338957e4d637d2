"""Host input pipeline of the port, the counterpart of
`locate_tpu/data/pipeline.py`, with a device stage built for the card.

  * A background *producer thread* (`BatchProducer`) assembles uint8 numpy
    batches (decode, resize, flip are per-example host work) in the JAX
    package's index and flip stream, byte for byte: a per-epoch Philox
    permutation and one flip draw per iterated example.
  * Batches cross to the device as **uint8** (4x fewer bytes than f32;
    the train step normalizes to [-1, 1] on the device) and labels as
    int64, the index dtype of the step's class embedding
    (`GAN.sample_labels`).
  * `device_prefetch` keeps `depth` batches in flight. On the card each
    host batch is written into pinned host memory and copied to the
    device with `non_blocking` on a side CUDA stream; the consumer's stream
    waits on the batch's event before the batch is yielded, and each
    yielded tensor is `record_stream`-ed on the consumer's stream, so the
    caching allocator hands its memory to no later prefetch while the step
    still reads it. A pinned buffer is written again only after its copy's
    event has completed. On the CPU the stage passes the arrays through
    (`torch.from_numpy`).

Several processes: each takes its (process_index, process_count), by
default its rank and the world size of the process group
(`parallel/distributed.py`), so the index sets are disjoint and each
rank's batch is the JAX package's process-local batch of that index.
"""

from __future__ import annotations

import collections
import queue
import threading
from typing import Dict, Iterator, Optional, Union

import numpy as np
import torch

Batch = Dict[str, np.ndarray]
# the dtype each key crosses to the device in (others keep their own)
DEVICE_DTYPES = {"image": np.uint8, "label": np.int64}


class BatchProducer:
    """Background thread yielding uint8 batches from a dataset."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        *,
        shard_index: int = 0,
        shard_count: int = 1,
        random_flip: bool = True,
        seed: int = 0,
        prefetch: int = 2,
        drop_remainder: bool = True,
        skip_examples: int = 0,
    ):
        if batch_size <= 0:
            raise ValueError("batch_size must be positive")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shard_index = shard_index
        self.shard_count = shard_count
        self.random_flip = random_flip
        self.seed = seed
        # Deterministic resume: the index stream is seeded per epoch, so
        # skipping N examples replays exactly the post-checkpoint stream
        # without decoding the skipped ones.
        self.skip_examples = skip_examples
        self._queue: "queue.Queue[Batch]" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _epoch_stream(self):
        """Per epoch: (indices, flips) arrays for the non-skipped tail.

        RNG discipline (the resume invariant): per epoch, the permutation is
        drawn first, then — when random_flip — exactly ONE uniform draw per
        iterated example, in stream order, vectorized (`Generator.random(n)`
        consumes the bit stream identically to n scalar draws). Skipped
        examples consume their draw but are not yielded; entirely-skipped
        epochs consume nothing (matching the original scalar stream).
        `example()`/`batch_fast()` must never consume this RNG.
        """
        epoch = 0
        n = len(self.dataset)
        to_skip = self.skip_examples
        while not self._stop.is_set():
            rng = np.random.Generator(
                np.random.Philox(key=self.seed, counter=epoch)
            )
            perm = rng.permutation(n)
            shard = perm[self.shard_index :: self.shard_count]
            epoch += 1
            if to_skip >= len(shard):
                to_skip -= len(shard)
                continue
            if self.random_flip:
                flips = rng.random(len(shard)) < 0.5
            else:
                flips = np.zeros(len(shard), bool)
            yield shard[to_skip:], flips[to_skip:]
            to_skip = 0

    def _assemble(self, indices, flips) -> Batch:
        if self._use_fast:
            try:
                imgs, labs = self.dataset.batch_fast(indices, flips)
                return {"image": imgs, "label": labs}
            except RuntimeError:
                # fast path structurally unavailable: permanent fallback
                self._use_fast = False
            except OSError:
                # corrupt file: fall back for this batch only — PIL may
                # still decode it
                pass
        # rng is never passed to example(): the stream RNG is consumed only
        # by the flip decision, one draw per example (resume invariant).
        images, labels = [], []
        for i, fl in zip(indices, flips):
            img, label = self.dataset.example(int(i), None)
            if fl:
                img = img[:, ::-1]
            images.append(np.ascontiguousarray(img))
            labels.append(label)
        return {
            "image": np.stack(images),
            "label": np.asarray(labels, np.int32),
        }

    def _run(self):
        self._use_fast = hasattr(self.dataset, "batch_fast")
        bs = self.batch_size
        buf_idx: list = []
        buf_flip: list = []
        try:
            for idxs, flips in self._epoch_stream():
                pos = 0
                while pos < len(idxs):
                    if self._stop.is_set():
                        return
                    take = min(bs - len(buf_idx), len(idxs) - pos)
                    buf_idx.extend(idxs[pos : pos + take])
                    buf_flip.extend(flips[pos : pos + take])
                    pos += take
                    if len(buf_idx) < bs:
                        break  # epoch exhausted; continue filling next epoch
                    batch = self._assemble(buf_idx, buf_flip)
                    buf_idx, buf_flip = [], []
                    while not self._stop.is_set():
                        try:
                            self._queue.put(batch, timeout=0.5)
                            break
                        except queue.Full:
                            continue
        except Exception as e:  # surface worker errors to the consumer
            # Same timeout-loop as the normal put path: if the consumer has
            # already stopped draining, a blocking put would park this
            # daemon thread forever holding the batch.
            while not self._stop.is_set():
                try:
                    self._queue.put({"__error__": e}, timeout=0.5)  # type: ignore[dict-item]
                    break
                except queue.Full:
                    continue

    def __iter__(self) -> Iterator[Batch]:
        while True:
            batch = self._queue.get()
            if "__error__" in batch:
                raise batch["__error__"]  # type: ignore[misc]
            yield batch

    def close(self, timeout: float = 30.0):
        """Stop the producer thread and wait for it: the prefetched batches
        are dropped, so a put the thread is waiting on returns at once and
        it sees the stop event; a batch it is assembling is finished first.
        Raises if the thread is still running after `timeout` seconds."""
        self._stop.set()
        while True:
            try:
                self._queue.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise RuntimeError(f"the batch producer thread did not stop within {timeout} s")


def _host_array(key: str, value: np.ndarray) -> np.ndarray:
    return np.asarray(value, DEVICE_DTYPES.get(key, value.dtype))


def _cpu_batches(host_batches: Iterator[Batch]) -> Iterator[Dict[str, torch.Tensor]]:
    for batch in host_batches:
        yield {k: torch.from_numpy(np.ascontiguousarray(_host_array(k, v)))
               for k, v in batch.items()}


class _PinnedSlot:
    """One host batch's pinned buffers and the event of the copy that read
    them last."""

    def __init__(self):
        self.buffers: Dict[str, torch.Tensor] = {}
        self.event: Optional[torch.cuda.Event] = None

    def fill(self, batch: Batch) -> Dict[str, torch.Tensor]:
        if self.event is not None:
            self.event.synchronize()  # its last copy has read the buffers
        for k, v in batch.items():
            arr = _host_array(k, v)
            buf = self.buffers.get(k)
            if buf is None or tuple(buf.shape) != arr.shape:
                dtype = torch.from_numpy(np.empty(0, arr.dtype)).dtype
                buf = self.buffers[k] = torch.empty(arr.shape, dtype=dtype, pin_memory=True)
            np.copyto(buf.numpy(), arr)
        return {k: self.buffers[k] for k in batch}


def _cuda_batches(host_batches: Iterator[Batch], device: torch.device,
                  depth: int) -> Iterator[Dict[str, torch.Tensor]]:
    slots = [_PinnedSlot() for _ in range(depth + 1)]
    side = torch.cuda.Stream(device)
    in_flight = collections.deque()

    def consume():
        tensors, event = in_flight.popleft()
        current = torch.cuda.current_stream(device)
        current.wait_event(event)
        for t in tensors.values():
            t.record_stream(current)
        return tensors

    try:
        for i, batch in enumerate(host_batches):
            slot = slots[i % len(slots)]
            pinned = slot.fill(batch)
            with torch.cuda.stream(side):
                tensors = {k: torch.empty(p.shape, dtype=p.dtype, device=device)
                           for k, p in pinned.items()}
                for k, p in pinned.items():
                    tensors[k].copy_(p, non_blocking=True)
                slot.event = torch.cuda.Event()
                slot.event.record(side)
            in_flight.append((tensors, slot.event))
            if len(in_flight) >= depth:
                yield consume()
        while in_flight:
            yield consume()
    finally:
        for slot in slots:  # no pinned buffer is released under a copy
            if slot.event is not None:
                slot.event.synchronize()


def device_prefetch(host_batches: Iterator[Batch],
                    device: Union[str, torch.device, None] = None,
                    depth: int = 2) -> Iterator[Dict[str, torch.Tensor]]:
    """The host batches as tensors on `device` ("cuda" when None), `depth`
    batches in flight on the card (double buffering for depth=2), as the
    module docstring sets out; a CUDA device without a card raises here."""
    from locate_tpu_torch.device import resolve_device

    device = resolve_device(device)
    if depth < 1:
        raise ValueError("depth must be >= 1")
    if device.type == "cpu":
        return _cpu_batches(host_batches)
    return _cuda_batches(host_batches, device, depth)


class InputPipeline:
    """Closeable batch iterator: `close()` stops the producer thread and
    drops the prefetch stage (callers must close — a leaked producer keeps
    decoding, and its batches hold pinned and device memory)."""

    def __init__(self, producer: BatchProducer, iterator: Iterator, dataset):
        self._producer = producer
        self._iterator = iterator
        self.dataset = dataset

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        return next(self._iterator)

    def close(self) -> None:
        self._producer.close()
        close = getattr(self._iterator, "close", None)
        if close is not None:
            close()
        self._iterator = iter(())

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def make_input_pipeline(
    data_cfg,
    global_batch: int,
    *,
    device: Union[str, torch.device, None] = None,
    seed: int = 0,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
    skip_batches: int = 0,
    steps_per_call: int = 1,
    d_steps: int = 1,
) -> InputPipeline:
    """Dataset -> producer thread -> device prefetch, one shard a process
    (`process_index` / `process_count`: by default the process group's rank
    and world size, 0 and 1 without a group).
    `skip_batches` deterministically fast-forwards the stream for resume
    (counted in OPTIMIZER steps, whatever `steps_per_call`; with a critic
    ratio each optimizer step consumes `d_steps` batches, which the
    fast-forward accounts for). The device is resolved before the producer
    starts, so a CUDA device without a card raises with no thread left."""
    import torch.distributed as dist

    from locate_tpu_torch.data.datasets import make_dataset
    from locate_tpu_torch.device import resolve_device

    grouped = dist.is_initialized()
    pi = process_index if process_index is not None else (dist.get_rank() if grouped else 0)
    pc = (process_count if process_count is not None
          else (dist.get_world_size() if grouped else 1))
    if global_batch % pc:
        raise ValueError(f"global_batch {global_batch} not divisible by {pc} hosts")
    device = resolve_device(device)
    dataset = make_dataset(data_cfg)
    per_host = global_batch // pc
    k = steps_per_call
    c = d_steps
    # With steps_per_call / d_steps the producer assembles one
    # (k*c*per_host) batch per call — identical example/flip order to
    # k*c consecutive per_host batches (the epoch stream is consumed
    # sequentially either way) — and the [k][c](per_host, ...) layout is a
    # FREE reshape view, so all assembly/copy work stays on the producer
    # thread.
    producer = BatchProducer(
        dataset,
        per_host * k * c,
        shard_index=pi,
        shard_count=pc,
        random_flip=data_cfg.random_flip,
        seed=seed,
        prefetch=data_cfg.prefetch,
        skip_examples=skip_batches * per_host * c,
    )
    # leading axes (omitted when 1): [k] steps_per_call, [c] d_steps
    lead = tuple(d for d in (k, c) if d > 1)
    if not lead:
        host_it = iter(producer)
    else:
        host_it = (
            {
                key: v.reshape(*lead, per_host, *v.shape[1:])
                for key, v in b.items()
            }
            for b in producer
        )
    it = device_prefetch(host_it, device, depth=data_cfg.prefetch)
    return InputPipeline(producer, it, dataset)
