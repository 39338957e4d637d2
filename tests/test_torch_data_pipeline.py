"""The port's input pipeline (`locate_tpu_torch/data/pipeline.py`) against
the JAX package's: `make_input_pipeline` on the CPU yields the JAX
pipeline's batches for one seed (flips on and off, `skip_batches` within
and across epochs, `steps_per_call` stacking, `d_steps`, disjoint shards at
`process_count=2`); the producer's fallbacks, error hand-off and `close()`;
the CPU device stage; labels in the class embedding's dtype through a
class-conditional step; and `bench e2e` on the CPU at a narrowed model."""

import json
import threading

import numpy as np
import pytest
import torch

from locate_tpu.config import DataConfig as JaxDataConfig
from locate_tpu.data import pipeline as jpl
from locate_tpu_torch import cli
from locate_tpu_torch.config import DataConfig, get_config
from locate_tpu_torch.data import pipeline as tpl
from locate_tpu_torch.data.datasets import SyntheticImages


def batches(pipe, n):
    try:
        return [next(pipe) for _ in range(n)]
    finally:
        pipe.close()


def assert_same(port, ref):
    assert set(port) == set(ref)
    for key in ref:
        np.testing.assert_array_equal(port[key].numpy(), np.asarray(ref[key]))


@pytest.fixture(scope="module")
def short_pack(tmp_path_factory):
    """100 synthetic images packed: at 8 a process an epoch is 12.5
    batches, so 30 batches cross two epoch boundaries, and skip_batches 14
    starts in the second epoch."""
    from locate_tpu_torch.data.packed import pack_dataset

    return pack_dataset(SyntheticImages(16, 3, length=100),
                        str(tmp_path_factory.mktemp("short") / "pack"))


@pytest.mark.parametrize("kw", [
    dict(), dict(random_flip=False), dict(skip_batches=3), dict(skip_batches=14),
    dict(steps_per_call=4), dict(d_steps=2), dict(d_steps=2, skip_batches=7),
    dict(steps_per_call=4, d_steps=2, skip_batches=2),
    dict(process_index=0, process_count=2), dict(process_index=1, process_count=2),
], ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()) or "default")
def test_pipeline_matches_jax(kw, short_pack):
    kw = dict(kw)
    data = dict(dataset="packed", path=short_pack, resolution=16,
                random_flip=kw.pop("random_flip", True))
    port = tpl.make_input_pipeline(DataConfig(**data), 16, seed=5, device="cpu", **kw)
    ref = jpl.make_input_pipeline(JaxDataConfig(**data), 16, seed=5,
                                  process_index=kw.pop("process_index", 0),
                                  process_count=kw.pop("process_count", 1), **kw)
    n = 30 // (kw.get("steps_per_call", 1) * kw.get("d_steps", 1))
    for p, r in zip(batches(port, n), batches(ref, n)):
        assert_same(p, r)
        assert p["image"].dtype == torch.uint8 and p["label"].dtype == torch.int64


def test_shards_are_disjoint_and_cover_an_epoch():
    cfg = DataConfig(dataset="synthetic", resolution=16, random_flip=False)
    seen = []
    for pi in (0, 1):
        pipe = tpl.make_input_pipeline(cfg, 16, seed=3, device="cpu", process_index=pi,
                                       process_count=2)
        seen.append({img.numpy().tobytes() for b in batches(pipe, 3) for img in b["image"]})
    assert len(seen[0]) == len(seen[1]) == 24 and not seen[0] & seen[1]
    with pytest.raises(ValueError, match="not divisible"):
        tpl.make_input_pipeline(cfg, 15, device="cpu", process_count=2)


class Counting:
    """A synthetic dataset whose `batch_fast` fails as told, counting calls."""

    def __init__(self, error=None, length=64):
        self.inner = SyntheticImages(8, 3, length=length)
        self.error, self.fast, self.examples = error, 0, 0

    def __len__(self):
        return len(self.inner)

    def batch_fast(self, indices, flips):
        self.fast += 1
        if self.error is not None:
            raise self.error
        return self.inner.batch_fast(indices, flips)

    def example(self, index, rng=None):
        self.examples += 1
        return self.inner.example(index, rng)


@pytest.mark.parametrize("error,fast_calls", [(None, 3), (RuntimeError("no native path"), 1),
                                              (OSError("corrupt file"), 3)])
def test_producer_fallbacks_match_jax(error, fast_calls):
    """RuntimeError from `batch_fast`: `example` from then on; OSError: that
    batch only; the batches equal the JAX producer's either way."""
    out = []
    for mod in (tpl, jpl):
        ds = Counting(error)
        prod = mod.BatchProducer(ds, 8, seed=2, prefetch=1)
        it = iter(prod)
        got = [next(it) for _ in range(3)]
        prod.close()
        out.append(got)
        assert ds.fast >= fast_calls and (ds.examples > 0) == (error is not None)
        if isinstance(error, RuntimeError):
            assert ds.fast == 1
    for p, r in zip(*out):
        for key in r:
            np.testing.assert_array_equal(p[key], r[key])


def test_producer_error_reaches_the_consumer():
    class Broken:
        def __len__(self):
            return 10

        def example(self, i, rng):
            raise ValueError("decode failed")

    prod = tpl.BatchProducer(Broken(), 2, seed=0)
    with pytest.raises(ValueError, match="decode failed"):
        next(iter(prod))
    prod.close()
    with pytest.raises(ValueError, match="batch_size"):
        tpl.BatchProducer(Broken(), 0)


def test_close_stops_the_producer_thread():
    """The pipeline's own producer thread has stopped when `close()`
    returns (a count of the process's threads also sees other tests'
    threads come and go under xdist)."""
    cfg = DataConfig(dataset="synthetic", resolution=16)
    with tpl.make_input_pipeline(cfg, 8, seed=0, device="cpu") as pipe:
        thread = pipe._producer._thread
        assert next(pipe)["image"].shape == (8, 16, 16, 3)
        assert thread.is_alive()
    assert not thread.is_alive()
    with pytest.raises(StopIteration):
        next(pipe)


def test_close_raises_while_the_thread_runs_on():
    """A producer held inside a batch past `close`'s timeout raises; it
    stops once that batch is done."""
    entered, release = threading.Event(), threading.Event()

    class Stuck:
        def __len__(self):
            return 16

        def example(self, i, rng):
            entered.set()
            release.wait()
            return np.zeros((4, 4, 3), np.uint8), 0

    prod = tpl.BatchProducer(Stuck(), 2, seed=0)
    assert entered.wait(10.0)
    with pytest.raises(RuntimeError, match="did not stop within 0.2 s"):
        prod.close(timeout=0.2)
    release.set()
    prod.close()
    assert not prod._thread.is_alive()


def test_cpu_device_stage_passes_arrays_through():
    host = [{"image": np.full((2, 4, 4, 3), i, np.uint8), "label": np.arange(2, dtype=np.int32)}
            for i in range(5)]
    out = list(tpl.device_prefetch(iter(host), "cpu", depth=2))
    assert len(out) == 5
    for i, b in enumerate(out):
        assert b["image"].device.type == "cpu" and int(b["image"][0, 0, 0, 0]) == i
        assert b["label"].dtype == torch.int64 and b["label"].tolist() == [0, 1]
    with pytest.raises(ValueError, match="depth"):
        tpl.device_prefetch(iter(host), "cpu", depth=0)


def test_cuda_without_a_card_raises_and_starts_no_thread():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a card")
    before = threading.active_count()
    with pytest.raises(RuntimeError, match="is_available"):
        tpl.device_prefetch(iter([]))
    with pytest.raises(RuntimeError, match="is_available"):
        tpl.make_input_pipeline(DataConfig(dataset="synthetic", resolution=16), 8)
    assert threading.active_count() == before


def test_labels_feed_a_class_conditional_step():
    """ffhq_256 (num_classes 10, projection D) narrowed: a pipeline batch's
    labels carry the dtype of the step's own label draws, and a step runs
    on it."""
    from locate_tpu_torch.models.gan import build_gan
    from locate_tpu_torch.train.state import create_train_state
    from locate_tpu_torch.train.step import make_train_step

    cfg = get_config("ffhq_256", {
        "model.resolution": "16", "data.resolution": "16", "model.base_channels": "32",
        "model.max_channels": "32", "model.min_channels": "16", "model.latent_dim": "16",
        "train.compute_dtype": "float32", "train.global_batch": "4", "data.dataset": "synthetic",
        "train.r1_gamma": "0.0"})
    assert cfg.model.num_classes == 10 and cfg.data.num_classes == 10
    gan = build_gan(cfg, "cpu")
    state = create_train_state(cfg, gan)
    step = make_train_step(cfg, gan)
    batch = batches(tpl.make_input_pipeline(cfg.data, 4, seed=1, device="cpu"), 1)[0]
    assert batch["label"].dtype == gan.sample_labels(state.rng, 4).dtype
    assert batch["label"].max() < 10 and batch["label"].unique().numel() > 1
    state, metrics = step(state, batch)
    assert state.step == 1 and all(torch.isfinite(v).all() for v in metrics.values())


def test_bench_e2e_on_the_cpu(tmp_path, capsys):
    """`bench 4 2 e2e` at a narrowed model: one JSON line with the e2e
    rate as its value and the input path, reconciliation, host and split
    keys; its pack in tmp_path."""
    pack = str(tmp_path / "pack")
    small = ["model.resolution=16", "data.resolution=16", "model.base_channels=32",
             "model.max_channels=32", "model.min_channels=16", "data.prefetch=1"]
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    try:
        assert cli.main(["bench", "4", "2", "e2e", "--device=cpu", f"--pack={pack}",
                         *small]) == 0
    finally:
        torch.set_num_threads(threads)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    d = json.loads(lines[0])
    assert d["measures"] == "end_to_end" and "e2e" in d["metric"] and "16x16" in d["metric"]
    assert d["value"] == d["e2e_images_per_sec"] > 0 and d["steps_per_call"] == 1
    assert d["device_only_images_per_sec"] > 0 and len(d["input_path_windows"]) == 2
    assert d["input_path_images_per_sec"] == max(d["input_path_windows"])
    rec = d["reconciliation"]
    assert rec["model"] == "e2e <= 1.15 * min(input_path, device_only)"
    assert rec["ok"] == (rec["e2e"] <= 1.15 * min(rec["input_path"], rec["device_only"]))
    assert d["host"]["pack"] == pack and d["host"]["cpu_count"] >= 1
    assert d["input_path_split"]["host_assembly_images_per_sec"] > 0
    from locate_tpu_torch.data.packed import PackedDataset

    assert len(PackedDataset(pack)) == 2048
