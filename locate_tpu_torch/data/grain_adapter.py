"""grain <-> dataset adapters of the port, counterparts of
`locate_tpu/data/grain_adapter.py`: thin adapters over the Dataset
protocol (`__len__`, `example`, `num_classes`).

  * `AsGrainSource(dataset)` — expose any dataset of the port (synthetic /
    CIFAR-10 / folder / packed) as a grain `RandomAccessDataSource`
    (`__len__` + `__getitem__` -> {"image", "label"}).

  * `GrainDataset(source, resolution)` — run any grain random-access
    source through the port's own producer and prefetch pipeline.
    Items may be dicts ({"image", optional "label"}), (image, label)
    tuples, or bare HWC uint8 arrays, already sized to `resolution` (this
    adapter does no decoding or resizing).

Neither side imports grain; deterministic resume (`skip_examples`) keeps
working because `example()` never consumes the stream RNG
(data/pipeline.py invariant).
"""

from __future__ import annotations

from typing import Any

import numpy as np

from locate_tpu_torch.data.datasets import Example


class AsGrainSource:
    """Dataset of the port -> grain RandomAccessDataSource."""

    def __init__(self, dataset):
        self._dataset = dataset

    def __len__(self) -> int:
        return len(self._dataset)

    def __getitem__(self, index: int) -> dict:
        img, label = self._dataset.example(int(index), None)
        return {"image": img, "label": np.int32(label)}


def _to_example(item: Any, resolution: int, channels: int) -> Example:
    if isinstance(item, dict):
        img, label = item["image"], item.get("label", 0)
    elif isinstance(item, tuple) and len(item) == 2:
        img, label = item
    else:
        img, label = item, 0
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(
            f"grain item image must be uint8 HWC, got dtype {img.dtype}"
        )
    if img.shape != (resolution, resolution, channels):
        raise ValueError(
            f"grain item image must already be sized "
            f"({resolution}, {resolution}, {channels}), got {img.shape}; "
            "resize in a grain transform or pre-pack the dataset"
        )
    return img, int(label)


class GrainDataset:
    """grain RandomAccessDataSource -> the port's Dataset protocol.

    `make_input_pipeline` builds its dataset from the config, so a grain
    source goes through `BatchProducer(GrainDataset(src, 64), batch)` and
    `device_prefetch` directly: the protocol is the contract.
    """

    def __init__(self, source, resolution: int, img_channels: int = 3,
                 num_classes: int = 0):
        self._source = source
        self.resolution = resolution
        self.img_channels = img_channels
        self.num_classes = num_classes

    def __len__(self) -> int:
        return len(self._source)

    def example(self, index: int, rng=None) -> Example:
        # rng is intentionally unused: the pipeline's deterministic-resume
        # fast-forward requires example() to never consume the stream RNG.
        return _to_example(
            self._source[int(index)], self.resolution, self.img_channels
        )
