"""locate-tpu on PyTorch and CUDA: the port of the JAX package `locate_tpu`
to an NVIDIA H100, one slice at a time (ROADMAP.md).

Ported so far: the generator's sampling path, the alternating GAN train
step, the input path (`data/`: datasets, packed shards, the native
loader, the producer thread and a pinned-memory device prefetch), and
the train loop with checkpoint and resume (`train()`, `train/loop.py`;
`io/checkpoint.py`: the port's own format, bitwise resume, async saves
that survive a SIGKILL), sampling and export from a checkpoint. The
modules keep the JAX package's layout (`config`, `data/`, `ops/`, `nn/`,
`models/`, `objectives/`, `train/`, `io/`, `utils/`, `cli`); the TPU
kernels on those paths are CUDA C++ kernels in `csrc/`, built at first
use. The package imports neither JAX nor `locate_tpu`. Entry points run
on the card unless the caller passes `device="cpu"`.

The exports below load at first use (a module `__getattr__`), so that
importing a submodule, such as the kernel ops for `io/export.py`'s
`load_compiled`, does not pull in the model and train code.
"""

import importlib

_EXPORTS = {"Config": "config", "ModelConfig": "config", "get_config": "config",
            "train": "train.loop"}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
    globals()[name] = value
    return value
