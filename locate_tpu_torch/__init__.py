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
"""

from locate_tpu_torch.config import Config, ModelConfig, get_config  # noqa: F401
from locate_tpu_torch.train.loop import train  # noqa: F401

__all__ = ["Config", "ModelConfig", "get_config", "train"]
