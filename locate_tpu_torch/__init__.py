"""locate-tpu on PyTorch and CUDA: the port of the JAX package `locate_tpu`
to an NVIDIA H100, one slice at a time (ROADMAP.md).

This slice is the generator's sampling path. Its modules keep the JAX
package's layout (`config`, `ops/`, `nn/`, `models/`, `io/`, `cli`); the
TPU kernels on the path are CUDA C++ kernels in `csrc/`, built at first
use. The package imports neither JAX nor `locate_tpu`. Entry points run on
the card unless the caller passes `device="cpu"`.
"""

from locate_tpu_torch.config import Config, ModelConfig, get_config  # noqa: F401

__all__ = ["Config", "ModelConfig", "get_config"]
