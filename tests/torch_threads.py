"""Thread guards for the port's CPU tests."""

import contextlib
import functools

import torch
from threadpoolctl import threadpool_limits


def on_one_thread(test):
    """Run `test` with one intra-op thread, the count restored after it.

    Two CPU calls of the same bf16 or f32 plain version (matmuls, sums)
    are bitwise equal only when both split their reductions the same
    way, and PyTorch's intra-op split follows the thread count, which
    other test files of an xdist worker change and a loaded host makes
    uneven."""

    @functools.wraps(test)
    def run(*args, **kwargs):
        with few_threads(1):
            return test(*args, **kwargs)

    return run


@contextlib.contextmanager
def few_threads(n: int):
    """PyTorch's intra-op threads and the BLAS pools' (numpy, scipy) held
    to `n` inside the block, restored after it. The eval's host metrics
    (a 1024x1024 sqrtm, covariances) gain nothing from more threads, and
    each xdist worker's full-size pools oversubscribe the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        with threadpool_limits(limits=n):
            yield
    finally:
        torch.set_num_threads(threads)
