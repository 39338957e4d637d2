"""Process groups, counterpart of `locate_tpu/parallel/distributed.py`.

One process per device: a rank is a device. `initialize_from_env()` joins
the processes of a job into one `torch.distributed` group (NCCL on the
card, gloo on the CPU) from the JAX package's variables
(`COORDINATOR_ADDRESS`, `NUM_PROCESSES`, `PROCESS_ID`) or `torchrun`'s
(`MASTER_ADDR` / `MASTER_PORT`, `WORLD_SIZE`, `RANK`, `LOCAL_RANK`). In a
single process it does nothing and returns False, as the JAX function
does. A failed initialization raises: nothing falls back to one process.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch
import torch.distributed as dist


def _env_int(*names: str) -> Optional[int]:
    for name in names:
        if os.environ.get(name, "") != "":
            return int(os.environ[name])
    return None


def _address() -> Optional[str]:
    """host:port of the coordinator, from COORDINATOR_ADDRESS or
    MASTER_ADDR and MASTER_PORT."""
    if os.environ.get("COORDINATOR_ADDRESS"):
        return os.environ["COORDINATOR_ADDRESS"]
    if os.environ.get("MASTER_ADDR"):
        return f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    return None


def initialize_from_env(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> bool:
    """Join the default process group from the arguments or the
    environment; returns True if this process is in a group. `backend`
    defaults to "nccl" where CUDA is available and "gloo" elsewhere; an
    NCCL rank first selects its card, `cuda:LOCAL_RANK` (the process
    index where LOCAL_RANK is unset).
    Calling it again in a process already in a group returns True."""
    if dist.is_initialized():
        return True
    coordinator_address = coordinator_address or _address()
    if num_processes is None:
        num_processes = _env_int("NUM_PROCESSES", "WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("PROCESS_ID", "RANK")
    if not coordinator_address and num_processes in (None, 1):
        return False  # single-process run
    if not coordinator_address or num_processes is None or process_id is None:
        raise ValueError(
            "a process group needs the coordinator's address, the number of processes "
            "and this process's index (COORDINATOR_ADDRESS, NUM_PROCESSES, PROCESS_ID or "
            f"MASTER_ADDR/MASTER_PORT, WORLD_SIZE, RANK); got {coordinator_address!r}, "
            f"{num_processes!r}, {process_id!r}")
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    local_rank = _env_int("LOCAL_RANK")
    local_rank = process_id if local_rank is None else local_rank
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("backend 'nccl' needs a card, and torch.cuda.is_available() "
                               "is False; pass backend='gloo' for CPU ranks")
        torch.cuda.set_device(local_rank)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return True


def world_size() -> int:
    """The processes of the job: the group's size, else the launcher's
    WORLD_SIZE / NUM_PROCESSES, else 1."""
    if dist.is_initialized():
        return dist.get_world_size()
    return _env_int("WORLD_SIZE", "NUM_PROCESSES") or 1


def local_device(device: Union[str, torch.device]) -> torch.device:
    """`device` with a CUDA index: a bare "cuda" is this rank's card (the
    one `initialize_from_env` selected), so every tensor, generator and
    kernel launch of a rank lands on its own card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device
