"""Multi-process scaffolding: the process group from the launcher's
environment, and each process's share of the data (JAX counterpart:
parallel/multihost.py).

The port runs one process per card. A launcher (`torchrun`, or a job
scheduler that sets the same variables) describes the run with
MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK and LOCAL_RANK, where JAX reads
JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES and JAX_PROCESS_ID.
`initialize()` joins that run's process group; each process then keeps
its own strided share of the windows (`process_shard`).

Everything is a no-op on a single process: `initialize()` returns False
and creates no process group, `process_shard` is the identity.

JAX's `global_batch` assembles one global array from every process's
local shard. PyTorch has no such array: each rank keeps its local batch,
and the data-parallel step (`train/steps.py` with a mesh) makes the global
batch's step from the local ones, its BatchNorm statistics and its
gradient all-reduced over the group.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


def launched() -> bool:
    """Whether a launcher described a run of more than one process."""
    return int(os.environ.get("WORLD_SIZE", "1")) > 1


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> bool:
    """Join the process group the launcher's environment describes.

    Arguments fall back to MASTER_ADDR:MASTER_PORT, WORLD_SIZE and RANK. A
    run of one process, or one that no environment describes, returns
    False and initialises nothing. The group runs NCCL where a card is
    present and gloo elsewhere. From the environment the group joins by
    `env://`, so it finds the store a launcher such as torchrun keeps; a
    coordinator named here is reached by `tcp://`."""
    init_method = f"tcp://{coordinator_address}" if coordinator_address else "env://"
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and "RANK" in os.environ:
        process_id = int(os.environ["RANK"])

    if not coordinator_address or not num_processes or num_processes <= 1:
        return False
    if process_id is None:
        raise ValueError("a multi-process run needs this process's rank (RANK)")
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes,
                            rank=process_id)
    return True


def _rank_and_world() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def process_shard_indices(n_total: int, process_index: Optional[int] = None,
                          process_count: Optional[int] = None) -> np.ndarray:
    """Indices of the windows THIS process should load: p, p+P, p+2P, ...
    truncated to a common length, so every process holds the same count
    (the data-parallel step needs equal local batches). With P = 1 this is
    every index. p and P default to this process's rank and the world
    size of the process group (0 and 1 without one)."""
    rank, world = _rank_and_world()
    p = rank if process_index is None else process_index
    P = world if process_count is None else process_count
    if not 0 <= p < P:
        raise ValueError(f"process_index {p} not in [0, {P})")
    per_host = n_total // P
    if per_host == 0:
        raise ValueError(f"{n_total} windows cannot feed {P} processes")
    return np.arange(p, p + per_host * P, P)


def process_shard(*arrays, process_index=None, process_count=None):
    """Slice each array's leading axis to this process's strided shard."""
    idx = process_shard_indices(arrays[0].shape[0], process_index, process_count)
    out = tuple(a[idx] for a in arrays)
    return out[0] if len(out) == 1 else out
