"""Multi-process initialization.

The port's counterpart of the JAX package's ``parallel/distributed.py``
(``jax.distributed.initialize`` with environment fallbacks).  What crosses
processes in the port is small and lives on the host: each process
evaluates its own mesh entries' shards on its own devices, and the
sharded evaluator all-gathers the per-candidate vectors, masks and scores
(a few KB a generation) and broadcasts the one bulky row the artifacts
need.  So the process group is ``gloo``, over TCP, which also lets two
processes share one card (NCCL cannot form a communicator of two ranks on
one GPU).  Call :func:`initialize_distributed` on every process before
building a mesh; :func:`..parallel.mesh.make_mesh` then spans the
processes.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional

__all__ = ["initialize_distributed", "process_count", "process_index"]

TIMEOUT = timedelta(seconds=300)


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    """The number of processes (1 without a process group)."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """``torch.distributed.init_process_group("gloo")`` with the JAX
    function's environment fallbacks.

    Args default from JAX_COORDINATOR_ADDRESS (``host:port`` of rank 0,
    which listens there) / JAX_NUM_PROCESSES / JAX_PROCESS_ID.  Returns
    False (no-op) when no address is set: single-process runs need
    nothing.  Unlike JAX on a TPU pod nothing detects the cluster, so the
    process count must be given.  Every collective times out after
    ``TIMEOUT``, so a lost peer fails a run instead of hanging it.
    """
    coordinator_address = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if coordinator_address is None:
        return False
    num_processes = num_processes or int(os.environ.get("JAX_NUM_PROCESSES", "0"))
    process_id = (process_id if process_id is not None
                  else int(os.environ.get("JAX_PROCESS_ID", "0")))
    if num_processes < 1:
        raise ValueError("initialize_distributed needs num_processes (or JAX_NUM_PROCESSES)")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} outside 0..{num_processes - 1}")
    import torch.distributed as dist

    init = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group("gloo", init_method=init, world_size=num_processes,
                            rank=process_id, timeout=TIMEOUT)
    return True
