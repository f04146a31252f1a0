"""Multi-process initialization, and the host-side exchanges of the paths
that span processes.

The port's counterpart of the JAX package's ``parallel/distributed.py``
(``jax.distributed.initialize`` with environment fallbacks).  Each process
runs its own mesh entries on its own devices; what crosses processes goes
through host copies:

* the sharded evaluator all-gathers the per-candidate vectors, masks and
  scores (a few KB a generation) and broadcasts the one bulky row the
  artifacts need;
* the data-parallel train step gathers every entry's float32 gradients and
  loss and adds them in entry order (:func:`gather_entries`,
  :func:`sum_in_order`), so every process takes the same Adam step as one
  process running every entry;
* the spatial rollout trades its bands' edge rows with the neighbouring
  bands' processes (:func:`exchange`) and takes the int8 activation scale's
  maximum over them (:func:`all_max`); the pipelined rollout sends each
  tick's stage messages (:func:`exchange`).

So the process group is ``gloo``, over TCP: its point-to-point operations
take host tensors only, and it lets two processes share one card (NCCL
cannot form a communicator of two ranks on one GPU).  Every collective and
every wait times out after ``TIMEOUT``, so a lost peer fails a run instead
of hanging it.  Call :func:`initialize_distributed` on every process
before building a mesh; :func:`..parallel.mesh.make_mesh` then spans the
processes.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import List, Optional, Sequence, Tuple

import torch

__all__ = ["all_max", "exchange", "gather_entries", "initialize_distributed", "new_group",
           "process_count", "process_index", "sum_in_order"]

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


def _host(x: torch.Tensor) -> torch.Tensor:
    return x.detach().to("cpu").contiguous()


def exchange(sends: Sequence[Tuple[torch.Tensor, int, int]],
             recvs: Sequence[Tuple[Sequence[int], torch.dtype, int, int]]) -> List[torch.Tensor]:
    """Point-to-point messages of host copies: each ``(tensor, dst, tag)``
    of ``sends`` goes to process ``dst``, and each ``(shape, dtype, src,
    tag)`` of ``recvs`` is received from ``src``; returns the received host
    tensors in the order of ``recvs``.  All are posted before any is
    waited on, so two processes that trade rows do not block each other;
    a tag tells apart the messages of one exchange between two
    processes."""
    import torch.distributed as dist

    works, out = [], []
    for x, dst, tag in sends:
        works.append(dist.isend(_host(x), dst, tag=tag))
    for shape, dtype, src, tag in recvs:
        buf = torch.empty(tuple(shape), dtype=dtype)
        works.append(dist.irecv(buf, src, tag=tag))
        out.append(buf)
    for work in works:
        work.wait(TIMEOUT)
    return out


def gather_entries(tensors: Sequence[Optional[torch.Tensor]], owners: Sequence[int],
                   shape: Sequence[int], dtype: torch.dtype) -> List[torch.Tensor]:
    """Every mesh entry's tensor on every process, as host tensors in entry
    order: ``tensors[i]`` is entry ``i``'s on the process that holds it
    (``owners[i]``) and ``None`` elsewhere; all have ``shape`` and
    ``dtype``.  One broadcast per entry, from its owner; a process's own
    entries come back as host copies of its tensors."""
    import torch.distributed as dist

    out = []
    for x, owner in zip(tensors, owners):
        buf = _host(x) if owner == process_index() else torch.empty(tuple(shape), dtype=dtype)
        if process_count() > 1:
            dist.broadcast(buf, src=int(owner))
        out.append(buf)
    return out


def sum_in_order(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """``parts[0] + parts[1] + ...``, added in list order: floating-point
    sums depend on their order, and a ring all-reduce would take another."""
    total = parts[0]
    for x in parts[1:]:
        total = total + x
    return total


def new_group(ranks: Sequence[int]):
    """``torch.distributed.new_group`` over ``ranks`` with ``TIMEOUT``.
    Every process must call it, in the same order, members or not."""
    import torch.distributed as dist

    return dist.new_group(sorted(set(int(r) for r in ranks)), timeout=TIMEOUT)


def all_max(x: torch.Tensor, group=None) -> torch.Tensor:
    """The elementwise maximum of ``x`` over the processes of ``group``
    (default: all), on ``x``'s device.  A maximum is exact, so the order in
    which it is taken cannot change it."""
    import torch.distributed as dist

    buf = _host(x).clone()
    dist.all_reduce(buf, op=dist.ReduceOp.MAX, group=group)
    return buf.to(x.device)
