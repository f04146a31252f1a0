"""Mesh construction and sharding descriptions.

The port's counterpart of the JAX package's ``parallel/mesh.py``.  The
population is the primary scale axis: every stage of the generation pass
is batched over candidates with no cross-candidate dataflow, so the
population splits over the mesh's entries, each entry runs its shard's pass
on its own device, and only the small per-candidate outputs (vectors,
masks, scores) come back to the host.  The frozen predictor's weights are
placed on each device once.

A :class:`Mesh` is a numpy object array of ``torch.device``\\ s with axis
names, as ``jax.sharding.Mesh`` is of JAX devices.  An entry may repeat a
device: ``make_mesh(devices=["cpu"] * 8)`` is eight logical shards on the
CPU, and ``make_mesh(devices=["cuda:0"] * 2)`` two on one card.  That is the
counterpart of the JAX tests' virtual host devices
(``--xla_force_host_platform_device_count=8``): the split, the per-shard
passes and the gathers all run, one shard after another; only overlap
across devices cannot show.  After :func:`..parallel.distributed.
initialize_distributed`, :func:`make_mesh` spans the processes: each
entry records the process that holds it (:attr:`Mesh.processes`), and a
process runs only its own entries.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import indexed_device, resolve_device
from .distributed import process_count, process_index

__all__ = [
    "Mesh",
    "NamedSharding",
    "make_mesh",
    "population_sharding",
    "replicate",
    "replicated_sharding",
    "shard_leading",
]

POP_AXIS = "pop"


def _object_array(items) -> np.ndarray:
    out = np.empty(len(items), dtype=object)
    out[:] = list(items)
    return out


class Mesh:
    """Devices (an object array of ``torch.device``) with axis names;
    ``processes`` (same shape, default this process) says which process
    holds each entry."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 processes: Optional[np.ndarray] = None) -> None:
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-d devices for axes {self.axis_names}")
        if processes is None:
            processes = np.full(self.devices.shape, process_index())
        self.processes = np.asarray(processes, dtype=np.int64).reshape(self.devices.shape)

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def spans_processes(self) -> bool:
        return bool((self.processes != process_index()).any())

    def is_local(self, i: int) -> bool:
        """Whether flat entry ``i`` is this process's."""
        return int(self.processes.flat[i]) == process_index()

    def local_devices(self) -> List[torch.device]:
        """This process's distinct devices, in entry order."""
        out: List[torch.device] = []
        for i, dev in enumerate(self.devices.flat):
            if self.is_local(i) and dev not in out:
                out.append(dev)
        return out

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def _all_devices(devices) -> Tuple[List[torch.device], List[int]]:
    """This process's devices (``devices``, else every CUDA device, which
    raises without a card), then, in a multi-process run, every process's,
    gathered in rank order; with the process of each."""
    if devices is None:
        resolve_device("cuda")  # raises without a card
        local = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        local = [indexed_device(d) for d in devices]
    if process_count() == 1:
        return local, [process_index()] * len(local)
    import torch.distributed as dist

    gathered = [None] * process_count()
    dist.all_gather_object(gathered, [str(d) for d in local])
    devs, procs = [], []
    for rank, names in enumerate(gathered):
        devs += [torch.device(name) for name in names]
        procs += [rank] * len(names)
    return devs, procs


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """1-D mesh over up to ``n_devices`` devices, axis name "pop".

    ``devices`` (default: every CUDA device) may repeat a device, one
    logical shard per entry (module docstring).  In a multi-process run
    they are this process's, and the mesh holds every process's."""
    devs, procs = _all_devices(devices)
    if n_devices is not None:
        if len(devs) < n_devices:
            raise ValueError(f"need {n_devices} devices, have {len(devs)}")
        devs, procs = devs[:n_devices], procs[:n_devices]
    return Mesh(_object_array(devs), (POP_AXIS,), np.asarray(procs))


class NamedSharding(NamedTuple):
    """How a tensor's leading axis is placed on ``mesh``: split over the
    axes of ``spec`` (one piece per entry), or replicated (``spec == ()``)."""

    mesh: Mesh
    spec: Tuple[str, ...]


def population_sharding(mesh: Mesh) -> NamedSharding:
    """Leading axis split over the population mesh axis."""
    return NamedSharding(mesh, (POP_AXIS,))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def shard_leading(x, mesh: Mesh) -> List[Optional[torch.Tensor]]:
    """``x``'s leading axis split into one piece per mesh entry (flat
    order), each on its entry's device; ``None`` for another process's
    entry.  The length must divide by the mesh size."""
    n = mesh.size
    x = torch.as_tensor(x)
    if x.shape[0] % n:
        raise ValueError(f"leading axis {x.shape[0]} does not divide over {n} entries")
    rows = x.shape[0] // n
    return [x[i * rows:(i + 1) * rows].to(dev) if mesh.is_local(i) else None
            for i, dev in enumerate(mesh.devices.flat)]


def _tree_to(tree, device: torch.device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to(v, device) for v in tree)
    return tree


def replicate(tree, mesh: Mesh) -> Dict[torch.device, object]:
    """A copy of ``tree`` (nested dicts, lists and tuples of tensors) on each
    of this process's distinct devices, keyed by device; a tree already on
    a device is that device's copy as it is."""
    return {dev: _tree_to(tree, dev) for dev in mesh.local_devices()}
