"""Population-sharded generation evaluator.

The port's counterpart of the JAX package's
``parallel/sharded_evaluator.py``: the same chunk pass as
:class:`..evolution.evaluator.GenerationEvaluator`, with each chunk split
over the mesh's entries.  The lifted predictor params and the coordinate
grid are placed once on each distinct device; each entry's shard of the
packed genome tables runs its pass on its entry's device, under
``torch.cuda.device`` of that device (kernel launches and graph captures go
to the current device); the outputs stay on the shards' devices, and only
the small per-candidate outputs come to the host.  The program cache's key
gains the device, so a shard of one shape on one device replays one CUDA
graph (``CapturedPass`` copies a shard in and clones its outputs out).

Across processes (:mod:`.distributed`) each process runs only its own
entries' shards; the small outputs are all-gathered, so every process
assigns the same fitness, and a bulky row (the winner's image and flow
frame) is broadcast from the process that holds it.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from .._device import device_context
from ..evolution.evaluator import EvalConfig, GenerationEvaluator, GenerationOutputs
from ..neat.config import NeatConfig
from .distributed import process_count
from .mesh import Mesh, replicate, shard_leading

__all__ = ["ShardedGenerationEvaluator", "ShardedGenerationOutputs"]


class ShardedGenerationOutputs(GenerationOutputs):
    """:class:`GenerationOutputs` over a mesh whose entries may belong to
    other processes (their shards are ``None`` here).  Reading the small
    outputs and fetching a row are collective: every process calls them
    alike."""

    def __init__(self, chunks, chunk_size: int, n: int, shard_rows: int, mesh: Mesh) -> None:
        super().__init__(chunks, chunk_size, n, shard_rows)
        self.mesh = mesh

    def _keys(self):  # every process holds an entry
        return list(next(s for s in self._chunks[0] if s is not None).keys())

    def _pieces(self, keys):
        if not self.mesh.spans_processes:
            return super()._pieces(keys)
        import torch.distributed as dist

        mine = {(c, s): {k: shard[k].cpu().numpy() for k in keys}
                for c, chunk in enumerate(self._chunks)
                for s, shard in enumerate(chunk) if shard is not None}
        gathered = [None] * process_count()
        dist.all_gather_object(gathered, mine)
        every = {}
        for part in gathered:
            every.update(part)
        return [every[(c, s)] for c in range(len(self._chunks))
                for s in range(len(self._chunks[c]))]

    def fetch(self, key: str, i: int) -> np.ndarray:
        """Host copy of one candidate's row, broadcast from the process
        that holds it."""
        if not self.mesh.spans_processes:
            return super().fetch(key, i)
        import torch.distributed as dist

        c, s, r = self._locate(i)
        shard = self._chunks[c][s]
        box = [shard[key][r].cpu().numpy() if shard is not None else None]
        dist.broadcast_object_list(box, src=int(self.mesh.processes.flat[s]))
        return box[0]


class ShardedGenerationEvaluator(GenerationEvaluator):
    """GenerationEvaluator whose chunk pass is split over a mesh."""

    def __init__(self, cfg: EvalConfig, params, neat_cfg: NeatConfig, mesh: Mesh) -> None:
        local = mesh.local_devices()
        if not local:
            raise ValueError(f"{mesh} holds no entry of this process")
        super().__init__(cfg, params, neat_cfg, device=local[0])
        self.mesh = mesh
        # population buckets must divide evenly over the mesh
        self._pop_min = max(8, mesh.size)
        # the lifted frozen weights and the grid, once per device
        self._replicas = replicate(self._frozen(), mesh)

    def _run_chunk(self, key: tuple, part: Dict[str, np.ndarray]) -> List[Dict]:
        n = self.mesh.size
        pop_bucket = len(part["weights"])
        if pop_bucket % n:
            raise ValueError(
                f"chunk {pop_bucket} must divide over {n} devices "
                f"(set microbatch to a multiple of the mesh size)")
        shards = {k: shard_leading(v, self.mesh) for k, v in part.items()}
        outs = []
        for i, dev in enumerate(self.mesh.devices.flat):
            if not self.mesh.is_local(i):
                outs.append(None)
                continue
            inputs = {k: pieces[i] for k, pieces in shards.items()}
            shard_key = (dev,) + key
            with device_context(dev):
                outs.append(self._programs.run(shard_key, self._live(shard_key), inputs))
        return outs

    def _outputs(self, pieces, chunk: int, n: int) -> GenerationOutputs:
        return ShardedGenerationOutputs(pieces, chunk, n, chunk // self.mesh.size, self.mesh)
