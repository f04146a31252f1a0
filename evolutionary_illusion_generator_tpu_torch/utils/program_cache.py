"""The chunk pass as a CUDA graph: captured once per program key, then replayed.

The port's counterpart of the JAX evaluator's ``jax.jit`` chunk program and
its exported-program cache (the JAX package's ``utils/program_cache.py``),
which trace the pass once per bucket key and replay it.  Here the pass runs
eagerly, and one generation at the main path's shape launches thousands of
small kernels.  :class:`ProgramCache` keeps one ``torch.cuda.CUDAGraph`` per
key (pop bucket, level and width buckets, activation set: the parts of the
JAX cache key that can change inside one evaluator, whose cache this is):

* the first call of a key runs the pass eagerly: that run is the warm-up,
  which builds the kernels and lets cuDNN pick its algorithms;
* the next call captures the pass on static input buffers, into which each
  chunk's packed tables are then copied, and from then on the graph is
  replayed; each chunk's outputs are cloned out of the graph's buffers, so
  a later chunk cannot overwrite an earlier chunk's results;
* the buckets only grow, so when a key's level and width buckets or its
  activation set is no longer the evaluator's, its graph (and the memory
  pool it holds) is dropped.

A capture that fails raises, naming the op that broke it: the pass must
stay capturable (no host synchronisation, no host data copied in), and a
silent eager fallback would hide exactly that.  The kernel wrappers count
only the launches they make themselves
(:func:`..ops.convlstm_gates.count_launch`): a kernel recorded during a
capture goes on the wrapper's ``captured``, and a replay counts nothing.
A graph keeps the wrappers' kernels it recorded (:attr:`CapturedPass.recorded`),
which run once at each replay; a profiler trace of a replay shows them.

``EIGEN_PROGRAM_CACHE=0`` (the JAX knob's name) turns it off, as do
``EvalConfig.program_cache=False`` and ``debug_nans``.  On the CPU it has
no effect: the pass runs eagerly.  The persistent ``.build/`` of
:mod:`.._build` plays the part of the JAX package's compilation cache.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Hashable, List

import torch

__all__ = ["CapturedPass", "ProgramCache", "counted_wrappers", "program_cache_enabled"]


def program_cache_enabled() -> bool:
    """False when the environment sets ``EIGEN_PROGRAM_CACHE=0``."""
    return os.environ.get("EIGEN_PROGRAM_CACHE", "1") != "0"


def counted_wrappers() -> List[Callable]:
    """Every kernel wrapper of the port that counts its launches (and the
    kernels it records into a graph)."""
    from ..ops import (
        convlstm_bisect,
        convlstm_fused,
        convlstm_gates,
        convlstm_narrow,
        prednet_units,
    )

    return [convlstm_gates.fused_lstm_gates, convlstm_narrow.narrow_convlstm_layer,
            convlstm_fused.fused_convlstm_layer_multi, convlstm_fused.fused_convlstm_layer,
            prednet_units.ahat_error_unit, prednet_units.a_unit,
            *convlstm_bisect.RUNGS.values()]


class CapturedPass:
    """``fn`` captured as a CUDA graph on copies of ``inputs`` (a dict of
    CUDA tensors); calling it with tensors of the same shapes replays it.
    ``recorded`` maps each kernel wrapper the capture reached to the number
    of its kernels the graph runs at each replay."""

    def __init__(self, fn: Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]],
                 inputs: Dict[str, torch.Tensor]) -> None:
        self.inputs = {k: v.clone() for k, v in inputs.items()}
        wrappers = counted_wrappers()
        before = [w.captured for w in wrappers]
        self.graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(self.graph):
                self.outputs = fn(self.inputs)
        except Exception as err:
            raise RuntimeError(f"CUDA graph capture of the chunk pass failed: {err}") from err
        self.recorded = {w.__name__: w.captured - n for w, n in zip(wrappers, before)
                         if w.captured != n}

    def __call__(self, inputs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        for k, v in inputs.items():
            self.inputs[k].copy_(v)
        self.graph.replay()
        return {k: v.clone() for k, v in self.outputs.items()}


class ProgramCache:
    """One :class:`CapturedPass` of ``fn`` per key, after one eager warm-up
    run of that key; ``enabled=False`` runs ``fn`` eagerly every time.
    ``replays`` counts the passes run as a graph replay."""

    def __init__(self, fn: Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]],
                 enabled: bool) -> None:
        self.fn = fn
        self.enabled = enabled
        self.graphs: Dict[Hashable, object] = {}  # key -> CapturedPass, or None once warm
        self.replays = 0

    def run(self, key: Hashable, live: Callable[[Hashable], bool],
            inputs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The pass on ``inputs`` under ``key``; first drops the graphs whose
        key ``live`` says can no longer occur."""
        if not self.enabled:
            return self.fn(inputs)
        for old in [k for k in self.graphs if not live(k)]:
            del self.graphs[old]
        if key not in self.graphs:
            self.graphs[key] = None
            return self.fn(inputs)
        if self.graphs[key] is None:
            self.graphs[key] = CapturedPass(self.fn, inputs)
        self.replays += 1
        return self.graphs[key](inputs)
