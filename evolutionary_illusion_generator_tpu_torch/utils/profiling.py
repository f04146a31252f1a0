"""Tracing / profiling hooks.

The port of the JAX package's ``utils/profiling.py``: named phase timers
aggregated per generation, plus a ``torch.profiler`` trace context that
writes a Chrome trace JSON (host ops and, on the card, its kernels).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch

__all__ = ["PhaseTimers", "trace", "TRACE_FILE"]

TRACE_FILE = "trace.json"


class PhaseTimers:
    """Accumulates named wall-clock phases; ``summary()`` -> {name: seconds}."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, float]:
        return dict(self.totals)

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """``torch.profiler`` trace into ``log_dir``/``TRACE_FILE`` (no-op when
    falsy); CUDA activity is traced when there is a card."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
