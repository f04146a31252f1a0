"""Tracing / profiling hooks.

The port of the JAX package's ``utils/profiling.py``: named phase timers
aggregated per generation, plus a ``torch.profiler`` trace context that
writes a Chrome trace JSON (host ops and, on the card, its kernels), and
the aggregation of a finished profile into time per kernel name
(:func:`device_events`, :func:`kernel_table`).
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional, Tuple

import torch

__all__ = ["PORT_KERNELS", "PhaseTimers", "by_wrapper", "card_line", "device_events",
           "kernel_table", "trace", "TRACE_FILE"]

TRACE_FILE = "trace.json"

#: The rollout's kernel wrappers by the names their kernels carry in a trace
#: (the narrow layer has two bodies: csrc/convlstm_narrow.cu's mma.sync
#: kernel and csrc/convlstm_narrow_hopper.cu's persistent one; the gate
#: convs two: csrc/convlstm_narrow.cu's mma.sync kernel and
#: csrc/gate_convs_wgmma.cu's; the gate kernel three, csrc/lstm_gates.cu's
#: scalar, vector and slab kernels; each unit several:
#: csrc/prednet_units.cu's mma.sync and direct kernels,
#: csrc/prednet_units_wgmma.cu's wgmma and im2col kernels).
PORT_KERNELS = {
    "narrow_convlstm_layer": ("convlstm_narrow_kernel", "convlstm_narrow_persistent_kernel"),
    "gate_convs": ("gate_convs_kernel", "gate_convs_wgmma_kernel"),
    "fused_convlstm_layer_multi": ("convlstm_fused_wgmma_kernel",),
    "fused_lstm_gates": ("lstm_gates_kernel", "lstm_gates_vector_kernel", "lstm_gates_slab_kernel"),
    "ahat_error_unit": ("ahat_error_unit_kernel", "ahat_error_unit_wgmma_kernel"),
    "a_unit": ("a_unit_kernel", "a_unit_wgmma_kernel", "a_unit_im2col_kernel"),
}
# pieces of the names of library conv kernels (cuDNN's implicit GEMMs, its
# direct and FFT convs, PyTorch's own im2col conv), not of cuBLAS's GEMMs; a
# port kernel's name is never counted as one
_LIBRARY_CONV = ("implicit_gemm", "fprop", "dgrad", "wgrad", "cudnn", "conv2d", "convolve",
                 "fft", "im2col")


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


def device_events(prof, device: torch.device) -> List[Tuple[str, int, float]]:
    """(name, count, microseconds) per name of what ran on ``device`` in a
    finished ``torch.profiler`` run, longest first: the card's kernels and
    their device time, or on the CPU its operators and their self time (so
    an operator nested in another is not counted twice)."""
    cuda = torch.device(device).type == "cuda"
    kind = torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU
    rows = [(e.key, e.count, e.self_device_time_total if cuda else e.self_cpu_time_total)
            for e in prof.key_averages() if e.device_type == kind]
    return sorted(rows, key=lambda r: -r[2])


def kernel_table(events: List[Tuple[str, int, float]], wall_s: float,
                 top: Optional[int] = None) -> Tuple[List[str], Dict[str, float]]:
    """Printable lines of :func:`device_events` (count, ms and share of the
    device time per name, the ``top`` longest), and the totals: the device's
    busy time in the profiled window of ``wall_s`` seconds, its busy share
    and the number of launches."""
    busy_us = sum(us for _, _, us in events)
    lines = [f"{'name':70s} {'count':>7s} {'ms':>10s} {'share':>7s}"]
    for name, count, us in events[:top]:
        lines.append(f"{name[:70]:70s} {count:7d} {us / 1e3:10.3f} "
                     f"{us / max(busy_us, 1e-9):7.2%}")
    totals = {"busy_s": busy_us / 1e6, "wall_s": wall_s,
              "busy_share": busy_us / 1e6 / wall_s if wall_s > 0 else float("nan"),
              "launches": sum(count for _, count, _ in events)}
    return lines, totals


def by_wrapper(events: List[Tuple[str, int, float]]) -> Dict[str, Dict[str, float]]:
    """:func:`device_events` summed by the port's kernel wrappers
    (:data:`PORT_KERNELS`), plus ``"library convs"``: the library's conv
    kernels (cuDNN, PyTorch's own) among them, with their names.
    {name: {"count", "ms"}}."""
    out = {name: {"count": 0, "ms": 0.0} for name in (*PORT_KERNELS, "library convs")}
    out["library convs"]["names"] = []
    for name, count, us in events:
        w = next((w for w, keys in PORT_KERNELS.items() if any(k in name for k in keys)), None)
        if w is None and any(key in name.lower() for key in _LIBRARY_CONV):
            w = "library convs"
            out[w]["names"].append(name)
        if w is not None:
            out[w]["count"] += count
            out[w]["ms"] += us / 1e3
    return out


def card_line(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them (the first card's), for
    a CUDA ``device``; ``"cpu"`` for the CPU."""
    if torch.device(device).type != "cuda":
        return "cpu"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]
