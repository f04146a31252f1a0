"""What one step of the plain route costs at the ``pop256_v5e8`` frame.

Runs one predictor step (``rollout_flow_frames(repeat=1, extension=1,
use_pallas=False)``, float32, the colour stack's bundled weights) on
(2, 960, 1280, 3) uint8-quantised noise, unsharded and as the spatial
rollout's two 480-row bands (``make_spatial_rollout`` on a (1, 2) mesh
that repeats the device), and reports for each:

- the step's seconds (CUDA-synchronised) and its peak device memory
  (``torch.cuda.max_memory_allocated`` over the step; ``memory_stats``'s
  peak reserved bytes beside it);
- every conv of the step (``F.conv2d``): its input and weight shapes, its
  padding, its CUDA-event milliseconds and the device memory it takes
  beyond its inputs (the peak during the call over what was allocated
  before it: output plus cuDNN's workspace);
- the ten kernels with the most device time under torch.profiler, and
  how many of its kernels are cuDNN's FFT ones (``fft`` or a complex GEMM,
  ``cf32``, in the name).

``--variants`` adds the unsharded step under other settings, each against
the default in the same run: ``benchmark`` (``cudnn.benchmark=True``),
``deterministic`` (``cudnn.deterministic=True``).  Then the unsharded
step's slowest conv alone, computed in other ways (:func:`conv_variants`),
and last the 22-step rollout of each (seconds and peak memory of a warm
run).  It prints one
JSON line per run::

    python3 -m evolutionary_illusion_generator_tpu_torch.scripts.plain_route_profile
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time
from collections import defaultdict
from typing import List, Optional

import torch
import torch.nn.functional as F

__all__ = ["SHAPE", "profile_step", "main"]

SHAPE = (2, 960, 1280, 3)


@contextlib.contextmanager
def _conv_timer(rows: list):
    """Times every ``F.conv2d`` inside the block with CUDA events, and the
    device memory each takes beyond what was allocated before it."""
    conv2d = F.conv2d

    def timed(x, w, *args, **kwargs):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        y = conv2d(x, w, *args, **kwargs)
        end.record()
        torch.cuda.synchronize()
        rows.append({"x": tuple(x.shape), "w": tuple(w.shape), "dtype": str(x.dtype)[6:],
                     "padding": kwargs.get("padding", args[2] if len(args) > 2 else 0),
                     "channels_last": x.is_contiguous(memory_format=torch.channels_last),
                     "ms": start.elapsed_time(end),
                     "extra_gib": (torch.cuda.max_memory_allocated() - before) / 2**30})
        return y

    F.conv2d = timed
    try:
        yield rows
    finally:
        F.conv2d = conv2d


def profile_step(run, label: str) -> dict:
    """One call of ``run`` (a step) warm, timed, its convs listed, then
    profiled; returns the record printed for it."""
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        run()  # warm: cuDNN's plans, the allocator's pool
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        run()
        torch.cuda.synchronize()
        seconds = time.time() - t0
        peak = torch.cuda.max_memory_allocated()
        reserved = torch.cuda.memory_stats().get("reserved_bytes.all.peak", 0)
        convs: List[dict] = []
        with _conv_timer(convs):
            run()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            run()
            torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    top = sorted(((e.key, [e.self_device_time_total / 1e3, e.count]) for e in kernels),
                 key=lambda kv: -kv[1][0])[:10]
    by_shape = defaultdict(lambda: [0.0, 0, 0.0])
    for c in convs:
        k = f"x{c['x']} w{c['w']} pad {c['padding']} {c['dtype']}"
        by_shape[k][0] += c["ms"]
        by_shape[k][1] += 1
        by_shape[k][2] = max(by_shape[k][2], c["extra_gib"])
    slowest = max(convs, key=lambda c: c["ms"])
    fft = sum(e.count for e in kernels if "fft" in e.key.lower() or "cf32" in e.key.lower())
    record = {
        "run": label, "seconds": seconds, "peak_gib": peak / 2**30, "fft_kernels": fft,
        "slowest": [slowest["x"], slowest["w"]],
        "peak_reserved_gib": reserved / 2**30,
        "conv_ms": sum(c["ms"] for c in convs), "convs": len(convs),
        "convs_by_shape": {k: {"ms": v[0], "calls": v[1], "max_extra_gib": v[2]}
                           for k, v in sorted(by_shape.items(), key=lambda kv: -kv[1][0])},
        "top_kernels_ms": {name: {"ms": v[0], "launches": v[1]} for name, v in top},
    }
    print(f"[plain_route_profile] {json.dumps(record)}", flush=True)
    return record


def conv_variants(x, w, iters: int = 3) -> List[dict]:
    """One float32 3x3 SAME conv of NCHW ``x`` (a channels-last view, as
    ``model._conv`` passes it) with ``w``, computed in other ways, each
    timed with CUDA events (``iters`` calls after a warm one), with the
    device memory it takes beyond its inputs and its largest gap to the
    first way."""
    def halves():
        xp = F.pad(x, (1, 1, 1, 1))
        mid = x.shape[2] // 2
        return torch.cat([F.conv2d(xp[:, :, :mid + 2], w), F.conv2d(xp[:, :, mid:], w)], dim=2)

    def no_cudnn():
        with torch.backends.cudnn.flags(enabled=False):
            return F.conv2d(x, w, padding=1)

    xc, wc = x.contiguous(), w.contiguous(memory_format=torch.channels_last)
    ways = {
        "as the port calls it (channels-last view, padding=1)": lambda: F.conv2d(x, w, padding=1),
        "explicit padding": lambda: F.conv2d(F.pad(x, (1, 1, 1, 1)), w),
        "contiguous NCHW input": lambda: F.conv2d(xc, w, padding=1),
        "channels-last input and weight": lambda: F.conv2d(x, wc, padding=1),
        "cuDNN off": no_cudnn,
        "two halves of the height": halves,
    }
    rows, ref = [], None
    with torch.inference_mode():
        for name, fn in ways.items():
            fn()
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                y = fn()
            end.record()
            torch.cuda.synchronize()
            ref = y if ref is None else ref
            rows.append({"way": name, "ms": start.elapsed_time(end) / iters,
                         "extra_gib": (torch.cuda.max_memory_allocated() - before) / 2**30,
                         "max_abs": (y - ref).abs().max().item()})
            print(f"[plain_route_profile] {json.dumps(rows[-1])}", flush=True)
    return rows


def main(argv: Optional[List[str]] = None) -> List[dict]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda:0")
    p.add_argument("--variants", default="benchmark,deterministic")
    args = p.parse_args(argv)
    from ..models.prednet import model
    from ..models.prednet.loader import load_or_init
    from ..parallel import make_mesh_2d, make_spatial_rollout

    dev = torch.device(args.device)
    torch.backends.cudnn.allow_tf32 = False  # as the driver runs: full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    params = load_or_init(None, (3, 48, 96, 192), device=dev)
    gen = torch.Generator().manual_seed(7)
    imgs = (torch.rand(*SHAPE, generator=gen) * 255).to(torch.uint8).float().div(255).to(dev)
    bands = make_spatial_rollout(make_mesh_2d(1, 2, devices=[dev] * 2), repeat=1, extension=1)

    def unsharded():
        return model.rollout_flow_frames(params, imgs, repeat=1, extension=1, use_pallas=False)

    records = [profile_step(unsharded, "unsharded"),
               profile_step(lambda: bands(params, imgs), "two bands")]
    cudnn = torch.backends.cudnn
    for name in filter(None, args.variants.split(",")):
        saved = cudnn.benchmark, cudnn.deterministic
        setattr(cudnn, name, True)
        try:
            records.append(profile_step(unsharded, f"unsharded, cudnn.{name}"))
        finally:
            cudnn.benchmark, cudnn.deterministic = saved
    records.append(profile_step(unsharded, "unsharded again"))
    # the slowest conv of the unsharded step, alone, computed in other ways
    x_shape, w_shape = records[0]["slowest"]
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(x_shape[0], x_shape[2], x_shape[3], x_shape[1], device=dev,
                    generator=gen).permute(0, 3, 1, 2)
    w = torch.randn(*w_shape, device=dev, generator=gen) * 0.05
    records.append({"run": "slowest conv", "ways": conv_variants(x, w)})
    for label, run in (("unsharded", lambda: model.rollout_flow_frames(
            params, imgs, repeat=20, extension=2, use_pallas=False)),
            ("two bands", lambda: make_spatial_rollout(
                make_mesh_2d(1, 2, devices=[dev] * 2), repeat=20, extension=2)(params, imgs))):
        with torch.inference_mode():
            run()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.time()
            run()
            torch.cuda.synchronize()
        record = {"run": f"{label}, 22 steps", "seconds": time.time() - t0,
                  "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        print(f"[plain_route_profile] {json.dumps(record)}", flush=True)
        records.append(record)
    return records



if __name__ == "__main__":
    main()
