"""Per-kernel profile of the PredNet rollout at the north-star chunk.

The port's counterpart of the JAX package's ``scripts/rollout_profile.py``:

1. runs the rollout the evaluator runs (``rollout_flow_frames``, the
   default ``"fused"`` route, bfloat16 compute, ``--s2d 1`` the s2d pixel
   layer as the JAX script defaults, ``--s2d 0`` the dense one;
   ``--use_pallas true`` the ``use_pallas=True`` route instead: the gate
   convs of ``convlstm_narrow.gate_convs`` and the gate kernel on every
   layer) at the
   north-star chunk (25 x 480x640x3, 20 + 2 steps, the seeded predictor
   ``init_params(PRNGKey(0))``, images ``uniform(PRNGKey(1))`` as JAX
   draws them) and times it: the median of three runs after a warm-up;
2. runs it once more under ``torch.profiler`` and prints, per kernel
   name (the 40 longest), its count, its milliseconds and its share of
   the device time, then the device's busy share of the profiled window
   (on the CPU: the operators' self time), and the device time by the
   port's kernel wrappers (the ConvLSTM kernels, the A and Ahat units)
   beside the library's conv kernels, and the gate kernel's by body.  This
   replaces the JAX script's parsing of a perfetto trace and its XLA cost
   model, which the port has no counterpart of;
3. prints one JSON line: the times in seconds, the busy share, the card's
   name and power limit, and the table's rows::

    python3 -m evolutionary_illusion_generator_tpu_torch.scripts.rollout_profile \\
        [--s2d 0|1] [--use_pallas fused|true] [--pop 25] [--width 640] [--height 480] \\
        [--channels 3,48,96,192] \\
        [--repeat 20] [--device cpu]

Without ``--device cpu`` it needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from .._device import resolve_device
from ..models.prednet.model import init_params, rollout_flow_frames
from ..utils import prng
from ..ops.convlstm_gates import BODIES as GATE_BODIES
from ..utils.profiling import PORT_KERNELS, by_wrapper, card_line, device_events, kernel_table

__all__ = ["main"]

TOP = 40  # rows of the kernel table, as the JAX script prints
#: ``--use_pallas`` -> the rollout's ``use_pallas``
ROUTES = {"fused": "fused", "true": True}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    """Time and profile the rollout; prints the table and its JSON line, and
    returns the JSON line's object."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--pop", type=int, default=25)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--channels", default="3,48,96,192")
    p.add_argument("--repeat", type=int, default=20)
    p.add_argument("--s2d", default="1", choices=("0", "1"))
    p.add_argument("--use_pallas", default="fused", choices=sorted(ROUTES),
                   help="the predictor's route (EvalConfig.use_pallas)")
    p.add_argument("--device", default=None,
                   help="'cpu' for the plain versions; default: the CUDA card")
    args = p.parse_args(argv)
    from torch.profiler import ProfilerActivity, profile

    device = resolve_device(args.device)
    card = card_line(device)
    channels = tuple(int(x) for x in args.channels.split(","))
    pop, w, h = args.pop, args.width, args.height
    s2d = args.s2d == "1"
    params = init_params(prng.PRNGKey(0), channels, device=device)
    imgs = torch.from_numpy(prng.uniform(prng.PRNGKey(1), (pop, h, w, channels[0]))).to(device)

    def roll():
        with torch.inference_mode():
            return rollout_flow_frames(params, imgs, repeat=args.repeat, extension=2,
                                       pair="population", compute_dtype=torch.bfloat16,
                                       s2d_l0=s2d, use_pallas=ROUTES[args.use_pallas])

    route = "" if args.use_pallas == "fused" else f" use_pallas={args.use_pallas}"
    print(f"[profile] device={device} ({card}) pop={pop} {w}x{h} stack={channels} s2d={s2d}"
          f"{route}", flush=True)
    t0 = time.perf_counter()
    roll()
    _sync(device)
    first = time.perf_counter() - t0
    print(f"[profile] first run {first:.3f}s", flush=True)
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        roll()
        _sync(device)
        ts.append(time.perf_counter() - t0)
    steady = sorted(ts)[1]
    print(f"[profile] steady {steady:.4f}s (all {['%.4f' % t for t in ts]})", flush=True)

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda"
                                           else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        roll()
        _sync(device)
        wall = time.perf_counter() - t0
    events = device_events(prof, device)
    lines, totals = kernel_table(events, wall, top=TOP)
    print(f"[profile] {'device kernels' if device.type == 'cuda' else 'CPU operators'}: "
          f"{totals['busy_s'] * 1e3:.1f} ms busy in {wall * 1e3:.1f} ms of wall (profiler on), "
          f"busy share {totals['busy_share']:.3f}, {totals['launches']} launches, "
          f"{len(events)} names", flush=True)
    for line in lines:
        print(line, flush=True)
    wrappers = by_wrapper(events)
    print("[profile] by wrapper (count, ms): " + ", ".join(
        f"{k} {v['count']} {v['ms']:.3f}" for k, v in wrappers.items()), flush=True)
    # the gate kernel's bodies, each by its kernel's name (scalar, vector, slab)
    gate_bodies = {body: {"count": sum(c for n, c, _ in events if key in n),
                          "ms": sum(us for n, _, us in events if key in n) / 1e3}
                   for body, key in zip(GATE_BODIES, PORT_KERNELS["fused_lstm_gates"])}
    print("[profile] the gate kernel by body (count, ms): " + ", ".join(
        f"{k} {v['count']} {v['ms']:.3f}" for k, v in gate_bodies.items()), flush=True)
    line = {"script": "rollout_profile", "card": card, "device": str(device), "pop": pop,
            "width": w, "height": h, "channels": list(channels), "s2d": s2d,
            "repeat": args.repeat, "first_s": first, "steady_s": steady, "all_s": ts,
            **totals, "wrappers": wrappers, "gate_bodies": gate_bodies,
            "kernels": [{"name": n, "count": c, "ms": us / 1e3,
                         "share": us / 1e6 / totals["busy_s"] if totals["busy_s"] else 0.0}
                        for n, c, us in events[:TOP]]}
    if args.use_pallas != "fused":  # the default route's line is as it was
        line["use_pallas"] = args.use_pallas
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
