"""Per-phase timing of one generation chunk at the north-star point.

The port's counterpart of the JAX package's ``scripts/phase_bench.py``.  At
one chunk of the north star (25 candidates, 640x480 colour, the Free
structure, channels ``3,48,96,192`` with the seeded predictor
``init_params(PRNGKey(0))``, 20 + 2 rollout steps in bfloat16 on the
default ``"fused"`` route) it times each phase alone:

  render    ``pack_population_levels`` (host), the tables to the device, the
            level CPPN and ``render_images``
  rollout   ``rollout_flow_frames`` -> the two flow frames
  flow      ``batched_flow`` with ``FlowConfig()`` (corners + pyramidal LK)
  full      the evaluator's generation, eagerly (``program_cache=False``)
            and replayed as a CUDA graph (the program cache replays a key
            from its third call)

and, around a replayed generation, the host's parts: the NEAT packing, the
copies of the packed tables into the graph's inputs, the replay itself,
the outputs' copies out and the fetch of the vectors, and the host's
scoring (``last_timings["score"]``).  Each time is the median of
``--reps`` after a warm-up, on a host clock read after
``torch.cuda.synchronize()``.  The sum of the isolated phases exceeds
``full``'s eager pass only by the boundaries between them; what matters is
their ratio.  Prints human lines, then one JSON line of every number (in
seconds) with the card's name and power limit::

    python3 -m evolutionary_illusion_generator_tpu_torch.scripts.phase_bench \\
        [--pop 25] [--width 640] [--height 480] [--reps 3] [--device cpu]

Without ``--device cpu`` it needs a CUDA card.  On the CPU there is no
graph: ``full_replay_s`` is then the eager generation again and ``graph``
is false.
"""

from __future__ import annotations

import argparse
import json
import time
from dataclasses import replace
from random import Random

import torch

from .._device import resolve_device
from ..evolution.evaluator import EvalConfig, GenerationEvaluator
from ..models.cppn import make_population_eval, pack_population_levels
from ..models.prednet.model import init_params, rollout_flow_frames
from ..neat import Genome, preset
from ..ops.flow.api import FlowConfig, batched_flow
from ..ops.grids import GRID_SCALING, create_grid
from ..ops.render import render_images, to_unit_float
from ..structure import StructureType
from ..utils import prng
from ..utils.profiling import card_line

__all__ = ["FIELDS", "main"]

CHANNELS = (3, 48, 96, 192)
REPEAT, EXTENSION = 20, 2
#: the JSON line's numbers, in seconds (``graph``: whether a graph replayed)
FIELDS = ("render_s", "rollout_s", "flow_s", "full_eager_s", "full_replay_s", "device_s",
          "pack_s", "copy_in_s", "replay_s", "copy_out_s", "score_s", "other_s")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _median(xs):
    return sorted(xs)[len(xs) // 2]


def timeit(fn, device: torch.device, reps: int, warmup: int = 1) -> float:
    """Median wall seconds of ``fn()``, the device synchronised around each
    call, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    ts = []
    for _ in range(reps):
        _sync(device)
        t0 = time.perf_counter()
        fn()
        _sync(device)
        ts.append(time.perf_counter() - t0)
    return _median(ts)


def genomes(pop: int, neat_cfg):
    """``pop`` genomes of ``neat_cfg``, made and mutated from ``Random(0)``
    as the JAX script makes them."""
    rng = Random(0)
    out = [Genome.new(i, neat_cfg, rng) for i in range(pop)]
    for g in out:
        g.mutate(neat_cfg, rng)
    return out


def _host_split(ev: GenerationEvaluator, items, device: torch.device, reps: int) -> dict:
    """The parts of a (replayed) generation of ``ev``: packing, the copies
    into the pass's inputs, the pass (the graph's replay where there is
    one), the outputs' copies out with the fetch of vectors and masks, and
    the host scoring."""
    gs = [g for _, g in items]
    pack = lambda: pack_population_levels(  # noqa: E731
        gs, ev.neat_cfg, ev._levels, ev._width, act_set=ev._act_set or None)
    packed = pack()
    key = ev.program_key(len(gs))
    graph = ev._programs.graphs.get(key)
    ins = {k: torch.as_tensor(v).to(device) for k, v in packed.items()}

    def copy_in():
        fresh = {k: torch.as_tensor(v).to(device) for k, v in packed.items()}
        if graph is not None:
            for k, v in fresh.items():
                graph.inputs[k].copy_(v)

    if graph is not None:
        run, outputs = graph.graph.replay, graph.outputs
    else:
        outputs = ev._eval_chunk(ins)
        run = lambda: ev._eval_chunk(ins)  # noqa: E731

    def copy_out():
        out = {k: v.clone() for k, v in outputs.items()}
        out["vectors"].cpu(), out["mask"].cpu()

    timings = []

    def generation():
        ev(items)
        timings.append(ev.last_timings)

    full = timeit(generation, device, reps, warmup=0)
    return {"full_replay_s": full, "device_s": _median([t["device"] for t in timings]),
            "score_s": _median([t["score"] for t in timings]),
            "pack_s": timeit(pack, device, reps), "copy_in_s": timeit(copy_in, device, reps),
            "replay_s": timeit(run, device, reps), "copy_out_s": timeit(copy_out, device, reps),
            "graph": graph is not None}


def main(argv=None) -> dict:
    """Time the phases; prints them and their JSON line, and returns the
    JSON line's object."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--pop", type=int, default=25, help="one chunk")
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--channels", default=",".join(map(str, CHANNELS)))
    p.add_argument("--device", default=None,
                   help="'cpu' for the plain versions; default: the CUDA card")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    pop, w, h, reps = args.pop, args.width, args.height, args.reps
    channels = tuple(int(c) for c in args.channels.split(","))
    card = card_line(device)

    neat_cfg = preset("free").replace(pop_size=pop)
    params = init_params(prng.PRNGKey(0), channels, device=device)
    gs = genomes(pop, neat_cfg)
    grid = create_grid(StructureType.Free, w, h, GRID_SCALING)
    x_mat = torch.as_tensor(grid["x_mat"], dtype=torch.float32).to(device)
    grid_flat = torch.stack([torch.as_tensor(grid[k], dtype=torch.float32).reshape(-1)
                             for k in ("x_mat", "y_mat")]).to(device)
    cppn_eval = make_population_eval()
    print(f"[phase] device={device} ({card}) pop={pop} {w}x{h} channels={channels}", flush=True)

    def render():
        packed = {k: torch.as_tensor(v).to(device)
                  for k, v in pack_population_levels(gs, neat_cfg, 8, 16).items()}
        outs = cppn_eval(packed["weights"], packed["bias"], packed["response"],
                         packed["act_id"], packed["out_slot"], grid_flat)
        return render_images(outs, x_mat, channels[0], bg=1, gradient=1)

    out = {"render_s": timeit(render, device, reps)}
    print(f"[phase] render  {out['render_s']:8.4f}s", flush=True)
    imgs = to_unit_float(render())

    def rollout():
        return rollout_flow_frames(params, imgs, repeat=REPEAT, extension=EXTENSION,
                                   pair="population", compute_dtype=torch.bfloat16)

    out["rollout_s"] = timeit(rollout, device, reps)
    print(f"[phase] rollout {out['rollout_s']:8.4f}s", flush=True)
    f0, f1 = rollout()
    out["flow_s"] = timeit(lambda: batched_flow(f0, f1, FlowConfig()), device, reps)
    print(f"[phase] flow    {out['flow_s']:8.4f}s", flush=True)

    items = [(g.key, g) for g in gs]
    cfg = EvalConfig(structure=StructureType.Free, w=w, h=h, c_dim=channels[0], gradient=1,
                     microbatch=pop)
    eager = GenerationEvaluator(replace(cfg, program_cache=False), params, neat_cfg,
                                device=device)
    out["full_eager_s"] = timeit(lambda: eager(items), device, reps)
    print(f"[phase] full, eager    {out['full_eager_s']:8.4f}s", flush=True)
    replayed = GenerationEvaluator(cfg, params, neat_cfg, device=device)
    replayed(items)  # the key's eager warm-up
    replayed(items)  # its capture, then replays
    out.update(_host_split(replayed, items, device, reps))
    parts = ("pack_s", "copy_in_s", "replay_s", "copy_out_s", "score_s")
    out["other_s"] = out["full_replay_s"] - sum(out[k] for k in parts)
    print(f"[phase] full, {'replayed' if out['graph'] else 'eager'} {out['full_replay_s']:8.4f}s:"
          + "".join(f" {k[:-2]} {out[k]:.4f}" for k in parts + ("other_s",)), flush=True)

    total = out["render_s"] + out["rollout_s"] + out["flow_s"]
    print(f"[phase] isolated sum {total:.4f}s -> render {out['render_s'] / total:.0%} rollout "
          f"{out['rollout_s'] / total:.0%} flow {out['flow_s'] / total:.0%}", flush=True)
    line = {"script": "phase_bench", "card": card, "device": str(device), "pop": pop,
            "width": w, "height": h, "channels": list(channels), "reps": reps,
            **{k: out[k] for k in FIELDS}, "graph": out["graph"]}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
