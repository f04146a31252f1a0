"""Regenerate the gallery: every family run, the deep run, the north star.

The port's counterpart of the JAX package's ``scripts/make_gallery.py``:
the same seven runs with the same driver arguments, run by the port's
``neat_illusion``, and the README table they make.  Each run writes
``GALLERY/<run>/``, which it empties first.  ``GALLERY`` is the port's own
directory (``gallery_torch/`` at the repository root, not tracked), never
the committed ``gallery/`` that the JAX package's runs made.

    python -m evolutionary_illusion_generator_tpu_torch.scripts.make_gallery            # all runs
    python -m evolutionary_illusion_generator_tpu_torch.scripts.make_gallery circles_bw # subset
    python -m evolutionary_illusion_generator_tpu_torch.scripts.make_gallery --list

Without ``--device cpu`` a run needs a CUDA card; ``--list`` needs none and
imports no torch.  All small runs: 160×120, pop 24, seed 1.  The
north-star run is pop 100, 640×480.

Artifact contract per run (reference parity, generate_illusion.py:478-673):
best.png / best_flow.png / best_black_bg.png / enhanced.png + periodic
neat-checkpoint-<gen> + metrics.jsonl.
"""

import argparse
import json
import os
import shutil

__all__ = ["GALLERY", "BW", "COLOR", "RUN_NAMES", "best_fitness", "main"]

GALLERY = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "gallery_torch")

BW = [1, 16, 32, 64]
COLOR = [3, 48, 96, 192]

# static so --list never imports torch
RUN_NAMES = (
    "circles_bw",
    "circles_color",
    "free_color",
    "bands",
    "circles_free",
    "circles_bw_deep",
    "free_big_640",
)


def _runs():
    from ..neat import preset
    from ..structure import StructureType

    def small(struct, npreset, c_dim, gradient, channels, generations=30,
              every=10):
        return dict(
            config=preset(npreset).replace(pop_size=24),
            structure=struct,
            w=160,
            h=120,
            c_dim=c_dim,
            gradient=gradient,
            channels=channels,
            generations=generations,
            checkpoint_every=every,
        )

    S = StructureType
    return {
        # name -> (driver kwargs, README "Structure | Color" cell)
        "circles_bw": (
            small(S.Circles, "circles_bw", 1, 0, BW),
            "Circles | grayscale, quantized",
        ),
        "circles_color": (
            small(S.Circles, "circles", 3, 1, COLOR),
            "Circles | RGB gradient",
        ),
        "free_color": (
            small(S.Free, "free", 3, 1, COLOR),
            "Free | RGB gradient",
        ),
        "bands": (
            small(S.Bands, "bands", 3, 1, COLOR),
            "Bands | RGB gradient",
        ),
        "circles_free": (
            small(S.CirclesFree, "circles", 3, 1, COLOR),
            "CirclesFree | RGB gradient",
        ),
        "circles_bw_deep": (
            small(S.Circles, "circles_bw", 1, 0, BW, generations=100,
                  every=25),
            "Circles, **100 generations** | grayscale, quantized",
        ),
        "free_big_640": (
            dict(
                config=preset("free").replace(pop_size=100, num_outputs=3),
                structure=S.Free,
                w=640,
                h=480,
                c_dim=3,
                gradient=1,
                channels=COLOR,
                generations=30,
                checkpoint_every=10,
                microbatch=25,
            ),
            "Free, **north-star config** (pop 100, 640×480) | RGB gradient",
        ),
    }


def best_fitness(run_dir):
    best = 0.0
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        for line in f:
            best = max(best, json.loads(line).get("fitness_max", 0.0))
    return best


def main(argv=None):
    """Runs the named runs (all without names) and prints the README
    table; returns the best fitness by run."""
    p = argparse.ArgumentParser()
    p.add_argument("runs", nargs="*", default=[])
    p.add_argument("--list", action="store_true")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' must be asked for)")
    args = p.parse_args(argv)
    if args.list:
        for name in RUN_NAMES:
            print(name)
        return {}

    from .._device import resolve_device
    from ..evolution.driver import neat_illusion

    device = resolve_device(args.device)
    runs = _runs()
    assert tuple(runs) == RUN_NAMES
    names = args.runs or list(runs)
    unknown = [n for n in names if n not in runs]
    if unknown:
        raise SystemExit(f"unknown runs: {unknown} (see --list)")

    results = {}
    for name in names:
        run_dir = os.path.join(GALLERY, name)
        print(f"[gallery] === {name} -> {run_dir}", flush=True)
        if os.path.isdir(run_dir):
            shutil.rmtree(run_dir)
        kwargs, _ = runs[name]
        neat_illusion(run_dir, None, seed=args.seed, device=device, **kwargs)
        results[name] = best_fitness(run_dir)
        print(f"[gallery] {name}: best fitness {results[name]:.3f}",
              flush=True)

    print("\n| Run | Structure | Color | Best fitness |")
    print("|---|---|---|---|")
    for name in names:
        desc = runs[name][1]
        print(f"| `{name}` | {desc} | {results[name]:.3f} |")
    return results


if __name__ == "__main__":
    main()
