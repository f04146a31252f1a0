"""Probe the reference's rated gallery and compare with the published scores.

The port's counterpart of the JAX package's ``scripts/probe_rated.py``.
Runs the single-image probe pipeline (``evolution/probe.get_vectors``: 20
repeats + 2 closed-loop frames, flow between the input and extended frame
21, structure-specific fitness) on the 8 stimuli of
``illusions_rating/EIGEN-images`` and prints a table against the published
scores (``illusions_rating/gorilla_data/2025/eigen_own_ratings.csv``).

Grayscale (mode L) stimuli use the grayscale channel stack (the reference's
300000_wb.model role), color ones the color stack (fpsi_500000_20v.model
role).  The north-star fidelity check: control strictly lowest;
circles-family images separating clearly above it.

    python -m evolutionary_illusion_generator_tpu_torch.scripts.probe_rated \\
        [--model_bw X] [--model_color Y] [--json OUT] [--device cpu]

Without ``--device cpu`` it needs a CUDA card.  The stimuli are not in the
repository: ``RATED_DIR`` names the directory they go in, in the
reference's layout (``rotate_01/small.png`` ... ``control/small.png``);
point it at a copy elsewhere to run on one.
"""

import argparse
import json
import os

from .._device import resolve_device
from ..evolution.probe import get_vectors
from ..ops.fitness.calculate import calculate_fitness
from ..ops.flow.api import FlowConfig
from ..utils.png import read_png

__all__ = ["RATED_DIR", "IMAGES", "BW", "COLOR", "main"]

# the reference's rated stimuli (its illusions_rating/EIGEN-images), which
# are not in the repository: where they go once added, at its root
RATED_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "illusions_rating", "EIGEN-images")

# (name, file, structure, published score)
IMAGES = [
    ("rotate_01", "rotate_01/small.png", 1, 0.818),
    ("rotate_02", "rotate_02/small.png", 1, 0.807),
    ("expand_01", "expand_01/small.png", 1, 0.802),
    ("expand_02", "expand_02/small.png", 1, 0.817),
    ("color_01_expand", "color_01_expand/small.png", 1, 0.804),
    ("color_02_expand", "color_02_expand/small.png", 1, 0.815),
    ("manyfish", "manyfish/manyfish-small.png", 2, 0.650),
    ("control", "control/small.png", 1, 0.0),
]

BW = (1, 16, 32, 64)
COLOR = (3, 48, 96, 192)


def main(argv=None):
    """Prints the JAX script's table and summary; returns what ``--json``
    writes."""
    p = argparse.ArgumentParser()
    p.add_argument("--model_bw", default=None, help="bw predictor (default: bundled)")
    p.add_argument("--model_color", default=None, help="color predictor (default: bundled)")
    p.add_argument("--json", default="", help="also write results as JSON")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' must be asked for)")
    p.add_argument("--int8", action="store_true",
                   help="int8-quantize the predictors (the promotion gate "
                        "for EvalConfig.prednet_int8)")
    p.add_argument("--s2d", action="store_true",
                   help="space-to-depth pixel layer (the promotion gate "
                        "for EvalConfig.s2d_l0)")
    p.add_argument("--lk_bf16", action="store_true",
                   help="bfloat16 LK window gathers/products (the promotion "
                        "gate for FlowConfig.lk_dtype='bfloat16')")
    p.add_argument("--only", default="",
                   help="comma-separated subset: image names and/or the "
                        "shorthands 'bw' / 'color' (stack-filtered probes "
                        "skip the other stack's rows).  Ordering summary "
                        "lines cover only the probed rows")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    selected = []
    if args.only:
        toks = {t.strip() for t in args.only.split(",") if t.strip()}
        names = {n for n, _, _, _ in IMAGES}
        bad = toks - names - {"bw", "color"}
        if bad:
            raise SystemExit(f"--only: unknown entries {sorted(bad)} "
                             f"(valid: bw, color, {sorted(names)})")
        for name, rel, structure, published in IMAGES:
            mode = read_png(os.path.join(RATED_DIR, rel))[1]
            stack = "bw" if mode == "L" else "color"
            if name in toks or stack in toks:
                selected.append((name, rel, structure, published))
    else:
        selected = list(IMAGES)

    flow_cfg = FlowConfig(lk_dtype="bfloat16" if args.lk_bf16 else "float32")

    results = {}
    print(f"{'image':18s} {'published':>9s} {'ours':>9s}  n_vec")
    for name, rel, structure, published in selected:
        path = os.path.join(RATED_DIR, rel)
        mode = read_png(path)[1]
        channels = BW if mode == "L" else COLOR
        model = args.model_bw if mode == "L" else args.model_color
        vectors = get_vectors(path, model, channels, 160, 120, int8=args.int8,
                              s2d=args.s2d, flow=flow_cfg, device=device)
        score = (
            0.0
            if vectors.size == 0
            else calculate_fitness(structure, vectors, path, 160, 120)
        )
        results[name] = {
            "published": published,
            "ours": float(score),
            "n_vectors": int(len(vectors)),
            "structure": structure,
            "channels": list(channels),
        }
        print(f"{name:18s} {published:9.3f} {score:9.3f}  {len(vectors)}")

    circles = [
        results[n]["ours"]
        for n in ("rotate_01", "rotate_02", "expand_01", "expand_02",
                  "color_01_expand", "color_02_expand")
        if n in results
    ]
    if "control" in results:
        control = results["control"]["ours"]
        ordering_ok = all(control < s for s in circles) and (
            "manyfish" not in results
            or control < results["manyfish"]["ours"]
        )
        sep = (min(circles) - control) if circles else 0.0
        print(f"\ncontrol strictly lowest: {ordering_ok}")
        print(f"min(circles) - control:  {sep:+.3f}")
    else:
        ordering_ok, sep = None, None
        print("\n(control not probed; no ordering summary)")
    out = {"results": results, "control_strictly_lowest": ordering_ok,
           "min_circles_minus_control": sep}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=2)
    return out


if __name__ == "__main__":
    main()
