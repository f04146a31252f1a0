"""Per-image breakdown of the circles fitness terms on the rated gallery.

The port's counterpart of the JAX package's ``scripts/probe_breakdown.py``.
For each rated stimulus print: total vectors, plausible vectors (norm <=
limit), the rotation-symmetry term, the strength term, the blended score,
and the mean |d| of all vs plausible vectors.  This is the tuning
instrument for the stand-in predictor: it shows whether a low score comes
from the plausibility gate (drift too strong), the count gate (<24
survivors), or angular incoherence (variance after rotation).

    python -m evolutionary_illusion_generator_tpu_torch.scripts.probe_breakdown \\
        [--model_bw X] [--model_color Y] [--device cpu]

Without ``--device cpu`` it needs a CUDA card.  The stimuli are not in the
repository: ``RATED_DIR`` names the directory they go in, in the
reference's layout (``rotate_01/small.png`` ... ``control/small.png``);
point it at a copy elsewhere to run on one.
"""

import argparse
import os

import numpy as np

from .._device import resolve_device
from ..evolution.probe import get_vectors
from ..ops.fitness.metrics_np import (
    plausibility_ratio,
    rotation_symmetry_score,
    strength_number,
    swarm_score,
)
from ..utils.png import read_png

__all__ = ["RATED_DIR", "IMAGES", "BW", "COLOR", "main"]

# the reference's rated stimuli (its illusions_rating/EIGEN-images), which
# are not in the repository: where they go once added, at its root
RATED_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "illusions_rating", "EIGEN-images")

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
    """Prints the JAX script's table; returns one row a image: ``None``
    where no vector was found, else (n, good, sym, str, score, m|d|,
    mg|d|)."""
    p = argparse.ArgumentParser()
    p.add_argument("--model_bw", default=None)
    p.add_argument("--model_color", default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' must be asked for)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    w, h = 160, 120
    print(f"{'image':17s} {'pub':>5s} {'n':>4s} {'good':>4s} "
          f"{'sym':>6s} {'str':>6s} {'score':>6s} {'m|d|':>6s} {'mg|d|':>6s}")
    rows = {}
    for name, rel, structure, published in IMAGES:
        path = os.path.join(RATED_DIR, rel)
        mode = read_png(path)[1]
        channels = BW if mode == "L" else COLOR
        model = args.model_bw if mode == "L" else args.model_color
        v = np.asarray(get_vectors(path, model, channels, w, h, device=device), np.float64)
        n = len(v)
        if n == 0:
            rows[name] = None
            print(f"{name:17s} {published:5.2f}    0     -")
            continue
        norms = np.hypot(v[:, 2], v[:, 3])
        limit = 0.3 if structure == 1 else 0.4
        _, good = plausibility_ratio(v, limit)
        ngood = len(good)
        gnorms = (np.hypot(good[:, 2], good[:, 3])
                  if ngood else np.zeros(0))
        if structure == 1:
            sym = (rotation_symmetry_score(good, w, h, [0, h / 2])
                   if ngood > 24 else float("nan"))
            stren = strength_number(good, limit) if ngood > 24 else float("nan")
            score = (0.7 * sym + 0.3 * stren) if ngood > 24 else 0.0
        else:
            sym = swarm_score(good) if ngood else float("nan")
            stren = strength_number(good, limit) if ngood else float("nan")
            score = (0.5 * sym + 0.1 * stren
                     + 0.4 * min(ngood, 15) / 15) if ngood else 0.0
        gmean = gnorms.mean() if ngood else float("nan")
        rows[name] = (n, ngood, float(sym), float(stren), float(score), float(norms.mean()),
                      float(gmean))
        print(f"{name:17s} {published:5.2f} {n:4d} {ngood:4d} "
              f"{sym:6.3f} {stren:6.3f} {score:6.3f} "
              f"{norms.mean():6.3f} {gmean:6.3f}")
    return rows


if __name__ == "__main__":
    main()
