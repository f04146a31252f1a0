"""Per-vector anatomy of the probe flow field on the rated circles stimuli.

The port's counterpart of the JAX package's ``scripts/field_anatomy.py``.
The rotation-symmetry term unit-normalizes flows, so its value is set by
DIRECTION coherence alone.  For each rated circles image this prints, per
radius band, the in-gate vectors' tangential/radial decomposition: counts,
mean signed components, and the sign-consistency of the dominant component.
That separates the three possible coherence killers:

  (a) opposite drift signs in different radius bands (duty-cue confusion),
  (b) radial contamination on a rotational stimulus (or vice versa),
  (c) plain angle noise from magnitudes near the LK noise floor.

    python -m evolutionary_illusion_generator_tpu_torch.scripts.field_anatomy \\
        [--model_bw X] [--color] [--only NAME] [--bands 4] [--device cpu]

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

__all__ = ["RATED_DIR", "IMAGES", "COLOR_IMAGES", "BW", "COLOR", "main"]

# the reference's rated stimuli (its illusions_rating/EIGEN-images), which
# are not in the repository: where they go once added, at its root
RATED_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "illusions_rating", "EIGEN-images")

IMAGES = [
    ("rotate_01", "rotate_01/small.png"),
    ("rotate_02", "rotate_02/small.png"),
    ("expand_01", "expand_01/small.png"),
    ("expand_02", "expand_02/small.png"),
]

# the color stimuli probe through the color stack (fpsi_500000_20v role);
# same circles metric, so the same anatomy applies
COLOR_IMAGES = [
    ("color_01_expand", "color_01_expand/small.png"),
    ("color_02_expand", "color_02_expand/small.png"),
]

BW = (1, 16, 32, 64)
COLOR = (3, 48, 96, 192)


def main(argv=None):
    """Prints the JAX script's anatomy; returns, a probed image, ``None``
    where no vector was found, else its vectors (float64 numpy)."""
    p = argparse.ArgumentParser()
    p.add_argument("--model_bw", default=None)
    p.add_argument("--model_color", default=None)
    p.add_argument("--color", action="store_true",
                   help="also decompose the two color stimuli (color stack)")
    p.add_argument("--only", default="",
                   help="substring filter on image names")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' must be asked for)")
    p.add_argument("--bands", type=int, default=4)
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    w, h = 160, 120
    cx, cy = w / 2.0, h / 2.0
    todo = [(n, rel, BW, args.model_bw) for n, rel in IMAGES]
    if args.color:
        todo += [(n, rel, COLOR, args.model_color) for n, rel in COLOR_IMAGES]
    if args.only:
        todo = [t for t in todo if args.only in t[0]]
    out = {}
    for name, rel, channels, model in todo:
        path = os.path.join(RATED_DIR, rel)
        v = np.asarray(get_vectors(path, model, channels, w, h, device=device), np.float64)
        if v.size == 0:
            out[name] = None
            print(f"{name}: no vectors")
            continue
        out[name] = v
        px, py, dx, dy = v[:, 0] - cx, v[:, 1] - cy, v[:, 2], v[:, 3]
        r = np.hypot(px, py)
        norm = np.hypot(dx, dy)
        ingate = norm <= 0.3
        # the sym term additionally drops radius > h/2
        inlim = ingate & (r > 0) & (r <= h / 2)
        # unit radial / tangential basis per vector
        ur = np.stack([px, py], -1) / np.maximum(r, 1e-9)[:, None]
        ut = np.stack([-py, px], -1) / np.maximum(r, 1e-9)[:, None]
        d = np.stack([dx, dy], -1)
        rad = (d * ur).sum(-1)
        tan = (d * ut).sum(-1)
        print(f"\n{name}: n={len(v)} ingate={ingate.sum()} "
              f"symset={inlim.sum()} m|d|={norm.mean():.3f} "
              f"mg|d|={norm[ingate].mean():.3f}")
        edges = np.linspace(0, h / 2, args.bands + 1)
        for b in range(args.bands):
            sel = inlim & (r >= edges[b]) & (r < edges[b + 1])
            if sel.sum() < 2:
                print(f"  r {edges[b]:5.1f}-{edges[b + 1]:5.1f}: n={sel.sum()}")
                continue
            t_s, r_s = tan[sel], rad[sel]
            # which component dominates, and how consistent is its sign?
            dom = "tan" if np.abs(t_s).mean() >= np.abs(r_s).mean() else "rad"
            c = t_s if dom == "tan" else r_s
            sign_con = max((c > 0).mean(), (c < 0).mean())
            print(
                f"  r {edges[b]:5.1f}-{edges[b + 1]:5.1f}: n={sel.sum():3d} "
                f"tan {t_s.mean():+.3f}|{np.abs(t_s).mean():.3f} "
                f"rad {r_s.mean():+.3f}|{np.abs(r_s).mean():.3f} "
                f"dom={dom} sign-consistency {sign_con:.2f}"
            )
        # overall angular stats of the sym set (what the metric sees)
        sel = inlim
        u = d[sel] / np.maximum(norm[sel], 1e-9)[:, None]
        urs = (u * ur[sel]).sum(-1)
        uts = (u * ut[sel]).sum(-1)
        print(f"  symset unit-flow: mean tan {uts.mean():+.3f} "
              f"mean rad {urs.mean():+.3f} "
              f"(|mean| near 1 = coherent; near 0 = mixed)")
    return out


if __name__ == "__main__":
    main()
