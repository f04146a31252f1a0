"""Diagnose the predictor's closed-loop drift on probe inputs.

The port's counterpart of the JAX package's ``scripts/drift_diag.py``.  For
each input (in-distribution tangential sawtooth, radial sawtooth and plain
rings from ``synthetic_cue_batch(PRNGKey(11), ...)``, then ``rotate_01``
and ``control`` of the rated stimuli under ``RATED_DIR``) report the flow
field's mean |displacement| and its mean tangential / radial components
around the image centre — the quantities the circles fitness actually
keys on — and the mean |second extension frame - input|.

    python -m evolutionary_illusion_generator_tpu_torch.scripts.drift_diag \\
        [--model X] [--channels 1,16,32,64] [--repeat 20] [--device cpu]

Without ``--device cpu`` it needs a CUDA card.  The synthetic inputs are
drawn on the host (bit-equal to the JAX package's), then rolled out on the
device.  The rated stimuli are not in the repository: ``RATED_DIR`` names
the directory they go in, in the reference's layout.
"""

import argparse
import os

import numpy as np
import torch

from .._device import resolve_device
from ..evolution.probe import _png_quantize
from ..models.prednet.loader import load_or_init
from ..models.prednet.model import rollout_flow_frames
from ..models.prednet.synthetic_data import synthetic_cue_batch
from ..ops.flow.api import FlowConfig, flow_vectors
from ..ops.flow.pyramid import to_gray
from ..utils import prng
from ..utils.image_io import load_image

__all__ = ["RATED_DIR", "inputs", "flow_row", "field_stats", "main"]

# the reference's rated stimuli (its illusions_rating/EIGEN-images), which
# are not in the repository: where they go once added, at its root
RATED_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "illusions_rating", "EIGEN-images")


def inputs(c_dim, w=160, h=120):
    """The five inputs by name, (h, w, c_dim) float32 numpy: the first
    frame of cue regimes 4 (tangential), 5 (radial) and 2 (plain rings),
    then the two rated stimuli."""
    out = {}
    for reg, name in ((4, "synth_tangential"), (5, "synth_radial"),
                      (2, "synth_rings")):
        probs = [0.0] * 7
        probs[reg] = 1.0
        seq = synthetic_cue_batch(prng.PRNGKey(11), 1, 1, h, w, c_dim,
                                  regime_probs=tuple(probs), device="cpu")
        out[name] = seq[0, 0].numpy()
    for name, rel in (("rotate_01", "rotate_01/small.png"),
                      ("control", "control/small.png")):
        out[name] = load_image(os.path.join(RATED_DIR, rel), size=(w, h), c_dim=c_dim)
    return out


def flow_row(f0, f1, device, w=160, h=120):
    """The flow between two (h, w, c) frames, each through the PNG
    quantisation, on ``device``, then :func:`field_stats`."""
    a, b = (torch.from_numpy(_png_quantize(f))[None].to(device) for f in (f0, f1))
    with torch.inference_mode():
        vec, mask = flow_vectors(to_gray(a), to_gray(b), FlowConfig())
    return field_stats(vec[0][mask[0]].cpu().numpy(), w, h)


def field_stats(v, w=160, h=120):
    """(mean |d|, mean tangential, mean radial component about the
    centre, n) of (N, 4) float32 vectors, or ``None`` where N is 0."""
    if len(v) == 0:
        return None
    x, y, dx, dy = v[:, 0] - w / 2, v[:, 1] - h / 2, v[:, 2], v[:, 3]
    r = np.hypot(x, y) + 1e-9
    tang = (x * dy - y * dx) / r   # + = counterclockwise
    rad = (x * dx + y * dy) / r    # + = expanding
    mag = np.hypot(dx, dy)
    return float(mag.mean()), float(tang.mean()), float(rad.mean()), len(v)


def main(argv=None):
    """Prints the JAX script's table; returns one row a input: ``None``
    where no vector was found, else (mean |d|, tangential, radial, drift,
    n)."""
    p = argparse.ArgumentParser()
    p.add_argument("--model", default=None)
    p.add_argument("--channels", default="1,16,32,64")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' must be asked for)")
    p.add_argument("--repeat", type=int, default=20)
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    channels = [int(c) for c in args.channels.split(",")]
    w, h = 160, 120
    params = load_or_init(args.model, channels, device=device)

    print(f"{'input':18s} {'mean|d|':>8s} {'tang':>8s} {'rad':>8s} "
          f"{'|pred-img|':>10s}  n")
    rows = {}
    for name, img in inputs(channels[0], w, h).items():
        batch = torch.from_numpy(img)[None].to(device)
        with torch.inference_mode():
            f0, f1 = rollout_flow_frames(params, batch, repeat=args.repeat, extension=2,
                                         pair="probe")
            drift = float(torch.mean(torch.abs(f1[0] - batch[0])))
        row = flow_row(f0[0].cpu().numpy(), f1[0].cpu().numpy(), device, w, h)
        rows[name] = row and (*row[:3], drift, row[3])
        if row is None:
            print(f"{name:18s} {'-':>8s}")
            continue
        mag, tang, rad, n = row
        print(f"{name:18s} {mag:8.4f} {tang:8.4f} "
              f"{rad:8.4f} {drift:10.5f}  {n}")
    return rows


if __name__ == "__main__":
    main()
