"""Drift response of a predictor vs sawtooth spatial period.

The port's counterpart of the JAX package's ``scripts/period_response.py``:
the same rings, rollout, flow and table.  Renders STATIC radial
asymmetric-sawtooth ring images over a sweep of spatial periods, runs the
population rollout (20 open + 2 closed frames in bfloat16 compute, flow
between the prediction at t=19 and the first extension frame), and
reports the in-gate flow statistics per period.  This is the transfer
curve behind the rated-gallery centre-band problem (``field_anatomy``):
the rated stimuli's wedge structure reaches ~4-8 px periods near the
centre, and a predictor trained on 12-40 px patterns shows where its
response dies.

    python -m evolutionary_illusion_generator_tpu_torch.scripts.period_response \\
        [--model_bw X] [--channels 1,16,32,64] [--device cpu]

Without ``--device cpu`` it needs a CUDA card.  The rings are made on the
host, so the card and the CPU roll out the same images.
"""

import argparse

import numpy as np
import torch

from .._device import resolve_device
from ..models.prednet.loader import load_or_init
from ..models.prednet.model import rollout_flow_frames
from ..models.prednet.synthetic_data import _asym_ramp
from ..ops.flow.api import FlowConfig, batched_flow

__all__ = ["W", "H", "rings", "period_table", "table_rows", "format_row", "main"]

W, H = 160, 120


def rings(periods, w=W, h=H):
    """(P, h, w, 1) float32: one ring image a period, centred, made on the
    host in float32 as the JAX script makes them."""
    yy, xx = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="ij")
    r = np.hypot(yy - h / 2, xx - w / 2) + 1e-6
    return np.stack(
        [_asym_ramp(torch.from_numpy(r / per)).numpy() for per in periods]
    )[..., None]


def period_table(params, periods, device, w=W, h=H):
    """The rings through the population rollout on ``device`` and
    ``batched_flow``, then :func:`table_rows`; returns the rows and the two
    flow frames, as numpy."""
    imgs = rings(periods, w, h)
    with torch.inference_mode():
        f0, f1 = rollout_flow_frames(
            params, torch.from_numpy(imgs).to(device), repeat=20, extension=2,
            pair="population", compute_dtype=torch.bfloat16,
        )
        vecs, mask = batched_flow(f0, f1, FlowConfig())
    rows = table_rows(vecs.cpu().numpy(), mask.cpu().numpy(), periods, w, h)
    return rows, f0.float().cpu().numpy(), f1.float().cpu().numpy()


def table_rows(vecs, mask, periods, w=W, h=H):
    """One dict a period from the (P, K, 4) vectors and (P, K) mask:
    ``n`` vectors, ``ingate`` count, ``mean`` |d|, ``mean_ingate`` |d| and
    the in-gate unit flows' radial ``coherence``; only ``period`` and ``n``
    where no vector was found."""
    vecs = np.asarray(vecs, np.float64)
    rows = []
    for i, per in enumerate(periods):
        v = vecs[i][mask[i]]
        if len(v) == 0:
            rows.append({"period": per, "n": 0})
            continue
        px, py = v[:, 0] - w / 2, v[:, 1] - h / 2
        rr = np.hypot(px, py)
        ur = np.stack([px, py], -1) / np.maximum(rr, 1e-9)[:, None]
        norm = np.hypot(v[:, 2], v[:, 3])
        ing = norm <= 0.3
        # radial coherence of in-gate unit flows (|mean| -> 1 = coherent)
        u = v[ing, 2:4] / np.maximum(norm[ing], 1e-9)[:, None]
        coh = np.abs((u * ur[ing]).sum(-1).mean()) if ing.sum() > 1 else 0.0
        rows.append({"period": per, "n": len(v), "ingate": int(ing.sum()),
                     "mean": float(norm.mean()),
                     "mean_ingate": float(norm[ing].mean() if ing.any() else 0),
                     "coherence": float(coh)})
    return rows


def format_row(row):
    """A row as the JAX script prints it."""
    if row["n"] == 0:
        return f"{row['period']:7.1f}    0"
    return (f"{row['period']:7.1f} {row['n']:4d} {row['ingate']:6d} {row['mean']:7.3f} "
            f"{row['mean_ingate']:7.3f} {row['coherence']:8.3f}")


def main(argv=None):
    """Prints the JAX script's table; returns the rows and the flow frames
    (:func:`period_table`)."""
    p = argparse.ArgumentParser()
    p.add_argument("--model_bw", default=None)
    p.add_argument("--channels", default="1,16,32,64")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' must be asked for)")
    p.add_argument("--periods", default="4,6,8,10,12,16,20,28,36")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    channels = tuple(int(x) for x in args.channels.split(","))
    params = load_or_init(args.model_bw, channels, device=device)
    periods = [float(x) for x in args.periods.split(",")]
    rows, f0, f1 = period_table(params, periods, device)

    print(f"{'period':>7s} {'n':>4s} {'ingate':>6s} {'m|d|':>7s} "
          f"{'mg|d|':>7s} {'rad-coh':>8s}")
    for row in rows:
        print(format_row(row))
    return {"rows": rows, "frames": (f0, f1)}


if __name__ == "__main__":
    main()
