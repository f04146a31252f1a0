"""Cache the rated-gallery probe vector sets for the CPU ordering guard.

The port's counterpart of the JAX package's ``scripts/cache_probe_vectors.py``.
Runs the full probe pipeline (``evolution/probe.get_vectors``: 20 open-loop
+ 2 closed-loop steps, PNG-quantized flow pair, corner/LK flow) on the
reference's 8 rated stimuli with the BUNDLED stand-in predictors, and
writes the extracted vector sets to ``--out`` together with the SHA-256 of
each bundled weights file, after ratcheting the floors in ``--floors``.

Both paths must be given: the committed ``gallery/probe_vectors.npz`` and
``gallery/ordering_floors.json`` are the JAX package's ordering guard
(``tests/test_rated_ordering.py``), and no run of the port writes them
unless it is told to.  A run that regresses (a control that does not score
exactly 0.0, an image below its floor without ``--allow_regression``, an
aggregate below its floor without a decision record) writes nothing.

    python -m evolutionary_illusion_generator_tpu_torch.scripts.cache_probe_vectors \\
        --out probe_vectors.npz --floors ordering_floors.json [--device cpu]

Without ``--device cpu`` it needs a CUDA card.  The stimuli are not in the
repository: ``RATED_DIR`` names the directory they go in, in the
reference's layout (``rotate_01/small.png`` ... ``control/small.png``);
point it at a copy elsewhere to run on one.
"""

import argparse
import hashlib
import json
import os

import numpy as np

from .._device import resolve_device
from ..evolution.probe import get_vectors
from ..models.prednet.loader import bundled_weights_path
from ..ops.fitness.calculate import score_vectors
from ..structure import StructureType
from ..utils.png import read_png

__all__ = ["RATED_DIR", "IMAGES", "BW", "COLOR", "CIRCLES", "BENCH_NOTES",
           "check_aggregates", "ratchet_floors", "sha256_file", "main"]

# the reference's rated stimuli (its illusions_rating/EIGEN-images), which
# are not in the repository: where they go once added, at its root
RATED_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "illusions_rating", "EIGEN-images")

# (name, relpath, structure, published score) — eigen_own_ratings.csv
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

# the published table's circles family (eigen_own_ratings.csv rows 2-9,
# all 0.802-0.818): the aggregate whose average is floored so a promotion
# cannot trade several images down a margin each
CIRCLES = ["rotate_01", "rotate_02", "expand_01", "expand_02",
           "color_01_expand", "color_02_expand"]

# the decision records an aggregate floor's lowering must quote (read only)
BENCH_NOTES = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "BENCH_NOTES.md")


def check_aggregates(old_aggs, scores, margin, rationale=None,
                     notes_text=None):
    """Ratchet the AGGREGATE floors (circles-family average + manyfish).

    Unlike the per-image floors, these cannot be lowered by
    ``--allow_regression``: lowering needs a WRITTEN decision record — a
    non-empty ``rationale`` string that already appears verbatim in
    BENCH_NOTES.md (``notes_text``), so the trade is committed prose, not
    a flag.  Returns (new_aggs, violations, accepted) where ``violations``
    lists (name, floor, value) below-floor aggregates and ``accepted``
    says whether the rationale authorizes lowering them.
    """
    new_aggs = dict(old_aggs)
    current = {
        "circles_avg": sum(scores[n] for n in CIRCLES) / len(CIRCLES),
        "manyfish": scores["manyfish"],
    }
    accepted = bool(rationale) and bool(notes_text) and rationale in notes_text
    violations = []
    for name, value in current.items():
        old = old_aggs.get(name)
        candidate = round(value - margin, 3)
        if old is not None and value < old:
            violations.append((name, old, value))
            if accepted:
                new_aggs[name] = candidate
        else:
            new_aggs[name] = max(candidate, old) if old is not None \
                else candidate
    return new_aggs, violations, accepted


def ratchet_floors(old_floors, scores, margin, allow_regression=False):
    """Ratchet per-image score floors against a fresh probe run.

    Returns (new_floors, regressions).  For each rated image the candidate
    floor is ``score - margin``; floors only ever move UP unless
    ``allow_regression`` — a promotion that scores below a shipped floor is
    a fidelity regression and must be accepted explicitly.  The control
    image is guarded exactly-0.0 by the caller and is excluded.
    """
    new_floors = dict(old_floors)
    regressions = []
    for name, score in scores.items():
        if name == "control":
            continue
        candidate = round(score - margin, 3)
        old = old_floors.get(name)
        if old is not None and score < old:
            regressions.append((name, old, score))
            if allow_regression:
                new_floors[name] = candidate
        else:
            new_floors[name] = max(candidate, old) if old is not None \
                else candidate
    return new_floors, regressions


def sha256_file(path):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def main(argv=None):
    """Writes ``--out`` and ``--floors``; returns the scores by image."""
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' must be asked for)")
    p.add_argument("--out", required=True, help="the vector cache to write (.npz)")
    p.add_argument("--floors", required=True,
                   help="the floors file to read and ratchet in place (JSON)")
    p.add_argument(
        "--allow_regression", action="store_true",
        help="accept scores below the shipped PER-IMAGE floors and LOWER "
             "them (an explicit fidelity trade; without this flag a "
             "regression aborts before the cache is written).  Does NOT "
             "waive the aggregate floors — see --aggregate_rationale")
    p.add_argument(
        "--aggregate_rationale", default="",
        help="decision record authorizing an AGGREGATE floor lowering "
             "(circles-family average / manyfish).  The exact text must "
             "already appear in BENCH_NOTES.md — the trade ships as "
             "committed prose, not a flag")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    w, h = 160, 120
    payload = {}
    scores = {}
    for name, rel, structure, published in IMAGES:
        path = os.path.join(RATED_DIR, rel)
        mode = read_png(path)[1]
        channels = BW if mode == "L" else COLOR
        vec = np.asarray(
            get_vectors(path, None, channels, w, h, device=device), np.float64
        ).reshape(-1, 4)
        score = score_vectors(StructureType(structure), vec, w, h)
        payload[f"vec/{name}"] = vec
        payload[f"meta/{name}"] = np.asarray(
            [structure, published, score], np.float64
        )
        scores[name] = float(score)
        print(f"[cache] {name:17s} n={len(vec):4d} score={score:.3f} "
              f"(published {published})")

    # Ratchet the per-image floors BEFORE writing anything: a candidate
    # that regresses below the shipped generation must be accepted
    # explicitly, not slipped in behind a self-consistent cache.
    with open(args.floors) as f:
        floors_doc = json.load(f)
    margin = floors_doc["margin"]
    new_floors, regressions = ratchet_floors(
        floors_doc["floors"], scores, margin, args.allow_regression
    )
    if scores.get("control", 0.0) != 0.0 and not args.allow_regression:
        raise SystemExit(
            f"[cache] REGRESSION: control scores "
            f"{scores['control']:.3f}, published mechanism gives exactly "
            f"0.0 — refusing to write the cache (--allow_regression to "
            f"override)")
    if regressions:
        for name, old, score in regressions:
            print(f"[cache] REGRESSION: {name} {score:.3f} < floor {old:.3f}")
        if not args.allow_regression:
            raise SystemExit(
                "[cache] refusing to write a regressed cache "
                "(--allow_regression to accept the trade and lower the "
                "floors)")
        print("[cache] --allow_regression: floors LOWERED for the images "
              "above")

    # Aggregate floors: a promotion trading several images down a margin
    # each must clear the family-average bar too, and lowering THAT needs
    # a committed decision record, not a flag.
    notes_text = ""
    if os.path.exists(BENCH_NOTES):
        with open(BENCH_NOTES) as f:
            notes_text = f.read()
    new_aggs, agg_violations, agg_accepted = check_aggregates(
        floors_doc.get("aggregates", {}), scores, margin,
        rationale=args.aggregate_rationale or None, notes_text=notes_text,
    )
    if agg_violations:
        for name, old, value in agg_violations:
            print(f"[cache] AGGREGATE REGRESSION: {name} {value:.3f} < "
                  f"floor {old:.3f}")
        if not agg_accepted:
            raise SystemExit(
                "[cache] refusing to lower an aggregate floor: write the "
                "decision record into BENCH_NOTES.md first, then rerun "
                "with --aggregate_rationale '<that exact text>' "
                "(--allow_regression alone does not authorize this)")
        print("[cache] aggregate floors LOWERED per the BENCH_NOTES "
              "decision record")
        floors_doc.setdefault("aggregate_decisions", []).append({
            "violations": [
                {"name": n, "floor": o, "score": round(v, 3)}
                for n, o, v in agg_violations
            ],
            "rationale": args.aggregate_rationale,
        })

    for channels in (BW, COLOR):
        wp = bundled_weights_path(channels)
        if wp is None:
            raise SystemExit(f"no bundled weights for {channels}")
        key = "sha/" + "_".join(map(str, channels))
        payload[key] = np.frombuffer(
            bytes.fromhex(sha256_file(wp)), np.uint8
        )
    np.savez(args.out, **payload)
    print(f"[cache] wrote {args.out}")
    floors_doc["floors"] = new_floors
    floors_doc["aggregates"] = new_aggs
    with open(args.floors, "w") as f:
        json.dump(floors_doc, f, indent=2, sort_keys=False)
        f.write("\n")
    print(f"[cache] floors ratcheted -> {args.floors}")
    return scores


if __name__ == "__main__":
    main()
