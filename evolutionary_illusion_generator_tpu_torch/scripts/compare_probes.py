"""Compare rated-probe JSONs (``probe_rated --json`` outputs).

The port's counterpart of the JAX package's ``scripts/compare_probes.py``,
the same table from the same files.  Prints a per-image table of scores
across N probe files plus the aggregate axes the weights program decides
on (circles avg/min, manyfish, control), so promoting a predictor variant
is a one-look decision::

    python -m evolutionary_illusion_generator_tpu_torch.scripts.compare_probes \\
        gallery/rated_probe_v5.json probe_v6a.json

Columns are labeled by file basename.  Reference published values come
from the first file's ``published`` fields.  Host only: it reads JSON and
touches no device.
"""

import json
import os
import sys

__all__ = ["CIRCLES_BW", "CIRCLES_COLOR", "main"]

CIRCLES_BW = ("rotate_01", "rotate_02", "expand_01", "expand_02")
CIRCLES_COLOR = ("color_01_expand", "color_02_expand")


def main(argv=None):
    paths = (argv if argv is not None else sys.argv[1:])
    if len(paths) < 2:
        raise SystemExit(__doc__)
    runs = []
    for p in paths:
        with open(p) as f:
            d = json.load(f)
        # probe_rated --json writes {"results": ...}; the promoted gallery
        # tables (rated_probe_v*.json) use {"scores": ...}
        table = d.get("scores") or d.get("results")
        if table is None:
            raise SystemExit(f"{p}: neither 'scores' nor 'results' key")
        runs.append((os.path.basename(p).replace(".json", ""), table))

    images = sorted(runs[0][1])
    names = [n for n, _ in runs]
    head = f"{'image':>16s} {'pub':>6s} " + " ".join(
        f"{n[:12]:>12s}" for n in names
    )
    print(head)
    for img in images:
        pub = runs[0][1][img].get("published", float("nan"))
        row = f"{img:>16s} {pub:6.3f} "
        row += " ".join(
            f"{r.get(img, {}).get('ours', float('nan')):12.4f}"
            for _, r in runs
        )
        print(row)

    print()
    for group, keys in (("circles_bw", CIRCLES_BW),
                        ("circles_color", CIRCLES_COLOR)):
        for agg, fn in (("avg", lambda v: sum(v) / len(v)), ("min", min)):
            row = f"{group + ' ' + agg:>23s} "
            for _, r in runs:
                vals = [r[k]["ours"] for k in keys if k in r]
                row += f"{fn(vals) if vals else float('nan'):12.4f} "
            print(row)
    return 0


if __name__ == "__main__":
    sys.exit(main())
