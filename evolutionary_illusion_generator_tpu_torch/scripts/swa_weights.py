"""Average several saved PredNet weight files (uniform SWA).

The port's counterpart of the JAX package's ``scripts/swa_weights.py``: the
mean, in float32, of each array over snapshots of one training trajectory
(the same keys and shapes in every file), written atomically.  numpy only::

    python3 -m evolutionary_illusion_generator_tpu_torch.scripts.swa_weights \\
        OUT.npz IN1.npz IN2.npz [...]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

__all__ = ["main"]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("out")
    p.add_argument("ins", nargs="+")
    args = p.parse_args(argv)
    out, ins = args.out, args.ins
    if len(ins) < 2:
        raise SystemExit("need at least two snapshots to average")
    stacks: dict = {}
    keys = None
    for path in ins:
        with np.load(path) as z:
            k = sorted(z.files)
            if keys is not None and k != keys:
                raise SystemExit(f"key mismatch in {path}")
            keys = k
            for name in k:
                stacks.setdefault(name, []).append(np.asarray(z[name], dtype=np.float32))
    avg = {name: np.mean(np.stack(arrs), axis=0) for name, arrs in stacks.items()}
    tmp = out + ".tmp.npz"
    np.savez(tmp, **avg)
    os.replace(tmp, out)
    print(f"[swa] wrote {out} = mean of {len(ins)} files ({len(avg)} arrays)")


if __name__ == "__main__":
    main()
