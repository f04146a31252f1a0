"""Extract plain predictor weights from a ``pretrain`` training checkpoint.

The port's counterpart of the JAX package's ``scripts/ckpt_to_weights.py``.
The rolling checkpoints that ``pretrain`` writes (``--out``'s
``.part-*`` files, both packages' format) carry the params as
``p/l{l}/{name}`` beside the optimizer state and the random key; the
loaders take only ``save_params`` files (``l{l}/{name}``).  This converts
the former to the latter through the port's
:func:`..models.prednet.loader.save_params` (float32, as the JAX script
writes).  It reads and writes numpy files only, on the CPU::

    python3 -m evolutionary_illusion_generator_tpu_torch.scripts.ckpt_to_weights \\
        <ckpt.npz> <weights_out.npz>
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..models.prednet.loader import params_from_numpy, save_params

__all__ = ["main"]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("src", help="a pretrain checkpoint (p/l{l}/{name} keys)")
    p.add_argument("dst", help="the save_params NPZ to write")
    args = p.parse_args(argv)
    data = np.load(args.src)
    pkeys = [k for k in data.files if k.startswith("p/l")]
    if not pkeys:
        raise SystemExit(f"{args.src}: no p/l*/ params keys — not a pretrain "
                         f"checkpoint (keys: {sorted(data.files)[:8]}...)")
    layers: dict = {}
    for k in pkeys:
        _, lpart, name = k.split("/", 2)
        layers.setdefault(int(lpart[1:]), {})[name] = data[k]
    params = params_from_numpy([layers[i] for i in sorted(layers)], torch.float32, "cpu")
    save_params(params, args.dst)
    step = int(data["step"]) if "step" in data.files else -1
    print(f"[ckpt2w] {args.src} (step {step}) -> {args.dst} ({len(params)} layers)")


if __name__ == "__main__":
    main()
