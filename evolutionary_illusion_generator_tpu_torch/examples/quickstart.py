"""Quickstart: the notebook's workflow as a script, on the port.

The counterpart of the repo's ``examples/quickstart.py``: a short evolution
on the small grayscale circles config with the bundled stand-in
predictor, then the winning image scored again through the single-image
probe.

    python -m evolutionary_illusion_generator_tpu_torch.examples.quickstart \
        [output_dir] [--generations N] [--device cpu]

It runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

from ..evolution import neat_illusion
from ..evolution.probe import score_image
from ..neat import preset
from ..structure import StructureType

CHANNELS = (1, 16, 32, 64)


def run(output_dir: str = "quickstart_results", generations: int = 3, device=None) -> float:
    """Evolve, print the winner and the artifacts, and return the probe's
    score of ``best.png``."""
    # evolve (the notebook's generate_illusion.py -s 1 cell)
    pop = neat_illusion(
        output_dir,
        model_name=None,  # no .model file -> the bundled stand-in weights
        config=preset("circles_bw").replace(pop_size=8, min_species_size=4),
        structure=StructureType.Circles,
        w=160,
        h=120,
        channels=CHANNELS,
        c_dim=1,
        gradient=0,
        generations=generations,
        seed=0,
        device=device,
    )
    print(f"best fitness after {pop.generation} generations:", pop.best_genome.fitness)
    print("artifacts:", sorted(os.listdir(output_dir)))

    # the single-image probe (the notebook's scoring cells)
    score = score_image(os.path.join(output_dir, "best.png"), structure=StructureType.Circles,
                        channels=CHANNELS, w=160, h=120, device=device)
    print("probe re-score of best.png:", score)
    return score


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="quickstart: evolve, then probe the winner")
    parser.add_argument("output_dir", nargs="?", default="quickstart_results")
    parser.add_argument("--generations", type=int, default=3)
    parser.add_argument("--device", default="",
                        help="torch device (empty = the CUDA card; 'cpu' must be asked for)")
    args = parser.parse_args(argv)
    run(args.output_dir, args.generations, args.device or None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
