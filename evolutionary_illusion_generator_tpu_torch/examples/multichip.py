"""Multi-device example: the ``pop256_v5e8`` run preset on a device mesh.

The counterpart of the repo's ``examples/multichip.py``.  With eight CUDA
devices it runs as is, the population sharded over all of them:

    python -m evolutionary_illusion_generator_tpu_torch.examples.multichip

With fewer it raises ``make_mesh``'s ``ValueError``.  ``--device D`` asks
for an explicit mesh of the preset's eight entries all on ``D`` (a repeated
device, one logical shard per entry, the counterpart of the JAX example's
virtual CPU mesh): ``--device cuda:0`` on one card, ``--device cpu`` on the
CPU, with ``--tiny`` for small shapes:

    python -m evolutionary_illusion_generator_tpu_torch.examples.multichip --tiny --device cpu

Multi-process runs: set JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES and
JAX_PROCESS_ID (``parallel/distributed.py``) on every process; with
``--device`` each process then puts its share of the eight entries there
(four each for two processes).
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from ..configs import run_preset
from ..evolution.driver import neat_illusion
from ..parallel import initialize_distributed
from ..parallel.distributed import process_count


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tiny", action="store_true", help="shrink shapes for a quick smoke run")
    p.add_argument("--generations", type=int, default=3)
    p.add_argument("--output_dir", default="multichip_results")
    p.add_argument("--device", default="",
                   help="put every mesh entry on this device (empty = every CUDA device)")
    args = p.parse_args(argv)

    # multi-process runs: JAX_COORDINATOR_ADDRESS etc.; a no-op otherwise
    initialize_distributed()

    rp = run_preset("pop256_v5e8")
    kwargs = rp.driver_kwargs()
    if args.tiny:
        kwargs.update(w=64, h=48, channels=(3, 4, 8), microbatch=8,
                      config=rp.neat.replace(pop_size=16, num_hidden=4))
    # each process's share of the preset's entries
    device = [args.device] * (rp.n_devices // process_count()) if args.device else None
    pop = neat_illusion(args.output_dir, None, n_devices=rp.n_devices,
                        generations=args.generations, quiet=False, device=device, **kwargs)
    print("best fitness:", pop.best_genome.fitness)
    return 0


if __name__ == "__main__":
    sys.exit(main())
