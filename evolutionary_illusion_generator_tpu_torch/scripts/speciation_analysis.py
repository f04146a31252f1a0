"""Speciation-plateau anatomy — reproducible evidence.

The port's counterpart of the JAX package's ``scripts/speciation_analysis.py``,
on the port's ``neat/`` copy.  Two measurements:

1. **Checkpoint distance anatomy**: pairwise compatibility distances inside
   the 100-generation circles_bw deep run (``gallery/circles_bw_deep``
   checkpoints, read only).  A single species is the forced outcome of the
   reference's own distance function on these populations when no pair
   crosses the 3.0 threshold.

2. **Isolated-lineage divergence**: two populations evolved ``generations``
   generations under the same circles_bw config with NO interbreeding
   (independent seeds; deterministic structure-sensitive synthetic fitness
   so selection pressure is real): cross-lineage against within-lineage
   distances, and the species of the merged population.

Host only, no device::

    python -m evolutionary_illusion_generator_tpu_torch.scripts.speciation_analysis

The deep run's checkpoints were written by the JAX package's ``neat/``:
they are unpickled with its module names mapped onto the port's copy, so
nothing of the JAX package is imported.
"""

import os
import pickle
from random import Random

import numpy as np

from ..neat import Population, preset
from ..neat.species import SpeciesSet

__all__ = ["DEEP_RUN", "checkpoint_anatomy", "synth_fitness", "isolated_lineages", "main"]

DEEP_RUN = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "gallery", "circles_bw_deep")

_JAX_PACKAGE = "evolutionary_illusion_generator_tpu"
_PORT_PACKAGE = "evolutionary_illusion_generator_tpu_torch"


class _PortUnpickler(pickle.Unpickler):
    """Reads a checkpoint of either package into the port's classes."""

    def find_class(self, module, name):
        if module == _JAX_PACKAGE or module.startswith(_JAX_PACKAGE + "."):
            module = _PORT_PACKAGE + module[len(_JAX_PACKAGE):]
        return super().find_class(module, name)


def _restore(path):
    """``neat.restore_checkpoint`` for a checkpoint the JAX package wrote:
    the population as a :class:`Population` of the port's classes."""
    with open(path, "rb") as f:
        state = _PortUnpickler(f).load()
    pop = Population.__new__(Population)
    for key in ("config", "generation", "population", "species_set", "reproduction",
                "best_genome"):
        setattr(pop, key, state[key])
    pop.rng = Random()
    pop.rng.setstate(state["rng_state"])
    pop.reporters = []
    return pop


def checkpoint_anatomy(deep_run=DEEP_RUN):
    print("== deep-run checkpoint distance anatomy ==")
    for gen in (25, 50, 75, 100):
        path = os.path.join(deep_run, f"neat-checkpoint-{gen}")
        if not os.path.exists(path):
            print(f"gen {gen}: checkpoint missing, skipped")
            continue
        pop = _restore(path)
        genomes = list(pop.population.values())
        cfg = pop.config
        ds = np.array(
            [
                g1.distance(g2, cfg)
                for i, g1 in enumerate(genomes)
                for g2 in genomes[i + 1:]
            ]
        )
        nodes = [len(g.nodes) for g in genomes]
        print(
            f"gen {gen:3d}: pop {len(genomes)}, dist mean {ds.mean():.3f} "
            f"max {ds.max():.3f} (threshold {cfg.compatibility_threshold}) "
            f"| nodes {min(nodes)}-{max(nodes)} "
            f"| frac>thr {(ds > cfg.compatibility_threshold).mean():.3f}"
        )


def synth_fitness(items, _config):
    """Deterministic structure-sensitive fitness: real selection pressure
    without the device pipeline."""
    for _gid, g in items:
        ws = [c.weight for c in g.connections.values() if c.enabled]
        g.fitness = float(np.tanh(abs(sum(ws)) / (1 + len(ws))))


def isolated_lineages(generations=100, seeds=(101, 202)):
    print("== isolated-lineage divergence ==")
    cfg = preset("circles_bw")
    lineages = []
    for seed in seeds:
        p = Population(cfg, seed=seed)
        for _ in range(generations):
            p.run_generation(synth_fitness)
        print(
            f"seed {seed}: gen {p.generation}, "
            f"species {len(p.species_set.species)}"
        )
        lineages.append(list(p.population.values()))

    a, b = lineages
    cross = np.array([g1.distance(g2, cfg) for g1 in a for g2 in b])
    within = np.array(
        [g1.distance(g2, cfg) for i, g1 in enumerate(a) for g2 in a[i + 1:]]
    )
    print(
        f"cross-lineage dist: mean {cross.mean():.3f} max {cross.max():.3f} "
        f"frac>{cfg.compatibility_threshold} "
        f"{(cross > cfg.compatibility_threshold).mean():.3f}"
    )
    print(f"within-lineage dist: mean {within.mean():.3f} max {within.max():.3f}")

    merged = {i: g for i, g in enumerate(a + b)}
    ss = SpeciesSet()
    ss.speciate(cfg, merged, 0)
    print(
        f"merged speciation: {len(ss.species)} species, sizes "
        f"{sorted(len(s.members) for s in ss.species.values())}"
    )


def main():
    checkpoint_anatomy()
    isolated_lineages()
    return 0


if __name__ == "__main__":
    main()
