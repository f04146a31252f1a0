"""Checkpoint / resume.

The reference checkpoints every 100 generations via ``neat.Checkpointer(100)``
(generate_illusion.py:696-708) — a crash loses up to 99 generations.  Genomes
are KBs, so this build defaults to EVERY generation (BASELINE.json config 5:
"per-gen checkpointing") and snapshots the full resumable state: population,
species, genome indexer, RNG state, generation counter, and best-so-far.
"""

from __future__ import annotations

import glob
import os
import pickle
from typing import Optional

from .population import Population
from .reporters import BaseReporter

__all__ = ["Checkpointer", "save_checkpoint", "restore_checkpoint"]

_STATE_KEYS = (
    "config",
    "generation",
    "population",
    "best_genome",
)


def save_checkpoint(pop: Population, path: str) -> None:
    state = {
        "config": pop.config,
        "generation": pop.generation,
        "population": pop.population,
        "species_set": pop.species_set,
        "reproduction": pop.reproduction,
        "rng_state": pop.rng.getstate(),
        "best_genome": pop.best_genome,
    }
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(state, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)


def restore_checkpoint(path: str) -> Population:
    with open(path, "rb") as f:
        state = pickle.load(f)
    pop = Population.__new__(Population)
    pop.config = state["config"]
    pop.generation = state["generation"]
    pop.population = state["population"]
    pop.species_set = state["species_set"]
    pop.reproduction = state["reproduction"]
    pop.best_genome = state["best_genome"]
    from random import Random

    pop.rng = Random()
    pop.rng.setstate(state["rng_state"])
    pop.reporters = []
    return pop


class Checkpointer(BaseReporter):
    """Reporter that snapshots the population every N generations.

    ``Checkpointer(100)`` matches the reference cadence; the framework
    default is 1.  Files are named ``neat-checkpoint-<gen>`` for parity with
    the reference artifact contract (SURVEY.md Appendix B).
    """

    def __init__(
        self,
        generation_interval: int = 1,
        directory: str = ".",
        prefix: str = "neat-checkpoint-",
        keep_last: Optional[int] = 5,
    ) -> None:
        self.generation_interval = generation_interval
        self.directory = directory
        self.prefix = prefix
        self.keep_last = keep_last
        self._population: Optional[Population] = None

    def attach(self, population: Population) -> None:
        self._population = population

    def end_generation(self, population, species_set) -> None:
        pop = self._population
        if pop is None:
            return
        if pop.generation % self.generation_interval == 0:
            os.makedirs(self.directory, exist_ok=True)
            path = os.path.join(self.directory, f"{self.prefix}{pop.generation}")
            save_checkpoint(pop, path)
            if self.keep_last is not None:
                existing = sorted(
                    glob.glob(os.path.join(self.directory, self.prefix + "*")),
                    key=lambda p: int(p.rsplit("-", 1)[-1]),
                )
                for stale in existing[: -self.keep_last]:
                    os.remove(stale)

    @staticmethod
    def restore_checkpoint(path: str) -> Population:
        return restore_checkpoint(path)
