"""Generational NEAT loop (neat-python Population.run semantics,
generate_illusion.py:688-711): evaluate -> report -> (optional fitness
termination) -> reproduce -> handle extinction -> speciate."""

from __future__ import annotations

from random import Random
from typing import Callable, Dict, List, Optional

import numpy as np

from .config import NeatConfig
from .genome import Genome
from .reporters import BaseReporter
from .reproduction import Reproduction
from .species import SpeciesSet

__all__ = ["Population", "CompleteExtinctionException"]


class CompleteExtinctionException(Exception):
    pass


_CRITERIA = {
    "max": max,
    "min": min,
    "mean": lambda xs: float(np.mean(xs)),
}


class Population:
    """Top-level NEAT run state.

    ``fitness_function(list_of_(gid, genome), config)`` must assign
    ``genome.fitness`` for every member — the same contract as the
    reference's ``eval_genomes`` closure (generate_illusion.py:692-694).
    """

    def __init__(self, config: NeatConfig, seed: Optional[int] = None) -> None:
        self.config = config
        self.rng = Random(seed)
        self.reproduction = Reproduction()
        self.species_set = SpeciesSet()
        self.reporters: List[BaseReporter] = []
        self.generation = 0
        self.best_genome: Optional[Genome] = None
        self.population: Dict[int, Genome] = self.reproduction.create_new(
            config, config.pop_size, self.rng
        )
        self.species_set.speciate(config, self.population, self.generation)

    def add_reporter(self, reporter: BaseReporter) -> None:
        self.reporters.append(reporter)

    def _report(self, method: str, *args) -> None:
        for r in self.reporters:
            getattr(r, method)(*args)

    def run_generation(self, fitness_function: Callable) -> Genome:
        """Run exactly one generation; returns this generation's best genome."""
        cfg = self.config
        self._report("start_generation", self.generation)

        fitness_function(list(self.population.items()), cfg)

        best = None
        for g in self.population.values():
            if g.fitness is None:
                raise RuntimeError(f"fitness not assigned to genome {g.key}")
            if best is None or g.fitness > best.fitness:
                best = g
        self._report("post_evaluate", self.population, self.species_set, best)
        if self.best_genome is None or best.fitness > self.best_genome.fitness:
            self.best_genome = best.copy()

        self.population = self.reproduction.reproduce(
            cfg, self.species_set, cfg.pop_size, self.generation, self.rng
        )

        if not self.species_set.species:
            if cfg.reset_on_extinction:
                self.population = self.reproduction.create_new(
                    cfg, cfg.pop_size, self.rng
                )
            else:
                raise CompleteExtinctionException()

        self.species_set.speciate(cfg, self.population, self.generation)
        # Increment BEFORE the end-of-generation report: a checkpoint written
        # by a reporter then snapshots the exact resume point (the next
        # generation's input population).
        self.generation += 1
        self._report("end_generation", self.population, self.species_set)
        return best

    def run(self, fitness_function: Callable, n: Optional[int] = None) -> Genome:
        """Run up to ``n`` generations (or until the fitness criterion is met
        when ``no_fitness_termination`` is off)."""
        cfg = self.config
        k = 0
        while n is None or k < n:
            k += 1
            best = self.run_generation(fitness_function)
            if not cfg.no_fitness_termination:
                criterion = _CRITERIA[cfg.fitness_criterion]
                fv = criterion([g.fitness for g in self.population.values()]
                               if self.population else [best.fitness])
                if fv >= cfg.fitness_threshold:
                    break
        return self.best_genome
