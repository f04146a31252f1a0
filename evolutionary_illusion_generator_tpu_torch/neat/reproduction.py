"""Reproduction with explicit fitness sharing (neat-python
DefaultReproduction semantics): per-species adjusted fitness drives spawn
counts (floored at ``min_species_size``), the top ``elitism`` members of each
species are copied verbatim, and parents are drawn from the top
``survival_threshold`` fraction."""

from __future__ import annotations

import math
from random import Random
from typing import Dict, List

from .config import NeatConfig
from .genome import Genome
from .species import SpeciesSet
from .stagnation import update_stagnation

__all__ = ["Reproduction"]


class Reproduction:
    def __init__(self) -> None:
        self.genome_indexer = 0
        self.ancestors: Dict[int, tuple] = {}

    def _next_genome_key(self) -> int:
        self.genome_indexer += 1
        return self.genome_indexer

    def create_new(self, cfg: NeatConfig, num: int, rng: Random) -> Dict[int, Genome]:
        pop = {}
        for _ in range(num):
            key = self._next_genome_key()
            pop[key] = Genome.new(key, cfg, rng)
        return pop

    @staticmethod
    def compute_spawn(
        adjusted_fitnesses: List[float],
        previous_sizes: List[int],
        pop_size: int,
        min_species_size: int,
    ) -> List[int]:
        """Proportional spawn sizes with damping and a per-species floor.

        Note: with ``min_species_size`` of 10-20 (circles/free presets) the
        effective population exceeds the nominal ``pop_size`` — a documented
        property of the shipped configs (SURVEY.md §2.1)."""
        af_sum = sum(adjusted_fitnesses)
        spawn_amounts = []
        for af, ps in zip(adjusted_fitnesses, previous_sizes):
            if af_sum > 0:
                s = max(min_species_size, af / af_sum * pop_size)
            else:
                s = min_species_size
            d = (s - ps) * 0.5
            c = int(round(d))
            spawn = ps
            if abs(c) > 0:
                spawn += c
            elif d > 0:
                spawn += 1
            elif d < 0:
                spawn -= 1
            spawn_amounts.append(spawn)

        total_spawn = sum(spawn_amounts)
        norm = pop_size / total_spawn
        return [
            max(min_species_size, int(round(n * norm))) for n in spawn_amounts
        ]

    def reproduce(
        self,
        cfg: NeatConfig,
        species_set: SpeciesSet,
        pop_size: int,
        generation: int,
        rng: Random,
    ) -> Dict[int, Genome]:
        # stagnation filter
        all_fitnesses: List[float] = []
        remaining = []
        for sid, s, stagnant in update_stagnation(cfg, species_set, generation):
            if stagnant:
                continue
            all_fitnesses.extend(s.get_fitnesses())
            remaining.append(s)

        if not remaining:
            species_set.species = {}
            return {}

        # explicit fitness sharing
        min_f = min(all_fitnesses)
        max_f = max(all_fitnesses)
        fitness_range = max(1.0, max_f - min_f)
        for s in remaining:
            mean_fit = sum(s.get_fitnesses()) / len(s.members)
            s.adjusted_fitness = (mean_fit - min_f) / fitness_range

        adjusted = [s.adjusted_fitness for s in remaining]
        previous_sizes = [len(s.members) for s in remaining]
        min_species_size = max(cfg.min_species_size, cfg.elitism)
        spawn_amounts = self.compute_spawn(
            adjusted, previous_sizes, pop_size, min_species_size
        )

        new_population: Dict[int, Genome] = {}
        species_set.species = {}
        for spawn, s in zip(spawn_amounts, remaining):
            spawn = max(spawn, cfg.elitism)
            old_members = sorted(
                s.members.items(), key=lambda kv: kv[1].fitness, reverse=True
            )
            s.members = {}
            species_set.species[s.key] = s

            # elites pass through unchanged (same key, same genome)
            for gid, genome in old_members[: cfg.elitism]:
                new_population[gid] = genome
                spawn -= 1
            if spawn <= 0:
                continue

            cutoff = max(
                int(math.ceil(cfg.survival_threshold * len(old_members))), 2
            )
            parents_pool = old_members[:cutoff]

            while spawn > 0:
                spawn -= 1
                _, parent1 = parents_pool[rng.randrange(len(parents_pool))]
                _, parent2 = parents_pool[rng.randrange(len(parents_pool))]
                if parent2.fitness > parent1.fitness:
                    parent1, parent2 = parent2, parent1
                gid = self._next_genome_key()
                child = Genome.crossover(gid, parent1, parent2, rng)
                child.mutate(cfg, rng)
                new_population[gid] = child
                self.ancestors[gid] = (parent1.key, parent2.key)

        return new_population
