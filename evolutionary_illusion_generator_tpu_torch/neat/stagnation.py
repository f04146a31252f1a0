"""Species stagnation (neat-python DefaultStagnation semantics): a species
that has not improved its ``species_fitness_func`` (max, per the shipped
configs) for ``max_stagnation`` generations is removed, but the top
``species_elitism`` species always survive."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .config import NeatConfig
from .species import Species, SpeciesSet

__all__ = ["update_stagnation"]

_FITNESS_FUNCS = {
    "max": max,
    "min": min,
    "mean": lambda xs: float(np.mean(xs)),
    "median": lambda xs: float(np.median(xs)),
}


def update_stagnation(
    cfg: NeatConfig, species_set: SpeciesSet, generation: int
) -> List[Tuple[int, Species, bool]]:
    """Returns [(species_id, species, is_stagnant)]."""
    func = _FITNESS_FUNCS[cfg.species_fitness_func]

    species_data = []
    for sid, s in species_set.species.items():
        prev = max(s.fitness_history) if s.fitness_history else -float("inf")
        s.fitness = func(s.get_fitnesses())
        s.fitness_history.append(s.fitness)
        s.adjusted_fitness = None
        if s.fitness > prev:
            s.last_improved = generation
        species_data.append((sid, s))

    # ascending species fitness; the fittest are considered last and are the
    # ones protected by species_elitism
    species_data.sort(key=lambda x: x[1].fitness)

    result = []
    num_non_stagnant = len(species_data)
    for idx, (sid, s) in enumerate(species_data):
        stagnant_time = generation - s.last_improved
        is_stagnant = False
        if num_non_stagnant > cfg.species_elitism:
            is_stagnant = stagnant_time >= cfg.max_stagnation
        if len(species_data) - idx <= cfg.species_elitism:
            is_stagnant = False
        if is_stagnant:
            num_non_stagnant -= 1
        result.append((sid, s, is_stagnant))
    return result
