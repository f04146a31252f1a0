"""Speciation by compatibility distance (neat-python DefaultSpeciesSet
semantics): each existing species re-anchors on the unspeciated genome
closest to its previous representative, remaining genomes join the nearest
species within ``compatibility_threshold`` or found a new one."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .config import NeatConfig
from .genome import Genome

__all__ = ["Species", "SpeciesSet"]


@dataclass
class Species:
    key: int
    created: int
    last_improved: int
    representative: Optional[Genome] = None
    members: Dict[int, Genome] = field(default_factory=dict)
    fitness: Optional[float] = None
    adjusted_fitness: Optional[float] = None
    fitness_history: List[float] = field(default_factory=list)

    def get_fitnesses(self) -> List[float]:
        return [g.fitness for g in self.members.values()]


class SpeciesSet:
    def __init__(self) -> None:
        self.species: Dict[int, Species] = {}
        self.genome_to_species: Dict[int, int] = {}
        self._next_key = 1

    def speciate(
        self, cfg: NeatConfig, population: Dict[int, Genome], generation: int
    ) -> None:
        unspeciated = set(population)
        new_representatives: Dict[int, int] = {}
        new_members: Dict[int, List[int]] = {}
        distances: Dict[tuple, float] = {}

        def dist(g1: Genome, g2: Genome) -> float:
            k = (g1.key, g2.key)
            if k not in distances:
                d = g1.distance(g2, cfg)
                distances[k] = d
                distances[(g2.key, g1.key)] = d
            return distances[k]

        # re-anchor surviving species on the closest unspeciated genome
        for sid, species in self.species.items():
            if not unspeciated:
                break
            best_gid = min(
                sorted(unspeciated),
                key=lambda gid: dist(species.representative, population[gid]),
            )
            new_representatives[sid] = best_gid
            new_members[sid] = [best_gid]
            unspeciated.remove(best_gid)

        # assign the rest
        for gid in sorted(unspeciated):
            genome = population[gid]
            candidates = []
            for sid, rid in new_representatives.items():
                d = dist(population[rid], genome)
                if d < cfg.compatibility_threshold:
                    candidates.append((d, sid))
            if candidates:
                _, sid = min(candidates)
                new_members[sid].append(gid)
            else:
                sid = self._next_key
                self._next_key += 1
                new_representatives[sid] = gid
                new_members[sid] = [gid]

        # rebuild species objects
        self.genome_to_species = {}
        old = self.species
        self.species = {}
        for sid, rid in new_representatives.items():
            s = old.get(sid)
            if s is None:
                s = Species(key=sid, created=generation, last_improved=generation)
            s.representative = population[rid]
            s.members = {gid: population[gid] for gid in new_members[sid]}
            self.species[sid] = s
            for gid in new_members[sid]:
                self.genome_to_species[gid] = sid
