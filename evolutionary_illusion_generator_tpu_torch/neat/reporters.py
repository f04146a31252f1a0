"""Generation reporters: stdout table, in-memory statistics, JSONL metrics.

Parity targets: neat.StdOutReporter / neat.StatisticsReporter
(generate_illusion.py:705-707) plus the structured per-generation JSONL
telemetry the reference lacks (SURVEY.md §5 observability row)."""

from __future__ import annotations

import json
import time
from typing import Dict, List, Optional

import numpy as np

__all__ = [
    "BaseReporter",
    "StdOutReporter",
    "StatisticsReporter",
    "JsonlReporter",
    "TensorBoardReporter",
]


class BaseReporter:
    def start_generation(self, generation: int) -> None: ...

    def post_evaluate(self, population, species_set, best_genome) -> None: ...

    def end_generation(self, population, species_set) -> None: ...

    def info(self, msg: str) -> None: ...


class StdOutReporter(BaseReporter):
    def __init__(self, show_species_detail: bool = True) -> None:
        self.show_species_detail = show_species_detail
        self.generation: Optional[int] = None
        self._t0 = 0.0

    def start_generation(self, generation: int) -> None:
        self.generation = generation
        self._t0 = time.time()
        print(f"\n ****** Running generation {generation} ****** \n")

    def post_evaluate(self, population, species_set, best_genome) -> None:
        fitnesses = [g.fitness for g in population.values()]
        print(
            f"Population's average fitness: {np.mean(fitnesses):3.5f} "
            f"stdev: {np.std(fitnesses):3.5f}"
        )
        sid = species_set.genome_to_species.get(best_genome.key, "?")
        print(
            f"Best fitness: {best_genome.fitness:3.5f} - size: {best_genome.size()} "
            f"- species {sid} - id {best_genome.key}"
        )

    def end_generation(self, population, species_set) -> None:
        ng = len(population)
        ns = len(species_set.species)
        print(f"Population of {ng} members in {ns} species")
        if self.show_species_detail:
            print("   ID   age  size   fitness   adj fit")
            print("  ====  ===  ====  =========  =======")
            for sid in sorted(species_set.species):
                s = species_set.species[sid]
                age = self.generation - s.created
                f = "--" if s.fitness is None else f"{s.fitness:.3f}"
                af = "--" if s.adjusted_fitness is None else f"{s.adjusted_fitness:.3f}"
                print(f"  {sid:>4}  {age:>3}  {len(s.members):>4}  {f:>9}  {af:>7}")
        print(f"Generation time: {time.time() - self._t0:.3f} sec")

    def info(self, msg: str) -> None:
        print(msg)


class StatisticsReporter(BaseReporter):
    """In-memory per-generation fitness statistics."""

    def __init__(self) -> None:
        self.most_fit_genomes: List = []
        self.generation_statistics: List[Dict] = []

    def post_evaluate(self, population, species_set, best_genome) -> None:
        self.most_fit_genomes.append(best_genome.copy())
        species_stats: Dict[int, Dict[int, float]] = {}
        for sid, s in species_set.species.items():
            species_stats[sid] = {
                gid: g.fitness for gid, g in s.members.items() if g.fitness is not None
            }
        self.generation_statistics.append(species_stats)

    def get_fitness_mean(self) -> List[float]:
        return [
            float(np.mean([f for ss in gen.values() for f in ss.values()]))
            for gen in self.generation_statistics
        ]

    def best_genome(self):
        return max(self.most_fit_genomes, key=lambda g: g.fitness)


class TensorBoardReporter(BaseReporter):
    """Per-generation scalars as TensorBoard event files (SURVEY.md §5
    observability row's optional extra beside the JSONL metrics).

    The writer import is lazy so the dependency stays optional: constructing
    the reporter without a usable ``tensorboard`` install raises ImportError.
    """

    def __init__(self, log_dir: str) -> None:
        from torch.utils.tensorboard import SummaryWriter

        self._writer = SummaryWriter(log_dir=log_dir)
        self.generation: Optional[int] = None
        self._t0 = 0.0

    def start_generation(self, generation: int) -> None:
        self.generation = generation
        self._t0 = time.time()

    def post_evaluate(self, population, species_set, best_genome) -> None:
        fitnesses = [g.fitness for g in population.values()]
        g = self.generation
        w = self._writer
        w.add_scalar("fitness/mean", float(np.mean(fitnesses)), g)
        w.add_scalar("fitness/std", float(np.std(fitnesses)), g)
        w.add_scalar("fitness/max", float(np.max(fitnesses)), g)
        w.add_scalar("population/size", len(population), g)
        w.add_scalar("population/num_species", len(species_set.species), g)
        w.add_scalar("best/nodes", best_genome.size()[0], g)
        w.add_scalar("best/connections", best_genome.size()[1], g)
        w.add_scalar("time/eval_seconds", time.time() - self._t0, g)
        w.flush()

    def close(self) -> None:
        self._writer.close()


class JsonlReporter(BaseReporter):
    """Structured per-generation metrics: one JSON object per line."""

    def __init__(self, path: str) -> None:
        self.path = path
        self.generation: Optional[int] = None
        self._t0 = 0.0

    def start_generation(self, generation: int) -> None:
        self.generation = generation
        self._t0 = time.time()

    def post_evaluate(self, population, species_set, best_genome) -> None:
        fitnesses = [g.fitness for g in population.values()]
        rec = {
            "generation": self.generation,
            "pop_size": len(population),
            "num_species": len(species_set.species),
            "fitness_mean": float(np.mean(fitnesses)),
            "fitness_std": float(np.std(fitnesses)),
            "fitness_max": float(np.max(fitnesses)),
            "best_genome": best_genome.key,
            "best_size_nodes": best_genome.size()[0],
            "best_size_conns": best_genome.size()[1],
            "eval_seconds": time.time() - self._t0,
            "species_sizes": {
                str(sid): len(s.members) for sid, s in species_set.species.items()
            },
        }
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
