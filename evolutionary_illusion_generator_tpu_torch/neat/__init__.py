"""Host-side NEAT engine.

A fresh implementation with neat-python-compatible semantics (the engine the
reference delegates its whole generational loop to,
generate_illusion.py:688-711): genomes, compatibility-distance speciation,
stagnation, fitness-sharing reproduction, reporters, per-generation
checkpointing, and an INI-compatible config loader with the five reference
presets built in.
"""

from .checkpoint import Checkpointer, restore_checkpoint, save_checkpoint
from .config import PRESET_NAMES, NeatConfig, load_config, preset
from .genome import ConnectionGene, Genome, NodeGene, creates_cycle
from .population import CompleteExtinctionException, Population
from .reporters import (
    JsonlReporter,
    StatisticsReporter,
    StdOutReporter,
    TensorBoardReporter,
)
from .reproduction import Reproduction
from .species import Species, SpeciesSet

__all__ = [
    "NeatConfig",
    "load_config",
    "preset",
    "PRESET_NAMES",
    "Genome",
    "NodeGene",
    "ConnectionGene",
    "creates_cycle",
    "Population",
    "CompleteExtinctionException",
    "Reproduction",
    "Species",
    "SpeciesSet",
    "Checkpointer",
    "save_checkpoint",
    "restore_checkpoint",
    "StdOutReporter",
    "StatisticsReporter",
    "JsonlReporter",
    "TensorBoardReporter",
]
