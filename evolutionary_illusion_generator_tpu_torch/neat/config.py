"""NEAT configuration: INI-compatible loader + named presets.

The reference drives neat-python with INI files (neat_configs/*.txt,
selected by structure/color/gradient at generate_illusion.py:750-766).  This
module parses that exact format (sections [NEAT], [DefaultGenome],
[DefaultSpeciesSet], [DefaultStagnation], [DefaultReproduction]) and also
ships the five reference presets as programmatic constructors so runs work
without any external file.
"""

from __future__ import annotations

import configparser
import dataclasses
from dataclasses import dataclass, field
from typing import List, Tuple

__all__ = ["NeatConfig", "load_config", "preset", "PRESET_NAMES"]

ACTIVATION_OPTIONS = ("sin", "sigmoid", "gauss", "tanh", "relu", "abs", "identity")
AGGREGATION_OPTIONS = ("sum", "product", "max", "min", "mean")


@dataclass
class NeatConfig:
    """Flat NEAT configuration covering all sections the reference uses."""

    # [NEAT]
    no_fitness_termination: bool = True
    fitness_criterion: str = "mean"
    fitness_threshold: float = 0.3
    pop_size: int = 5
    reset_on_extinction: bool = False

    # [DefaultGenome] — node activation
    activation_default: str = "sin"
    activation_mutate_rate: float = 0.5
    activation_options: Tuple[str, ...] = (
        "sin",
        "sigmoid",
        "gauss",
        "tanh",
        "relu",
        "abs",
    )
    # aggregation
    aggregation_default: str = "sum"
    aggregation_mutate_rate: float = 0.2
    aggregation_options: Tuple[str, ...] = ("sum",)
    # bias
    bias_init_mean: float = 0.0
    bias_init_stdev: float = 1.0
    bias_max_value: float = 30.0
    bias_min_value: float = -30.0
    bias_mutate_power: float = 0.5
    bias_mutate_rate: float = 0.7
    bias_replace_rate: float = 0.1
    # compatibility
    compatibility_disjoint_coefficient: float = 1.0
    compatibility_weight_coefficient: float = 0.5
    # connection add/remove
    conn_add_prob: float = 0.5
    conn_delete_prob: float = 0.5
    # enabled
    enabled_default: bool = True
    enabled_mutate_rate: float = 0.1
    feed_forward: bool = True
    initial_connection: str = "partial_nodirect 0.8"
    # node add/remove
    node_add_prob: float = 0.3
    node_delete_prob: float = 0.3
    # network size
    num_hidden: int = 20
    num_inputs: int = 2
    num_outputs: int = 3
    # response
    response_init_mean: float = 1.0
    response_init_stdev: float = 0.0
    response_max_value: float = 30.0
    response_min_value: float = -30.0
    response_mutate_power: float = 0.1
    response_mutate_rate: float = 0.1
    response_replace_rate: float = 0.1
    # weights
    weight_init_mean: float = 0.1
    weight_init_stdev: float = 1.0
    weight_max_value: float = 30.0
    weight_min_value: float = -30.0
    weight_mutate_power: float = 0.5
    weight_mutate_rate: float = 0.8
    weight_replace_rate: float = 0.1

    # [DefaultSpeciesSet]
    compatibility_threshold: float = 3.0

    # [DefaultStagnation]
    species_fitness_func: str = "max"
    max_stagnation: int = 20
    species_elitism: int = 2

    # [DefaultReproduction] — dataclass defaults here are neat-python's
    # own defaults, so INI files that omit a key (default.txt/bands.txt omit
    # min_species_size) parse exactly as neat-python would parse them.
    elitism: int = 0
    survival_threshold: float = 0.2
    min_species_size: int = 2

    @property
    def input_keys(self) -> List[int]:
        return [-i - 1 for i in range(self.num_inputs)]

    @property
    def output_keys(self) -> List[int]:
        return list(range(self.num_outputs))

    @property
    def initial_connection_kind(self) -> Tuple[str, float]:
        parts = self.initial_connection.split()
        kind = parts[0]
        p = float(parts[1]) if len(parts) > 1 else 1.0
        return kind, p

    def replace(self, **kwargs) -> "NeatConfig":
        return dataclasses.replace(self, **kwargs)


_BOOL_FIELDS = {
    "no_fitness_termination",
    "reset_on_extinction",
    "enabled_default",
    "feed_forward",
}
_INT_FIELDS = {
    "pop_size",
    "num_hidden",
    "num_inputs",
    "num_outputs",
    "max_stagnation",
    "species_elitism",
    "elitism",
    "min_species_size",
}
_STR_FIELDS = {
    "fitness_criterion",
    "activation_default",
    "aggregation_default",
    "initial_connection",
    "species_fitness_func",
}
_TUPLE_FIELDS = {"activation_options", "aggregation_options"}


def load_config(path: str) -> NeatConfig:
    """Parse a neat-python-format INI file into a :class:`NeatConfig`.

    Accepts the exact files shipped with the reference (sections are merged;
    unknown keys are ignored with the same leniency as neat-python).
    """
    parser = configparser.ConfigParser()
    with open(path) as f:
        parser.read_string(f.read())

    known = {f.name for f in dataclasses.fields(NeatConfig)}
    kwargs = {}
    for section in parser.sections():
        for key, raw in parser.items(section):
            if key not in known:
                continue
            if key in _BOOL_FIELDS:
                kwargs[key] = raw.strip().lower() in ("true", "1", "yes", "on")
            elif key in _INT_FIELDS:
                kwargs[key] = int(raw)
            elif key in _TUPLE_FIELDS:
                kwargs[key] = tuple(raw.split())
            elif key in _STR_FIELDS:
                kwargs[key] = raw.strip()
            else:
                kwargs[key] = float(raw)
    return NeatConfig(**kwargs)


def _circles() -> NeatConfig:
    """neat_configs/circles.txt: pop 5, 2->3, hidden 20, elitism 4."""
    return NeatConfig(elitism=4, survival_threshold=0.5, min_species_size=10)


def _circles_bw() -> NeatConfig:
    """neat_configs/circles_bw.txt: circles with a single output node."""
    return _circles().replace(num_outputs=1)


def _free() -> NeatConfig:
    """neat_configs/free.txt: 6 outputs (stale dual-render remnant,
    SURVEY.md Appendix C #7), min_species_size 20."""
    return _circles().replace(num_outputs=6, min_species_size=20)


def _default() -> NeatConfig:
    """neat_configs/default.txt: pop 15, declared 4 inputs (quirk #8 — the
    renderer always feeds 2 leaves), 6 outputs, hidden 8."""
    return NeatConfig(
        fitness_threshold=3.9,
        pop_size=15,
        aggregation_mutate_rate=0.0,
        enabled_mutate_rate=0.01,
        node_delete_prob=0.2,
        num_hidden=8,
        num_inputs=4,
        num_outputs=6,
        response_mutate_power=0.0,
        response_mutate_rate=0.0,
        response_replace_rate=0.0,
        weight_init_mean=0.0,
        elitism=2,
        survival_threshold=0.2,
    )


def _bands() -> NeatConfig:
    """neat_configs/bands.txt: like default but 2 inputs."""
    return _default().replace(num_inputs=2)


_PRESETS = {
    "circles": _circles,
    "circles_bw": _circles_bw,
    "free": _free,
    "default": _default,
    "bands": _bands,
}

PRESET_NAMES = tuple(_PRESETS)


def preset(name: str) -> NeatConfig:
    """Return one of the five reference NEAT presets by name."""
    try:
        return _PRESETS[name]()
    except KeyError:
        raise ValueError(f"unknown preset {name!r}; choose from {PRESET_NAMES}")
