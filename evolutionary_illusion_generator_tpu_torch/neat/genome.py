"""NEAT genomes: node/connection genes, mutation, crossover, distance.

Semantics follow the neat-python engine the reference delegates to
(generate_illusion.py:688-711): gaussian attribute init with clamping,
perturb-or-replace float mutation, structural add/delete mutations gated by
independent probabilities, fitter-parent crossover with per-attribute coin
flips, and the disjoint+attribute compatibility distance.  RNG streams are
explicit (``random.Random``) so runs are reproducible and checkpointable.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from random import Random
from typing import Dict, List, Optional, Tuple

from .config import NeatConfig

__all__ = ["NodeGene", "ConnectionGene", "Genome", "creates_cycle"]


def _clamp(v: float, lo: float, hi: float) -> float:
    return max(lo, min(hi, v))


def _init_float(rng: Random, mean: float, stdev: float, lo: float, hi: float) -> float:
    return _clamp(rng.gauss(mean, stdev), lo, hi)


def _mutate_float(
    rng: Random,
    value: float,
    mutate_rate: float,
    replace_rate: float,
    mutate_power: float,
    init_mean: float,
    init_stdev: float,
    lo: float,
    hi: float,
) -> float:
    r = rng.random()
    if r < mutate_rate:
        return _clamp(value + rng.gauss(0.0, mutate_power), lo, hi)
    if r < mutate_rate + replace_rate:
        return _init_float(rng, init_mean, init_stdev, lo, hi)
    return value


@dataclass
class NodeGene:
    """Hidden/output node: ``act(bias + response * aggregate(w_i * x_i))``."""

    bias: float
    response: float
    activation: str
    aggregation: str

    @staticmethod
    def new(cfg: NeatConfig, rng: Random) -> "NodeGene":
        return NodeGene(
            bias=_init_float(
                rng,
                cfg.bias_init_mean,
                cfg.bias_init_stdev,
                cfg.bias_min_value,
                cfg.bias_max_value,
            ),
            response=_init_float(
                rng,
                cfg.response_init_mean,
                cfg.response_init_stdev,
                cfg.response_min_value,
                cfg.response_max_value,
            ),
            activation=cfg.activation_default,
            aggregation=cfg.aggregation_default,
        )

    def mutate(self, cfg: NeatConfig, rng: Random) -> None:
        self.bias = _mutate_float(
            rng,
            self.bias,
            cfg.bias_mutate_rate,
            cfg.bias_replace_rate,
            cfg.bias_mutate_power,
            cfg.bias_init_mean,
            cfg.bias_init_stdev,
            cfg.bias_min_value,
            cfg.bias_max_value,
        )
        self.response = _mutate_float(
            rng,
            self.response,
            cfg.response_mutate_rate,
            cfg.response_replace_rate,
            cfg.response_mutate_power,
            cfg.response_init_mean,
            cfg.response_init_stdev,
            cfg.response_min_value,
            cfg.response_max_value,
        )
        if rng.random() < cfg.activation_mutate_rate:
            self.activation = rng.choice(cfg.activation_options)
        if rng.random() < cfg.aggregation_mutate_rate:
            self.aggregation = rng.choice(cfg.aggregation_options)

    def crossover(self, other: "NodeGene", rng: Random) -> "NodeGene":
        return NodeGene(
            bias=self.bias if rng.random() > 0.5 else other.bias,
            response=self.response if rng.random() > 0.5 else other.response,
            activation=self.activation if rng.random() > 0.5 else other.activation,
            aggregation=self.aggregation if rng.random() > 0.5 else other.aggregation,
        )

    def distance(self, other: "NodeGene", cfg: NeatConfig) -> float:
        d = abs(self.bias - other.bias) + abs(self.response - other.response)
        if self.activation != other.activation:
            d += 1.0
        if self.aggregation != other.aggregation:
            d += 1.0
        return d * cfg.compatibility_weight_coefficient

    def copy(self) -> "NodeGene":
        return NodeGene(self.bias, self.response, self.activation, self.aggregation)


@dataclass
class ConnectionGene:
    weight: float
    enabled: bool

    @staticmethod
    def new(cfg: NeatConfig, rng: Random) -> "ConnectionGene":
        return ConnectionGene(
            weight=_init_float(
                rng,
                cfg.weight_init_mean,
                cfg.weight_init_stdev,
                cfg.weight_min_value,
                cfg.weight_max_value,
            ),
            enabled=cfg.enabled_default,
        )

    def mutate(self, cfg: NeatConfig, rng: Random) -> None:
        self.weight = _mutate_float(
            rng,
            self.weight,
            cfg.weight_mutate_rate,
            cfg.weight_replace_rate,
            cfg.weight_mutate_power,
            cfg.weight_init_mean,
            cfg.weight_init_stdev,
            cfg.weight_min_value,
            cfg.weight_max_value,
        )
        if rng.random() < cfg.enabled_mutate_rate:
            self.enabled = rng.random() < 0.5

    def crossover(self, other: "ConnectionGene", rng: Random) -> "ConnectionGene":
        return ConnectionGene(
            weight=self.weight if rng.random() > 0.5 else other.weight,
            enabled=self.enabled if rng.random() > 0.5 else other.enabled,
        )

    def distance(self, other: "ConnectionGene", cfg: NeatConfig) -> float:
        d = abs(self.weight - other.weight)
        if self.enabled != other.enabled:
            d += 1.0
        return d * cfg.compatibility_weight_coefficient

    def copy(self) -> "ConnectionGene":
        return ConnectionGene(self.weight, self.enabled)


def creates_cycle(connections, test: Tuple[int, int]) -> bool:
    """True if adding directed edge ``test`` to ``connections`` forms a cycle."""
    i, o = test
    if i == o:
        return True
    visited = {o}
    while True:
        num_added = 0
        for a, b in connections:
            if a in visited and b not in visited:
                if b == i:
                    return True
                visited.add(b)
                num_added += 1
        if num_added == 0:
            return False


@dataclass
class Genome:
    """A CPPN genome: node genes keyed by id, connection genes keyed by
    (in_id, out_id).  Input ids are negative (-1..-num_inputs), output ids
    are 0..num_outputs-1."""

    key: int
    nodes: Dict[int, NodeGene] = field(default_factory=dict)
    connections: Dict[Tuple[int, int], ConnectionGene] = field(default_factory=dict)
    fitness: Optional[float] = None

    # ---- construction -------------------------------------------------

    @staticmethod
    def new(key: int, cfg: NeatConfig, rng: Random) -> "Genome":
        g = Genome(key=key)
        hidden_keys = list(
            range(cfg.num_outputs, cfg.num_outputs + cfg.num_hidden)
        )
        for nk in cfg.output_keys + hidden_keys:
            g.nodes[nk] = NodeGene.new(cfg, rng)

        kind, p = cfg.initial_connection_kind
        candidates: List[Tuple[int, int]] = []
        if kind in ("full_nodirect", "partial_nodirect"):
            if hidden_keys:
                for ik in cfg.input_keys:
                    for hk in hidden_keys:
                        candidates.append((ik, hk))
                for hk in hidden_keys:
                    for ok in cfg.output_keys:
                        candidates.append((hk, ok))
            else:
                for ik in cfg.input_keys:
                    for ok in cfg.output_keys:
                        candidates.append((ik, ok))
        elif kind in ("full_direct", "partial_direct", "full", "partial"):
            for ik in cfg.input_keys:
                for hk in hidden_keys:
                    candidates.append((ik, hk))
            for hk in hidden_keys:
                for ok in cfg.output_keys:
                    candidates.append((hk, ok))
            for ik in cfg.input_keys:
                for ok in cfg.output_keys:
                    candidates.append((ik, ok))
        elif kind == "unconnected":
            candidates = []
        else:
            raise ValueError(f"unsupported initial_connection: {kind}")

        partial = kind.startswith("partial")
        for ck in candidates:
            if not partial or rng.random() < p:
                g.connections[ck] = ConnectionGene.new(cfg, rng)
        return g

    def copy(self, key: Optional[int] = None) -> "Genome":
        g = Genome(key=self.key if key is None else key)
        g.nodes = {k: n.copy() for k, n in self.nodes.items()}
        g.connections = {k: c.copy() for k, c in self.connections.items()}
        g.fitness = self.fitness
        return g

    # ---- mutation ------------------------------------------------------

    def _next_node_key(self) -> int:
        return max(self.nodes) + 1 if self.nodes else 0

    def mutate(self, cfg: NeatConfig, rng: Random) -> None:
        if rng.random() < cfg.node_add_prob:
            self.mutate_add_node(cfg, rng)
        if rng.random() < cfg.node_delete_prob:
            self.mutate_delete_node(cfg, rng)
        if rng.random() < cfg.conn_add_prob:
            self.mutate_add_connection(cfg, rng)
        if rng.random() < cfg.conn_delete_prob:
            self.mutate_delete_connection(rng)
        for conn in self.connections.values():
            conn.mutate(cfg, rng)
        for node in self.nodes.values():
            node.mutate(cfg, rng)

    def mutate_add_node(self, cfg: NeatConfig, rng: Random) -> None:
        if not self.connections:
            return
        conn_key = rng.choice(sorted(self.connections))
        conn = self.connections[conn_key]
        conn.enabled = False
        new_key = self._next_node_key()
        self.nodes[new_key] = NodeGene.new(cfg, rng)
        i, o = conn_key
        self.connections[(i, new_key)] = ConnectionGene(weight=1.0, enabled=True)
        self.connections[(new_key, o)] = ConnectionGene(
            weight=conn.weight, enabled=True
        )

    def mutate_add_connection(self, cfg: NeatConfig, rng: Random) -> None:
        possible_outputs = sorted(self.nodes)
        out_node = rng.choice(possible_outputs)
        possible_inputs = possible_outputs + cfg.input_keys
        in_node = rng.choice(possible_inputs)
        key = (in_node, out_node)
        if key in self.connections:
            return
        if in_node in cfg.output_keys and out_node in cfg.output_keys:
            return
        if cfg.feed_forward and creates_cycle(list(self.connections), key):
            return
        self.connections[key] = ConnectionGene.new(cfg, rng)

    def mutate_delete_node(self, cfg: NeatConfig, rng: Random) -> None:
        available = [k for k in self.nodes if k not in cfg.output_keys]
        if not available:
            return
        del_key = rng.choice(sorted(available))
        for ck in [ck for ck in self.connections if del_key in ck]:
            del self.connections[ck]
        del self.nodes[del_key]

    def mutate_delete_connection(self, rng: Random) -> None:
        if self.connections:
            del self.connections[rng.choice(sorted(self.connections))]

    # ---- crossover -----------------------------------------------------

    @staticmethod
    def crossover(
        key: int, parent1: "Genome", parent2: "Genome", rng: Random
    ) -> "Genome":
        """Child from two parents; ``parent1`` must be the fitter one.
        Disjoint/excess genes come from the fitter parent, matching genes
        flip a coin per attribute."""
        child = Genome(key=key)
        for ck, c1 in parent1.connections.items():
            c2 = parent2.connections.get(ck)
            child.connections[ck] = c1.copy() if c2 is None else c1.crossover(c2, rng)
        for nk, n1 in parent1.nodes.items():
            n2 = parent2.nodes.get(nk)
            child.nodes[nk] = n1.copy() if n2 is None else n1.crossover(n2, rng)
        return child

    # ---- compatibility distance ----------------------------------------

    def distance(self, other: "Genome", cfg: NeatConfig) -> float:
        node_distance = 0.0
        if self.nodes or other.nodes:
            disjoint = sum(1 for k in other.nodes if k not in self.nodes)
            for k, n1 in self.nodes.items():
                n2 = other.nodes.get(k)
                if n2 is None:
                    disjoint += 1
                else:
                    node_distance += n1.distance(n2, cfg)
            max_nodes = max(len(self.nodes), len(other.nodes))
            node_distance = (
                node_distance + cfg.compatibility_disjoint_coefficient * disjoint
            ) / max_nodes

        conn_distance = 0.0
        if self.connections or other.connections:
            disjoint = sum(1 for k in other.connections if k not in self.connections)
            for k, c1 in self.connections.items():
                c2 = other.connections.get(k)
                if c2 is None:
                    disjoint += 1
                else:
                    conn_distance += c1.distance(c2, cfg)
            max_conn = max(len(self.connections), len(other.connections))
            conn_distance = (
                conn_distance + cfg.compatibility_disjoint_coefficient * disjoint
            ) / max_conn

        return node_distance + conn_distance

    def size(self) -> Tuple[int, int]:
        """(node count, enabled connection count)."""
        return len(self.nodes), sum(1 for c in self.connections.values() if c.enabled)
