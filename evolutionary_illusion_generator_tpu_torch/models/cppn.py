"""CPPN compilers (numpy, host) and batched evaluators (PyTorch).

The port of the JAX package's ``models/cppn.py``, both of its paths:

- node-serial (:func:`compile_genome`, :func:`pack_population`,
  :func:`evaluate_cppn`, :func:`evaluate_population`): a genome is a
  topo-ordered weight matrix plus per-node tables over a power-of-two slot
  bucket, evaluated one slot after another, each slot a
  ``(slots,) x (slots, pixels)`` product.  The artifact renders use it, as
  the JAX package's do.
- level-blocked (:func:`compile_genome_levels`,
  :func:`pack_population_levels`, :func:`evaluate_cppn_levels`,
  :func:`evaluate_population_levels`, :func:`make_population_eval`): nodes
  packed into topological LEVELS of ``width`` slots, each level one
  ``(width, slots) x (slots, pixels)`` matmul.  The generation evaluator
  uses it.

The host compilers (:func:`required_nodes`, :func:`compile_genome`,
:func:`pack_population`, :func:`compile_genome_levels`,
:func:`genome_depth`, :func:`population_act_set`,
:func:`pack_population_levels`) are copies of the JAX package's numpy code.

Node semantics match neat-python/pytorch_neat: each node computes
``act(bias + response * sum_i(w_i * x_i))``; activations use neat-python's
scaled definitions (sigmoid(5z), tanh(2.5z), sin(5z), gauss(-5z^2), relu,
abs, identity).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..neat.config import NeatConfig
from ..neat.genome import Genome

__all__ = [
    "ACTIVATIONS",
    "ACT_ID",
    "CompiledCppn",
    "compile_genome",
    "pack_population",
    "evaluate_cppn",
    "evaluate_population",
    "required_nodes",
    "population_act_set",
    "compile_genome_levels",
    "pack_population_levels",
    "evaluate_cppn_levels",
    "evaluate_population_levels",
    "make_population_eval",
    "genome_depth",
]

# ---------------------------------------------------------------------------
# activations (neat-python-compatible scalings)
# ---------------------------------------------------------------------------


def _sigmoid(z):
    return torch.sigmoid(torch.clamp(5.0 * z, -60.0, 60.0))


def _tanh(z):
    return torch.tanh(torch.clamp(2.5 * z, -60.0, 60.0))


def _sin(z):
    return torch.sin(torch.clamp(5.0 * z, -60.0, 60.0))


def _gauss(z):
    return torch.exp(-5.0 * torch.clamp(z, -3.4, 3.4) ** 2)


def _relu(z):
    return torch.clamp_min(z, 0.0)


def _abs(z):
    return torch.abs(z)


def _identity(z):
    return z


#: Order defines the integer activation ids used in compiled tables.
ACTIVATIONS = (
    ("sin", _sin),
    ("sigmoid", _sigmoid),
    ("gauss", _gauss),
    ("tanh", _tanh),
    ("relu", _relu),
    ("abs", _abs),
    ("identity", _identity),
)
_ACT_ID = {name: i for i, (name, _) in enumerate(ACTIVATIONS)}
_ACT_FNS = tuple(fn for _, fn in ACTIVATIONS)
ACT_ID = _ACT_ID  # public alias (evaluators map activation names to ids)


# ---------------------------------------------------------------------------
# compilation (host numpy; a copy of the JAX package's compilers)
# ---------------------------------------------------------------------------


def required_nodes(genome: Genome, cfg: NeatConfig) -> set:
    """Nodes on an enabled path into an output (neat-python
    ``required_for_output`` semantics); outputs are always included."""
    required = set(cfg.output_keys)
    frontier = set(cfg.output_keys)
    while frontier:
        new_frontier = set()
        for (i, o), conn in genome.connections.items():
            if conn.enabled and o in frontier and i not in required:
                if i >= 0:  # inputs are implicit
                    new_frontier.add(i)
                    required.add(i)
        frontier = new_frontier
    return required


@dataclass
class CompiledCppn:
    """One genome lowered to dense tables.

    Slot layout: ``[inputs (num_inputs) | eval nodes in topo order]``.
    ``weights[j, s]`` feeds slot ``num_inputs + j`` from slot ``s``; rows are
    strictly lower-triangular in slot order (feed-forward).
    """

    num_inputs: int
    num_nodes: int  # real (unpadded) eval nodes
    weights: np.ndarray  # (max_nodes, num_inputs + max_nodes) f32
    bias: np.ndarray  # (max_nodes,) f32
    response: np.ndarray  # (max_nodes,) f32
    act_id: np.ndarray  # (max_nodes,) i32
    out_slot: np.ndarray  # (num_outputs,) i32 — slot index per output node


def compile_genome(
    genome: Genome, cfg: NeatConfig, max_nodes: int
) -> CompiledCppn:
    """Lower one genome to a :class:`CompiledCppn` with ``max_nodes`` slots."""
    req = required_nodes(genome, cfg)
    enabled = {
        k: c for k, c in genome.connections.items() if c.enabled
        and k[1] in req and (k[0] < 0 or k[0] in req)
    }

    # topo order over required nodes (inputs come free)
    incoming: Dict[int, List[Tuple[int, float]]] = {n: [] for n in req}
    for (i, o), conn in enabled.items():
        incoming[o].append((i, conn.weight))
    order: List[int] = []
    placed = set(cfg.input_keys)
    pending = set(req)
    while pending:
        ready = sorted(
            n for n in pending if all(src in placed for src, _ in incoming[n])
        )
        if not ready:
            raise ValueError(f"genome {genome.key}: cycle in feed-forward net")
        for n in ready:
            order.append(n)
            placed.add(n)
            pending.discard(n)

    if len(order) > max_nodes:
        raise ValueError(
            f"genome {genome.key} needs {len(order)} slots > bucket {max_nodes}"
        )

    ni = cfg.num_inputs
    S = ni + max_nodes
    weights = np.zeros((max_nodes, S), dtype=np.float32)
    bias = np.zeros(max_nodes, dtype=np.float32)
    response = np.zeros(max_nodes, dtype=np.float32)
    act_id = np.full(max_nodes, _ACT_ID["identity"], dtype=np.int32)

    slot_of = {ik: idx for idx, ik in enumerate(cfg.input_keys)}
    for j, n in enumerate(order):
        slot_of[n] = ni + j

    for j, n in enumerate(order):
        node = genome.nodes[n]
        bias[j] = node.bias
        response[j] = node.response
        if node.aggregation != "sum":
            raise NotImplementedError(
                f"aggregation {node.aggregation!r} not supported on device"
            )
        act_id[j] = _ACT_ID[node.activation]
        for src, w in incoming[n]:
            weights[j, slot_of[src]] += w

    out_slot = np.array([slot_of[o] for o in cfg.output_keys], dtype=np.int32)
    return CompiledCppn(
        num_inputs=ni,
        num_nodes=len(order),
        weights=weights,
        bias=bias,
        response=response,
        act_id=act_id,
        out_slot=out_slot,
    )


def _bucket(n: int, minimum: int = 8) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def pack_population(
    genomes: Sequence[Genome], cfg: NeatConfig, max_nodes: int | None = None
) -> Dict[str, np.ndarray]:
    """Compile a population into stacked arrays ready for the device.

    Returns dict of arrays with a leading population axis; ``max_nodes`` is
    the shared slot bucket (auto-sized to the largest genome, rounded up to a
    power of two).
    """
    if max_nodes is None:
        need = max((len(required_nodes(g, cfg)) for g in genomes), default=1)
        max_nodes = _bucket(need)
    progs = [compile_genome(g, cfg, max_nodes) for g in genomes]
    return {
        "weights": np.stack([p.weights for p in progs]),
        "bias": np.stack([p.bias for p in progs]),
        "response": np.stack([p.response for p in progs]),
        "act_id": np.stack([p.act_id for p in progs]),
        "out_slot": np.stack([p.out_slot for p in progs]),
    }


def compile_genome_levels(
    genome: Genome, cfg: NeatConfig, levels: int, width: int
) -> dict:
    """Lower one genome to per-level dense tables.

    Slot layout: ``[inputs | level0 (width) | level1 (width) | ...]``.
    Returns dict of arrays: weights (L, width, S), bias/response (L, width),
    act_id (L, width) i32, out_slot (O,) i32.
    """
    req = required_nodes(genome, cfg)
    enabled = {
        k: c
        for k, c in genome.connections.items()
        if c.enabled and k[1] in req and (k[0] < 0 or k[0] in req)
    }
    incoming: Dict[int, List[Tuple[int, float]]] = {n: [] for n in req}
    for (i, o), conn in enabled.items():
        incoming[o].append((i, conn.weight))

    ni = cfg.num_inputs
    S = ni + levels * width
    slot_of = {ik: idx for idx, ik in enumerate(cfg.input_keys)}
    level_of: Dict[int, int] = {}
    fill = [0] * levels

    # topo placement
    placed = set(cfg.input_keys)
    pending = set(req)
    order: List[int] = []
    while pending:
        ready = sorted(
            n for n in pending if all(src in placed for src, _ in incoming[n])
        )
        if not ready:
            raise ValueError(f"genome {genome.key}: cycle in feed-forward net")
        for n in ready:
            min_level = 0
            for src, _ in incoming[n]:
                if src >= 0:
                    min_level = max(min_level, level_of[src] + 1)
            k = min_level
            while k < levels and fill[k] >= width:
                k += 1
            if k >= levels:
                raise ValueError(
                    f"genome {genome.key} overflows level bucket "
                    f"({levels}x{width})"
                )
            level_of[n] = k
            slot_of[n] = ni + k * width + fill[k]
            fill[k] += 1
            order.append(n)
            placed.add(n)
            pending.discard(n)

    weights = np.zeros((levels, width, S), dtype=np.float32)
    bias = np.zeros((levels, width), dtype=np.float32)
    response = np.zeros((levels, width), dtype=np.float32)
    act_id = np.full((levels, width), _ACT_ID["identity"], dtype=np.int32)

    for n in order:
        node = genome.nodes[n]
        if node.aggregation != "sum":
            raise NotImplementedError(
                f"aggregation {node.aggregation!r} not supported on device"
            )
        k = level_of[n]
        j = slot_of[n] - ni - k * width
        bias[k, j] = node.bias
        response[k, j] = node.response
        act_id[k, j] = _ACT_ID[node.activation]
        for src, w in incoming[n]:
            weights[k, j, slot_of[src]] += w

    out_slot = np.array([slot_of[o] for o in cfg.output_keys], dtype=np.int32)
    return {
        "weights": weights,
        "bias": bias,
        "response": response,
        "act_id": act_id,
        "out_slot": out_slot,
    }


def genome_depth(genome: Genome, cfg: NeatConfig) -> int:
    """Topological depth (number of levels) a genome needs."""
    req = required_nodes(genome, cfg)
    incoming: Dict[int, List[int]] = {n: [] for n in req}
    for (i, o), conn in genome.connections.items():
        if conn.enabled and o in req and i >= 0 and i in req:
            incoming[o].append(i)
    depth: Dict[int, int] = {}
    placed = set()
    pending = set(req)
    while pending:
        ready = [n for n in pending if all(s in placed for s in incoming[n])]
        if not ready:
            raise ValueError("cycle")
        for n in ready:
            depth[n] = 1 + max((depth[s] for s in incoming[n]), default=0)
            placed.add(n)
            pending.discard(n)
    return max(depth.values(), default=1)


def population_act_set(genomes: Sequence[Genome], cfg: NeatConfig) -> set:
    """Activation ids used by any *required* node of any genome."""
    used = set()
    for g in genomes:
        for n in required_nodes(g, cfg):
            used.add(_ACT_ID[g.nodes[n].activation])
    return used


def pack_population_levels(
    genomes: Sequence[Genome],
    cfg: NeatConfig,
    levels: int = 8,
    width: int = 16,
    act_set: Sequence[int] | None = None,
) -> Dict[str, np.ndarray]:
    """Compile a population into stacked level tables (leading pop axis).

    ``levels``/``width`` grow (x2) automatically when a genome's depth or
    node count overflows the requested bucket.

    ``act_set`` (sorted global activation ids) remaps ``act_id`` entries to
    positions WITHIN the set, for evaluation with
    ``make_population_eval(act_set)`` — which then computes only those
    activation functions instead of all ``len(ACTIVATIONS)`` per level
    (VERDICT round-1 item 5).  It must cover ``population_act_set``; padding
    slots remap arbitrarily to position 0 (their values are never read:
    no weight row or out_slot references them).
    """
    while True:
        try:
            progs = [
                compile_genome_levels(g, cfg, levels, width) for g in genomes
            ]
            break
        except ValueError:
            need = max(len(required_nodes(g, cfg)) for g in genomes)
            if levels * width < need:
                width *= 2
            else:
                levels *= 2
    packed = {k: np.stack([p[k] for p in progs]) for k in progs[0]}
    if act_set is not None:
        used = population_act_set(genomes, cfg)
        if not used <= set(act_set):
            raise ValueError(
                f"act_set {tuple(act_set)} does not cover the population's "
                f"activations {sorted(used)}"
            )
        lut = np.zeros(len(ACTIVATIONS), dtype=np.int32)
        for local, gid in enumerate(act_set):
            lut[gid] = local
        packed["act_id"] = lut[packed["act_id"]]
    return packed


# ---------------------------------------------------------------------------
# evaluation (device)
# ---------------------------------------------------------------------------


def evaluate_population(weights, bias, response, act_id, out_slot, inputs):
    """Evaluate a population of node-serial CPPNs on a pixel batch.

    weights: (pop, N, ni+N); bias/response/act_id: (pop, N); out_slot:
    (pop, O); inputs: (ni, P), shared by the population.  Returns
    (pop, O, P).  Slot ``ni + j`` is ``act(r * (w_row @ vals) + b)`` over
    the slots before it (its row is zero from there on, so the product
    stops there); the activation is selected per genome from those its
    slot's genomes use (``act_id`` is read on the host once a call).
    """
    pop, n_nodes, S = weights.shape
    ni = S - n_nodes
    vals = torch.zeros(pop, S, inputs.shape[1], dtype=inputs.dtype, device=inputs.device)
    vals[:, :ni] = inputs
    acts = act_id.cpu().numpy()
    rows = torch.arange(pop, device=inputs.device)
    for j in range(n_nodes):
        s = ni + j
        pre = torch.bmm(weights[:, j:j + 1, :s], vals[:, :s])[:, 0]  # (pop, P)
        z = response[:, j, None] * pre + bias[:, j, None]
        used = sorted(set(acts[:, j].tolist()))
        if len(used) == 1:
            vals[:, s] = _ACT_FNS[used[0]](z)
        else:
            stacked = torch.stack([_ACT_FNS[a](z) for a in used])  # (A', pop, P)
            local = torch.as_tensor([used.index(a) for a in acts[:, j]], device=inputs.device)
            vals[:, s] = stacked[local, rows]
    return torch.gather(vals, 1, out_slot.long()[:, :, None].expand(-1, -1, vals.shape[2]))


def evaluate_cppn(weights, bias, response, act_id, out_slot, inputs):
    """Evaluate one compiled CPPN on a pixel batch.

    Args:
      weights: (N, ni+N); bias/response/act_id: (N,); out_slot: (O,)
      inputs: (ni, P) input planes (flattened grid rows).
    Returns:
      (O, P) output-node values.
    """
    return evaluate_population(weights[None], bias[None], response[None], act_id[None],
                               out_slot[None], inputs)[0]


def _apply_act_rows(act_id, z, act_set=None):
    """Per-row activation: act_id (pop, width), z (pop, width, P).

    Masked sum over the (pruned) activation set — every fn in the set is
    clipped/total, so the unselected branches contribute exact zeros."""
    fns = _ACT_FNS if act_set is None else tuple(_ACT_FNS[i] for i in act_set)
    if len(fns) == 1:
        return fns[0](z)
    out = torch.zeros_like(z)
    sel = act_id[:, :, None]
    for local, fn in enumerate(fns):
        out = out + torch.where(sel == local, fn(z), 0.0)
    return out


def evaluate_population_levels(weights, bias, response, act_id, out_slot, inputs,
                               act_set=None):
    """Evaluate a population of level-compiled CPPNs on a pixel batch.

    weights: (pop, L, width, S); bias/response/act_id: (pop, L, width);
    out_slot: (pop, O); inputs: (ni, P), shared by the population.
    ``act_set`` (tuple of global activation ids, or None for all): only
    these activation functions are computed per level; ``act_id`` entries
    must then be positions within the set (pack_population_levels remaps
    them).  Returns (pop, O, P).
    """
    pop, L, width, S = weights.shape
    ni = S - L * width
    vals = torch.zeros(pop, S, inputs.shape[1], dtype=inputs.dtype,
                       device=inputs.device)
    vals[:, :ni] = inputs
    for k in range(L):
        pre = torch.bmm(weights[:, k], vals)  # (pop, width, P)
        z = response[:, k, :, None] * pre + bias[:, k, :, None]
        vals[:, ni + k * width : ni + (k + 1) * width] = _apply_act_rows(
            act_id[:, k], z, act_set
        )
    return torch.gather(
        vals, 1, out_slot.long()[:, :, None].expand(-1, -1, vals.shape[2])
    )


def evaluate_cppn_levels(weights, bias, response, act_id, out_slot, inputs,
                         act_set=None):
    """Evaluate one level-compiled CPPN on a pixel batch.

    weights: (L, width, S); bias/response/act_id: (L, width); inputs (ni, P).
    ``act_set`` as in :func:`evaluate_population_levels`.  Returns (O, P).
    """
    return evaluate_population_levels(weights[None], bias[None], response[None],
                                      act_id[None], out_slot[None], inputs, act_set)[0]


def make_population_eval(act_set=None):
    """Population evaluator computing only ``act_set``'s activations
    (None = all).  Callers keep ``act_set`` GROW-ONLY across a run."""
    if act_set is None:
        return evaluate_population_levels
    act_set = tuple(act_set)

    def evaluate(weights, bias, response, act_id, out_slot, inputs):
        return evaluate_population_levels(weights, bias, response, act_id, out_slot,
                                          inputs, act_set)

    return evaluate
