"""The port's own copies of the JAX package's framework-free modules
(``ops/fitness/{metrics_np,calculate}``, ``ops/grids``, ``neat``,
``configs``) give bit-equal results to the originals on the same inputs."""

import math

import numpy as np
import pytest

from evolutionary_illusion_generator_tpu import configs as jax_configs
from evolutionary_illusion_generator_tpu import neat as jax_neat
from evolutionary_illusion_generator_tpu.ops import grids as jax_grids
from evolutionary_illusion_generator_tpu.ops.fitness import calculate as jax_calculate
from evolutionary_illusion_generator_tpu.ops.fitness import metrics_np as jax_metrics
from evolutionary_illusion_generator_tpu_torch import configs, neat
from evolutionary_illusion_generator_tpu_torch.ops import grids
from evolutionary_illusion_generator_tpu_torch.ops.fitness import calculate, metrics_np
from evolutionary_illusion_generator_tpu_torch.structure import StructureType

W, H = 160, 120


def _same(a, b):
    """Bit-equality through tuples, lists, arrays and floats (NaN == NaN)."""
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True)
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return a == b and type(a) is type(b)


def _vectors(seed, n, max_flow=0.5):
    rng = np.random.default_rng(seed)
    v = np.zeros((n, 4))
    v[:, 0] = rng.uniform(0, W, n)
    v[:, 1] = rng.uniform(0, H, n)
    v[:, 2:] = rng.uniform(-max_flow, max_flow, (n, 2))
    return v


CALLS = [
    ("plausibility_ratio", lambda v: (v, 0.5)),
    ("strength_number", lambda v: (v, 0.4)),
    ("direction_ratio", lambda v: (v,)),
    ("horizontal_symmetry_score", lambda v: (v,)),
    ("swarm_score", lambda v: (v,)),
    ("rotation_symmetry_score", lambda v: (v, W, H, (0, 60))),
    ("inside_outside_score", lambda v: (v, W, H)),
    ("divergence_convergence_score", lambda v: (v, W, H)),
    ("tangent_ratio", lambda v: (v, W, H)),
]


@pytest.mark.parametrize("name,args", CALLS, ids=[c[0] for c in CALLS])
@pytest.mark.parametrize("seed,n", [(0, 40), (1, 3), (2, 200)])
def test_metrics_np_bit_equal(name, args, seed, n):
    v = _vectors(seed, n)
    assert _same(getattr(metrics_np, name)(*args(v)), getattr(jax_metrics, name)(*args(v)))


@pytest.mark.parametrize("structure", list(StructureType))
@pytest.mark.parametrize("seed,n", [(3, 60), (4, 5), (5, 0)])
def test_score_vectors_bit_equal(structure, seed, n):
    v = _vectors(seed, n, max_flow=0.3)
    ours = calculate.score_vectors(structure, v, W, H)
    ref = jax_calculate.score_vectors(structure, v, W, H)
    assert _same(ours, ref)


@pytest.mark.parametrize("structure", list(StructureType))
def test_grids_equal(structure):
    ours = grids.create_grid(structure, W, H, grids.GRID_SCALING)
    ref = jax_grids.create_grid(int(structure), W, H, jax_grids.GRID_SCALING)
    assert ours.keys() == ref.keys()
    assert all(_same(ours[k], ref[k]) for k in ours)


def test_neat_runs_identically():
    """Same seed and fitness function: the same genomes, generation after
    generation."""
    def fitness(items, cfg):
        for gid, g in items:
            g.fitness = float(len(g.connections) % 7) + 0.01 * gid

    cfg = neat.preset("circles").replace(pop_size=12)
    jcfg = jax_neat.preset("circles").replace(pop_size=12)
    ours, ref = neat.Population(cfg, seed=11), jax_neat.Population(jcfg, seed=11)
    for _ in range(3):
        ours.run_generation(fitness)
        ref.run_generation(fitness)
        assert sorted(ours.population) == sorted(ref.population)
        for gid, g in ours.population.items():
            r = ref.population[gid]
            assert sorted(g.connections) == sorted(r.connections)
            assert all(g.connections[k].weight == r.connections[k].weight for k in g.connections)
            assert {k: (n.bias, n.activation) for k, n in g.nodes.items()} == {
                k: (n.bias, n.activation) for k, n in r.nodes.items()}


@pytest.mark.parametrize("name", jax_configs.RUN_PRESET_NAMES)
def test_run_presets_equal(name):
    """Each run preset's ``driver_kwargs()`` (its NEAT config field by
    field), name and device count."""
    assert configs.RUN_PRESET_NAMES == jax_configs.RUN_PRESET_NAMES
    ours, ref = configs.run_preset(name), jax_configs.run_preset(name)
    kw, ref_kw = ours.driver_kwargs(), ref.driver_kwargs()
    assert vars(kw.pop("config")) == vars(ref_kw.pop("config"))
    assert kw == ref_kw
    assert (ours.name, ours.n_devices) == (ref.name, ref.n_devices)
