"""The port's three scoring back ends: the C++ batch scorer, numpy, and
device scoring (``ops/fitness/metrics_torch.py``), against each other and
against the JAX package's ``score_vectors_jax``; and the evaluator's
``score_backend`` / ``score_on_device`` switches.

Populations of masked vector sets are made from a numpy seed, with the
invalid rows poisoned.  The C++ scorer is built on first use into the
port's ``.build/``; the build is atomic, so the test workers may race it.
"""

import copy
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from evolutionary_illusion_generator_tpu.ops.fitness import metrics_jax
from evolutionary_illusion_generator_tpu.ops.fitness.metrics_jax import score_vectors_jax
from evolutionary_illusion_generator_tpu_torch import cli
from evolutionary_illusion_generator_tpu_torch.evolution import (
    EvalConfig,
    GenerationEvaluator,
    neat_illusion,
)
from evolutionary_illusion_generator_tpu_torch.models.prednet.loader import (
    init_params_numpy,
    params_from_numpy,
)
from evolutionary_illusion_generator_tpu_torch.neat import Population, preset
from evolutionary_illusion_generator_tpu_torch.ops.fitness import metrics_torch, native
from evolutionary_illusion_generator_tpu_torch.ops.fitness.calculate import score_vectors
from evolutionary_illusion_generator_tpu_torch.ops.flow import FlowConfig
from evolutionary_illusion_generator_tpu_torch.structure import StructureType

# the suite runs in several worker processes: one torch thread each keeps
# them from oversubscribing the cores
torch.set_num_threads(1)

W, H = 160, 120
# The C++ scorer against numpy: the same float64 math summed in another
# order, and contracted into FMAs under -march=native, so the last bits
# differ (9e-15 measured); the JAX package holds its scorer so
# (tests/test_native_scorer.py).
NATIVE_ATOL = 1e-12
# float32 device scores against float64 host scores, with the same
# ranking (the JAX package's tests/test_device_scoring.py)
DEVICE_RTOL, DEVICE_ATOL = 1e-3, 1e-5
# float32 on both sides, two frameworks' reductions (2.4e-7 measured)
JAX_ATOL = 1e-6
# rotation_symmetry_score, and the circles scores built on it, are worse
# conditioned.  Each of its terms, d_i = rx_1 - dist (or ry_1), is a unit
# vector's dot (cross) product with the radial direction, in [-1, 1], but it
# is formed from values the size of the recentred radius r <= R_MAX = H / 2
# (the upper limit both callers pass).  XLA contracts vcx*vcx + vcy*vcy and
# the numerators x_1*vcx + y_1*vcy into FMAs and torch does not, so each
# term moves by a few float32 ulps of R_MAX: ROT_DELTA, 4 ulp (the largest
# gap per term over 300 seeds of _population).  To first order the variance
# then moves by (2/n) sum (d_i - m) delta_i <= 2 ROT_DELTA sqrt(var) <=
# 2 ROT_DELTA (Cauchy-Schwarz, var <= 1), and ((1-var_x)^2 + (1-var_y)^2)/2
# by at most |dvar_x| + |dvar_y| <= 4 ROT_DELTA; JAX_ATOL covers the sums.
# That is 6.2e-5; the largest gap over those 300 seeds was 6.4e-6 for the
# metric and 3.0e-6 for a circles score.
R_MAX = H / 2.0
ROT_DELTA = 4 * float(np.spacing(np.float32(R_MAX)))
ROT_ATOL = 4 * ROT_DELTA + JAX_ATOL
ROTATION_STRUCTURES = (StructureType.Circles, StructureType.CirclesFree)
TINY_FLOW = dict(max_corners=32, win=9, levels=2, iters=6)


def _population(structure, pop=24, K=64):
    """A population with an empty set (0), a full one (1) and random
    lengths, the invalid rows poisoned with 1e9 (as the JAX package's
    tests/test_native_scorer.py makes them); flows small enough that the
    plausibility gates keep most vectors."""
    rng = np.random.default_rng(int(structure))
    vectors = np.full((pop, K, 4), 1e9)
    mask = np.zeros((pop, K), dtype=bool)
    for p in range(pop):
        n = (0, K)[p] if p < 2 else int(rng.integers(0, K + 1))
        vectors[p, :n, 0] = rng.uniform(0, W, n)
        vectors[p, :n, 1] = rng.uniform(0, H, n)
        vectors[p, :n, 2:] = rng.uniform(-0.3, 0.3, (n, 2))
        mask[p, :n] = True
    return vectors, mask


def _host(structure, vectors, mask):
    return np.array([score_vectors(structure, v[m], W, H) for v, m in zip(vectors, mask)])


@pytest.mark.parametrize("structure", list(StructureType))
def test_native_scores_match_numpy(structure):
    assert native.is_available()
    vectors, mask = _population(structure)
    got = native.score_population_native(int(structure), vectors, mask, W, H)
    want = _host(structure, vectors, mask)
    assert got.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=NATIVE_ATOL, rtol=0)
    assert got[0] == want[0] == 0.0  # no vectors
    with pytest.raises(ValueError, match="do not match"):
        native.score_population_native(int(structure), vectors[:, :3], mask, W, H)


def test_native_library_lives_in_the_build_directory():
    """Built once into the port's git-ignored ``.build/``, under a
    directory named by the source's hash, never beside the source."""
    assert native.is_available()
    path = native.library_path()
    assert path.exists() and path.parent.parent.name == ".build"
    assert path.parent.name.startswith("fitness_native-")
    assert not list(Path(native.native.__file__).parent.glob("*.so"))


@pytest.mark.parametrize("structure", list(StructureType))
def test_device_scores_match_jax_and_host(structure):
    """score_vectors_torch over the population axis against the JAX
    function mapped over it (float32 both), and against float64 host
    scores with the same ranking; empty and full masks included."""
    vectors, mask = _population(structure)
    v32 = vectors.astype(np.float32)
    ours = metrics_torch.score_vectors_torch(structure, torch.from_numpy(v32),
                                             torch.from_numpy(mask), W, H).numpy()
    ref = np.asarray(jax.vmap(lambda v, m: score_vectors_jax(int(structure), v, m, W, H))(
        jnp.asarray(v32), jnp.asarray(mask)))
    host = _host(structure, vectors, mask)
    assert ours.dtype == np.float32 and ours.shape == (len(vectors),)
    atol = ROT_ATOL if structure in ROTATION_STRUCTURES else JAX_ATOL
    np.testing.assert_allclose(ours, ref, atol=atol, rtol=0)
    np.testing.assert_allclose(ours, host, rtol=DEVICE_RTOL, atol=DEVICE_ATOL)
    assert list(np.argsort(ours, kind="stable")) == list(np.argsort(host, kind="stable"))
    assert ours[0] == 0.0
    # one candidate without the population axis
    one = metrics_torch.score_vectors_torch(structure, torch.from_numpy(v32[2]),
                                            torch.from_numpy(mask[2]), W, H)
    assert one.shape == () and one.item() == ours[2]


@pytest.mark.parametrize("name,args", [
    ("plausibility_mask", lambda: (0.3,)),
    ("strength_number", lambda: (0.4,)),
    ("horizontal_symmetry_score", lambda: ([0, 60],)),
    ("swarm_score", lambda: ()),
    ("rotation_symmetry_score", lambda: (W, H, [0, 60])),
])
def test_device_metrics_match_jax(name, args):
    vectors, mask = _population(StructureType.Free)
    v32 = vectors.astype(np.float32)
    ours = getattr(metrics_torch, name)(torch.from_numpy(v32), torch.from_numpy(mask),
                                        *args()).numpy()
    ref = np.asarray(jax.vmap(lambda v, m: getattr(metrics_jax, name)(v, m, *args()))(
        jnp.asarray(v32), jnp.asarray(mask)))
    assert ours.shape == ref.shape
    if ours.dtype == bool:
        np.testing.assert_array_equal(ours, ref)
    else:
        atol = ROT_ATOL if name == "rotation_symmetry_score" else JAX_ATOL
        np.testing.assert_allclose(ours, ref, atol=atol, rtol=0)


def test_device_scoring_refuses_unknown_structures():
    with pytest.raises(ValueError):
        metrics_torch.score_vectors_torch(7, torch.zeros(2, 4, 4), torch.ones(2, 4, dtype=bool),
                                          W, H)


def _evaluator(**kw):
    cfg = EvalConfig(structure=StructureType.Free, w=48, h=40, c_dim=1, gradient=0, repeat=4,
                     flow=FlowConfig(**TINY_FLOW), **kw)
    ncfg = preset("circles_bw").replace(pop_size=8, num_hidden=4)
    params = params_from_numpy(init_params_numpy((1, 4, 8), seed=1), device="cpu")
    return GenerationEvaluator(cfg, params, ncfg, device="cpu"), ncfg


def test_evaluator_backends_agree():
    """``score_backend``: "auto" is the native scorer where it builds,
    "native" and "numpy" agree within NATIVE_ATOL; "native" raises where
    the scorer cannot be built, an unknown backend raises."""
    vectors, mask = _population(StructureType.Free)
    scores = {b: _evaluator(score_backend=b)[0]._score_host(vectors, mask)
              for b in ("auto", "native", "numpy")}
    np.testing.assert_array_equal(scores["auto"], scores["native"])
    np.testing.assert_allclose(scores["native"], scores["numpy"], atol=NATIVE_ATOL, rtol=0)
    np.testing.assert_array_equal(scores["numpy"], _host(StructureType.Free, vectors, mask))
    assert EvalConfig().score_backend == "auto" and EvalConfig().score_on_device is False
    with pytest.raises(ValueError, match="score_backend"):
        _evaluator(score_backend="gpu")[0]._score_host(vectors, mask)


def test_native_backend_raises_without_the_scorer(monkeypatch):
    vectors, mask = _population(StructureType.Free)
    monkeypatch.setattr(native, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="native fitness scorer unavailable"):
        _evaluator(score_backend="native")[0]._score_host(vectors, mask)
    got = _evaluator(score_backend="auto")[0]._score_host(vectors, mask)
    np.testing.assert_array_equal(got, _host(StructureType.Free, vectors, mask))


def test_score_on_device_matches_host_scoring():
    """One generation scored on the device and on the host (numpy) from the
    same vectors: scores within tolerance, the same ranking and winner, and
    the device scores among the small outputs."""
    dev, ncfg = _evaluator(score_on_device=True)
    host, _ = _evaluator(score_backend="numpy")
    items = list(Population(ncfg, seed=3).population.items())
    d = dev(copy.deepcopy(items))
    h = host(copy.deepcopy(items))
    assert d.dtype == np.float64
    np.testing.assert_allclose(d, h, rtol=DEVICE_RTOL, atol=DEVICE_ATOL)
    assert list(np.argsort(d, kind="stable")) == list(np.argsort(h, kind="stable"))
    assert dev.last_results["best_idx"] == host.last_results["best_idx"]
    small = dev.last_results["outputs"].small()
    assert set(small) == {"vectors", "mask", "scores"}
    assert small["scores"].dtype == np.float32 and len(small["scores"]) == len(items)
    assert set(host.last_results["outputs"].small()) == {"vectors", "mask"}
    np.testing.assert_array_equal(small["vectors"], host.last_results["vectors"])


def test_driver_and_cli_score_on_device(tmp_path):
    """``neat_illusion(score_on_device=True)`` and the CLI's
    ``--score_on_device`` run on the CPU."""
    cfg = preset("circles_bw").replace(pop_size=4, num_hidden=4, min_species_size=4, elitism=2)
    pop = neat_illusion(str(tmp_path / "run"), None, cfg, StructureType.Circles, w=48, h=40,
                        channels=(1, 4, 8), c_dim=1, gradient=0, generations=1,
                        score_on_device=True, flow=FlowConfig(**TINY_FLOW), quiet=True,
                        save_artifacts=False, device="cpu")
    assert pop.generation == 1 and np.isfinite(pop.best_genome.fitness)
    out = tmp_path / "cli"
    assert cli.main(["-o", str(out), "-s", "1", "-ch", "3,4,8", "--generations", "1",
                     "--score_on_device", "--device", "cpu"]) == 0
    assert (out / "metrics.jsonl").exists()
