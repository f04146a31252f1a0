"""The port's ``graft_entry.py`` against the repo's ``__graft_entry__.py``.

The ``pop256_v5e8`` composition runs in both packages at the JAX dry run's
geometry (96x72, ``3,16,32,48``, repeat 6, seed 0; 256 genomes in chunks of
64 over an 8-entry mesh, a checkpoint, a resume): the port on ``["cpu"] *
8`` on both of its predictor routes, JAX on the 8 virtual CPU devices the
conftest gives it.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as jax_entry
from evolutionary_illusion_generator_tpu.configs import run_preset as jax_run_preset
from evolutionary_illusion_generator_tpu.evolution.driver import neat_illusion as jax_neat_illusion
from evolutionary_illusion_generator_tpu.neat import Population as JaxPopulation
from evolutionary_illusion_generator_tpu.neat.reporters import (
    StatisticsReporter as JaxStatisticsReporter,
)
from evolutionary_illusion_generator_tpu_torch import graft_entry
from evolutionary_illusion_generator_tpu_torch.models.prednet.loader import params_to_numpy
from evolutionary_illusion_generator_tpu_torch.neat import Population
from evolutionary_illusion_generator_tpu_torch.neat.reporters import StatisticsReporter

# the suite runs in several worker processes: one torch thread each keeps
# them from oversubscribing the cores
torch.set_num_threads(1)

MESH = ["cpu"] * 8
# Generation 1's fitness, genome by genome, against JAX's.  The seeded
# predictor is JAX's bit for bit, but its bfloat16 rollout sums in another
# order (and on the "fused" route in float32 where JAX's default rounds each
# source's conv to bfloat16); a one-ulp flip grows over the steps and moves
# the tracked corners, so every genome's fitness moves a little.  Measured
# over the 256 genomes: max 2.84e-02 / mean 7.20e-03 (use_pallas=False),
# max 3.34e-02 / mean 7.25e-03 ("fused"), at fitness 0.60-0.70; the card's
# bound for a sharded against an unsharded evaluator is 0.05 as well.
FITNESS_ATOL = 5e-2
FITNESS_MEAN_TOL = 1e-2
# 22 steps of a bfloat16 rollout: held in the mean (ROADMAP.md Queue 3)
ROLLOUT_MEAN_TOL = 2e-2


def _fitness_by_generation(pop, reporter_type):
    """Per evaluated generation, {genome key: fitness}."""
    stats = next(r for r in pop.reporters if isinstance(r, reporter_type))
    return [{k: f for species in gen.values() for k, f in species.items()}
            for gen in stats.generation_statistics]


@pytest.fixture(scope="module")
def jax_composition(tmp_path_factory):
    """The JAX composition, as ``__graft_entry__.dryrun_multichip`` runs it."""
    out = str(tmp_path_factory.mktemp("jax"))
    kwargs = jax_run_preset("pop256_v5e8").driver_kwargs()
    kwargs.update(w=96, h=72, repeat=6, channels=[3, 16, 32, 48])
    common = dict(generations=1, seed=0, n_devices=8, quiet=True, save_artifacts=False)
    pop = jax_neat_illusion(out, None, **common, **kwargs)
    ckpt = os.path.join(out, "neat-checkpoint-1")
    pop2 = jax_neat_illusion(out, None, checkpoint=ckpt, **common, **kwargs)
    assert pop2.generation == pop.generation + 1 and pop2.best_genome.fitness > 0.0
    return (_fitness_by_generation(pop, JaxStatisticsReporter),
            _genomes(JaxPopulation(kwargs["config"], seed=0)))


def _genomes(pop):
    return {k: (sorted((n, dataclasses.astuple(g)) for n, g in v.nodes.items()),
                sorted((c, dataclasses.astuple(g)) for c, g in v.connections.items()))
            for k, v in pop.population.items()}


@pytest.mark.parametrize("use_pallas", [False, "fused"], ids=["plain", "fused"])
def test_composition_matches_the_jax_composition(use_pallas, jax_composition, tmp_path):
    """Generation 1's population is JAX's genome for genome, and each
    genome's fitness is JAX's within FITNESS_ATOL (FITNESS_MEAN_TOL in the
    mean); both generations have a best fitness above 0 and the resume
    advances one generation.  The resumed populations are not compared:
    reproduction selects on those small fitness differences."""
    jax_fitness, jax_first = jax_composition
    pop, pop2 = graft_entry.composition(str(tmp_path), 8, MESH, use_pallas=use_pallas,
                                        **graft_entry.DRYRUN_GEOMETRY)
    assert pop.config.pop_size == 256 and pop2.generation == pop.generation + 1 == 2
    assert _genomes(Population(pop.config, seed=0)) == jax_first
    ours, ref = _fitness_by_generation(pop, StatisticsReporter)[0], jax_fitness[0]
    assert sorted(ours) == sorted(ref) and len(ours) == 256
    got = np.array([ours[k] for k in sorted(ref)])
    want = np.array([ref[k] for k in sorted(ref)])
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=FITNESS_ATOL, rtol=0)
    assert np.abs(got - want).mean() <= FITNESS_MEAN_TOL
    resumed = _fitness_by_generation(pop2, StatisticsReporter)[0]
    assert len(resumed) == 256 and np.isfinite(list(resumed.values())).all()
    assert pop.best_genome.fitness > 0.0 and max(resumed.values()) > 0.0


def test_dryrun_multichip_prints_the_jax_line(capsys):
    """Every part of the dry run passes on ``["cpu"] * 8`` and its line has
    the JAX line's fields and loss."""
    line = graft_entry.dryrun_multichip(8, MESH)
    assert capsys.readouterr().out.strip() == line
    assert line.startswith("dryrun_multichip(8): generation step over 16 genomes + dp train "
                           "step OK (loss=0.2528) + pop x sp rollout (4x2) OK + pop256_v5e8 "
                           "composition (256 genomes, chunk 64, 8-dev sharded evaluator, "
                           "per-gen checkpoint + resume, best fitness ")
    assert line.endswith(") OK") and float(line.rsplit(" ", 2)[1][:-1]) > 0.0


def test_dryrun_multichip_takes_one_device_repeated(monkeypatch):
    """``device="cpu"`` stands for ``["cpu"] * n_devices`` in every part."""
    seen = []
    monkeypatch.setattr(graft_entry, "composition", lambda *a, **kw: seen.append((a, kw)))
    with pytest.raises(TypeError):  # the stub returns no populations
        graft_entry.dryrun_multichip(2, "cpu")
    (out, n, devices), kw = seen[0]
    assert n == 2 and devices == ["cpu", "cpu"] and kw == graft_entry.DRYRUN_GEOMETRY


def test_entry_draws_the_jax_entry_and_rolls_out_as_it_does():
    """``entry``'s params and images are the JAX entry's bit for bit; its
    forward is the 20+2-step population rollout, held to JAX's on a crop in
    the mean."""
    fn, (params, images) = graft_entry.entry(device="cpu")
    jfn, (jparams, jimages) = jax_entry.entry()
    np.testing.assert_array_equal(images.numpy(), np.asarray(jimages))
    for ours, ref in zip(params_to_numpy(params), jparams):
        assert sorted(ours) == sorted(ref)
        for k in ref:
            np.testing.assert_array_equal(ours[k], np.asarray(ref[k], np.float32), err_msg=k)
    crop = images[:1, :24, :32]
    f0, f1 = fn(params, crop)
    j0, j1 = jfn(jparams, jnp.asarray(crop.numpy()))
    for a, b in ((f0, j0), (f1, j1)):
        assert a.shape == (1, 24, 32, 3) and bool(torch.isfinite(a).all())
        assert np.abs(a.numpy() - np.asarray(b)).mean() <= ROLLOUT_MEAN_TOL
