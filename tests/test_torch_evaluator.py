"""One whole generation through the port's GenerationEvaluator against the
JAX package's, and the port's ``neat_illusion`` driver on the CPU."""

import copy
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from evolutionary_illusion_generator_tpu.evolution.evaluator import (
    EvalConfig as JaxEvalConfig,
    GenerationEvaluator as JaxEvaluator,
)
from evolutionary_illusion_generator_tpu.neat import Population as JaxPopulation
from evolutionary_illusion_generator_tpu.neat import preset as jax_preset
from evolutionary_illusion_generator_tpu.ops.flow import FlowConfig as JaxFlowConfig
from evolutionary_illusion_generator_tpu_torch.evolution import (
    EvalConfig,
    GenerationEvaluator,
    neat_illusion,
)
from evolutionary_illusion_generator_tpu_torch.models.prednet.loader import (
    init_params_numpy,
    params_from_numpy,
)
from evolutionary_illusion_generator_tpu_torch.neat import preset
from evolutionary_illusion_generator_tpu_torch.ops.flow import FlowConfig
from evolutionary_illusion_generator_tpu_torch.structure import StructureType

# the suite runs in several worker processes: one torch thread each keeps
# them from oversubscribing the cores
torch.set_num_threads(1)

TINY_FLOW = dict(max_corners=32, win=9, levels=2, iters=6)
# float32 predictor on both sides; the fitness reads LK vectors that agree
# to ~1e-5 px (float32 summation order), scored in float64 (2e-5 measured)
FITNESS_ATOL = 1e-3


@pytest.mark.parametrize("structure,c_dim,channels", [
    (StructureType.Free, 3, (3, 8, 16)),
    (StructureType.Circles, 1, (1, 4, 8)),
])
def test_generation_matches_jax(structure, c_dim, channels):
    layers = init_params_numpy(channels, seed=3)
    ncfg = jax_preset("circles" if c_dim == 3 else "circles_bw").replace(
        pop_size=6, num_hidden=4, num_outputs=c_dim)
    items = list(JaxPopulation(ncfg, seed=5).population.items())
    kw = dict(structure=structure, w=64, h=48, c_dim=c_dim, gradient=1, repeat=3,
              extension=2, prednet_dtype="float32")
    ref_eval = JaxEvaluator(
        JaxEvalConfig(flow=JaxFlowConfig(**TINY_FLOW), score_backend="numpy",
                      program_cache=False, **kw),
        [{k: jnp.asarray(v) for k, v in l.items()} for l in layers], ncfg)
    ours_eval = GenerationEvaluator(
        EvalConfig(flow=FlowConfig(**TINY_FLOW), **kw),
        params_from_numpy(layers, torch.float32, "cpu"), ncfg, device="cpu")

    ref_items, our_items = copy.deepcopy(items), copy.deepcopy(items)
    ref_scores = ref_eval(ref_items)
    scores = ours_eval(our_items)
    np.testing.assert_allclose(scores, ref_scores, atol=FITNESS_ATOL, rtol=0)
    assert [g.fitness for _, g in our_items] == list(scores)
    assert ours_eval.last_results["best_idx"] == ref_eval.last_results["best_idx"]

    ref_out = ref_eval.last_results["outputs"].to_numpy()
    out = ours_eval.last_results["outputs"].to_numpy()
    diff = np.abs(out["images_u8"].astype(np.int16) - ref_out["images_u8"].astype(np.int16))
    # uint8 truncation boundaries, as in test_torch_cppn_render.py
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.01
    np.testing.assert_array_equal(out["mask"], ref_out["mask"])
    # the overlay's base frame: the same float32 frame, truncated to uint8
    diff = np.abs(out["flow_frame0"].astype(np.int16) - ref_out["flow_frame0"].astype(np.int16))
    assert out["flow_frame0"].dtype == np.uint8 and out["flow_frame0"].shape == ref_out["flow_frame0"].shape
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.01
    best = ours_eval.last_results["best_row"]
    np.testing.assert_array_equal(ours_eval.last_results["outputs"].fetch("images_u8", best),
                                  out["images_u8"][best])


def test_driver_runs_generations_on_cpu(tmp_path):
    out = str(tmp_path / "run")
    cfg = preset("circles_bw").replace(pop_size=4, num_hidden=4, min_species_size=4,
                                       elitism=2)
    pop = neat_illusion(out, None, cfg, StructureType.Circles, w=48, h=40,
                        channels=(1, 4, 8), c_dim=1, gradient=0, generations=2, seed=1,
                        flow=FlowConfig(**TINY_FLOW), quiet=True, save_artifacts=False,
                        device="cpu")
    assert pop.generation == 2 and pop.best_genome is not None
    with open(os.path.join(out, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["generation"] for r in recs] == [0, 1]
    assert all(np.isfinite(r["fitness_max"]) for r in recs)
    assert os.path.exists(os.path.join(out, "neat-checkpoint-2"))

    resumed = neat_illusion(out, None, cfg, StructureType.Circles, w=48, h=40,
                            channels=(1, 4, 8), c_dim=1, gradient=0,
                            checkpoint=os.path.join(out, "neat-checkpoint-2"),
                            generations=1, flow=FlowConfig(**TINY_FLOW), quiet=True,
                            save_artifacts=False, device="cpu")
    assert resumed.generation == 3


@pytest.mark.parametrize("kwargs,exc,match", [
    # the parallel evaluator is ported: two devices where the run has one
    # is make_mesh's error (tests/test_torch_parallel.py runs it on two)
    pytest.param(dict(n_devices=2), ValueError, "need 2 devices, have 1",
                 id="kwargs0-Parallel"),
])
def test_driver_refuses_what_is_not_ported(kwargs, exc, match, tmp_path):
    """Driver arguments the run cannot honour raise before anything runs."""
    with pytest.raises(exc, match=match):
        neat_illusion(str(tmp_path / "run"), None, None, StructureType.Circles, device="cpu",
                      **kwargs)
    assert not (tmp_path / "run").exists()


@pytest.mark.parametrize("kwargs", [dict(score_on_device=True),
                                    dict(chainer_half_order="auto"),
                                    dict(debug_nans=True)])
def test_driver_runs_the_ported_options(kwargs, tmp_path):
    """``score_on_device=True``, a ``chainer_half_order`` other than
    ``"ahat-a"`` (no Chainer file given, so nothing is imported, as in the
    JAX driver) and ``debug_nans=True`` (the sanitizer, silent on a clean
    generation: tests/test_torch_debug_nans.py) run a generation."""
    cfg = preset("circles_bw").replace(pop_size=4, num_hidden=4, min_species_size=4,
                                       elitism=2)
    pop = neat_illusion(str(tmp_path / "run"), None, cfg, StructureType.Circles, w=48, h=40,
                        channels=(1, 4, 8), c_dim=1, gradient=0, generations=1,
                        flow=FlowConfig(**TINY_FLOW), quiet=True, save_artifacts=False,
                        device="cpu", **kwargs)
    assert pop.generation == 1 and np.isfinite(pop.best_genome.fitness)
