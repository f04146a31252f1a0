"""How far the port's seeded draws, artifact renders and ``pop256_v5e8``
composition fall from the JAX package's, on the CPU.

    python3 tests/port_gaps.py [draws] [renders] [composition] [flow]

- draws: ``prng.normal`` against ``jax.random.normal`` over four seeds of
  1,000,003 draws, and the same through numpy's ``log1p`` (the port's
  ``erfinv`` before it copied XLA's): how many differ, by how many ulps;
- renders: each gallery run's best genome rendered by both packages'
  ``render_genome`` (run size, black and white backgrounds, and the
  800x800 poster), and by the port's level evaluator: the largest byte
  gap and the share of pixels off;
- composition: ``graft_entry.composition`` at the dry run's geometry on
  ``["cpu"] * 8`` on both predictor routes against the JAX composition:
  best fitness of both generations, generation 1's largest and mean
  fitness gap genome by genome; and on the fused route with the predictor
  drawn from numpy (``init_params_numpy``, the port's seeded draw before it
  drew JAX's);
- flow: the masked flow slots of the card tests' sharded case (64x48,
  ``3,48,96``, pop 16) with the predictor drawn from seeds 0-3.

A measurement, not a test (it takes a few minutes); with no argument it
runs all four.
"""

import os
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))
# the JAX composition's eight virtual CPU devices, as tests/conftest.py asks
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import numpy as np  # noqa: E402
import torch  # noqa: E402

from evolutionary_illusion_generator_tpu_torch.utils import prng  # noqa: E402


def draws():
    def normal_numpy_log1p(key, shape):
        lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
        u = prng.uniform(key, shape, lo, np.float32(1.0))
        saved = prng._log1p32
        prng._log1p32 = lambda x: np.log1p(x).astype(np.float32)
        try:
            return (np.float32(np.sqrt(2)) * prng._erfinv32(u)).astype(np.float32)
        finally:
            prng._log1p32 = saved

    n = 1_000_003
    for name, fn in (("port", prng.normal), ("numpy log1p", normal_numpy_log1p)):
        off, ulps = 0, 0
        for seed in range(4):
            ours = fn(prng.PRNGKey(seed), (n,))
            theirs = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (n,)))
            off += int((ours != theirs).sum())
            gap = np.abs(ours.view(np.int32).astype(np.int64) - theirs.view(np.int32))
            ulps = max(ulps, int(gap.max()))
        print(f"draws ({name}): {off} of {4 * n} differ from jax.random.normal, "
              f"at most {ulps} ulps")


def renders():
    from test_torch_artifacts import RUNS, _best

    from evolutionary_illusion_generator_tpu.evolution import artifacts as jax_artifacts
    from evolutionary_illusion_generator_tpu_torch.evolution import artifacts
    from evolutionary_illusion_generator_tpu_torch.models import cppn
    from evolutionary_illusion_generator_tpu_torch.ops.render import render_images

    def level_render(genome, cfg, grid, c_dim, bg, gradient):
        act_set = tuple(sorted(cppn.population_act_set([genome], cfg)))
        packed = cppn.pack_population_levels([genome], cfg, cppn.genome_depth(genome, cfg),
                                             act_set=act_set)
        x_mat = torch.as_tensor(grid["x_mat"], dtype=torch.float32)
        flat = torch.stack([x_mat.reshape(-1),
                            torch.as_tensor(grid["y_mat"], dtype=torch.float32).reshape(-1)])
        outs = cppn.make_population_eval(act_set)(
            *[torch.as_tensor(packed[k]) for k in ("weights", "bias", "response", "act_id",
                                                   "out_slot")], flat)
        return render_images(outs, x_mat, c_dim, bg=bg, gradient=gradient)[0].numpy()

    for run in sorted(RUNS):
        structure, c_dim, gradient, w, h = RUNS[run]
        genome, cfg = _best(run)
        for poster in (False, True):
            if poster:
                grid = artifacts._cached_enhanced_grid(artifacts.ENHANCED_SIZE, structure)
                jgrid = jax_artifacts._cached_enhanced_grid(artifacts.ENHANCED_SIZE, structure)
            else:
                grid = artifacts._cached_grid(structure, w, h)
                jgrid = jax_artifacts._cached_grid(structure, w, h)
            for bg in (1,) if poster else (0, 1):
                ref = jax_artifacts.render_genome(genome, cfg, jgrid, c_dim, bg=bg,
                                                  gradient=gradient).astype(np.int16)
                for label, img in (
                        ("node-serial", artifacts.render_genome(
                            genome, cfg, grid, c_dim, bg=bg, gradient=gradient, device="cpu")),
                        ("levels", level_render(genome, cfg, grid, c_dim, bg, gradient))):
                    d = np.abs(img.astype(np.int16) - ref)
                    print(f"renders {run} {'poster' if poster else 'run size'} bg {bg} "
                          f"{label}: max {d.max()}, {int((d > 0).sum())} of {d.size} pixels "
                          f"off ({(d > 0).mean():.3e})")


def composition():
    from evolutionary_illusion_generator_tpu.configs import run_preset as jax_run_preset
    from evolutionary_illusion_generator_tpu.evolution.driver import neat_illusion
    from evolutionary_illusion_generator_tpu.neat.reporters import (
        StatisticsReporter as JaxStatistics,
    )
    from evolutionary_illusion_generator_tpu_torch import graft_entry
    from evolutionary_illusion_generator_tpu_torch.neat.reporters import StatisticsReporter

    def first_generation(pop, kind):
        stats = next(r for r in pop.reporters if isinstance(r, kind))
        return {k: f for sp in stats.generation_statistics[0].values() for k, f in sp.items()}

    with tempfile.TemporaryDirectory() as out:
        kwargs = jax_run_preset("pop256_v5e8").driver_kwargs()
        kwargs.update(w=96, h=72, repeat=6, channels=[3, 16, 32, 48])
        common = dict(generations=1, seed=0, n_devices=8, quiet=True, save_artifacts=False)
        jpop = neat_illusion(out, None, **common, **kwargs)
        jpop2 = neat_illusion(out, None, checkpoint=os.path.join(out, "neat-checkpoint-1"),
                              **common, **kwargs)
    ref = first_generation(jpop, JaxStatistics)
    print(f"composition (JAX): best fitness {jpop.best_genome.fitness:.4f} then "
          f"{jpop2.best_genome.fitness:.4f}")
    from evolutionary_illusion_generator_tpu_torch.evolution import driver
    from evolutionary_illusion_generator_tpu_torch.models.prednet import loader

    def numpy_drawn(path, channels, seed=0, dtype=torch.bfloat16, half_order="ahat-a",
                    device=None):
        return loader.params_from_numpy(loader.init_params_numpy(channels, seed), dtype, device)

    for route, draw in ((False, None), ("fused", None), ("fused", numpy_drawn)):
        seeded = driver.load_or_init
        driver.load_or_init = draw or seeded
        try:
            with tempfile.TemporaryDirectory() as out:
                pop, pop2 = graft_entry.composition(out, 8, ["cpu"] * 8, use_pallas=route,
                                                    **graft_entry.DRYRUN_GEOMETRY)
        except RuntimeError as err:  # no fitness signal
            print(f"composition (port, use_pallas={route!r}, numpy-drawn predictor): {err}")
            continue
        finally:
            driver.load_or_init = seeded
        ours = first_generation(pop, StatisticsReporter)
        d = np.abs(np.array([ours[k] - ref[k] for k in sorted(ref)]))
        print(f"composition (port, use_pallas={route!r}"
              f"{', numpy-drawn predictor' if draw else ''}): best fitness "
              f"{pop.best_genome.fitness:.4f} then {pop2.best_genome.fitness:.4f}; "
              f"generation 1 against JAX genome by genome: max {d.max():.4e}, "
              f"mean {d.mean():.4e} over {len(d)}")


def flow():
    from evolutionary_illusion_generator_tpu_torch.evolution import EvalConfig, GenerationEvaluator
    from evolutionary_illusion_generator_tpu_torch.models.prednet.loader import load_or_init
    from evolutionary_illusion_generator_tpu_torch.neat import Population, preset

    ncfg = preset("circles").replace(pop_size=16)
    items = list(Population(ncfg, seed=3).population.items())
    for seed in range(4):
        params = load_or_init(None, (3, 48, 96), seed=seed, device="cpu")
        ev = GenerationEvaluator(EvalConfig(w=64, h=48), params, ncfg, device="cpu")
        fitness = ev(list(items))
        mask = ev.last_results["outputs"].to_numpy()["mask"]
        print(f"flow (64x48, 3,48,96 from seed {seed}, pop 16): {int(mask.sum())} of "
              f"{mask.size} corner slots masked in, best fitness {fitness.max():.4f}")


if __name__ == "__main__":
    parts = sys.argv[1:] or ["draws", "renders", "composition", "flow"]
    for part in parts:
        {"draws": draws, "renders": renders, "composition": composition, "flow": flow}[part]()
