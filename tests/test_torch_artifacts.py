"""The port's per-generation artifacts against the JAX package's, and
``neat_illusion``'s artifacts and ``profile_dir`` on the CPU.

The genomes are the best of committed gallery checkpoints; the other
inputs come from the gallery files or from a numpy seed.
"""

import glob
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from evolutionary_illusion_generator_tpu.evolution import artifacts as jax_artifacts
from evolutionary_illusion_generator_tpu.neat.checkpoint import restore_checkpoint
from evolutionary_illusion_generator_tpu_torch.evolution import artifacts, driver, neat_illusion
from evolutionary_illusion_generator_tpu_torch.neat import preset
from evolutionary_illusion_generator_tpu_torch.ops.flow import FlowConfig
from evolutionary_illusion_generator_tpu_torch.structure import StructureType
from evolutionary_illusion_generator_tpu_torch.utils.png import read_png
from evolutionary_illusion_generator_tpu_torch.utils.profiling import TRACE_FILE

# the suite runs in several worker processes: one torch thread each keeps
# them from oversubscribing the cores
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
# gallery run -> (structure, c_dim, gradient, w, h), as scripts/make_gallery.py ran it
RUNS = {
    "circles_color": (StructureType.Circles, 3, 1, 160, 120),
    "circles_bw": (StructureType.Circles, 1, 0, 160, 120),
    "free_big_640": (StructureType.Free, 3, 1, 640, 480),
}
ARTIFACTS = ("best.png", "best_flow.png", "best_black_bg.png", "enhanced.png")
TINY_FLOW = dict(max_corners=32, win=9, levels=2, iters=6)


def _best(run):
    pop = restore_checkpoint(str(REPO / "gallery" / run / "neat-checkpoint-30"))
    return pop.best_genome, pop.config


# Both packages render through the node-serial evaluator at a 128-slot
# bucket; last-bit CPPN differences (float32 sums, transcendentals) still
# move a pixel by one where a value sits on a uint8 truncation boundary.
# Measured on these renders: at most 6.9e-05 of the pixels (circles_color,
# 4 of 57,600), none by more than 1.
MAX_OFF_BY_ONE_SHARE = 1e-4


def _assert_render_close(ours, ref):
    """The uint8 truncation tolerance: a pixel off by one, on at most
    MAX_OFF_BY_ONE_SHARE of the pixels."""
    assert ours.shape == ref.shape and ours.dtype == ref.dtype == np.uint8
    diff = np.abs(ours.astype(np.int16) - ref.astype(np.int16))
    assert diff.max() <= 1 and (diff > 0).mean() <= MAX_OFF_BY_ONE_SHARE


@pytest.mark.parametrize("poster", [False, True], ids=["run_size", "enhanced"])
@pytest.mark.parametrize("run", sorted(RUNS))
def test_render_genome_matches_jax(run, poster):
    structure, c_dim, gradient, w, h = RUNS[run]
    genome, cfg = _best(run)
    if poster:
        size = artifacts.ENHANCED_SIZE
        grid = artifacts._cached_enhanced_grid(size, structure)
        jax_grid = jax_artifacts._cached_enhanced_grid(size, structure)
    else:
        grid = artifacts._cached_grid(structure, w, h)
        jax_grid = jax_artifacts._cached_grid(structure, w, h)
    for bg in (0, 1):
        ours = artifacts.render_genome(genome, cfg, grid, c_dim, bg=bg, gradient=gradient,
                                       device="cpu")
        ref = jax_artifacts.render_genome(genome, cfg, jax_grid, c_dim, bg=bg, gradient=gradient)
        _assert_render_close(ours, ref)
        if poster:
            break  # the poster is drawn on the white background only


@pytest.mark.parametrize("run", ["circles_color", "circles_bw"])
def test_save_best_artifacts_matches_jax(run, tmp_path):
    structure, c_dim, gradient, w, h = RUNS[run]
    genome, cfg = _best(run)
    image = np.asarray(Image.open(REPO / "gallery" / run / "best.png"))
    rng = np.random.default_rng(len(run))
    vectors = np.zeros((40, 4), np.float32)
    vectors[:, :2] = rng.uniform(0, 1, (40, 2)) * [w, h]
    vectors[:, 2:] = rng.normal(0, 1, (40, 2))
    flow_frame0 = rng.integers(0, 256, (h, w, c_dim), dtype=np.uint8)
    args = (genome, image, vectors, flow_frame0, cfg, structure, c_dim, gradient)
    artifacts.save_best_artifacts(*args, str(tmp_path / "ours"), device="cpu")
    jax_artifacts.save_best_artifacts(*args, str(tmp_path / "ref"))
    assert sorted(os.listdir(tmp_path / "ours")) == sorted(os.listdir(tmp_path / "ref"))
    for name in sorted(os.listdir(tmp_path / "ref")):
        ours = np.asarray(Image.open(tmp_path / "ours" / name))
        ref = np.asarray(Image.open(tmp_path / "ref" / name))
        if name in ("best.png", "best_flow.png"):
            np.testing.assert_array_equal(ours, ref)
        else:
            _assert_render_close(ours, ref)


def _tiny_run(out, **kw):
    cfg = preset("circles").replace(pop_size=4, num_hidden=4, min_species_size=4, elitism=2)
    return neat_illusion(str(out), None, cfg, StructureType.Circles, w=48, h=40,
                         channels=(3, 8, 16), c_dim=3, gradient=1, generations=2, seed=1,
                         flow=FlowConfig(**TINY_FLOW), quiet=True, device="cpu", **kw)


def test_driver_writes_the_artifacts_by_default(tmp_path, monkeypatch):
    """The file set of the JAX package's two-generation run
    (tests/test_e2e.py), and best.png is the last winner's rendered row."""
    made = []

    class Recording(driver.GenerationEvaluator):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(driver, "GenerationEvaluator", Recording)
    pop = _tiny_run(tmp_path / "run")
    out = tmp_path / "run"
    assert pop.generation == 2 and pop.best_genome is not None
    for name in ARTIFACTS:
        assert (out / name).exists(), name
    assert glob.glob(str(out / "neat-checkpoint-*"))
    with open(out / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [r["generation"] for r in recs] == [0, 1] and recs[0]["pop_size"] >= 4
    shapes = {name: read_png(str(out / name))[0].shape for name in ARTIFACTS}
    assert shapes == {"best.png": (40, 48, 3), "best_flow.png": (40, 48, 3),
                      "best_black_bg.png": (40, 48, 3), "enhanced.png": (800, 800, 3)}
    res = made[0].last_results
    np.testing.assert_array_equal(read_png(str(out / "best.png"))[0],
                                  res["outputs"].fetch("images_u8", res["best_row"]))
    # the overlay's base is the winner's first flow frame
    frame = res["outputs"].fetch("flow_frame0", res["best_row"])
    assert frame.dtype == np.uint8 and frame.shape == (40, 48, 3)


def test_profile_dir_writes_a_trace_of_generation_1(tmp_path):
    prof = tmp_path / "prof"
    _tiny_run(tmp_path / "run", save_artifacts=False, profile_dir=str(prof))
    assert os.listdir(prof) == [TRACE_FILE]
    with open(prof / TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("conv2d" in n for n in names)  # the rollout ran under the trace
    assert not (tmp_path / "run" / "best.png").exists()
