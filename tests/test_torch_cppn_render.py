"""The port's CPPN packer, CPPN evaluator and renderer against the JAX
package, on the genomes of the committed gallery checkpoints."""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from evolutionary_illusion_generator_tpu.models import cppn as jax_cppn
from evolutionary_illusion_generator_tpu.neat import restore_checkpoint
from evolutionary_illusion_generator_tpu.ops import render as jax_render
from evolutionary_illusion_generator_tpu.ops.grids import GRID_SCALING, create_grid
from evolutionary_illusion_generator_tpu_torch.models import cppn
from evolutionary_illusion_generator_tpu_torch.ops import render
from evolutionary_illusion_generator_tpu_torch.structure import StructureType

# the suite runs in several worker processes: one torch thread each keeps
# them from oversubscribing the cores
torch.set_num_threads(1)

GALLERY = Path(__file__).resolve().parents[1] / "gallery"
W, H = 160, 120
# The CPPN's float32 sin/tanh/exp and its matmul sums differ in the last
# bits between XLA and torch; a value that lands on a uint8 truncation
# boundary then differs by one.  Measured on the gallery: at most 0.63% of
# the pixels, never by more than 1.
MAX_OFF_BY_ONE_SHARE = 0.01

CHECKPOINTS = {
    "circles_color": StructureType.Circles,
    "circles_free": StructureType.CirclesFree,
    "free_color": StructureType.Free,
    "circles_bw": StructureType.Circles,
}
TABLES = ("weights", "bias", "response", "act_id", "out_slot")


def _population(run):
    ckpt = sorted(GALLERY.glob(f"{run}/neat-checkpoint-*"))[-1]
    pop = restore_checkpoint(str(ckpt))
    return pop.config, list(pop.population.values())


def _check_bytes(ours, ref):
    assert ours.shape == ref.shape and ours.dtype == np.uint8
    diff = np.abs(ours.astype(np.int16) - ref.astype(np.int16))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= MAX_OFF_BY_ONE_SHARE


@pytest.mark.parametrize("run", sorted(CHECKPOINTS))
def test_gallery_render_matches_jax(run):
    cfg, genomes = _population(run)
    act_set = tuple(sorted(cppn.population_act_set(genomes, cfg)))
    packed = cppn.pack_population_levels(genomes, cfg, 8, 16, act_set=act_set)
    ref_packed = jax_cppn.pack_population_levels(genomes, cfg, 8, 16, act_set=act_set)
    for k in TABLES:  # the packer is a copy: identical tables
        np.testing.assert_array_equal(packed[k], ref_packed[k])

    grid = create_grid(CHECKPOINTS[run], W, H, GRID_SCALING)
    gf = np.stack([grid["x_mat"].reshape(-1), grid["y_mat"].reshape(-1)]).astype(np.float32)
    x_mat = grid["x_mat"].astype(np.float32)
    c_dim = min(3, cfg.num_outputs)

    ref_out = jax.jit(jax_cppn.make_population_eval(act_set))(
        *[jnp.asarray(packed[k]) for k in TABLES], jnp.asarray(gf))
    out = cppn.make_population_eval(act_set)(
        *[torch.as_tensor(packed[k]) for k in TABLES], torch.as_tensor(gf))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=1e-3, rtol=0)

    # gradient=1, as the main path renders: a quantized palette (gradient=0)
    # turns a last-bit difference at a palette boundary into a full step,
    # so test_render_same_values_give_same_bytes covers it from equal values
    ref = jax_render.render_images(ref_out, jnp.asarray(x_mat), c_dim, gradient=1)
    ours = render.render_images(out, torch.as_tensor(x_mat), c_dim, gradient=1)
    _check_bytes(ours.numpy(), np.asarray(ref))


def test_render_same_values_give_same_bytes():
    """From identical node values the renderers agree byte for byte,
    including the clip-before-truncate order and the background mask."""
    rng = np.random.default_rng(0)
    vals = rng.uniform(-0.5, 1.5, (3, 3, 12 * 16)).astype(np.float32)
    vals[0, :, :5] = np.array([0.0, 1.0, 0.999999, 0.5, 1.0 / 255.0])[None]
    x_mat = rng.choice([-1.0, 0.3], (12, 16)).astype(np.float32)
    for c_dim, gradient in [(3, 1), (3, 0), (1, 1), (1, 0)]:
        ref = jax_render.render_images(jnp.asarray(vals), jnp.asarray(x_mat), c_dim,
                                       gradient=gradient)
        ours = render.render_images(torch.as_tensor(vals), torch.as_tensor(x_mat), c_dim,
                                    gradient=gradient)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    ref = jax_render.render_equilum_images(jnp.asarray(vals), jnp.asarray(x_mat))
    ours = render.render_equilum_images(torch.as_tensor(vals), torch.as_tensor(x_mat))
    _check_bytes(ours.numpy(), np.asarray(ref))
    u8 = ours
    np.testing.assert_array_equal(render.to_unit_float(u8).numpy(),
                                  np.asarray(jax_render.to_unit_float(jnp.asarray(u8.numpy()))))


def test_genome_depth_and_required_nodes_match():
    cfg, genomes = _population("circles_free")
    for g in genomes:
        assert cppn.required_nodes(g, cfg) == jax_cppn.required_nodes(g, cfg)
        assert cppn.genome_depth(g, cfg) == jax_cppn.genome_depth(g, cfg)
