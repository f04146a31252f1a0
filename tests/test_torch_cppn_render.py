"""The port's CPPN packer, CPPN evaluator and renderer against the JAX
package, on the genomes of the committed gallery checkpoints."""

import dataclasses
from pathlib import Path
from random import Random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from evolutionary_illusion_generator_tpu.models import cppn as jax_cppn
from evolutionary_illusion_generator_tpu.neat import ConnectionGene, Genome, preset, restore_checkpoint
from evolutionary_illusion_generator_tpu.ops import render as jax_render
from evolutionary_illusion_generator_tpu.ops.grids import GRID_SCALING, create_grid
from evolutionary_illusion_generator_tpu_torch.models import cppn
from evolutionary_illusion_generator_tpu_torch.ops import render
from evolutionary_illusion_generator_tpu_torch.structure import StructureType
from test_cppn import eval_genome_oracle

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


# -- the node-serial evaluator (the JAX package's artifact path) ------------

def _mutated(cfg, n, steps, seed=7):
    """``n`` genomes mutated ``steps`` times, as tests/test_cppn.py makes them."""
    rng = Random(seed)
    genomes = []
    for t in range(n):
        g = Genome.new(t, cfg, rng)
        for _ in range(steps):
            g.mutate(cfg, rng)
        genomes.append(g)
    return genomes


def _torch_tables(packed):
    return [torch.as_tensor(packed[k]) for k in TABLES]


# Float32 sums in another order and last-bit transcendentals, grown by deep
# genomes (sin(5z)): measured against JAX on these cases at most 1.3e-4
# (free_color), the level evaluator's atol above; the oracle's float64 is
# held at tests/test_cppn.py's tolerance.
SERIAL_ATOL = 1e-3


def test_compile_genome_matches_jax_and_the_oracle():
    """tests/test_cppn.py's compile cases: five genomes mutated 20 times,
    a 128-slot bucket; identical tables, values within SERIAL_ATOL of
    JAX's ``evaluate_cppn`` and the host oracle's at its tolerance."""
    cfg = preset("circles")
    inputs = np.random.default_rng(0).uniform(-10, 10, (2, 64))
    for g in _mutated(cfg, 5, 20):
        prog = cppn.compile_genome(g, cfg, max_nodes=128)
        ref = jax_cppn.compile_genome(g, cfg, max_nodes=128)
        assert isinstance(prog, cppn.CompiledCppn)
        assert (prog.num_inputs, prog.num_nodes) == (ref.num_inputs, ref.num_nodes)
        for k in TABLES:
            np.testing.assert_array_equal(getattr(prog, k), getattr(ref, k))
        got = cppn.evaluate_cppn(*[torch.as_tensor(getattr(prog, k)) for k in TABLES],
                                 torch.as_tensor(inputs, dtype=torch.float32)).numpy()
        want = np.asarray(jax_cppn.evaluate_cppn(*[jnp.asarray(getattr(ref, k)) for k in TABLES],
                                                 jnp.asarray(inputs, jnp.float32)))
        np.testing.assert_allclose(got, want, atol=SERIAL_ATOL, rtol=0)
        np.testing.assert_allclose(got, eval_genome_oracle(g, cfg, inputs), rtol=2e-3, atol=1e-4)


@pytest.mark.parametrize("run", sorted(CHECKPOINTS))
def test_evaluate_population_matches_jax(run):
    """A gallery population through ``pack_population`` +
    ``evaluate_population`` (the artifact path) against JAX's, and through
    ``evaluate_population_levels`` against both."""
    cfg, genomes = _population(run)
    packed = cppn.pack_population(genomes, cfg)
    ref_packed = jax_cppn.pack_population(genomes, cfg)
    for k in TABLES:
        np.testing.assert_array_equal(packed[k], ref_packed[k])
    grid = create_grid(CHECKPOINTS[run], 40, 30, GRID_SCALING)
    gf = np.stack([grid["x_mat"].reshape(-1), grid["y_mat"].reshape(-1)]).astype(np.float32)
    out = cppn.evaluate_population(*_torch_tables(packed), torch.as_tensor(gf)).numpy()
    ref = np.asarray(jax.jit(jax_cppn.evaluate_population)(
        *[jnp.asarray(ref_packed[k]) for k in TABLES], jnp.asarray(gf)))
    assert out.shape == ref.shape == (len(genomes), cfg.num_outputs, gf.shape[1])
    np.testing.assert_allclose(out, ref, atol=SERIAL_ATOL, rtol=0)
    lv = cppn.pack_population_levels(genomes, cfg)
    levels = cppn.evaluate_population_levels(*_torch_tables(lv), torch.as_tensor(gf)).numpy()
    ref_levels = np.asarray(jax_cppn.evaluate_population_levels(
        *[jnp.asarray(lv[k]) for k in TABLES], jnp.asarray(gf)))
    np.testing.assert_allclose(levels, ref_levels, atol=SERIAL_ATOL, rtol=0)
    np.testing.assert_allclose(levels, out, atol=SERIAL_ATOL, rtol=0)
    one = cppn.evaluate_cppn_levels(*[t[0] for t in _torch_tables(lv)], torch.as_tensor(gf))
    np.testing.assert_array_equal(one.numpy(), levels[0])


def test_pack_population_batches_and_levels_match_the_oracle():
    """tests/test_cppn.py's batch and level cases against the host oracle."""
    cfg = preset("circles_bw")
    genomes = _mutated(cfg, 4, 1)
    inputs = np.random.default_rng(1).uniform(-1, 1, (2, 32)).astype(np.float32)
    out = cppn.evaluate_population(*_torch_tables(cppn.pack_population(genomes, cfg)),
                                   torch.as_tensor(inputs))
    assert out.shape == (4, 1, 32)
    cfg_c = preset("circles")
    deep = _mutated(cfg_c, 4, 30)
    wide = np.random.default_rng(2).uniform(-10, 10, (2, 48))
    lv = cppn.evaluate_population_levels(*_torch_tables(cppn.pack_population_levels(deep, cfg_c)),
                                         torch.as_tensor(wide, dtype=torch.float32))
    for i, g in enumerate(genomes):
        np.testing.assert_allclose(out[i].numpy(), eval_genome_oracle(g, cfg, inputs),
                                   rtol=2e-3, atol=1e-4)
    for i, g in enumerate(deep):
        np.testing.assert_allclose(lv[i].numpy(), eval_genome_oracle(g, cfg_c, wide),
                                   rtol=2e-3, atol=1e-4)


def test_compile_genome_raises_as_jax():
    """A cycle, a non-``sum`` aggregation and more nodes than the bucket
    each raise, with the JAX compiler's errors."""
    cfg = preset("circles")
    g = _mutated(cfg, 1, 20)[0]
    hidden = sorted(n for n in cppn.required_nodes(g, cfg) if n not in cfg.output_keys)
    out = cfg.output_keys[0]
    cyclic = g.copy()
    if hidden:
        cyclic.connections[(out, hidden[0])] = ConnectionGene(1.0, True)
        cyclic.connections[(hidden[0], out)] = ConnectionGene(1.0, True)
    else:
        cyclic.connections[(out, out)] = ConnectionGene(1.0, True)
    summed = g.copy()
    summed.nodes[out] = dataclasses.replace(summed.nodes[out], aggregation="max")
    need = len(cppn.required_nodes(g, cfg))
    for bad, err, match, bucket in ((cyclic, ValueError, "cycle", 128),
                                    (summed, NotImplementedError, "aggregation", 128),
                                    (g, ValueError, "bucket", need - 1)):
        for compile_genome in (cppn.compile_genome, jax_cppn.compile_genome):
            with pytest.raises(err, match=match):
                compile_genome(bad, cfg, max_nodes=bucket)


def test_pack_population_bucket_grows_in_powers_of_two():
    """The shared slot bucket is the smallest power of two (at least 8)
    that holds the largest genome; an explicit bucket is kept."""
    cfg = preset("circles")
    genomes = _mutated(cfg, 6, 60, seed=3)
    need = max(len(cppn.required_nodes(g, cfg)) for g in genomes)
    packed = cppn.pack_population(genomes, cfg)
    bucket = packed["weights"].shape[1]
    assert bucket >= max(need, 8) and bucket & (bucket - 1) == 0 and (bucket == 8 or bucket // 2 < need)
    assert packed["weights"].shape == (6, bucket, cfg.num_inputs + bucket)
    assert {k: v.shape for k, v in packed.items()} == {
        k: v.shape for k, v in jax_cppn.pack_population(genomes, cfg).items()}
    assert [cppn._bucket(n) for n in (1, 8, 9, 16, 17, 100)] == [8, 8, 16, 16, 32, 128]
    assert cppn.pack_population(genomes, cfg, 256)["weights"].shape[1] == 256
