"""The port's ``parallel/`` package on the CPU: the population-sharded
evaluator, the data-parallel train step, the spatial and pipelined
rollouts and a two-process run, each against the port's own unsharded
path and against the JAX package's ``parallel/`` on the virtual 8-device
CPU mesh of ``tests/conftest.py``; and ``EvalConfig.use_pallas``.

The port's meshes repeat the CPU device (``make_mesh(devices=["cpu"] *
8)``), one logical shard per entry, as the JAX tests' virtual devices do.
Weights are made once in numpy (seeded) and handed to both frameworks;
genomes come from a seed as in ``tests/test_sharding.py``.
"""

import copy
import json
import os
import socket
import subprocess
import sys
from dataclasses import replace
from pathlib import Path
from random import Random

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from evolutionary_illusion_generator_tpu.evolution.evaluator import (
    EvalConfig as JaxEvalConfig,
    GenerationEvaluator as JaxEvaluator,
)
from evolutionary_illusion_generator_tpu.models.prednet import train as jax_train
from evolutionary_illusion_generator_tpu.neat import Genome as JaxGenome
from evolutionary_illusion_generator_tpu.neat import preset as jax_preset
from evolutionary_illusion_generator_tpu.ops.flow import FlowConfig as JaxFlowConfig
from evolutionary_illusion_generator_tpu.parallel import (
    ShardedGenerationEvaluator as JaxShardedEvaluator,
    make_mesh as jax_make_mesh,
)
from evolutionary_illusion_generator_tpu.parallel import pipeline as jax_pipeline
from evolutionary_illusion_generator_tpu.parallel import spatial as jax_spatial
from evolutionary_illusion_generator_tpu_torch.evolution import (
    EvalConfig,
    GenerationEvaluator,
    neat_illusion,
)
from evolutionary_illusion_generator_tpu_torch.models.prednet import pretrain, train
from evolutionary_illusion_generator_tpu_torch.models.prednet.loader import (
    init_params_numpy,
    params_from_numpy,
)
from evolutionary_illusion_generator_tpu_torch.models.prednet.model import rollout_flow_frames
from evolutionary_illusion_generator_tpu_torch.neat import Genome, preset
from evolutionary_illusion_generator_tpu_torch.ops.flow import FlowConfig
from evolutionary_illusion_generator_tpu_torch.parallel import (
    ShardedGenerationEvaluator,
    initialize_distributed,
    make_mesh,
    make_mesh_2d,
    make_spatial_rollout,
    population_sharding,
    replicated_sharding,
)
from evolutionary_illusion_generator_tpu_torch.parallel.mesh import (
    replicate,
    shard_leading,
)
from evolutionary_illusion_generator_tpu_torch.parallel.pipeline import (
    make_pp_mesh,
    pipelined_rollout_flow_frames,
)
from evolutionary_illusion_generator_tpu_torch.structure import StructureType

# the suite runs in several worker processes: one torch thread each keeps
# them from oversubscribing the cores
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
W, H = 48, 40
CHANNELS = (1, 4, 8)
TINY_FLOW = dict(max_corners=32, win=9, levels=2, iters=6)
# as tests/test_torch_evaluator.py: float32 predictors on both sides, LK
# vectors that agree to ~1e-5 px, scored in float64
FITNESS_ATOL = 1e-3
# the use_pallas=False route against the JAX default (the same split convs
# and plain gate math, float32 predictor): vectors differ only by float32
# summation order (5.5e-6 px measured), the fitness by up to 3.5e-4
FALSE_ROUTE_VECTOR_ATOL = 2e-5
FALSE_ROUTE_FITNESS_ATOL = 5e-4
# port vs JAX rollouts with float32 params: float32 summation order only
# (spatial 9e-8, pipeline 7e-8 measured); bfloat16 params would add
# rounding flips of the state (~8e-4) that say nothing of the sharding
SPATIAL_JAX_ATOL = 1e-6
PIPELINE_ATOL = 2e-5  # tests/test_pipeline.py's
# the data-parallel loss against the single-device one (tests/test_sharding.py)
DP_LOSS_ATOL = 1e-4
# after one Adam step: as tests/test_torch_train.py's flip rule
PARAM_ATOL = 1e-5
FLIP_SHARE = 2e-3
CHILD_TIMEOUT_S = 120


def _genomes(n, cfg, genome_cls, seed=0):
    rng = Random(seed)
    gs = [genome_cls.new(i, cfg, rng) for i in range(n)]
    for g in gs:
        g.mutate(cfg, rng)
    return gs


def _cpu_mesh(n):
    return make_mesh(devices=["cpu"] * n)


def _eval_cfg(**kw):
    return EvalConfig(structure=StructureType.Circles, w=W, h=H, c_dim=1, gradient=0,
                      flow=FlowConfig(**TINY_FLOW), **kw)


@pytest.fixture(scope="module")
def neat_cfg():
    return preset("circles_bw").replace(num_hidden=4)


@pytest.fixture(scope="module")
def layers():
    return init_params_numpy(CHANNELS, seed=0)


# ---- mesh -----------------------------------------------------------------


def test_mesh_shapes_and_placement():
    mesh = _cpu_mesh(4)
    assert mesh.shape == {"pop": 4} and mesh.size == 4 and not mesh.spans_processes
    assert [str(d) for d in mesh.devices.flat] == ["cpu"] * 4
    assert make_mesh(2, devices=["cpu"] * 4).shape == {"pop": 2}
    with pytest.raises(ValueError, match="need 5 devices, have 4"):
        make_mesh(5, devices=["cpu"] * 4)
    assert population_sharding(mesh).spec == ("pop",)
    assert replicated_sharding(mesh).spec == ()
    x = torch.arange(8.0).reshape(8, 1)
    pieces = shard_leading(x, mesh)
    assert [p.flatten().tolist() for p in pieces] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    with pytest.raises(ValueError, match="does not divide"):
        shard_leading(torch.zeros(6), mesh)
    tree = [{"w": torch.ones(2)}]
    placed = replicate(tree, mesh)
    assert list(placed) == [torch.device("cpu")]
    assert placed[torch.device("cpu")][0]["w"] is tree[0]["w"]  # already there: no copy


# ---- the sharded evaluator ----------------------------------------------------


@pytest.mark.parametrize("s2d", [False, True])
@pytest.mark.parametrize("n", [8, 4])
def test_sharded_evaluator_matches_unsharded(n, s2d, neat_cfg, layers):
    """Images, masks and vectors equal the unsharded evaluator's bit for bit
    (the JAX test allows the vectors 1e-4; each shard here runs the same
    ops on fewer rows, and the CPU's kernels sum each row alike)."""
    params = params_from_numpy(layers, torch.bfloat16, "cpu")
    genomes = _genomes(16, neat_cfg, Genome)
    cfg = _eval_cfg(s2d_l0=s2d)
    single = GenerationEvaluator(cfg, params, neat_cfg, device="cpu")
    sharded = ShardedGenerationEvaluator(cfg, params, neat_cfg, _cpu_mesh(n))
    assert sharded._pop_min == max(8, n)
    out_s = single.evaluate_images(genomes).to_numpy()
    outputs = sharded.evaluate_images(genomes)
    out_m = outputs.to_numpy()
    assert set(out_m) == set(out_s)
    for k in out_s:
        np.testing.assert_array_equal(out_m[k], out_s[k], err_msg=k)
    # a row is fetched from its shard
    for i in (0, 5, 15):
        np.testing.assert_array_equal(outputs.fetch("images_u8", i), out_s["images_u8"][i])


@pytest.mark.parametrize("s2d", [False, True])
def test_sharded_fitness_matches_jax(s2d, layers):
    """The port's sharded evaluator on ``["cpu"] * 8`` against the JAX
    ``ShardedGenerationEvaluator`` on ``make_mesh(8)``, float32 predictor."""
    jcfg = jax_preset("circles_bw").replace(num_hidden=4)
    cfg = preset("circles_bw").replace(num_hidden=4)
    kw = dict(structure=StructureType.Circles, w=W, h=H, c_dim=1, gradient=0,
              prednet_dtype="float32", s2d_l0=s2d, score_backend="numpy")
    ref = JaxShardedEvaluator(
        JaxEvalConfig(flow=JaxFlowConfig(**TINY_FLOW), program_cache=False, **kw),
        [{k: jnp.asarray(v) for k, v in l.items()} for l in layers], jcfg, jax_make_mesh(8))
    ours = ShardedGenerationEvaluator(EvalConfig(flow=FlowConfig(**TINY_FLOW), **kw),
                                      params_from_numpy(layers, torch.float32, "cpu"), cfg,
                                      _cpu_mesh(8))
    jg = _genomes(16, jcfg, JaxGenome, seed=3)
    og = _genomes(16, cfg, Genome, seed=3)
    ref_scores = ref([(g.key, g) for g in jg])
    scores = ours([(g.key, g) for g in og])
    np.testing.assert_allclose(scores, ref_scores, atol=FITNESS_ATOL, rtol=0)
    assert [g.fitness for g in og] == list(scores)
    np.testing.assert_array_equal(ours.last_results["mask"], ref.last_results["mask"])


def test_sharded_chunk_must_divide_over_the_mesh(neat_cfg, layers):
    params = params_from_numpy(layers, torch.bfloat16, "cpu")
    ev = ShardedGenerationEvaluator(_eval_cfg(microbatch=4), params, neat_cfg, _cpu_mesh(8))
    with pytest.raises(ValueError, match="chunk 4 must divide over 8 devices"):
        ev.evaluate_images(_genomes(8, neat_cfg, Genome))


def test_driver_shards_over_a_device_list(tmp_path):
    """``neat_illusion(n_devices=2)`` builds the sharded evaluator over the
    devices it is given (the CPU twice), and its run equals the unsharded
    one; with one device it raises ``make_mesh``'s error."""
    cfg = preset("circles_bw").replace(pop_size=4, num_hidden=4, min_species_size=4,
                                       elitism=2)
    kw = dict(w=W, h=H, channels=CHANNELS, c_dim=1, gradient=0, generations=2, seed=1,
              flow=FlowConfig(**TINY_FLOW), quiet=True)
    runs = {}
    for name, extra in (("single", dict(device="cpu")),
                        ("sharded", dict(n_devices=2, device=["cpu", "cpu"]))):
        out = tmp_path / name
        neat_illusion(str(out), None, cfg, StructureType.Circles, **kw, **extra)
        with open(out / "metrics.jsonl") as f:
            runs[name] = [(r["fitness_max"], r["fitness_mean"]) for r in map(json.loads, f)]
        assert (out / "best.png").exists()
    assert runs["sharded"] == runs["single"]
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        neat_illusion(str(tmp_path / "one"), None, cfg, StructureType.Circles, n_devices=2,
                      device="cpu", **kw)


# ---- the data-parallel train step ---------------------------------------------

B_TRAIN, T_TRAIN, HW_TRAIN = 8, 5, 16


def _train_inputs():
    rng = np.random.default_rng(4)
    frames = rng.uniform(0, 1, (B_TRAIN, T_TRAIN, HW_TRAIN, HW_TRAIN, 3)).astype(np.float32)
    closed = np.array([1, 0, 0.75, 1, 0, 1, 1, 0.5], np.float32)
    open_ = np.ones((B_TRAIN, 3), np.float32)
    open_[1, :2] = 0.0
    open_[5, :3] = 0.0
    cue = np.array([1, 0, 1, 0, 0, 1, 1, 0], np.float32)
    return frames, {"closed": closed, "open": open_, "cue": cue}


# step kind -> (make_train_step kwargs, extra step arguments)
DP_KINDS = {
    "open_loop": (dict(), ()),
    "closed": (dict(t_open=3, closed_weight=5.0, edge_weight=0.3), ()),
    "masked": (dict(t_open=3, closed_weight=5.0, masked_closed=True, motion_weight=0.5),
               ("closed",)),
    "all_masks": (dict(t_open=3, closed_weight=5.0, masked_closed=True, motion_weight=0.5,
                       masked_open=True, cue_motion_weight=0.25), ("closed", "open", "cue")),
}


def _flip_rule(got, want, lr):
    for l, (g, w) in enumerate(zip(got, want)):
        for k in w:
            gk, wk = g[k].float().numpy(), w[k].float().numpy()
            gap = np.abs(gk - wk)
            assert (gap > PARAM_ATOL).mean() <= FLIP_SHARE, (l, k)
            assert (gap <= 2 * lr + 2**-7 * np.abs(wk)).all(), (l, k, gap.max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", sorted(DP_KINDS))
def test_dp_step_matches_single_device(kind, dtype):
    """One data-parallel Adam step on ``["cpu"] * 4`` against the unsharded
    step: the loss (each shard's part normalised by the whole batch's
    sums, masks included) and the params after the step."""
    kw, extra = DP_KINDS[kind]
    frames, masks = _train_inputs()
    params = params_from_numpy(init_params_numpy((3, 4, 8), seed=1), getattr(torch, dtype),
                               "cpu")
    tx = train.adam(2e-3)
    args = [torch.from_numpy(frames)] + [torch.from_numpy(masks[n]) for n in extra]
    p1, o1, l1 = train.make_train_step(tx, **kw)(params, train.init_opt_state(tx, params), *args)
    pd, od, ld = train.make_train_step(tx, mesh=_cpu_mesh(4), **kw)(
        params, train.init_opt_state(tx, params), *args)
    np.testing.assert_allclose(ld.item(), l1.item(), rtol=1e-6)
    assert int(od["count"]) == 1
    _flip_rule(pd, p1, 2e-3)
    assert all(v.dtype == getattr(torch, dtype) for layer in pd for k, v in layer.items()
               if not k.startswith("lstm_k_"))


def test_dp_loss_matches_jax_and_the_single_device_loss():
    """As ``tests/test_sharding.py``: the data-parallel step's loss equals
    the single-device loss within 1e-4, and the JAX data-parallel step's."""
    layers = init_params_numpy(CHANNELS, seed=0)
    frames = np.random.default_rng(1).uniform(0, 1, (8, 3, H, W, 1)).astype(np.float32)
    params = params_from_numpy(layers, torch.float32, "cpu")
    single = train.prednet_loss(params, torch.from_numpy(frames)).item()
    tx = train.adam(1e-4)
    _, _, loss_dp = train.make_train_step(tx, mesh=_cpu_mesh(8))(
        params, train.init_opt_state(tx, params), torch.from_numpy(frames))
    assert abs(single - loss_dp.item()) < DP_LOSS_ATOL
    jp = [{k: jnp.asarray(v) for k, v in l.items()} for l in layers]
    jtx = optax.adam(1e-4)
    _, _, jloss = jax_train.make_train_step(jtx, mesh=jax_make_mesh(8))(
        jp, jax_train.init_opt_state(jtx, jp), jnp.asarray(frames))
    np.testing.assert_allclose(loss_dp.item(), float(jloss), rtol=1e-5)


def test_pretrain_on_a_mesh_matches_one_device():
    kw = dict(steps=2, batch=4, T=3, h=16, w=16, seed=0, verbose=False, log_every=1)
    p1, l1 = pretrain.pretrain((1, 4, 8), device="cpu", **kw)
    pm, lm = pretrain.pretrain((1, 4, 8), mesh=_cpu_mesh(2), **kw)
    np.testing.assert_allclose(lm, l1, rtol=1e-6)
    _flip_rule(pm, p1, 2e-3 * 2)


# ---- the spatial rollout ------------------------------------------------------


def _spatial_inputs(dtype):
    params = params_from_numpy(init_params_numpy(CHANNELS, seed=0), dtype, "cpu")
    imgs = torch.from_numpy(np.random.default_rng(1).uniform(0, 1, (4, 64, 64, 1))
                            .astype(np.float32))
    return params, imgs


@pytest.mark.parametrize("pop_sp", [(2, 4), (1, 8), (4, 2)])
def test_spatial_rollout_matches_unsharded(pop_sp):
    """Bit-equal to the unsharded plain rollout of each pop entry's batch:
    a band's convs sum each output pixel's taps in the unsharded conv's
    order.  Where an entry holds two images or more that is the whole
    batch's rollout too; (4, 2) leaves one image per entry, and the CPU's
    conv sums a batch of one in another order (the unsharded rollout of one
    image differs from its row of a batch of four by 1.2e-5 in bfloat16),
    so there it is held against the per-entry rollouts only."""
    n_pop, n_sp = pop_sp
    params, imgs = _spatial_inputs(torch.bfloat16)
    a, b = make_spatial_rollout(make_mesh_2d(n_pop, n_sp, devices=["cpu"] * 8), repeat=5,
                                extension=2)(params, imgs)
    bp = imgs.shape[0] // n_pop
    per = [rollout_flow_frames(params, imgs[p * bp:(p + 1) * bp], repeat=5, extension=2,
                               use_pallas=False) for p in range(n_pop)]
    assert torch.equal(a, torch.cat([f[0] for f in per]))
    assert torch.equal(b, torch.cat([f[1] for f in per]))
    if bp > 1:
        a0, b0 = rollout_flow_frames(params, imgs, repeat=5, extension=2, use_pallas=False)
        assert torch.equal(a, a0) and torch.equal(b, b0)


@pytest.mark.parametrize("s2d", [False, True])
@pytest.mark.parametrize("pop_sp", [(2, 4), (1, 8)])
def test_spatial_rollout_matches_jax(pop_sp, s2d):
    """Against JAX ``make_spatial_rollout`` on the virtual mesh, float32
    params; under ``s2d_l0`` also against the port's unsharded s2d rollout
    (bit-equal) and its plain rollout (accumulation order only, 1e-6 as in
    ``tests/test_spatial.py``)."""
    n_pop, n_sp = pop_sp
    layers = init_params_numpy(CHANNELS, seed=0)
    params, imgs = _spatial_inputs(torch.float32)
    a, b = make_spatial_rollout(make_mesh_2d(n_pop, n_sp, devices=["cpu"] * 8), repeat=5,
                                extension=2, s2d_l0=s2d)(params, imgs)
    jmesh = jax_spatial.make_mesh_2d(n_pop, n_sp)
    ja, jb = jax_spatial.make_spatial_rollout(jmesh, repeat=5, extension=2, s2d_l0=s2d,
                                              compute_dtype=jnp.float32)(
        [{k: jnp.asarray(v) for k, v in l.items()} for l in layers],
        jax.device_put(jnp.asarray(imgs.numpy()), NamedSharding(jmesh, P("pop", "sp"))))
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), atol=SPATIAL_JAX_ATOL, rtol=0)
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), atol=SPATIAL_JAX_ATOL, rtol=0)
    if s2d:
        a_s2d, b_s2d = rollout_flow_frames(params, imgs, repeat=5, extension=2,
                                           use_pallas=False, s2d_l0=True)
        assert torch.equal(a, a_s2d) and torch.equal(b, b_s2d)
        a0, b0 = rollout_flow_frames(params, imgs, repeat=5, extension=2, use_pallas=False)
        np.testing.assert_allclose(a.numpy(), a0.numpy(), atol=1e-6, rtol=0)
        np.testing.assert_allclose(b.numpy(), b0.numpy(), atol=1e-6, rtol=0)


def test_spatial_probe_pair_and_guards():
    params, imgs = _spatial_inputs(torch.bfloat16)
    mesh = make_mesh_2d(2, 2, devices=["cpu"] * 4)
    f0, f1 = make_spatial_rollout(mesh, repeat=3, extension=2, pair="probe")(params, imgs)
    r0, r1 = rollout_flow_frames(params, imgs, repeat=3, extension=2, pair="probe",
                                 use_pallas=False)
    assert torch.equal(f0, r0) and torch.equal(f1, r1)
    with pytest.raises(ValueError, match="split into 2 bands"):
        make_spatial_rollout(mesh, repeat=2, extension=1)(params, imgs[:, :60])
    with pytest.raises(ValueError, match="unknown pair"):
        make_spatial_rollout(mesh, pair="other")
    assert make_mesh_2d(2, 4, devices=["cpu"] * 8).shape == {"pop": 2, "sp": 4}
    with pytest.raises(ValueError, match="need 16 devices"):
        make_mesh_2d(4, 4, devices=["cpu"] * 8)


# ---- the pipelined rollout ------------------------------------------------------


def _pipeline_inputs(channels, B, hw, dtype=torch.float32, seed=0):
    layers = init_params_numpy(channels, seed=seed)
    imgs = np.random.default_rng(seed + 1).uniform(0, 1, (B, *hw, channels[0])).astype(
        np.float32)
    return layers, params_from_numpy(layers, dtype, "cpu"), imgs


def _hold_pipeline(layers, params, imgs, n_stages, n_micro, pair, repeat):
    f0p, f1p = pipelined_rollout_flow_frames(
        params, torch.from_numpy(imgs), make_pp_mesh(n_stages, devices=["cpu"] * n_stages),
        repeat=repeat, extension=2, pair=pair, n_micro=n_micro)
    f0, f1 = rollout_flow_frames(params, torch.from_numpy(imgs), repeat=repeat, extension=2,
                                 pair=pair, use_pallas=False)
    np.testing.assert_allclose(f0p.numpy(), f0.numpy(), atol=PIPELINE_ATOL, rtol=0)
    np.testing.assert_allclose(f1p.numpy(), f1.numpy(), atol=PIPELINE_ATOL, rtol=0)
    j0, j1 = jax_pipeline.pipelined_rollout_flow_frames(
        [{k: jnp.asarray(v) for k, v in l.items()} for l in layers], jnp.asarray(imgs),
        jax_pipeline.make_pp_mesh(n_stages), repeat=repeat, extension=2, pair=pair,
        n_micro=n_micro)
    np.testing.assert_allclose(f0p.numpy(), np.asarray(j0), atol=PIPELINE_ATOL, rtol=0)
    np.testing.assert_allclose(f1p.numpy(), np.asarray(j1), atol=PIPELINE_ATOL, rtol=0)


@pytest.mark.parametrize("pair", ["population", "probe"])
def test_pipelined_matches_unpipelined_and_jax(pair):
    layers, params, imgs = _pipeline_inputs(CHANNELS, 8, (48, 40))
    _hold_pipeline(layers, params, imgs, 3, 4, pair, 5)


def test_pipelined_minimum_microbatches_and_four_stages():
    """``n_micro = L`` (the least that fills the wavefront), and the
    four-stage colour stack."""
    layers, params, imgs = _pipeline_inputs(CHANNELS, 6, (48, 40), seed=2)
    _hold_pipeline(layers, params, imgs, 3, 3, "population", 4)
    layers, params, imgs = _pipeline_inputs((3, 4, 8, 8), 4, (32, 32), seed=3)
    _hold_pipeline(layers, params, imgs, 4, 4, "population", 3)


def test_pipelined_bfloat16_equals_unpipelined():
    """bfloat16 params: every stage runs the unpipelined step's ops on its
    microbatch, so the frames are equal bit for bit."""
    _, params, imgs = _pipeline_inputs(CHANNELS, 8, (48, 40), dtype=torch.bfloat16)
    f0p, f1p = pipelined_rollout_flow_frames(
        params, torch.from_numpy(imgs), make_pp_mesh(3, devices=["cpu"] * 3), repeat=5,
        extension=2, n_micro=4)
    f0, f1 = rollout_flow_frames(params, torch.from_numpy(imgs), repeat=5, extension=2,
                                 use_pallas=False)
    assert torch.equal(f0p, f0) and torch.equal(f1p, f1)


def test_pipeline_guards():
    """The JAX module's guards and messages."""
    _, params, imgs = _pipeline_inputs(CHANNELS, 8, (48, 40))
    imgs = torch.from_numpy(imgs)
    mesh = make_pp_mesh(3, devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="n_micro"):
        pipelined_rollout_flow_frames(params, imgs, mesh, n_micro=2)
    with pytest.raises(ValueError, match="not divisible"):
        pipelined_rollout_flow_frames(params, imgs, mesh, n_micro=5)
    with pytest.raises(ValueError, match="pp"):
        pipelined_rollout_flow_frames(params, imgs, make_pp_mesh(2, devices=["cpu"] * 2),
                                      n_micro=4)
    with pytest.raises(ValueError, match="does not halve"):
        pipelined_rollout_flow_frames(params, imgs[:, :46], mesh, n_micro=4)
    peep = [dict(p, w_ci=torch.zeros(p["ahat_w"].shape[0])) for p in params]
    with pytest.raises(NotImplementedError, match="peephole"):
        pipelined_rollout_flow_frames(peep, imgs, mesh, n_micro=4)
    with pytest.raises(ValueError, match="need 4 devices"):
        make_pp_mesh(4, devices=["cpu"] * 3)


# ---- multi-process ---------------------------------------------------------


def test_initialize_distributed_is_a_no_op_when_unset(monkeypatch):
    for name in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    assert initialize_distributed() is False
    with pytest.raises(ValueError, match="num_processes"):
        initialize_distributed("localhost:1")


_CHILD = """
import json, sys
from random import Random
sys.path.insert(0, {repo!r})
import numpy as np, torch
import torch.distributed as dist
torch.set_num_threads(1)
from evolutionary_illusion_generator_tpu_torch.evolution import EvalConfig
from evolutionary_illusion_generator_tpu_torch.models.prednet.loader import (
    init_params_numpy, params_from_numpy)
from evolutionary_illusion_generator_tpu_torch.neat import Genome, preset
from evolutionary_illusion_generator_tpu_torch.ops.flow import FlowConfig
from evolutionary_illusion_generator_tpu_torch.parallel import (
    ShardedGenerationEvaluator, initialize_distributed, make_mesh)
from evolutionary_illusion_generator_tpu_torch.structure import StructureType

assert initialize_distributed()  # from the JAX_* environment
mesh = make_mesh(devices=["cpu"])
cfg = preset("circles_bw").replace(num_hidden=4)
rng = Random(0)
genomes = [Genome.new(i, cfg, rng) for i in range(16)]
for g in genomes:
    g.mutate(cfg, rng)
ev = ShardedGenerationEvaluator(
    EvalConfig(structure=StructureType.Circles, w=48, h=40, c_dim=1, gradient=0,
               flow=FlowConfig(max_corners=32, win=9, levels=2, iters=6),
               score_backend="numpy"),
    params_from_numpy(init_params_numpy((1, 4, 8), seed=0), torch.bfloat16, "cpu"), cfg, mesh)
scores = ev([(g.key, g) for g in genomes])
rows = {{i: ev.last_results["outputs"].fetch("images_u8", i).tolist() for i in (1, 12)}}
print(json.dumps({{"rank": dist.get_rank(), "processes": mesh.processes.tolist(),
                  "scores": scores.tolist(), "rows": rows}}))
dist.destroy_process_group()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_two_processes(code, timeout=CHILD_TIMEOUT_S, env=None):
    """``python -c code`` as ranks 0 and 1 of a ``gloo`` group on this
    host (the JAX_* environment of :func:`initialize_distributed`); each
    child must print one JSON object as its last line, and fails the
    caller (never hangs it) when it exits non-zero or outlives
    ``timeout`` seconds.  Returns the two objects in rank order."""
    port = _free_port()
    procs = []
    for rank in range(2):
        child_env = dict(os.environ, JAX_COORDINATOR_ADDRESS=f"localhost:{port}",
                         JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(rank), **(env or {}))
        procs.append(subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True, env=child_env,
                                      cwd=str(REPO)))
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, err
            results.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            p.kill()
            p.wait()
    return results


def test_two_processes_assign_the_single_process_fitness(neat_cfg, layers):
    """Two ``gloo`` processes, each holding one entry of a two-entry CPU
    mesh, evaluate half the population each; both assign the fitness of
    the single-process evaluator, and each fetches the winner-style rows
    of the other rank's shard."""
    results = run_two_processes(_CHILD.format(repo=str(REPO)))

    params = params_from_numpy(layers, torch.bfloat16, "cpu")
    genomes = _genomes(16, neat_cfg, Genome)
    single = GenerationEvaluator(_eval_cfg(score_backend="numpy"), params, neat_cfg,
                                 device="cpu")
    want = single([(g.key, g) for g in genomes])
    images = single.last_results["outputs"].to_numpy()["images_u8"]
    assert sorted(r["rank"] for r in results) == [0, 1]
    for r in results:
        assert r["processes"] == [0, 1]
        np.testing.assert_array_equal(r["scores"], want)
        for i, row in r["rows"].items():  # row 1 is rank 0's, row 12 rank 1's
            np.testing.assert_array_equal(np.array(row, np.uint8), images[int(i)])


# ---- EvalConfig.use_pallas --------------------------------------------------------


def _route_setup(channels, c_dim):
    layers = init_params_numpy(channels, seed=3)
    jcfg = jax_preset("circles" if c_dim == 3 else "circles_bw").replace(
        pop_size=8, num_hidden=4, num_outputs=c_dim)
    from evolutionary_illusion_generator_tpu.neat import Population as JaxPopulation

    items = list(JaxPopulation(jcfg, seed=5).population.items())
    kw = dict(structure=StructureType.Free, w=64, h=48, c_dim=c_dim, gradient=1, repeat=5,
              extension=2, prednet_dtype="float32", score_backend="numpy")
    ref = JaxEvaluator(JaxEvalConfig(flow=JaxFlowConfig(**TINY_FLOW), program_cache=False,
                                     **kw),
                       [{k: jnp.asarray(v) for k, v in l.items()} for l in layers], jcfg)
    ref_scores = ref(copy.deepcopy(items))
    return layers, jcfg, items, kw, ref, ref_scores


@pytest.mark.parametrize("route", [False, True, "fused"])
def test_use_pallas_routes_match_the_jax_default(route):
    """``use_pallas=False`` is the JAX default route's math (split convs,
    plain gate math), held tighter than FITNESS_ATOL; ``True`` (the gate
    math widened to float32, equal here with a float32 predictor) and
    ``"fused"`` (layer 2 of 32 channels on the fused kernel's plain
    version: bfloat16 sources) at FITNESS_ATOL."""
    layers, jcfg, items, kw, ref, ref_scores = _route_setup((3, 8, 32), 3)
    ev = GenerationEvaluator(EvalConfig(flow=FlowConfig(**TINY_FLOW), use_pallas=route, **kw),
                             params_from_numpy(layers, torch.float32, "cpu"), jcfg,
                             device="cpu")
    scores = ev(copy.deepcopy(items))
    atol = FITNESS_ATOL if route == "fused" else FALSE_ROUTE_FITNESS_ATOL
    np.testing.assert_allclose(scores, ref_scores, atol=atol, rtol=0)
    if route is False:
        out, ref_out = ev.last_results, ref.last_results
        np.testing.assert_array_equal(out["mask"], ref_out["mask"])
        m = out["mask"]
        np.testing.assert_allclose(out["vectors"][m], ref_out["vectors"][m],
                                   atol=FALSE_ROUTE_VECTOR_ATOL, rtol=0)


def test_use_pallas_default_and_values():
    assert EvalConfig().use_pallas == "fused"
    assert JaxEvalConfig().use_pallas is False  # the one deliberate difference
    ev = GenerationEvaluator(_eval_cfg(use_pallas="other"),
                             params_from_numpy(init_params_numpy(CHANNELS), torch.float32,
                                               "cpu"),
                             preset("circles_bw").replace(num_hidden=4), device="cpu")
    with pytest.raises(ValueError, match="use_pallas must be"):
        ev.evaluate_images(_genomes(2, preset("circles_bw").replace(num_hidden=4), Genome))


@pytest.mark.parametrize("route", [False, True, "fused"])
def test_driver_passes_use_pallas(route, monkeypatch, tmp_path):
    from evolutionary_illusion_generator_tpu_torch.evolution import driver

    seen = []

    class Recording(GenerationEvaluator):
        def __init__(self, cfg, *a, **kw):
            seen.append(cfg.use_pallas)
            super().__init__(cfg, *a, **kw)

    monkeypatch.setattr(driver, "GenerationEvaluator", Recording)
    cfg = preset("circles_bw").replace(pop_size=4, num_hidden=4, min_species_size=4)
    neat_illusion(str(tmp_path), None, cfg, StructureType.Circles, w=W, h=H, channels=CHANNELS,
                  c_dim=1, gradient=0, generations=1, flow=FlowConfig(**TINY_FLOW),
                  quiet=True, save_artifacts=False, use_pallas=route, device="cpu")
    assert seen == [route]
