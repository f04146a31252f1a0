"""Driver entry points of the port: the flagship forward and the multi-device
dry run.

The counterpart of the repo's ``__graft_entry__.py``:

- :func:`entry` returns the flagship forward (the PredNet rollout at
  ``3,48,96,192`` on a population of eight 160x120 images) and its
  arguments, drawn from the JAX entry's seeds;
- :func:`dryrun_multichip` runs, over an ``n_devices``-entry mesh, one
  population-sharded generation step, one data-parallel train step, one
  pop x sp rollout and the ``pop256_v5e8`` composition (256 genomes in
  chunks of 64, a checkpoint each generation, a resume), and prints the
  JAX dry run's line.

Both run on the card unless the caller asks for another device.  A mesh's
entries may repeat one device (one logical shard per entry), so
``device=["cpu"] * 8`` runs the dry run on the CPU and
``device=["cuda:0"] * 8`` on one card:

    python -m evolutionary_illusion_generator_tpu_torch.graft_entry 8 --device cpu
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
from random import Random
from typing import List, Optional, Sequence, Union

import torch

from ._device import resolve_device
from .utils import prng

__all__ = ["entry", "dryrun_multichip", "composition", "DRYRUN_GEOMETRY"]

#: The dry run's cut of the ``pop256_v5e8`` composition (the JAX dry run's):
#: the preset's population, chunk and mesh at a small frame and stack.
#: ``repeat`` is 6, not 2: at 2 the rollout never settles, every flow vector
#: fails the 0.4 px plausibility gate and all 256 candidates score 0, which
#: a dead scoring path would also give.
DRYRUN_GEOMETRY = dict(w=96, h=72, repeat=6, channels=(3, 16, 32, 48))

Devices = Union[None, str, torch.device, Sequence]


def _mesh_devices(n_devices: int, device: Devices) -> Optional[list]:
    """The mesh's entries: ``None`` (every CUDA device), a list, or one
    device repeated ``n_devices`` times."""
    if device is None or isinstance(device, (list, tuple)):
        return None if device is None else list(device)
    return [device] * n_devices


def entry(device=None):
    """``(fn, example_args)``: the flagship forward on ``device`` (``None``:
    the card).

    The PredNet rollout that dominates every generation: 20 open-loop
    presentations and 2 closed-loop extension frames over a population
    batch, returning the two frames the flow stage compares.  Params and
    images are the JAX entry's draws (``PRNGKey(0)`` and ``PRNGKey(1)``).
    """
    from .models.prednet.model import init_params, rollout_flow_frames

    device = resolve_device(device)
    channels = (3, 48, 96, 192)
    params = init_params(prng.PRNGKey(0), channels, device=device)
    images = torch.from_numpy(prng.uniform(prng.PRNGKey(1), (8, 120, 160, 3))).to(device)

    @torch.inference_mode()
    def forward(params, images):
        return rollout_flow_frames(params, images, repeat=20, extension=2, pair="population")

    return forward, (params, images)


def composition(output_dir: str, n_devices: int = 8, device: Devices = None, *,
                use_pallas: Union[bool, str] = "fused", **overrides):
    """The ``pop256_v5e8`` run preset end to end: one generation of 256
    genomes in global chunks of 64 over an ``n_devices``-entry sharded
    evaluator, its checkpoint, then one generation resumed from it.

    ``overrides`` replace the preset's driver arguments (the dry run passes
    :data:`DRYRUN_GEOMETRY`).  Returns the two runs' populations; asserts
    the preset's geometry, the checkpoint and that the resume advanced one
    generation, and raises ``RuntimeError`` unless the best fitness of both
    runs is above 0.
    """
    from .configs import run_preset
    from .evolution.driver import neat_illusion

    rp = run_preset("pop256_v5e8")
    kwargs = rp.driver_kwargs()
    assert kwargs["microbatch"] == 64 and rp.n_devices == 8
    kwargs.update(overrides)
    common = dict(generations=1, seed=0, n_devices=n_devices, quiet=True, save_artifacts=False,
                  use_pallas=use_pallas, device=_mesh_devices(n_devices, device))
    pop = neat_illusion(output_dir, None, **common, **kwargs)
    assert pop.config.pop_size == 256
    ckpt = os.path.join(output_dir, "neat-checkpoint-1")
    assert os.path.exists(ckpt), os.listdir(output_dir)
    kwargs["checkpoint"] = ckpt
    pop2 = neat_illusion(output_dir, None, **common, **kwargs)
    assert pop2.generation == pop.generation + 1
    if not (pop.best_genome.fitness > 0.0 and pop2.best_genome.fitness > 0.0):
        raise RuntimeError("pop256 composition produced no fitness signal: scoring path dead "
                           "or rollout settings regressed")
    return pop, pop2


def dryrun_multichip(n_devices: int, device: Devices = None) -> str:
    """One population-sharded generation step, one data-parallel PredNet
    train step and one pop x sp rollout over an ``n_devices`` mesh at tiny
    shapes, then the ``pop256_v5e8`` composition at
    :data:`DRYRUN_GEOMETRY`.  ``device`` as in :func:`composition`
    (``None``: every CUDA device).  Prints and returns the JAX dry run's
    line."""
    from .evolution.evaluator import EvalConfig
    from .models.prednet.model import init_params
    from .models.prednet.train import adam, init_opt_state, make_train_step
    from .neat import Genome, preset
    from .ops.flow import FlowConfig
    from .parallel import ShardedGenerationEvaluator, make_mesh
    from .structure import StructureType

    devices = _mesh_devices(n_devices, device)
    mesh = make_mesh(n_devices, devices=devices)
    home = resolve_device(mesh.local_devices()[0])
    w, h = 48, 40
    channels = (1, 4, 8)
    neat_cfg = preset("circles_bw").replace(num_hidden=4)
    params = init_params(prng.PRNGKey(0), channels, device=home)

    # --- evolution generation step, population sharded over the mesh ---
    cfg = EvalConfig(structure=StructureType.Circles, w=w, h=h, c_dim=1, gradient=0,
                     flow=FlowConfig(max_corners=32, win=9, levels=2, iters=4),
                     use_pallas=False)
    evaluator = ShardedGenerationEvaluator(cfg, params, neat_cfg, mesh)
    rng = Random(0)
    genomes = [Genome.new(i, neat_cfg, rng) for i in range(2 * n_devices)]
    scores = evaluator([(g.key, g) for g in genomes])
    assert len(scores) == len(genomes)

    # --- PredNet training step, batch sharded over the mesh -----------
    tx = adam(1e-4)
    step = make_train_step(tx, mesh=mesh)
    frames = torch.from_numpy(
        prng.uniform(prng.PRNGKey(2), (n_devices, 3, h, w, channels[0]))).to(home)
    params, _, loss = step(params, init_opt_state(tx, params), frames)
    assert bool(torch.isfinite(torch.as_tensor(loss)))

    # --- 2-D (pop x spatial) sharded rollout ---------------------------
    sp_note = ""
    if n_devices >= 2 and n_devices % 2 == 0:
        from .parallel import make_mesh_2d, make_spatial_rollout

        n_pop = n_devices // 2
        roll = make_spatial_rollout(make_mesh_2d(n_pop, 2, devices=devices), repeat=3,
                                    extension=2)
        imgs = torch.from_numpy(
            prng.uniform(prng.PRNGKey(3), (n_pop, h, w, channels[0]))).to(home)
        with torch.inference_mode():
            f0, _ = roll(params, imgs)
        assert f0.shape == imgs.shape
        sp_note = f" + pop x sp rollout ({n_pop}x2) OK"

    # --- the pop256_v5e8 preset composition ----------------------------
    comp_note = ""
    if 256 % n_devices == 0 and 64 % n_devices == 0:
        with tempfile.TemporaryDirectory() as out:
            _, pop2 = composition(out, n_devices, devices, **DRYRUN_GEOMETRY)
        comp_note = (
            f" + pop256_v5e8 composition (256 genomes, chunk 64, {n_devices}-dev sharded "
            f"evaluator, per-gen checkpoint + resume, best fitness "
            f"{pop2.best_genome.fitness:.4f}) OK")

    line = (f"dryrun_multichip({n_devices}): generation step over {len(genomes)} genomes + dp "
            f"train step OK (loss={float(loss):.4f})" + sp_note + comp_note)
    print(line)
    return line


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description="The port's multi-device dry run.")
    p.add_argument("n_devices", nargs="?", type=int, default=8)
    p.add_argument("--device", default="",
                   help="put every mesh entry on this device (empty = every CUDA device)")
    args = p.parse_args(argv)
    dryrun_multichip(args.n_devices, args.device or None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
