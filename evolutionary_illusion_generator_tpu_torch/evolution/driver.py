"""Run driver: the ``neat_illusion`` entry point of the port.

The signature of the JAX package's ``neat_illusion`` (the reference's
``neat_illusion(output_dir, model_name, config_path, structure, w, h,
channels, c_dim, checkpoint, gradient)`` plus the run knobs), with
``device``.  Each generation writes the winner's artifacts
(``evolution/artifacts.py``); ``profile_dir`` takes a ``torch.profiler``
trace of generation 1; ``debug_nans=True`` runs the device pass under the
NaN sanitizer (:mod:`..utils.debug_nans`).  ``n_devices > 1`` shards the
population over a mesh of that many devices
(:class:`..parallel.ShardedGenerationEvaluator`).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Union

import torch

from .._device import resolve_device
from ..models.prednet.loader import load_or_init
from ..neat import (
    Checkpointer,
    JsonlReporter,
    NeatConfig,
    Population,
    StatisticsReporter,
    StdOutReporter,
    load_config,
    preset,
    restore_checkpoint,
)
from ..ops.flow.api import FlowConfig
from ..structure import StructureType
from ..utils.profiling import trace
from .artifacts import save_best_artifacts
from .evaluator import EvalConfig, GenerationEvaluator

__all__ = ["neat_illusion", "resolve_neat_config"]


def resolve_neat_config(config: Union[str, NeatConfig, None], structure, c_dim,
                        gradient) -> NeatConfig:
    """Config resolution with the reference's auto-selection rules:
    bands -> bands preset; circles -> circles (color gradient) or
    circles_bw; free -> free; else default."""
    if isinstance(config, NeatConfig):
        return config
    if isinstance(config, str) and config:
        if os.path.exists(config):
            return load_config(config)
        return preset(config)
    structure = StructureType(structure)
    if structure == StructureType.Bands:
        return preset("bands")
    if structure in (StructureType.Circles, StructureType.CirclesFree):
        if c_dim > 1 and gradient == 1:
            return preset("circles")
        return preset("circles_bw")
    if structure == StructureType.Free:
        return preset("free")
    return preset("default")


def neat_illusion(
    output_dir: str,
    model_name: Optional[str],
    config: Union[str, NeatConfig, None],
    structure: Union[int, StructureType],
    w: int = 160,
    h: int = 120,
    channels: Sequence[int] = (3, 48, 96, 192),
    c_dim: int = 3,
    checkpoint: Optional[str] = None,
    gradient: int = 1,
    *,
    generations: int = 100,
    seed: int = 0,
    checkpoint_every: int = 1,
    score_on_device: bool = False,
    use_pallas: Union[bool, str] = "fused",
    microbatch: int = 0,
    repeat: int = 20,
    extension: int = 2,
    flow: Optional[FlowConfig] = None,
    equilum: bool = False,
    pertype_count: int = 1,
    tensorboard: bool = False,
    save_artifacts: bool = True,
    quiet: bool = False,
    n_devices: Optional[int] = None,
    profile_dir: Optional[str] = None,
    chainer_half_order: str = "ahat-a",
    debug_nans: bool = False,
    device: Union[None, str, torch.device, Sequence] = None,
) -> Population:
    """Evolve illusions for up to ``generations`` generations on ``device``
    (``None`` = the card; ``"cpu"`` must be asked for).

    Returns the final :class:`Population` (``population.best_genome`` is the
    best-ever genome).  ``model_name`` is a native NPZ weight file or a
    Chainer ``.model`` snapshot (imported with ``chainer_half_order``);
    without one the bundled stand-in weights for ``channels`` are used, else
    seeded random weights.  ``score_on_device=True`` scores on the device
    in float32 instead of on the host in float64.

    ``use_pallas`` is the predictor's route (``EvalConfig.use_pallas``):
    ``"fused"`` (the default, the port's kernels; the JAX driver's default
    is ``False``, its TPU XLA path), ``True`` or ``False`` (no kernel).
    ``debug_nans=True`` raises ``FloatingPointError`` at the first op of
    the device pass that makes a NaN.  ``n_devices > 1`` splits each
    population chunk over a mesh of ``n_devices`` devices
    (:func:`..parallel.make_mesh`): every CUDA device, or ``device`` when it
    is a list of devices (which may repeat one, one shard per entry);
    ``make_mesh`` raises ``ValueError`` where there are fewer.
    """
    mesh = None
    if n_devices is not None and n_devices > 1:
        from ..parallel import make_mesh

        devices = device if isinstance(device, (list, tuple)) else (
            None if device is None else [device])
        mesh = make_mesh(n_devices, devices=devices)
        device = mesh.local_devices()[0] if mesh.local_devices() else None
    elif isinstance(device, (list, tuple)):
        raise ValueError("a list of devices needs n_devices > 1")
    device = resolve_device(device)
    if device.type == "cuda":
        # float32 convolutions and matmuls in full float32 (cuDNN would
        # take TF32 for convolutions by default), so the float32 paths agree
        # with the plain versions and the JAX reference
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    structure = StructureType(structure)
    os.makedirs(output_dir, exist_ok=True)
    neat_cfg = resolve_neat_config(config, structure, c_dim, gradient)
    params = load_or_init(model_name, list(channels), seed=seed,
                          half_order=chainer_half_order, device=device)
    eval_cfg = EvalConfig(
        structure=structure,
        w=w,
        h=h,
        c_dim=c_dim,
        gradient=gradient,
        repeat=repeat,
        extension=extension,
        flow=flow or FlowConfig(),
        equilum=equilum,
        pertype_count=pertype_count,
        score_on_device=score_on_device,
        use_pallas=use_pallas,
        microbatch=microbatch,
        debug_nans=debug_nans,
    )
    if mesh is not None:
        from ..parallel import ShardedGenerationEvaluator

        evaluator = ShardedGenerationEvaluator(eval_cfg, params, neat_cfg, mesh)
    else:
        evaluator = GenerationEvaluator(eval_cfg, params, neat_cfg, device=device)

    pop = restore_checkpoint(checkpoint) if checkpoint else Population(neat_cfg, seed=seed)
    if not quiet:
        pop.add_reporter(StdOutReporter(True))
    pop.add_reporter(StatisticsReporter())
    pop.add_reporter(JsonlReporter(os.path.join(output_dir, "metrics.jsonl")))
    if tensorboard:
        from ..neat.reporters import TensorBoardReporter

        pop.add_reporter(TensorBoardReporter(os.path.join(output_dir, "tensorboard")))
    ckpt = Checkpointer(checkpoint_every, directory=output_dir)
    ckpt.attach(pop)
    pop.add_reporter(ckpt)

    def eval_genomes(genome_items, cfg):
        # profile a warm generation: generation 1 (generation 0 builds)
        with trace(profile_dir if pop.generation == 1 else None):
            evaluator(genome_items, cfg)
        if save_artifacts:
            res = evaluator.last_results
            best_genome = genome_items[res["best_idx"]][1]
            # device rows are per render (pertype_count per genome); the
            # winner's best render drives the artifacts
            row = res["best_row"]
            vectors = res["vectors"][row][res["mask"][row]]
            # only the winner's image and flow frame leave the device
            save_best_artifacts(
                best_genome,
                res["outputs"].fetch("images_u8", row),
                vectors,
                res["outputs"].fetch("flow_frame0", row),
                neat_cfg,
                structure,
                c_dim,
                gradient,
                output_dir,
                device=evaluator.device,
            )

    pop.run(eval_genomes, generations)
    return pop
