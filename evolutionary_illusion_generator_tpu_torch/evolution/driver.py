"""Run driver: the ``neat_illusion`` entry point of the port.

The signature of the JAX package's ``neat_illusion`` (the reference's
``neat_illusion(output_dir, model_name, config_path, structure, w, h,
channels, c_dim, checkpoint, gradient)`` plus the run knobs), with
``device``.  Not ported yet, and so not accepted here: PNG artifacts
(``save_artifacts=True`` raises until the PIL-free image I/O lands),
``profile_dir``, device scoring (``score_on_device``), multi-device
(``n_devices``), the Pallas toggle ``use_pallas`` (the port's route is
fixed: its kernels on the card), ``debug_nans`` and the Chainer importer's
``chainer_half_order``.
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
    microbatch: int = 0,
    repeat: int = 20,
    extension: int = 2,
    flow: Optional[FlowConfig] = None,
    equilum: bool = False,
    pertype_count: int = 1,
    tensorboard: bool = False,
    save_artifacts: bool = True,
    quiet: bool = False,
    profile_dir: Optional[str] = None,
    device=None,
) -> Population:
    """Evolve illusions for up to ``generations`` generations on ``device``
    (``None`` = the card; ``"cpu"`` must be asked for).

    Returns the final :class:`Population` (``population.best_genome`` is the
    best-ever genome).  ``model_name`` is a native NPZ weight file; without
    one the bundled stand-in weights for ``channels`` are used, else seeded
    random weights.
    """
    if save_artifacts:
        raise NotImplementedError(
            "PNG artifacts need the port's PIL-free image I/O (ROADMAP.md, "
            "'PIL-free image I/O with artifacts'); pass save_artifacts=False"
        )
    if profile_dir is not None:
        raise NotImplementedError(
            "profile_dir is not ported yet (ROADMAP.md, 'PIL-free image I/O "
            "with artifacts, probe, CLI')"
        )
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
    params = load_or_init(model_name, list(channels), seed=seed, device=device)
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
        microbatch=microbatch,
    )
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

    pop.run(evaluator, generations)
    return pop
