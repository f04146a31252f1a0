"""Per-generation best-candidate artifacts.

The port of the JAX package's ``evolution/artifacts.py``, after the
reference artifact contract: ``best.png``, ``best_flow.png`` (arrow
overlay), ``best_black_bg.png`` (re-render with black background), and the
800x800 ``enhanced.png`` poster tiling.  Files are overwritten each
generation, exactly like the reference.  The re-renders run on the
evaluator's device; the files are written by the port's own PNG writer.
"""

from __future__ import annotations

import functools
import os
from typing import Optional

import numpy as np
import torch

from .._device import resolve_device
from ..models.cppn import _bucket, evaluate_population, pack_population, required_nodes
from ..neat.config import NeatConfig
from ..neat.genome import Genome
from ..ops.grids import GRID_SCALING, create_grid, enhanced_image_grid
from ..ops.render import render_images
from ..structure import StructureType
from ..utils.image_io import draw_flow_overlay, save_image

__all__ = ["render_genome", "save_best_artifacts", "ENHANCED_SIZE"]

ENHANCED_SIZE = 800

#: The CPPN slot bucket of artifact renders (the JAX package's): the
#: node-serial evaluator's tables over 128 slots, doubled for a larger genome.
_RENDER_BUCKET = 128


@functools.lru_cache(maxsize=8)
def _cached_grid(structure: StructureType, w: int, h: int):
    return create_grid(structure, w, h, GRID_SCALING)


@functools.lru_cache(maxsize=8)
def _cached_enhanced_grid(size: int, structure: StructureType):
    return enhanced_image_grid(size, size, structure)


@torch.inference_mode()
def render_genome(
    genome: Genome,
    neat_cfg: NeatConfig,
    grid: dict,
    c_dim: int,
    bg: int = 1,
    gradient: int = 1,
    device=None,
) -> np.ndarray:
    """Render a single genome on an arbitrary grid on ``device`` (``None``
    = the card); returns (h, w, c) uint8."""
    device = resolve_device(device)
    packed = pack_population([genome], neat_cfg,
                             _bucket(len(required_nodes(genome, neat_cfg)), _RENDER_BUCKET))
    prog = {k: torch.as_tensor(v).to(device) for k, v in packed.items()}
    x_mat = torch.as_tensor(grid["x_mat"], dtype=torch.float32)
    y_mat = torch.as_tensor(grid["y_mat"], dtype=torch.float32)
    flat = torch.stack([x_mat.reshape(-1), y_mat.reshape(-1)]).to(device)
    outs = evaluate_population(
        prog["weights"], prog["bias"], prog["response"], prog["act_id"],
        prog["out_slot"], flat,
    )
    img = render_images(outs, x_mat.to(device), c_dim, bg=bg, gradient=gradient)
    return img[0].cpu().numpy()


def save_best_artifacts(
    best_genome: Genome,
    best_image_u8: np.ndarray,
    best_vectors: np.ndarray,
    flow_frame0: Optional[np.ndarray],
    neat_cfg: NeatConfig,
    structure: StructureType,
    c_dim: int,
    gradient: int,
    best_dir: str,
    enhanced: bool = True,
    device=None,
) -> None:
    """Write the per-generation winner artifacts into ``best_dir``; the
    re-renders run on ``device`` (``None`` = the card)."""
    os.makedirs(best_dir, exist_ok=True)
    save_image(best_image_u8, os.path.join(best_dir, "best.png"))

    # arrow overlay on the first flow frame (the prediction frame the flow
    # ran on, as the reference overlays)
    base = flow_frame0 if flow_frame0 is not None else best_image_u8
    draw_flow_overlay(
        np.asarray(base), best_vectors, os.path.join(best_dir, "best_flow.png")
    )

    h, w = best_image_u8.shape[:2]
    grid = _cached_grid(structure, w, h)
    black = render_genome(best_genome, neat_cfg, grid, c_dim, bg=0, gradient=gradient,
                          device=device)
    save_image(black, os.path.join(best_dir, "best_black_bg.png"))

    if enhanced:
        e_grid = _cached_enhanced_grid(ENHANCED_SIZE, structure)
        poster = render_genome(best_genome, neat_cfg, e_grid, c_dim, bg=1,
                               gradient=gradient, device=device)
        save_image(poster, os.path.join(best_dir, "enhanced.png"))
