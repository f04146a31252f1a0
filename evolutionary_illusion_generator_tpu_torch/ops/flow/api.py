"""Flow API: the batched device extractor.

The port of the JAX package's ``ops/flow/api.py`` without the file
interface ``lucas_kanade``, which reads PNGs and waits for the port's
image I/O."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .corners import shi_tomasi_corners
from .lk import pyramid_lk
from .pyramid import to_gray

__all__ = ["FlowConfig", "flow_vectors", "batched_flow"]


@dataclass(frozen=True)
class FlowConfig:
    """Sparse-flow parameters (OpenCV-comparable defaults), field for field
    the JAX package's ``FlowConfig``."""

    max_corners: int = 128
    quality_level: float = 0.01
    min_distance: int = 7
    block_size: int = 3
    levels: int = 3
    win: int = 21
    iters: int = 12
    min_eig_threshold: float = 1e-4
    max_residual: float = 1.0
    # LK window/gather compute dtype ("float32" | "bfloat16"); the 2x2
    # solve, flow state, accumulations and the residual gate stay float32
    lk_dtype: str = "float32"


def flow_vectors(gray0, gray1, cfg: FlowConfig = FlowConfig()):
    """Corners on gray0, LK track to gray1; gray (B, H, W).

    Returns (vectors (B, K, 4) [x, y, dx, dy], mask (B, K)).
    """
    positions, mask = shi_tomasi_corners(
        gray0,
        max_corners=cfg.max_corners,
        quality_level=cfg.quality_level,
        min_distance=cfg.min_distance,
        block_size=cfg.block_size,
        border=cfg.win // 2 + 1,
    )
    flow, ok = pyramid_lk(
        gray0,
        gray1,
        positions,
        mask,
        levels=cfg.levels,
        win=cfg.win,
        iters=cfg.iters,
        min_eig_threshold=cfg.min_eig_threshold,
        max_residual=cfg.max_residual,
        dtype=getattr(torch, cfg.lk_dtype),
    )
    return torch.cat([positions, flow], dim=-1), ok


def batched_flow(frames0, frames1, cfg: FlowConfig = FlowConfig()):
    """Population flow: frames (pop, H, W, C) [0,1] -> ((pop, K, 4), (pop, K)).

    Corner detection runs on ``frames0`` (the reference detects on the first
    frame of each pair)."""
    return flow_vectors(to_gray(frames0), to_gray(frames1), cfg)
