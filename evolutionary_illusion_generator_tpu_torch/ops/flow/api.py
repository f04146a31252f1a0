"""Flow API: the batched device extractor and the reference's file
interface.

The port of the JAX package's ``ops/flow/api.py``.  ``batched_flow`` is the
device path: (pop, H, W, C) frame pairs in, fixed-K masked vector tensors
out.  ``lucas_kanade`` keeps the call shape of the reference's flow
submodule: two PNG paths in, ``{"vectors": [[x, y, dx, dy], ...]}`` out,
with an optional arrow overlay.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..._device import resolve_device
from .corners import shi_tomasi_corners
from .lk import pyramid_lk
from .pyramid import to_gray

__all__ = ["FlowConfig", "flow_vectors", "batched_flow", "lucas_kanade"]


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


def lucas_kanade(
    image0_path: str,
    image1_path: str,
    output_dir: str = ".",
    save: bool = False,
    verbose: int = 0,
    save_name: Optional[str] = None,
    cfg: FlowConfig = FlowConfig(),
    *,
    device=None,
):
    """The reference's file interface: corners on the first PNG, tracked
    into the second, on ``device`` (``None`` = the card).

    Returns ``{"vectors": [[x, y, dx, dy], ...]}``: an empty list when
    nothing was trackable, which callers replace with the reference's
    ``[[0, 0, -1000, 0]]`` sentinel.  ``save=True`` with a ``save_name``
    writes the arrow overlay there; ``output_dir`` is accepted for
    signature parity, as in the JAX function.
    """
    from ...utils.image_io import draw_flow_overlay, load_image

    device = resolve_device(device)
    img0 = load_image(image0_path, c_dim=3)
    img1 = load_image(image1_path, c_dim=3)
    gray0, gray1 = (to_gray(torch.from_numpy(im).to(device))[None] for im in (img0, img1))
    vectors, mask = flow_vectors(gray0, gray1, cfg)
    vectors = vectors[0][mask[0]].cpu().numpy()
    if verbose:
        print(f"lucas_kanade: {len(vectors)} vectors")
    if save and save_name:
        draw_flow_overlay(img0, vectors, save_name)
    return {"vectors": vectors.tolist()}
