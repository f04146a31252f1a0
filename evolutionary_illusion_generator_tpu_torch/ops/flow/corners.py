"""Shi-Tomasi corner detection with fixed-K output (device).

The port of the JAX package's ``ops/flow/corners.py``, batched over a
leading image axis: min-eigenvalue response, local-max non-max suppression
(which also enforces the minimum corner distance), relative quality
threshold, then the K best.  ``jax.lax.top_k`` keeps the lower index first
on ties and ``torch.topk`` does not promise an order, so the K best come
from a STABLE descending sort.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .pyramid import edge_pad

__all__ = ["shi_tomasi_corners"]


def _sobel(img):
    """Sobel gradients with replicate padding; img (B, H, W) -> (Ix, Iy)."""
    p = edge_pad(img, 1)
    ix = (
        (p[:, :-2, 2:] + 2.0 * p[:, 1:-1, 2:] + p[:, 2:, 2:])
        - (p[:, :-2, :-2] + 2.0 * p[:, 1:-1, :-2] + p[:, 2:, :-2])
    ) / 8.0
    iy = (
        (p[:, 2:, :-2] + 2.0 * p[:, 2:, 1:-1] + p[:, 2:, 2:])
        - (p[:, :-2, :-2] + 2.0 * p[:, :-2, 1:-1] + p[:, :-2, 2:])
    ) / 8.0
    return ix, iy


def _box_filter(img, size: int):
    """size x size box sum via two cumulative passes (same padding)."""
    r = size // 2
    x = F.pad(img, (r, r, r, r))
    x = torch.cumsum(x, dim=1)
    x = torch.cat([x[:, size - 1 : size], x[:, size:] - x[:, :-size]], dim=1)
    x = torch.cumsum(x, dim=2)
    return torch.cat([x[:, :, size - 1 : size], x[:, :, size:] - x[:, :, :-size]], dim=2)


def shi_tomasi_corners(gray, max_corners: int = 128, quality_level: float = 0.01,
                       min_distance: int = 7, block_size: int = 3, border: int = 8):
    """Detect up to ``max_corners`` Shi-Tomasi corners per image.

    Args:
      gray: (B, H, W) float images.
    Returns:
      (positions, mask): positions (B, K, 2) float32 [x, y] pixel coords,
      mask (B, K) bool (True = real corner).
    """
    B, H, W = gray.shape
    ix, iy = _sobel(gray)
    ixx = _box_filter(ix * ix, block_size)
    iyy = _box_filter(iy * iy, block_size)
    ixy = _box_filter(ix * iy, block_size)

    # min eigenvalue of [[ixx, ixy], [ixy, iyy]]
    tr = ixx + iyy
    det_part = torch.sqrt(torch.clamp_min((ixx - iyy) ** 2 + 4.0 * ixy * ixy, 0.0))
    response = 0.5 * (tr - det_part)

    # suppress the border (LK windows must fit)
    ys = torch.arange(H, device=gray.device)[:, None]
    xs = torch.arange(W, device=gray.device)[None, :]
    in_bounds = (ys >= border) & (ys < H - border) & (xs >= border) & (xs < W - border)
    response = torch.where(in_bounds, response, -torch.inf)

    # non-max suppression doubles as the min-distance constraint; max_pool2d
    # pads with -inf like the JAX reduce_window
    nms_size = 2 * (min_distance // 2) + 1
    pooled = F.max_pool2d(response[:, None], nms_size, stride=1,
                          padding=nms_size // 2)[:, 0]
    response = torch.where(response >= pooled, response, -torch.inf)

    scores, idx = torch.sort(response.reshape(B, -1), dim=1, descending=True,
                             stable=True)
    scores, idx = scores[:, :max_corners], idx[:, :max_corners]
    positions = torch.stack([(idx % W).float(), (idx // W).float()], dim=-1)

    best = scores[:, :1]
    mask = (scores > quality_level * best) & torch.isfinite(scores) & (best > 0)
    return positions, mask
