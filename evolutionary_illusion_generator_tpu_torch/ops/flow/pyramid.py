"""Grayscale conversion and Gaussian image pyramids (device).

The port of the JAX package's ``ops/flow/pyramid.py``; functions take a
leading batch of images."""

from __future__ import annotations

import torch

__all__ = ["to_gray", "pyr_down", "build_pyramid"]

# ITU-R BT.601 luma weights (OpenCV RGB2GRAY).
_LUMA = (0.299, 0.587, 0.114)

# 5-tap binomial kernel (OpenCV pyrDown)
_PYR_K = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def to_gray(image):
    """(..., H, W, C) [0,1] float -> (..., H, W) grayscale."""
    if image.shape[-1] == 1:
        return image[..., 0]
    # on the host: CUDA ops take a CPU 0-dim tensor as a scalar, so nothing
    # is copied to the device (a copy would break a CUDA-graph capture)
    luma = torch.tensor(_LUMA, dtype=image.dtype)
    return image[..., 0] * luma[0] + image[..., 1] * luma[1] + image[..., 2] * luma[2]


def _edge_index(n: int, r: int, device):
    """Indices of an axis of length ``n`` replicate-padded by ``r``."""
    return torch.arange(-r, n + r, device=device).clamp(0, n - 1)


def edge_pad(img, r: int):
    """Replicate-pad the last two axes of ``img`` by ``r`` on every side."""
    H, W = img.shape[-2:]
    return img[..., _edge_index(H, r, img.device), :][..., _edge_index(W, r, img.device)]


def _sep_filter2(img, k):
    """Separable filter with edge-replicate padding; img (..., H, W)."""
    r = len(k) // 2
    H, W = img.shape[-2:]
    x = img[..., _edge_index(H, r, img.device), :]
    x = sum(k[i] * x[..., i : i + H, :] for i in range(len(k)))
    x = x[..., _edge_index(W, r, img.device)]
    return sum(k[i] * x[..., :, i : i + W] for i in range(len(k)))


def pyr_down(img):
    """Gaussian blur + 2x decimation; img (..., H, W)."""
    return _sep_filter2(img, _PYR_K)[..., ::2, ::2]


def build_pyramid(img, levels: int):
    """List of ``levels`` images, level 0 = full resolution."""
    pyr = [img]
    for _ in range(levels - 1):
        pyr.append(pyr_down(pyr[-1]))
    return pyr
