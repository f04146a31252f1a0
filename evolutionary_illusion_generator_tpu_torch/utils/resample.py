"""LANCZOS resampling of 8-bit images, without Pillow.

The port's stand-in for Pillow's ``Image.resize(size, Image.LANCZOS)`` on
L and RGB images, which the JAX package calls in ``load_image`` and the
probe's ``pad_to_size``.  It carries the arithmetic of Pillow's
``libImaging/Resample.c`` so that the result is pixel-equal:

* a horizontal pass, then a vertical pass, each rounded to uint8;
* the filter ``sinc(x) sinc(x / 3)`` on ``[-3, 3)``, stretched by the
  scale when downsampling (support ``3 * max(scale, 1)``);
* for output pixel ``i`` the source window ``[int(center - support +
  0.5), int(center + support + 0.5))`` clipped to the image, with
  ``center = (i + 0.5) * scale``;
* the window's weights normalised to sum 1, then made 22-bit fixed point
  (rounded half away from zero);
* each sum starts at ``1 << 21``, is shifted right by 22 and clipped to
  0..255;
* an axis whose size does not change is not resampled.

The weights are computed one by one with :func:`math.sin`, in Pillow's
order, so that the normalising sum rounds as it does in C.  Host code
(numpy).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

__all__ = ["lanczos_resize"]

_SUPPORT = 3.0
_PRECISION_BITS = 22


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos(x: float) -> float:
    if -3.0 <= x < 3.0:
        return _sinc(x) * _sinc(x / 3)
    return 0.0


def _matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) fixed-point weights of one axis as float64
    integers (Pillow's ``precompute_coeffs`` + ``normalize_coeffs_8bpc``):
    row i holds output pixel i's window."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = _SUPPORT * filterscale
    ss = 1.0 / filterscale
    matrix = np.zeros((out_size, in_size), np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [_lanczos((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for w in k:
            ww += w
        for x, w in enumerate(k):
            if ww != 0.0:
                w /= ww
            fixed = w * (1 << _PRECISION_BITS)
            matrix[xx, xmin + x] = int(fixed - 0.5) if w < 0 else int(fixed + 0.5)
    return matrix


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass along ``axis`` (0 rows, 1 columns) of an (H, W, C) uint8
    image, rounded to uint8.  The weighted sums are a float64 matrix
    product, which is exact here: every product and partial sum is an
    integer of magnitude below 2**32, far inside float64's 53 bits, so no
    order of summation rounds."""
    src = np.moveaxis(img, axis, 0).astype(np.float64)
    acc = np.tensordot(_matrix(img.shape[axis], out_size), src, axes=(1, 0))
    acc = acc.astype(np.int64) + (1 << (_PRECISION_BITS - 1))
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def lanczos_resize(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Resize an (H, W) or (H, W, C) uint8 image to ``size = (width,
    height)``, as Pillow's ``Image.resize(size, Image.LANCZOS)`` does on an
    L or RGB image."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"lanczos_resize takes (H, W[, C]) uint8, got {img.shape} {img.dtype}")
    w, h = int(size[0]), int(size[1])
    if w < 1 or h < 1:
        raise ValueError(f"size must be positive, got {size}")
    if (w, h) == (img.shape[1], img.shape[0]):
        return img.copy()
    out = img[..., None] if img.ndim == 2 else img
    if w != out.shape[1]:
        out = _resample_axis(out, w, axis=1)
    if h != out.shape[0]:
        out = _resample_axis(out, h, axis=0)
    return out[..., 0] if img.ndim == 2 else out
