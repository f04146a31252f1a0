"""Host image IO and flow-overlay rendering, without Pillow.

The port of the JAX package's ``utils/image_io.py``: candidate and best
PNGs and the arrow overlay the flow stage saves.  Files go through
:mod:`.png`; the overlay's rasterizer draws what Pillow's
``ImageDraw.line(width=1)`` and ``ImageDraw.ellipse`` draw, pixel for
pixel, for the JAX function's calls; ``load_image``'s resize is
Pillow's LANCZOS, pixel for pixel (:mod:`.resample`).
"""

from __future__ import annotations

import os
from typing import Iterable, Optional

import numpy as np

from .png import convert, read_png, write_png
from .resample import lanczos_resize

__all__ = ["load_image", "save_image", "draw_flow_overlay"]


def load_image(path: str, size: Optional[tuple] = None, c_dim: int = 3) -> np.ndarray:
    """Load a PNG as (H, W, C) float32 in [0, 1], converted to RGB
    (``c_dim=3``) or L, then LANCZOS-resized to ``size = (width, height)``
    when given (:func:`.resample.lanczos_resize`, Pillow's arithmetic)."""
    img, mode = read_png(path)
    img = convert(img, mode, "RGB" if c_dim == 3 else "L")
    if size is not None:
        img = lanczos_resize(img, size)
    arr = img.astype(np.float32) / 255.0
    if c_dim == 1:
        arr = arr[..., None]
    return arr


def _to_u8(arr: np.ndarray) -> np.ndarray:
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255.0).astype(np.uint8)
    return arr


def save_image(array: np.ndarray, path: str) -> None:
    """Save (H, W, C) uint8 or [0,1] float array as PNG."""
    arr = _to_u8(np.asarray(array))
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    if not (arr.ndim == 2 or (arr.ndim == 3 and arr.shape[-1] == 3)):
        raise ValueError(f"save_image writes L or RGB, got shape {arr.shape}")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    write_png(path, arr)


def _line(x0: int, y0: int, x1: int, y1: int):
    """The pixels of Pillow's one-pixel line between integer end points:
    Bresenham along the major axis, both ends included, the minor axis
    stepping when the error reaches 0 (so in closed form
    ``floor((2 d_minor i + d_major) / (2 d_major))`` steps by pixel i)."""
    dx, dy = abs(x1 - x0), abs(y1 - y0)
    sx, sy = (1 if x1 >= x0 else -1), (1 if y1 >= y0 else -1)
    major, minor = (dx, dy) if dx > dy else (dy, dx)
    i = np.arange(major + 1)
    steps = (2 * minor * i + major) // (2 * major) if major else i
    if dx > dy:
        return x0 + sx * i, y0 + sy * steps
    return x0 + sx * steps, y0 + sy * i


def _dot(x: float, y: float):
    """The pixels of Pillow's filled ellipse in the box (x-1, y-1, x+1, y+1).

    Pillow truncates the box's corners toward zero and fills inclusive
    integer boxes; a point's box is then 2 or 3 pixels on a side, which the
    ellipse fills whole, except the 3x3 box, where it leaves the corners."""
    x0, y0, x1, y1 = int(x - 1), int(y - 1), int(x + 1), int(y + 1)
    xx, yy = np.meshgrid(np.arange(x0, x1 + 1), np.arange(y0, y1 + 1))
    keep = np.ones(xx.shape, bool)
    if x1 - x0 == 2 and y1 - y0 == 2:
        keep[::2, ::2] = False  # the four corners
    return xx[keep], yy[keep]


def draw_flow_overlay(
    image: np.ndarray,
    vectors: Iterable,
    path: Optional[str] = None,
    scale: float = 10.0,
    color=(255, 0, 0),
) -> np.ndarray:
    """Render flow vectors as arrows over an image.

    ``vectors`` rows are [x, y, dx, dy]; displacements are magnified by
    ``scale`` for visibility.  Each vector is a line from (x, y) to its
    magnified end and a dot at (x, y), clipped to the image.
    """
    arr = _to_u8(np.asarray(image))
    if arr.ndim == 2 or (arr.ndim == 3 and arr.shape[-1] == 1):
        arr = np.repeat(arr.reshape(arr.shape[0], arr.shape[1], 1), 3, axis=-1)
    out = np.array(arr, copy=True)
    h, w = out.shape[:2]
    for v in vectors:
        x, y, dx, dy = float(v[0]), float(v[1]), float(v[2]), float(v[3])
        x1, y1 = x + dx * scale, y + dy * scale
        for px, py in (_line(int(x), int(y), int(x1), int(y1)), _dot(x, y)):
            inside = (px >= 0) & (px < w) & (py >= 0) & (py < h)
            out[py[inside], px[inside]] = color
    if path is not None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        write_png(path, out)
    return out
