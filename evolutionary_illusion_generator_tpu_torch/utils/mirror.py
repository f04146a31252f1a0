"""Image mirroring utilities.

The port of the JAX package's ``utils/mirror.py``: the reference imports
``mirror, mirror_multiple, TransformationType`` but never calls them, so
this is the working equivalent inferred from the names: single/batch
mirroring of image files along the chosen axes.  Files are read and
written as PNG by :mod:`.png`, in the input file's own mode.
"""

from __future__ import annotations

import os
from enum import IntEnum
from typing import Iterable, List

import numpy as np

from .png import read_png, write_png

__all__ = ["TransformationType", "mirror", "mirror_multiple"]


class TransformationType(IntEnum):
    HorizontalMirror = 0
    VerticalMirror = 1
    BothMirror = 2


def _transform(arr: np.ndarray, kind: TransformationType) -> np.ndarray:
    if kind == TransformationType.HorizontalMirror:
        return arr[:, ::-1]
    if kind == TransformationType.VerticalMirror:
        return arr[::-1, :]
    if kind == TransformationType.BothMirror:
        return arr[::-1, ::-1]
    raise ValueError(kind)


def mirror(
    image_path: str,
    output_dir: str,
    kind: TransformationType = TransformationType.HorizontalMirror,
) -> str:
    """Mirror one PNG file; returns the output path."""
    img, _ = read_png(image_path)
    out = _transform(img, kind)
    os.makedirs(output_dir, exist_ok=True)
    name, ext = os.path.splitext(os.path.basename(image_path))
    out_path = os.path.join(output_dir, f"{name}_mirror{ext or '.png'}")
    write_png(out_path, out)
    return out_path


def mirror_multiple(
    image_paths: Iterable[str],
    output_dir: str,
    kind: TransformationType = TransformationType.HorizontalMirror,
) -> List[str]:
    return [mirror(p, output_dir, kind) for p in image_paths]
