"""Misc image utilities from the reference's API surface.

The port of the JAX package's ``utils/misc.py``.  All three are dead code
in the reference but part of its surface.  Images are read by :mod:`.png`;
``pil_to_cv2`` is plain numpy (OpenCV's BGR channel order).
"""

from __future__ import annotations

import numpy as np

from .png import convert, read_png

__all__ = ["get_fidelity", "rgb2gray", "pil_to_cv2"]

#: The reference's rgb2gray uses a typo'd blue weight 0.144 instead of the
#: BT.601 0.114.  The correct weights are the default; pass
#: ``strict_reference=True`` for the typo'd ones.
_BT601 = np.array([0.299, 0.587, 0.114])
_REFERENCE_TYPO = np.array([0.299, 0.587, 0.144])


def rgb2gray(rgb: np.ndarray, strict_reference: bool = False) -> np.ndarray:
    weights = _REFERENCE_TYPO if strict_reference else _BT601
    return np.dot(rgb[..., :3], weights)


def _read_rgb(path: str) -> np.ndarray:
    return convert(*read_png(path), "RGB")


def get_fidelity(input_image_path: str, prediction_image_path: str) -> float:
    """1 - normalized MSE between two images."""
    a = np.array(_read_rgb(input_image_path), dtype=float)
    b = np.array(_read_rgb(prediction_image_path), dtype=float)
    err = np.sum((a - b) ** 2) / (float(a.shape[0] * a.shape[1]) * 255 * 255)
    return 1 - err


def pil_to_cv2(image, c_dim: int = 3) -> np.ndarray:
    """RGB (c_dim 3) or greyscale image -> OpenCV's BGR array."""
    image_np = np.asarray(image)
    if c_dim == 3:
        return np.ascontiguousarray(image_np[..., 2::-1])
    gray = image_np.reshape(image_np.shape[0], image_np.shape[1], 1)
    return np.repeat(gray, 3, axis=-1)
