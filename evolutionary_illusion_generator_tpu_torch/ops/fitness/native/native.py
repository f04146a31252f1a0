"""ctypes binding of the C++ batch fitness scorer.

The port of the JAX package's ``ops/fitness/native/native.py``, with the
same API.  ``fitness_native.cpp`` is a byte-for-byte copy of the JAX
package's.  The shared library is built on first use with ``g++ -O3
-march=native -shared -fPIC`` into the port's ``.build/`` directory
(listed in ``.gitignore``), under a directory named by a hash of the source
and the flags, so an edited source is rebuilt and nothing is written beside
the source.  Without a compiler :func:`is_available` is False.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from ...._build import BUILD_ROOT

__all__ = ["is_available", "library_path", "score_population_native"]

_SRC = Path(__file__).resolve().parent / "fitness_native.cpp"
_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    """Where the scorer's shared library is (or would be) built."""
    h = hashlib.sha256(" ".join(_FLAGS).encode() + _SRC.read_bytes()).hexdigest()[:16]
    return BUILD_ROOT / f"fitness_native-{h}" / "libfitness_native.so"


def _build(out: Path) -> bool:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *_FLAGS, "-o", str(tmp), str(_SRC)], check=True,
                       capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return True


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        out = library_path()
        if not out.exists() and not _build(out):
            return None
        try:
            lib = ctypes.CDLL(str(out))
        except OSError:
            return None
        lib.score_population.argtypes = [
            ctypes.c_int,
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_double,
            ctypes.c_double,
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        ]
        lib.score_population.restype = None
        _lib = lib
        return _lib


def is_available() -> bool:
    """Whether the scorer is built (building it now if it is not)."""
    return _load() is not None


def score_population_native(structure, vectors, mask, w, h) -> np.ndarray:
    """Score a whole population.

    Args:
      structure: StructureType/int.
      vectors: (pop, K, 4) float array of [x, y, dx, dy].
      mask: (pop, K) bool validity.
    Returns:
      (pop,) float64 scores.  Raises RuntimeError if the library is
      unavailable (callers check :func:`is_available`).
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native fitness scorer unavailable (no g++?)")
    vectors = np.ascontiguousarray(vectors, dtype=np.float64)
    mask_u8 = np.ascontiguousarray(mask, dtype=np.uint8)
    pop, K = mask_u8.shape
    if vectors.shape != (pop, K, 4):
        raise ValueError(f"vectors {vectors.shape} do not match mask {mask_u8.shape}")
    out = np.zeros(pop, dtype=np.float64)
    lib.score_population(int(structure), vectors, mask_u8, pop, K, float(w), float(h), out)
    return out
