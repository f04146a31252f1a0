"""Counter-based random numbers that reproduce the JAX package's draws.

The part of ``jax.random`` that the PredNet trainer uses, on the host in
numpy: ``PRNGKey``, ``split``, ``fold_in``, ``uniform``, ``normal`` and
``choice(p=)``.  The generator is threefry2x32 in the mode JAX runs by
default (``jax_threefry_partitionable``): the bits of element ``i`` of a
draw are ``threefry2x32(key, (hi(i), lo(i)))``, the two output words
XORed.  The same seed then gives the port the same keys, the same
synthetic frames and the same initial weights as the JAX package, and a
checkpoint's key resumes the same data stream in either package.

Keys are explicit values, as in JAX: uint32 arrays of shape ``(..., 2)``.
Every function takes a stack of keys with any leading shape and draws for
each key, so a batch of sequences draws its per-sequence scalars in one
call.  The 32-bit arithmetic is numpy's uint32, which wraps.

``split``, ``fold_in``, ``uniform`` and ``choice`` are bit-equal to
``jax.random``.  ``normal`` goes through ``erfinv``: this module evaluates
the polynomial XLA uses (Giles' single-precision approximation, its
Horner steps fused as XLA's CPU compiler fuses them), but ``log1p`` is
numpy's, so a draw can differ from JAX's in its last bits
(``tests/test_torch_prng.py`` holds it to a few float32 ulps).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np

__all__ = ["PRNGKey", "split", "fold_in", "random_bits", "uniform", "normal", "choice",
           "fma32"]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)

Shape = Union[int, Sequence[int]]


def _u32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.uint32)


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(k1, k2, x1, x2) -> Tuple[np.ndarray, np.ndarray]:
    """The threefry2x32 block function, 20 rounds, on broadcast uint32
    arrays (JAX's ``_threefry2x32_lowering``)."""
    k1, k2 = _u32(k1), _u32(k2)
    shape = np.broadcast_shapes(k1.shape, k2.shape, np.shape(x1), np.shape(x2))
    ks = [np.broadcast_to(k, shape).astype(np.uint32).reshape(-1)
          for k in (k1, k2)]
    ks.append(ks[0] ^ ks[1] ^ _PARITY)
    x = [np.broadcast_to(_u32(v), shape).reshape(-1) + ks[i] for i, v in enumerate((x1, x2))]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r)
            x[1] = x[0] ^ x[1]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0].reshape(shape), x[1].reshape(shape)


def PRNGKey(seed: int) -> np.ndarray:
    """The key of an integer seed: ``[seed >> 32, seed & 0xFFFFFFFF]``."""
    seed = int(seed)
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], dtype=np.uint32)


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if np.ndim(shape) == 0 else tuple(int(s) for s in shape)


def _counts(shape: Tuple[int, ...]):
    """JAX's ``iota_2x32_shape``: the flat index of each element as (hi, lo)."""
    n = math.prod(shape)
    idx = np.arange(n, dtype=np.uint64).reshape(shape)
    return (idx >> np.uint64(32)).astype(np.uint32), (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def _bits_pair(key, shape: Tuple[int, ...]):
    key = _u32(key)
    lead = key.shape[:-1]
    hi, lo = _counts(shape)
    k1 = key[..., 0].reshape(lead + (1,) * len(shape))
    k2 = key[..., 1].reshape(lead + (1,) * len(shape))
    return threefry2x32(k1, k2, hi, lo)


def split(key, num: int = 2) -> np.ndarray:
    """``num`` new keys from each key: shape ``(..., num, 2)``."""
    b1, b2 = _bits_pair(key, (int(num),))
    return np.stack([b1, b2], axis=-1)


def fold_in(key, data: int) -> np.ndarray:
    """A key derived from ``key`` and the integer ``data`` (as uint32)."""
    key = _u32(key)
    d = np.uint32(int(data) & 0xFFFFFFFF)
    b1, b2 = threefry2x32(key[..., 0], key[..., 1], np.uint32(0), d)
    return np.stack([b1, b2], axis=-1)


def random_bits(key, shape: Shape = ()) -> np.ndarray:
    """32 random bits per element: shape ``(..., *shape)`` uint32."""
    b1, b2 = _bits_pair(key, _shape(shape))
    return b1 ^ b2


def fma32(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """float32 ``a * b + c`` rounded once (the product of two float32
    values is exact in float64)."""
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(np.float32)


def uniform(key, shape: Shape = (), minval=0.0, maxval=1.0) -> np.ndarray:
    """float32 draws in ``[minval, maxval)``: 23 random mantissa bits under
    the exponent of 1.0, minus 1, scaled, and floored at ``minval``, all in
    float32 as JAX does (the scale and shift one fused multiply-add, as
    XLA's CPU compiler contracts them).  ``minval`` / ``maxval`` broadcast
    against the draw's trailing ``shape`` (numbers or arrays)."""
    shape = _shape(shape)
    bits = random_bits(key, shape)
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
    lo = np.asarray(minval, dtype=np.float32)
    hi = np.asarray(maxval, dtype=np.float32)
    return np.maximum(lo, fma32(floats, hi - lo, lo)).astype(np.float32)


# XLA's float32 erf_inv (Giles, "Approximating the erfinv function"): a
# degree-8 polynomial in w = -log1p(-x^2) - 2.5 below w = 5, in
# sqrt(w) - 3 above
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _erfinv32(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        w = -np.log1p(-(x * x))
        lt = w < np.float32(5.0)
        w = np.where(lt, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0)).astype(np.float32)
        p = np.where(lt, np.float32(_ERFINV_LT5[0]), np.float32(_ERFINV_GE5[0]))
        for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
            p = fma32(p, w, np.where(lt, np.float32(a), np.float32(b)))
        out = p * x
        return np.where(np.abs(x) == 1, x * np.float32(np.inf), out).astype(np.float32)


def normal(key, shape: Shape = ()) -> np.ndarray:
    """float32 standard normal draws: ``sqrt(2) * erfinv(u)`` with ``u``
    uniform in ``(-1, 1)``, as JAX draws them."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(key, shape, lo, np.float32(1.0))
    return (np.float32(math.sqrt(2)) * _erfinv32(u)).astype(np.float32)


def _cumsum32(p: np.ndarray) -> np.ndarray:
    """float32 inclusive prefix sums in the order XLA's CPU reduce-window
    takes them: each prefix summed from its first element."""
    out = np.empty_like(p)
    acc = np.float32(0.0)
    for i, v in enumerate(p):
        acc = np.float32(acc + v)
        out[i] = acc
    return out


def choice(key, n: int, p) -> np.ndarray:
    """One index in ``range(n)`` per key, drawn with probabilities ``p``
    (need not sum to 1): ``searchsorted(cumsum(p), cumsum(p)[-1] * (1 - u))``
    in float32, as ``jax.random.choice(key, n, p=p)`` draws it."""
    p = np.asarray(p, dtype=np.float32)
    if p.shape != (int(n),):
        raise ValueError(f"p must have shape ({n},), got {p.shape}")
    cum = _cumsum32(p)
    r = cum[-1] * (np.float32(1.0) - uniform(key, ()))
    return np.searchsorted(cum, r, side="left").astype(np.int32)
