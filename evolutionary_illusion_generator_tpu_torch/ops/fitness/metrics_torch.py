"""Device (PyTorch) flow-fitness metrics over fixed-K masked vector sets.

The port of the JAX package's ``ops/fitness/metrics_jax.py``.  The
variable-length vector lists of the reference become a fixed-size
``(..., K, 4)`` tensor of ``[x, y, dx, dy]`` rows plus a boolean validity
mask ``(..., K)``; every function reduces over K and keeps the leading
axes, so one call scores a whole population ``(pop, K, 4)`` (the JAX
package maps its single-candidate functions with ``jax.vmap``).  The math
is the host-exact :mod:`.metrics_np` versions', in the vectors' dtype
(float32 on the evaluator's path): ``EvalConfig.score_on_device`` scores
with it instead of pulling the vectors to the host.  Plain PyTorch ops, as
the JAX package leaves these to XLA.
"""

from __future__ import annotations

import math

import torch

from ...structure import StructureType

__all__ = [
    "plausibility_mask",
    "strength_number",
    "horizontal_symmetry_score",
    "swarm_score",
    "rotation_symmetry_score",
    "score_vectors_torch",
]


def _count(mask):
    return mask.sum(dim=-1)


def _masked_mean(x, mask, count):
    return torch.where(mask, x, 0.0).sum(dim=-1) / count


def _masked_var(x, mask, count):
    m = _masked_mean(x, mask, count)
    return torch.where(mask, (x - m[..., None]) ** 2, 0.0).sum(dim=-1) / count


def _norms(vectors):
    return torch.sqrt(vectors[..., 2] ** 2 + vectors[..., 3] ** 2)


def plausibility_mask(vectors, mask, limit):
    """The mask of valid vectors whose flow norm is <= limit (the device
    analogue of ``plausibility_ratio``)."""
    return mask & ~(_norms(vectors) > limit)


def strength_number(vectors, mask, max_norm):
    """Masked ``strength_number`` (the x-mean-only quirk)."""
    count = _count(mask).clamp(min=1)
    mx = _masked_mean(vectors[..., 2].abs(), mask, count)
    var = _masked_var(_norms(vectors), mask, count)
    return mx / max_norm * (1.0 - var.clamp(max=1.0))


def horizontal_symmetry_score(vectors, mask, limits):
    """Masked ``horizontal_symmetry_score`` with its quirks: below-middle
    rows contribute ``[ndx, ndx]``, the others ``[-ndx, ndy]``; 0 when no
    vector falls inside ``limits``."""
    middle = int(limits[1] / 2)
    y = vectors[..., 1]
    sel = mask & ~((y < limits[0]) | (y > limits[1]))
    count = _count(sel)
    safe_count = count.clamp(min=1)
    norm = _norms(vectors)
    norm = torch.where(norm == 0, 1.0, norm)
    ndx, ndy = vectors[..., 2] / norm, vectors[..., 3] / norm
    below = y < middle
    col_x = torch.where(below, ndx, -ndx)
    col_y = torch.where(below, ndx, ndy)
    var_x = _masked_var(col_x, sel, safe_count)
    mean_x = _masked_mean(col_x, sel, safe_count).abs()
    mean_y = _masked_mean(col_y, sel, safe_count).abs()
    score = ((1.0 - var_x) + mean_x + (1.0 - mean_y)) / 3.0
    return torch.where(count == 0, 0.0, score)


def swarm_score(vectors, mask):
    """Masked O(K^2) ``swarm_score`` with the reference's precedence quirk:
    the "optimal" neighbour angle is ``((angle_a + df*pi) % 2) * pi``.
    Invalid rows contribute to no sum."""
    n = _count(mask).clamp(min=1)
    norms = _norms(vectors)
    norms = torch.where(norms == 0, 1.0, norms)
    angles = torch.arccos((vectors[..., 2] / norms).clamp(-1.0, 1.0))
    x, y = vectors[..., 0], vectors[..., 1]
    dx = x[..., None, :] - x[..., :, None]
    dy = y[..., None, :] - y[..., :, None]
    df = ((dx * dx + dy * dy) / 1.0e4).clamp(max=1.0)
    close = torch.where(df < 1.0, 1.0, 0.0)
    pair = mask[..., :, None] & mask[..., None, :]
    optimal = torch.remainder(angles[..., :, None] + df * math.pi, 2.0) * math.pi
    loss = torch.where(pair, close * (angles[..., None, :] - optimal).abs(), 0.0)
    temp = math.pi - loss.sum(dim=-1) / n[..., None]
    return torch.where(mask, temp / math.pi, 0.0).sum(dim=-1) / n


def rotation_symmetry_score(vectors, mask, w, h, limits):
    """Masked ``rotation_symmetry_score``: vectors whose recentred radius
    is outside ``limits`` or exactly 0 drop out, each flow is rotated so its
    origin lies on +x, and the score is ``((1-var_x)^2 + (1-var_y)^2)/2``;
    0 when fewer than 2 survive."""
    vcx = vectors[..., 0] - w / 2.0
    vcy = vectors[..., 1] - h / 2.0
    dist = torch.sqrt(vcx * vcx + vcy * vcy)
    sel = mask & ~((dist < limits[0]) | (dist > limits[1]) | (dist == 0))
    count = _count(sel)
    safe_count = count.clamp(min=1)
    safe_dist = torch.where(dist == 0, 1.0, dist)
    norms = _norms(vectors)
    norms = torch.where(norms == 0, 1.0, norms)
    x_1 = vcx + vectors[..., 2] / norms
    y_1 = vcy + vectors[..., 3] / norms
    rx_1 = (x_1 * vcx + y_1 * vcy) / safe_dist
    ry_1 = (-x_1 * vcy + y_1 * vcx) / safe_dist
    var_x = _masked_var(rx_1 - dist, sel, safe_count)
    var_y = _masked_var(ry_1, sel, safe_count)
    score = ((1.0 - var_x) ** 2 + (1.0 - var_y) ** 2) / 2.0
    return torch.where(count < 2, 0.0, score)


def score_vectors_torch(structure, vectors, mask, w, h):
    """The population loop's per-structure switch on the device: the
    plausibility gates (0.15 / 0.3 / 0.4), the >24 vector gate for circles
    and the per-structure blends.  ``vectors`` (..., K, 4), ``mask``
    (..., K); returns the scores (...,)."""
    structure = StructureType(int(structure))
    if structure == StructureType.Bands:
        good = plausibility_mask(vectors, mask, 0.15)
        score = horizontal_symmetry_score(vectors, good, [0, h / 4.0 * 2])
        return torch.where(_count(good) > 0, score, 0.0)
    if structure in (StructureType.Circles, StructureType.CirclesFree):
        max_strength = 0.3
        good = plausibility_mask(vectors, mask, max_strength)
        score = (0.7 * rotation_symmetry_score(vectors, good, w, h, [0, h / 2.0])
                 + 0.3 * strength_number(vectors, good, max_strength))
        return torch.where(_count(good) > 24, score, 0.0)
    if structure == StructureType.Free:
        max_strength = 0.4
        good = plausibility_mask(vectors, mask, max_strength)
        count = _count(good)
        score = (0.5 * swarm_score(vectors, good)
                 + 0.1 * strength_number(vectors, good, max_strength)
                 + 0.4 * (count.clamp(max=15) / 15.0))
        return torch.where(count > 0, score, 0.0)
    raise ValueError(f"unsupported structure for device scoring: {structure}")
