"""Reference-exact flow-fitness metrics (host numpy).

These reproduce, value-for-value, the scoring math of the reference's
``fitness_calculator.py`` — including its documented quirks — so that fitness
*rankings* are bit-compatible with the reference pipeline.  Each function's
docstring cites the reference lines it matches.  The implementations are
vectorized numpy (the reference uses per-vector Python loops) but compute the
same IEEE-754 double-precision arithmetic in the same association order where
it matters.

Flow vectors are ``[x, y, dx, dy]`` rows: pixel position of a tracked corner
and its displacement between the two frames (px), exactly the contract of the
reference's ``lucas_kanade`` (fitness_calculator.py:21, 98).

Preserved quirks (SURVEY.md Appendix C):
  * ``horizontal_symmetry_score`` normalizes all four components by the flow
    norm and assigns the 1-element slice ``normalized_v[2:3]`` into a 2-wide
    row — numpy *broadcasts*, so below-middle rows become ``[ndx, ndx]``
    (fitness_calculator.py:98-103).
  * ``swarm_score``'s "optimal" angle uses ``% 2 * math.pi`` which parses as
    ``((a) % 2) * pi`` (fitness_calculator.py:154).
  * ``strength_number`` uses only the x-component mean; the y mean is computed
    and discarded (fitness_calculator.py:34-39).
  * ``inside_outside_score`` neighbor window upper j-bound uses ``i``:
    ``max_j = min(h, i + 1)`` (fitness_calculator.py:277).
"""

from __future__ import annotations

import math

import numpy as np

__all__ = [
    "plausibility_ratio",
    "strength_number",
    "direction_ratio",
    "horizontal_symmetry_score",
    "swarm_score",
    "rotation_symmetry_score",
    "inside_outside_score",
    "divergence_convergence_score",
    "tangent_ratio",
]


def _as_vectors(vectors) -> np.ndarray:
    v = np.asarray(vectors, dtype=np.float64)
    if v.ndim == 1:
        v = v.reshape(1, -1)
    return v


def plausibility_ratio(vectors, limit):
    """Keep vectors whose flow norm is <= ``limit``.

    Returns ``[kept/total, kept_vectors]``.  Matches
    fitness_calculator.py:18-27 (vectors with ``norm > limit`` are dropped).
    """
    v = _as_vectors(vectors)
    norms = np.sqrt(v[:, 2] * v[:, 2] + v[:, 3] * v[:, 3])
    keep = ~(norms > limit)
    kept = v[keep]
    ratio = kept.shape[0] / v.shape[0]
    return [ratio, kept]


def strength_number(vectors, max_norm, strict_reference=True):
    """Mean |dx| / max_norm, damped by the variance of flow norms.

    Matches fitness_calculator.py:32-41.  Quirk: only the x component's mean
    is used (``my`` at :35 is dead); ``strict_reference=False`` uses the
    full flow norm instead.
    """
    v = _as_vectors(vectors)
    norms = np.sqrt(v[:, 2] * v[:, 2] + v[:, 3] * v[:, 3])
    if strict_reference:
        mx = np.mean(np.abs(v[:, 2]))
    else:
        mx = np.mean(norms)
    var = np.var(norms)
    return float(mx / max_norm * (1.0 - min(var, 1.0)))


def direction_ratio(vectors, limits=None):
    """[orientation in {-1,0,1}, mean x-projection of unit flows].

    Matches fitness_calculator.py:47-77 (dead code in the reference — kept
    for API-surface parity).
    """
    v = _as_vectors(vectors)
    if limits is not None:
        keep = ~((v[:, 1] < limits[0]) | (v[:, 1] > limits[1]))
        v = v[keep]
    count = v.shape[0]
    if count > 0:
        norms = np.sqrt(v[:, 2] * v[:, 2] + v[:, 3] * v[:, 3])
        mean_ratio = float(np.sum(v[:, 2] / norms) / count)
        orientation_sum = float(np.sum(v[:, 2]))
    else:
        mean_ratio = 0.0
        orientation_sum = 0.0
    orientation = 1 if orientation_sum > 0 else (-1 if orientation_sum < 0 else 0)
    return [orientation, mean_ratio]


def horizontal_symmetry_score(vectors, limits=(0, 60), strict_reference=True):
    """Symmetry of flow about the horizontal middle of ``limits``.

    Matches fitness_calculator.py:81-120, including the broadcast quirk:
    rows below the middle are assigned the 1-element slice
    ``normalized_v[2:3]`` into a 2-wide row, which numpy broadcasts into BOTH
    columns, so they contribute ``[ndx, ndx]``; rows at/above the middle
    contribute ``[-ndx, ndy]`` (:100-103).  All four components are divided
    by the flow norm (:98) — the position components are then discarded.
    ``strict_reference=False`` fixes the broadcast: below-middle rows
    contribute ``[ndx, ndy]``.
    """
    v = _as_vectors(vectors)
    middle = int(limits[1] / 2)
    keep = ~((v[:, 1] < limits[0]) | (v[:, 1] > limits[1]))
    v = v[keep]
    if v.shape[0] == 0:
        return 0
    flow_norm = np.sqrt(v[:, 2] * v[:, 2] + v[:, 3] * v[:, 3])
    ndx = v[:, 2] / flow_norm
    ndy = v[:, 3] / flow_norm
    below = v[:, 1] < middle
    col_x = np.where(below, ndx, -ndx)
    if strict_reference:
        col_y = np.where(below, ndx, ndy)  # broadcast quirk: ndx lands in y
    else:
        col_y = ndy
    var_x = np.var(col_x)
    mean_x = abs(np.mean(col_x))
    mean_y = abs(np.mean(col_y))
    return float(((1.0 - var_x) + mean_x + (1.0 - mean_y)) / 3.0)


def swarm_score(vectors, strict_reference=True):
    """Neighborhood angular-coherence score, O(n^2) over vector pairs.

    Matches fitness_calculator.py:124-159.  Per anchor ``a``: squared pixel
    distances to every vector are scaled by 1/100^2 and capped at 1; the
    binary "close" mask is 1 strictly inside 100 px; the "optimal" neighbor
    angle is ``((angle_a + df*pi) % 2) * pi`` (the reference's ``% 2 *
    math.pi`` precedence quirk, :154); loss = close * |angles - optimal|;
    score accumulates ``(pi - mean loss)/pi`` and is averaged over anchors.
    ``strict_reference=False`` fixes the precedence to the intended
    ``(angle + df*pi) % (2*pi)``.
    """
    v = _as_vectors(vectors)
    n = v.shape[0]
    norms = np.sqrt(v[:, 2] * v[:, 2] + v[:, 3] * v[:, 3])
    ndx = v[:, 2] / norms
    angles = np.arccos(ndx)

    dx = v[None, :, 0] - v[:, None, 0]
    dy = v[None, :, 1] - v[:, None, 1]
    distances = dx * dx + dy * dy
    distance_factors = distances / (100.0 * 100.0)
    distance_factors = np.where(distance_factors > 1.0, 1.0, distance_factors)
    close = 1.0 - np.where(distance_factors < 1.0, 0.0, distance_factors)

    raw = angles[:, None] + distance_factors * math.pi
    if strict_reference:
        optimal = np.mod(raw, 2.0) * math.pi
    else:
        optimal = np.mod(raw, 2.0 * math.pi)
    loss = close * np.abs(angles[None, :] - optimal)
    temp = math.pi - loss.sum(axis=1) / n
    score = np.sum(temp / math.pi)
    return float(score / n)


def rotation_symmetry_score(vectors, w, h, limits=None, original_filename="temp.png"):
    """Variance of flows after rotating each onto the +x axis.

    Matches fitness_calculator.py:166-215.  Vectors are re-centered on the
    image center; those with radius outside ``limits`` (or exactly 0, when
    limits are given) are dropped; flows are unit-normalized; each vector end
    is rotated so its origin lies on the +x axis; the score is
    ``((1-var_x)^2 + (1-var_y)^2) / 2``.
    """
    v = _as_vectors(vectors)
    cx, cy = w / 2.0, h / 2.0
    vcx = v[:, 0] - cx
    vcy = v[:, 1] - cy
    dist = np.sqrt(vcx * vcx + vcy * vcy)
    if limits is not None:
        keep = ~((dist < limits[0]) | (dist > limits[1]) | (dist == 0))
    else:
        keep = np.ones(v.shape[0], dtype=bool)
    vcx, vcy, dist = vcx[keep], vcy[keep], dist[keep]
    fdx, fdy = v[keep, 2], v[keep, 3]
    if vcx.shape[0] < 2:
        return 0
    norms = np.sqrt(fdx * fdx + fdy * fdy)
    fdx = fdx / norms
    fdy = fdy / norms
    x_1 = vcx + fdx
    y_1 = vcy + fdy
    rx_1 = (x_1 * vcx + y_1 * vcy) / dist
    ry_1 = (-x_1 * vcy + y_1 * vcx) / dist
    var_x = np.var(rx_1 - dist)
    var_y = np.var(ry_1)
    score = ((1.0 - var_x) * (1.0 - var_x) + (1.0 - var_y) * (1.0 - var_y)) / 2.0
    return float(score)


def inside_outside_score(vectors, width, height):
    """Cell-mean flow agreement inside cells, disagreement between neighbors.

    Matches fitness_calculator.py:219-304, including: cell step = width/5;
    grid sized ``int(dim/step)+1``; counts initialized to one (so cell means
    are biased); the neighbor-window j upper bound bug ``min(h, i+1)``
    (:277); half-open neighbor ranges that make the window asymmetric.
    """
    v = _as_vectors(vectors)
    step = width / 5.0
    w = int(width / step) + 1
    h = int(height / step) + 1
    flow = np.zeros((w, h, 2))
    count = np.ones((w, h))
    agreement = np.zeros((w, h, 2))
    norm_sum = np.zeros((w, h))

    ci = (v[:, 0] / step).astype(int)
    cj = (v[:, 1] / step).astype(int)
    np.add.at(flow[:, :, 0], (ci, cj), v[:, 2])
    np.add.at(flow[:, :, 1], (ci, cj), v[:, 3])
    np.add.at(count, (ci, cj), 1.0)
    np.add.at(norm_sum, (ci, cj), np.sqrt(v[:, 2] ** 2 + v[:, 3] ** 2))

    flow[:, :, 0] = flow[:, :, 0] / count
    flow[:, :, 1] = flow[:, :, 1] / count
    norm_sum = norm_sum / count

    np.add.at(agreement[:, :, 0], (ci, cj), (flow[ci, cj, 0] - v[:, 2]) ** 2)
    np.add.at(agreement[:, :, 1], (ci, cj), (flow[ci, cj, 1] - v[:, 3]) ** 2)
    agreement[:, :, 0] = agreement[:, :, 0] / count
    agreement[:, :, 1] = agreement[:, :, 1] / count

    score_agreement = -min(np.mean(agreement), 10.0)
    score_size = min(10.0, np.mean(norm_sum))

    sum_d = 0.0
    for i in range(w):
        for j in range(h):
            vx, vy = flow[i, j, 0], flow[i, j, 1]
            if vx != 0 or vy != 0:
                norm_v = math.sqrt(vx * vx + vy * vy)
                vx, vy = vx / norm_v, vy / norm_v
            min_i, max_i = max(0, i - 1), min(w, i + 1)
            min_j, max_j = max(0, j - 1), min(h, i + 1)  # reference bug: i, not j
            plus = minus = 0
            for x in range(min_i, max_i):
                for y in range(min_j, max_j):
                    if i == x and j == y:
                        continue
                    wx, wy = flow[x, y, 0], flow[x, y, 1]
                    if wx != 0 or wy != 0:
                        norm_w = math.sqrt(wx * wx + wy * wy)
                        wx, wy = wx / norm_w, wy / norm_w
                        if vx * wx + vy * wy > 0:
                            plus += 1
                        else:
                            minus += 1
            sum_d += (min(2, plus) + min(2, minus)) / 4.0

    sum_d = sum_d / (w * h) * 10.0
    return float((score_agreement + score_size + sum_d) / 30.0)


def divergence_convergence_score(vectors, width, height):
    """Neighborhood parallel/anti-parallel balance score.

    Matches fitness_calculator.py:309-376 (dead code in the reference).
    Cells take the *last* vector written, not the mean (the reference's TODO
    at :319 was never done).
    """
    v = _as_vectors(vectors)
    step = 10
    w = int(width / step)
    h = int(height / step)
    flow = np.zeros((w, h, 2))
    for idx in range(v.shape[0]):
        i = int(v[idx, 0] / step)
        j = int(v[idx, 1] / step)
        norm_v = math.sqrt(v[idx, 2] ** 2 + v[idx, 3] ** 2)
        flow[i, j, 0] = v[idx, 2] / norm_v
        flow[i, j, 1] = v[idx, 3] / norm_v

    score = 0.0
    for i in range(w):
        for j in range(h):
            vx, vy = flow[i, j, 0], flow[i, j, 1]
            if vx == 0 and vy == 0:
                continue
            plus = minus = 0.0
            sum_vec = 0
            for x in range(max(i - 1, 0), min(i + 1, w)):
                for y in range(max(j - 1, 0), min(j + 1, h)):
                    wx, wy = flow[x, y, 0], flow[x, y, 1]
                    if wx == 0 and wy == 0:
                        continue
                    sum_vec += 1
                    dot = vx * wx + vy * wy
                    if dot > 0:
                        plus += dot
                    else:
                        minus -= dot
            if sum_vec > 0:
                loss = 1.0 - (plus - minus) / (plus + minus)
                score += loss * abs(vx + vy)
    return float(score)


def tangent_ratio(vectors, w, h, limits=None):
    """[direction in {-1,0,1}, |mean tangency|] of flows vs concentric circles.

    Matches fitness_calculator.py:386-465 (dead code, superseded by
    :func:`rotation_symmetry_score`).  Unlike the reference (which mutates
    each vector row in place, :404-407) this computes on a copy; the returned
    values are identical.  Note the reference's control flow: zero-norm
    vectors increment the count and are skipped; out-of-limits vectors are
    skipped WITHOUT incrementing the count (:419-429).
    """
    v = _as_vectors(vectors).copy()
    c = [w / 2.0, h / 2.0]
    mean_alignment = 0.0
    count = 0
    for row in v:
        row[0] = row[0] - c[0]
        row[1] = row[1] - c[1]
        row[2] = row[0] + row[2]
        row[3] = row[1] + row[3]
        ro = np.array([row[0], row[1]])
        vo = np.array([row[2] - row[0], row[3] - row[1]])
        norm_r = math.sqrt(ro[0] ** 2 + ro[1] ** 2)
        norm_v = math.sqrt(vo[0] ** 2 + vo[1] ** 2)
        if norm_r * norm_v == 0:
            count += 1
            continue
        ro = ro / norm_r
        vo = vo / norm_v
        if limits is not None:
            if norm_r < limits[0] or norm_r > limits[1]:
                continue
        dot_p = float(np.clip(ro[0] * vo[0] + ro[1] * vo[1], -1.0, 1.0))
        angle = math.acos(dot_p)
        score = (math.pi / 2.0) - abs(angle)
        score = 1.0 - abs(score) / (math.pi / 2.0)
        cw = ro[0] * vo[1] - ro[1] * vo[0]
        if cw > 0:
            mean_alignment += score
        else:
            mean_alignment -= score
        count += 1

    direction = 1 if mean_alignment > 0 else (-1 if mean_alignment < 0 else 0)
    if count > 0:
        mean_alignment = mean_alignment / count
    return [direction, abs(mean_alignment)]
