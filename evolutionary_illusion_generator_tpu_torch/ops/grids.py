"""Coordinate-grid builders for CPPN input planes.

Vectorized re-implementations of the reference's per-pixel Python loops:

* :func:`fill_circle`        <- generate_illusion.py:38-117 (polar ring mapper)
* :func:`create_grid`        <- generate_illusion.py:196-317
* :func:`enhanced_image_grid`<- generate_illusion.py:121-193 (800x800 poster)

Semantics are matched value-for-value (the tests compare against a literal
scalar transcription), with ONE deliberate deviation: grids are always
returned as ``(h, w)`` float arrays.  The reference reshapes the Bands grid
to ``(1, h*w, 1)`` (generate_illusion.py:236-237), a shape its own
background-masking loop (:398-401) cannot index without raising — a latent
crash we do not reproduce.

The grid is computed once per run on the host (numpy, f64) and uploaded as a
device-resident constant; ``x_mat == -1`` is the whitespace sentinel consumed
by the renderer's background mask.
"""

from __future__ import annotations

import math

import numpy as np

from ..structure import StructureType

__all__ = ["fill_circle", "create_grid", "enhanced_image_grid", "GRID_SCALING"]

#: The evolution loop always builds grids with scaling=10
#: (generate_illusion.py:501).
GRID_SCALING = 10.0

# Ring ratio table: r_ratios[i] = (2/3)^i, i = 0..9
# (generate_illusion.py:41-48: powers of 1.5 normalized by the largest).
_N_RATIOS = 10
_R_RATIOS = (1.0 / 1.5) ** np.arange(_N_RATIOS)


def fill_circle(x, y, xx, yy, max_radius, direction, structure=StructureType.Circles):
    """Map centered coordinates to (ring-normalized radius, structured angle).

    Vectorized over ``x``/``y`` (arrays or scalars).  ``xx``/``yy`` (absolute
    pixel coords) are accepted for signature parity and unused, exactly like
    the reference.  Returns ``(r, theta)`` where ``r == -1`` marks whitespace
    (outside the circle, in the inter-ring gaps, or in the innermost core).

    Matches generate_illusion.py:38-117: 10 geometric rings with ratio 1.5;
    radius position within its ring normalized to [0, 1] (flipped when
    ``direction < 0``); theta from arctan with a pi shift for x < 0 and a
    pi/4 rotation on odd rings; Circles additionally wraps theta mod pi/6;
    the band 0.1 < r <= 0.9 is kept and rescaled by 1/0.8, the rest is
    whitespace.
    """
    del xx, yy
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    r_total = np.sqrt(x * x + y * y)
    half = max_radius / 2.0
    inside = r_total <= half
    radius = np.minimum(1.0, r_total / half)

    # First ring index i in [1, 8] with radius > r_ratios[i]; the table is
    # strictly decreasing so the predicate is monotone in i.
    hit = radius[..., None] > _R_RATIOS[1 : _N_RATIOS - 1]
    found = hit.any(axis=-1)
    i_star = 1 + np.argmax(hit, axis=-1)
    lo = _R_RATIOS[i_star]
    hi = _R_RATIOS[i_star - 1]
    r_ring = (radius - lo) / (hi - lo)
    if direction < 0:
        r_ring = 1.0 - r_ring
    radius_index = np.where(found, _N_RATIOS - i_star - 1, 0)
    r = np.where(inside & found, r_ring, -1.0)

    theta = np.zeros_like(r_total)
    if structure in (StructureType.Circles, StructureType.CirclesFree):
        safe_x = np.where(x == 0, 1.0, x)
        t = np.where(x == 0, math.pi / 2.0, np.arctan(y / safe_x))
        t = np.where(x < 0, t + math.pi, t)
        t = np.where(radius_index % 2 == 1, t + math.pi / 4.0, t)
        if structure == StructureType.Circles:
            t = np.mod(t, math.pi / 6.0)
        if direction < 0:
            t = (math.pi / 6.0) - t
        theta = np.where(inside, t, 0.0)

    # whitespace margins inside each ring (generate_illusion.py:110-115)
    keep = inside & (r <= 0.9) & (r >= 0.1)
    theta = np.where(keep, theta, 0.0)
    r = np.where(keep, r / 0.8, -1.0)
    return r, theta


def _centered_mesh(x_res, y_res):
    xx = np.arange(x_res, dtype=np.float64)
    yy = np.arange(y_res, dtype=np.float64)
    x = xx - (x_res / 2.0)
    y = yy - (y_res / 2.0)
    return np.meshgrid(x, y)  # (y_res, x_res) each


def create_grid(structure, x_res=32, y_res=32, scaling=1.0):
    """Build the per-structure CPPN input planes.

    Returns ``{"x_mat": (h, w), "y_mat": (h, w)}`` float64 arrays.  Matches
    generate_illusion.py:196-317 per structure:

    * Bands (:202-239): 4 horizontal bands with 10-px zero padding between
      them, x coordinate tiled 10x with its sign flipped in alternating
      bands.
    * Circles (:241-260): whole-frame :func:`fill_circle` with
      max_radius = y_res, direction = 1.
    * CirclesFree (:262-306): radius repeating every y_res/6 px (3 rings per
      half-height), theta rotated pi/4 on odd rings, zeroed outside the
      inscribed circle.
    * Free (:308-315): plain meshgrid on [-scaling, scaling].
    """
    structure = StructureType(structure)
    num_points = x_res * y_res
    del num_points

    if structure == StructureType.Bands:
        y_rep = 4
        padding = 10
        y_len = int(y_res / y_rep)
        sc = scaling / y_rep
        a = np.linspace(-sc, sc, num=y_len - padding)
        to_tile = np.concatenate((a, np.zeros(padding)))
        y_range = np.tile(to_tile, y_rep)

        x_rep = 10
        x_len = int(x_res / x_rep)
        sc = scaling / x_rep
        x_range = np.tile(np.linspace(-sc, sc, num=x_len), x_rep)

        x_reverse = np.ones((y_res, 1))
        start = y_len
        while start < y_res:
            m_start = max(0, start - padding)
            x_reverse[m_start:start] = 0.0
            stop = min(y_res, start + y_len)
            m_start = max(stop - padding, 0)
            x_reverse[m_start:stop] = 0.0
            x_reverse[start:stop] = -x_reverse[start:stop]
            start += 2 * y_len

        x_mat = x_reverse @ x_range.reshape(1, x_res)
        y_mat = y_range.reshape(y_res, 1) @ np.ones((1, x_res))
        return {"x_mat": x_mat, "y_mat": y_mat}

    if structure == StructureType.Circles:
        x, y = _centered_mesh(x_res, y_res)
        r, theta = fill_circle(x, y, None, None, y_res, 1, StructureType.Circles)
        return {"x_mat": r, "y_mat": theta}

    if structure == StructureType.CirclesFree:
        r_rep = 3
        r_len = int(y_res / (2 * r_rep))
        x, y = _centered_mesh(x_res, y_res)
        r_total = np.sqrt(x * x + y * y)
        r = np.minimum(r_total, y_res / 2.0)
        r = np.mod(r, r_len) / r_len

        safe_x = np.where(x == 0, 1.0, x)
        theta = np.where(x == 0, math.pi / 2.0, np.arctan(y / safe_x))
        theta = np.where(x < 0, theta + math.pi, theta)
        r_index = (r_total / r_len).astype(np.int64)
        theta = np.where(r_index % 2 == 1, theta + math.pi / 4.0, theta)
        theta = np.where(r_total < y_res / 2.0, theta, 0.0)
        return {"x_mat": r, "y_mat": theta}

    if structure == StructureType.Free:
        x_range = np.linspace(-scaling, scaling, num=x_res)
        y_range = np.linspace(-scaling, scaling, num=y_res)
        y_mat = y_range.reshape(y_res, 1) @ np.ones((1, x_res))
        x_mat = np.ones((y_res, 1)) @ x_range.reshape(1, x_res)
        return {"x_mat": x_mat, "y_mat": y_mat}

    raise ValueError(f"unknown structure: {structure}")


def enhanced_image_grid(x_res, y_res, structure):
    """Poster grid: 3x3 circle tiling plus a 2x2 half-step overlay.

    Matches generate_illusion.py:121-193: main circles on a 3x3 cell grid
    (rotation direction flips with index parity, even indices spin -1); the
    overlay circles sit at half-step offsets and only claim pixels strictly
    inside their radius; unclaimed pixels keep the whitespace sentinel
    (x_mat = -1, y_mat = -1).
    """
    structure = StructureType(structure)
    c_rows = c_cols = 3
    y_step = int(y_res / c_cols)
    x_step = int(x_res / c_cols)
    sub_rows = c_rows - 1
    sub_cols = c_cols - 1

    centers = {}
    for yk in range(c_rows):
        for xk in range(c_cols):
            centers[yk * c_cols + xk] = (
                x_step * xk + x_step / 2.0,
                y_step * yk + y_step / 2.0,
            )
    for yk in range(sub_rows):
        for xk in range(sub_cols):
            # reference quirk: the sub-circle y-center uses x_step
            # (generate_illusion.py:149) — identical for square cells.
            centers[c_rows * c_cols + yk * sub_cols + xk] = (
                x_step * xk + x_step,
                y_step * yk + x_step,
            )

    x_mat = np.full((y_res, x_res), -1.0)
    y_mat = np.full((y_res, x_res), -1.0)

    xx_block, yy_block = np.meshgrid(
        np.arange(x_step, dtype=np.float64), np.arange(y_step, dtype=np.float64)
    )

    for row in range(c_rows):
        for col in range(c_cols):
            index = row * c_cols + col
            direction = -1 if index % 2 == 0 else 1
            cx, cy = centers[index]
            real_x0, real_y0 = col * x_step, row * y_step
            x = (real_x0 + xx_block) - cx
            y = (real_y0 + yy_block) - cy
            r, theta = fill_circle(x, y, None, None, y_step, direction, structure)
            x_mat[real_y0 : real_y0 + y_step, real_x0 : real_x0 + x_step] = r
            y_mat[real_y0 : real_y0 + y_step, real_x0 : real_x0 + x_step] = theta

    half = int(x_step / 2)
    for row in range(sub_rows):
        for col in range(sub_cols):
            # reference quirk: sub-circle index stride uses sub_rows
            # (generate_illusion.py:176) — identical when sub_rows==sub_cols.
            index = c_rows * c_cols + row * sub_rows + col
            direction = -1 if index % 2 == 0 else 1
            cx, cy = centers[index]
            real_x0 = col * x_step + half
            real_y0 = row * y_step + half
            x = (real_x0 + xx_block) - cx
            y = (real_y0 + yy_block) - cy
            inside = np.sqrt(x * x + y * y) < x_step / 2.0
            r, theta = fill_circle(x, y, None, None, y_step, direction, structure)
            region_x = x_mat[real_y0 : real_y0 + y_step, real_x0 : real_x0 + x_step]
            region_y = y_mat[real_y0 : real_y0 + y_step, real_x0 : real_x0 + x_step]
            region_x[...] = np.where(inside, r, region_x)
            region_y[...] = np.where(inside, theta, region_y)

    return {"x_mat": x_mat, "y_mat": y_mat}
