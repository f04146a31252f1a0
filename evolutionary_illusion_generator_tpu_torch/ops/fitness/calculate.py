"""Structure-specific fitness switch.

Reproduces the authoritative per-structure scoring of the reference's
population loop (generate_illusion.py:557-617) and its single-image variant
(fitness_calculator.py:505-548): thresholds 0.15 / 0.3 / 0.4, the
``min_vectors=24`` gate for circles, and the 0.7/0.3 and 0.5/0.1/0.4 score
weights.
"""

from __future__ import annotations

import numpy as np

from ...structure import StructureType
from .metrics_np import (
    horizontal_symmetry_score,
    inside_outside_score,
    plausibility_ratio,
    rotation_symmetry_score,
    strength_number,
    swarm_score,
)

__all__ = [
    "score_vectors",
    "calculate_fitness",
    "EMPTY_FLOW_SENTINEL",
    "PLAUSIBILITY_LIMITS",
    "MIN_VECTORS_CIRCLES",
]

#: Sentinel row used when the flow extractor finds no trackable vectors
#: (generate_illusion.py:554).  Its norm (1000) fails every plausibility
#: gate, so such candidates score 0.
EMPTY_FLOW_SENTINEL = np.array([[0.0, 0.0, -1000.0, 0.0]])

#: Per-structure plausibility (max flow norm) thresholds
#: (generate_illusion.py:569, 583, 597).
PLAUSIBILITY_LIMITS = {
    StructureType.Bands: 0.15,
    StructureType.Circles: 0.3,
    StructureType.CirclesFree: 0.3,
    StructureType.Free: 0.4,
}

#: Minimum surviving vectors for the circles score gate
#: (generate_illusion.py:587).
MIN_VECTORS_CIRCLES = 24


def score_vectors(structure, vectors, w, h):
    """Score one candidate's flow vectors for the given structure family.

    This is the population-loop switch (generate_illusion.py:564-609):
    candidates whose vectors fail the plausibility/count gates score 0.

    Args:
      structure: a :class:`StructureType`.
      vectors: (N, 4) array of [x, y, dx, dy] flow rows (px).
      w, h: image width/height in px.

    Returns:
      float fitness score.
    """
    vectors = np.asarray(vectors, dtype=np.float64)
    if vectors.size == 0:
        vectors = EMPTY_FLOW_SENTINEL
    score_d = 0.0

    if structure == StructureType.Bands:
        _, good = plausibility_ratio(vectors, PLAUSIBILITY_LIMITS[structure])
        if len(good) > 0:
            stripes = 4
            step = h / stripes
            score_d = horizontal_symmetry_score(good, [0, step * 2])
    elif structure in (StructureType.Circles, StructureType.CirclesFree):
        max_strength = PLAUSIBILITY_LIMITS[structure]
        _, good = plausibility_ratio(vectors, max_strength)
        if len(good) > MIN_VECTORS_CIRCLES:
            limits = [0, h / 2]
            score_direction = rotation_symmetry_score(good, w, h, limits)
            score_strength = strength_number(good, max_strength)
            score_d = 0.7 * score_direction + 0.3 * score_strength
    elif structure == StructureType.Free:
        max_strength = PLAUSIBILITY_LIMITS[structure]
        _, good = plausibility_ratio(vectors, max_strength)
        if len(good) > 0:
            score_strength = strength_number(good, max_strength)
            score_number = min(len(good), 15) / 15
            score_s = swarm_score(good)
            score_d = 0.5 * score_s + 0.1 * score_strength + 0.4 * score_number
    else:
        # Reference dead branch (generate_illusion.py:606-607) — it reads an
        # unbound ``good_vectors`` there; we pass the raw vectors instead.
        score_d = inside_outside_score(vectors, w, h)

    return float(score_d)


def calculate_fitness(structure, vectors, image_path, w, h):
    """Single-image fitness (probe path).

    API parity with fitness_calculator.py:505-548.  The reference leaves
    ``score_d`` unbound when the gates fail (latent bug, SURVEY.md Appendix
    C #5); this returns 0.0 in that case.  ``image_path`` is accepted for
    signature parity and unused, like the reference's ``image_path``.
    """
    del image_path
    return score_vectors(StructureType(structure), vectors, w, h)
