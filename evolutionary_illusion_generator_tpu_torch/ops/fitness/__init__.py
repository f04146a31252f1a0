"""Flow-fitness metric library (host, exact float64 numpy).

The numpy metrics (:mod:`.metrics_np`) reproduce the reference's
``fitness_calculator.py`` math bit-for-bit (quirks included).
"""

from .calculate import (
    EMPTY_FLOW_SENTINEL,
    MIN_VECTORS_CIRCLES,
    PLAUSIBILITY_LIMITS,
    calculate_fitness,
    score_vectors,
)
from .metrics_np import (
    direction_ratio,
    divergence_convergence_score,
    horizontal_symmetry_score,
    inside_outside_score,
    plausibility_ratio,
    rotation_symmetry_score,
    strength_number,
    swarm_score,
    tangent_ratio,
)

__all__ = [
    "EMPTY_FLOW_SENTINEL",
    "MIN_VECTORS_CIRCLES",
    "PLAUSIBILITY_LIMITS",
    "calculate_fitness",
    "score_vectors",
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
