"""Human-evaluation analysis (the reference's ``illusions_rating`` study).

``ratings`` is a copy of the JAX package's ``analysis/ratings.py`` (pandas
and scipy, no framework).  The package re-exports its names as the JAX
package does, but imports ``ratings`` only when one of them is first read
(PEP 562), so that the package imports on a machine without pandas.
"""

import importlib

__all__ = [
    "GALLERY_MODEL_SCORES",
    "attention_check_pass",
    "filter_participants",
    "normalize_per_participant",
    "summarize",
    "welch_tests_vs_control",
    "correlate_with_model_scores",
]


def __getattr__(name):
    if name in __all__:
        return getattr(importlib.import_module(".ratings", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))
