"""Evolution loop: the generation evaluator and the ``neat_illusion`` driver."""

from .driver import neat_illusion, resolve_neat_config
from .evaluator import EvalConfig, GenerationEvaluator, GenerationOutputs

__all__ = [
    "EvalConfig",
    "GenerationEvaluator",
    "GenerationOutputs",
    "neat_illusion",
    "resolve_neat_config",
]
