"""Evolution loop: generation evaluator, run driver, artifacts, probes."""

from .artifacts import render_genome, save_best_artifacts
from .driver import neat_illusion, resolve_neat_config
from .evaluator import EvalConfig, GenerationEvaluator, GenerationOutputs
from .probe import calculate_fitness, get_vectors, score_image

__all__ = [
    "EvalConfig",
    "GenerationEvaluator",
    "GenerationOutputs",
    "neat_illusion",
    "resolve_neat_config",
    "render_genome",
    "save_best_artifacts",
    "get_vectors",
    "score_image",
    "calculate_fitness",
]
