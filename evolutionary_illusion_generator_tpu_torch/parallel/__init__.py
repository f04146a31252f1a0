"""Device mesh and sharding: the population over a mesh, the data-parallel
trainer's mesh, multi-process initialization, and the spatial and
pipelined predictor rollouts."""

from .distributed import initialize_distributed
from .mesh import make_mesh, population_sharding, replicated_sharding
from .sharded_evaluator import ShardedGenerationEvaluator
from .spatial import make_mesh_2d, make_spatial_rollout

__all__ = [
    "initialize_distributed",
    "make_mesh",
    "make_mesh_2d",
    "make_spatial_rollout",
    "population_sharding",
    "replicated_sharding",
    "ShardedGenerationEvaluator",
]
