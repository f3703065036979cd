"""Sharded solves over ``torch.distributed``: one process per shard.

Counterpart of ``field_interpolation_tpu.parallel`` (contouring, its
``contour`` module, is not ported yet). Start the ranks with
`launch.run_ranks`; every rank calls the entry points on its own block.
"""

from .mesh import Mesh
from .sharded import shard_problem, solve_refined_sharded, solve_sharded

__all__ = ["Mesh", "shard_problem", "solve_refined_sharded", "solve_sharded"]
