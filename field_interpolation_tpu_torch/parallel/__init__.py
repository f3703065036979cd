"""Sharded solves over ``torch.distributed``: one process per shard.

Counterpart of ``field_interpolation_tpu.parallel``: the sharded solves
and, in ``contour``, contours of a sharded field. Start the ranks with
`launch.run_ranks`; every rank calls the entry points on its own block.
"""

from .contour import marching_squares_sharded
from .mesh import Mesh
from .sharded import shard_problem, solve_refined_sharded, solve_sharded

__all__ = ["Mesh", "marching_squares_sharded", "shard_problem", "solve_refined_sharded",
           "solve_sharded"]
