"""PyTorch/CUDA port of ``field_interpolation_tpu``.

Scattered-data field interpolation and SDF reconstruction on 2-D and 3-D
grids as a matrix-free normal-equations PCG, in PyTorch, with the operator
apply, the damped-Jacobi sweep and the whole 2-D multigrid-PCG segment as
hand-written CUDA kernels for the H100 (``ops/``, ``csrc/``). On CPU tensors
every kernel runs its plain PyTorch version.
The JAX package stays the reference; names here are its names. Entry points
not ported yet are listed in ROADMAP.md.
"""

from .grid import Grid, grid_2d, grid_3d
from .weights import SolverConfig, Weights
from .operators import Problem, assemble
from .solver import SolveInfo, pcg, solve, solve_refined
from .sdf import (
    PreciseProblem,
    assemble_precise,
    assemble_sdf,
    sdf_from_points,
    sdf_from_points_precise,
)

__version__ = "0.1.0"

__all__ = [
    "Grid",
    "grid_2d",
    "grid_3d",
    "Weights",
    "SolverConfig",
    "Problem",
    "assemble",
    "SolveInfo",
    "pcg",
    "solve",
    "solve_refined",
    "assemble_sdf",
    "assemble_precise",
    "sdf_from_points",
    "sdf_from_points_precise",
    "PreciseProblem",
]
