"""PyTorch/CUDA port of ``field_interpolation_tpu``.

Scattered-data field interpolation and SDF reconstruction on 1-D, 2-D and
3-D grids as a matrix-free normal-equations PCG, in PyTorch, with the
operator apply, the per-sweep smoother, the multi-sweep 2-D smoother (each
in damped-Jacobi and Chebyshev form), the whole 2-D multigrid cycle and the
whole 2-D multigrid-PCG segment as hand-written CUDA kernels for the H100
(``ops/``, ``csrc/``); lumped or Galerkin coarse data; value interpolation
and sampling, reusable setup (`prepare`, the `Solver` session) and implicit
differentiation (`solve_implicit`); batched solves of many independent
fields in ``batch`` (one launch of the batched segment and apply kernels
for all lanes); the sharded solve in ``parallel/``; contouring (host
NumPy and device extractors in ``contour``, sharded ones in
``parallel.contour``); ``SolverConfig(debug=True)`` (``debugging``) and the
tooling modules (``utils.observe``, ``checkpoint``, ``visualize``).
Every entry point runs on the device of the tensors it is given; on CPU
tensors every kernel runs its plain PyTorch version.
The JAX package stays the reference; names here are its names, and, as
there, contouring and tooling are submodules, not top-level names.
"""

from .grid import Grid, grid_2d, grid_3d
from .weights import SolverConfig, Weights
from .operators import Problem, assemble
from .solver import SolveInfo, pcg, prepare, solve, solve_refined
from .diff import solve_implicit
from .session import Solver
from .sdf import (
    PreciseProblem,
    assemble_interpolation,
    assemble_precise,
    assemble_sdf,
    interpolate,
    interpolate_precise,
    sample_field,
    sample_field_gradient,
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
    "prepare",
    "solve",
    "Solver",
    "solve_refined",
    "solve_implicit",
    "assemble_sdf",
    "assemble_interpolation",
    "assemble_precise",
    "sdf_from_points",
    "sdf_from_points_precise",
    "interpolate",
    "interpolate_precise",
    "sample_field",
    "sample_field_gradient",
    "PreciseProblem",
]
