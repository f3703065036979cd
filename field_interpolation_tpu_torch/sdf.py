"""Top-level entry points: SDF from oriented points (torch).

Counterpart of the SDF half of ``field_interpolation_tpu.sdf``:
`sdf_from_points` (float32 assembly + PCG) and `sdf_from_points_precise`
(float32 problem + matter-free float64 system + float64 refinement), both
with the nested-iteration start `fmg_start` (`_fmg_guess`).
The H100 has native float64, so `PreciseProblem` keeps its float64 rows and
scatter in plain float64: none of the reference's double-float or
integer-grid emulation is needed.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import constraints as cons
from . import stencils
from .grid import Grid
from .multigrid import prolong
from .operators import Problem, assemble
from .solver import SolveInfo, solve, solve_refined
from .weights import SolverConfig, Weights


def assemble_sdf(
    grid: Grid,
    weights: Weights,
    positions: torch.Tensor,                  # [n, D] oriented point positions
    normals: torch.Tensor,                    # [n, D] unit surface normals
    point_weights: Optional[torch.Tensor] = None,
) -> Problem:
    """Per oriented point: value row f(p)=0 + gradient rows ∇f(p)=n̂ (SPEC.md).
    Assembles in float32 on the device of ``positions``."""
    f32 = torch.float32
    zeros = torch.zeros(positions.shape[0], dtype=f32, device=positions.device)
    return assemble(grid, weights, positions.to(f32), zeros,
                    gradients=normals.to(f32),
                    point_weights=None if point_weights is None
                    else point_weights.to(f32))


def _fmg_guess(grid: Grid, weights: Weights, positions, normals,
               point_weights, config: SolverConfig,
               depth: int = 1) -> Optional[torch.Tensor]:
    """Nested-iteration (FMG) initial guess: assemble and solve the SAME
    cloud on the (n+1)//2-coarsened grid (positions scaled by the spacing
    ratio, tol = max(1e-3, tol)), prolong, and rescale to fine lattice
    units. ``depth > 1`` starts the coarse solve from its own coarser guess.
    None when the grid cannot coarsen."""
    cshape = tuple(max(2, (n + 1) // 2) for n in grid.shape)
    if cshape == grid.shape:
        return None
    cgrid = Grid(cshape)
    scale = ((np.asarray(cshape, np.float64) - 1.0)
             / (np.asarray(grid.shape, np.float64) - 1.0))
    cpos = positions * torch.as_tensor(scale, dtype=positions.dtype,
                                       device=positions.device)
    cprob = assemble_sdf(cgrid, weights, cpos, normals, point_weights)
    ccfg = dataclasses.replace(config, tol=max(1e-3, config.tol), debug=False)
    cx0 = None
    if depth > 1:
        cx0 = _fmg_guess(cgrid, weights, cpos, normals, point_weights, config,
                         depth - 1)
    xc, _ = solve(cprob, ccfg, x0=cx0)
    # SDF values are in lattice units: rescale by the spacing ratio.
    return prolong(xc, grid.shape) * (1.0 / float(scale.min()))


def sdf_from_points(
    grid: Grid,
    weights: Weights,
    positions: torch.Tensor,
    normals: torch.Tensor,
    point_weights: Optional[torch.Tensor] = None,
    config: SolverConfig = SolverConfig(),
    x0: Optional[torch.Tensor] = None,
    fmg_start: bool | int = False,
) -> tuple[torch.Tensor, SolveInfo]:
    """Reconstruct a signed-distance field from an oriented point cloud.
    Returns (field [*grid.shape] float32, SolveInfo); warm start via ``x0``.
    ``fmg_start=True`` (ignored when ``x0`` is given) starts from a
    half-resolution solve of the same cloud (`_fmg_guess`); an int recurses
    that many levels. The coarse iterations are not counted in SolveInfo."""
    if fmg_start and x0 is None:
        x0 = _fmg_guess(grid, weights, positions, normals, point_weights,
                        config, depth=int(fmg_start))
    problem = assemble_sdf(grid, weights, positions, normals, point_weights)
    return solve(problem, config, x0=x0)


@dataclasses.dataclass(frozen=True)
class PreciseProblem:
    """Mixed-precision problem for solver.solve_refined: the float32 problem
    (densified data stencil, the kernels' path) plus a float64 system kept
    MATTER-FREE as per-sample weighted rows."""

    p32: Problem
    b64: torch.Tensor          # [*grid] float64, Aᵀb of the f64 system
    corner_idx: torch.Tensor   # [n, 2^D] int64
    rows64: torch.Tensor       # [n, R, 2^D] float64, weight-scaled row coeffs
    tw64: torch.Tensor         # [n, R] float64, weight-scaled row targets
    grid: Grid
    weights: Weights

    def _rows_apply(self, x: torch.Tensor) -> torch.Tensor:
        """B x: [grid] → [n, R] per-sample row values."""
        xc = x.reshape(-1)[self.corner_idx]                     # [n, C]
        return torch.einsum("nrc,nc->nr", self.rows64, xc)

    def _scatter(self, y: torch.Tensor) -> torch.Tensor:
        """Bᵀ y: [n, R] row values → [*grid], one float64 index_add_."""
        contrib = torch.einsum("nrc,nr->nc", self.rows64, y)    # [n, C]
        out = torch.zeros(self.grid.num_nodes, dtype=torch.float64,
                          device=contrib.device)
        out.index_add_(0, self.corner_idx.reshape(-1), contrib.reshape(-1))
        return out.reshape(self.grid.shape)

    def residual64(self, x: torch.Tensor) -> torch.Tensor:
        """r = b − A x in least-squares form −S x + Bᵀ(t − B x), all float64."""
        s = stencils.smoothness_apply(x, self.weights, self.grid.ndim)
        return self._scatter(self.tw64 - self._rows_apply(x)) - s

    def apply64_delta(self, d: torch.Tensor) -> torch.Tensor:
        """A d = S d + Bᵀ B d in float64, for a refinement correction d."""
        s = stencils.smoothness_apply(d, self.weights, self.grid.ndim)
        return s + self._scatter(self._rows_apply(d))


def assemble_precise(
    grid: Grid,
    weights: Weights,
    positions: torch.Tensor,
    values: torch.Tensor,
    gradients: Optional[torch.Tensor] = None,
    point_weights: Optional[torch.Tensor] = None,
) -> PreciseProblem:
    """Assemble for the mixed-precision refined solve: a float32 problem from
    the float32-rounded inputs, and float64 rows from the inputs as given
    (float32 inputs cast exactly, so the rows equal the reference's)."""
    f32, f64 = torch.float32, torch.float64
    n = positions.shape[0]
    dev = positions.device
    pw = (torch.ones((n,), dtype=f64, device=dev) if point_weights is None
          else point_weights.to(f64))
    with_gradient = gradients is not None
    corner_idx, row_coeffs, in_bounds = cons.multilinear_corner_data(
        grid, positions.to(f64))
    row_w = cons.sample_row_weights(weights, in_bounds, pw, grid.ndim,
                                    with_gradient)
    if with_gradient:
        row_t = torch.cat([values[:, None].to(f64), gradients.to(f64)], dim=1)
    else:
        row_coeffs = row_coeffs[:, :1, :]
        row_w = row_w[:, :1]
        row_t = values[:, None].to(f64)
    rows64 = row_coeffs * row_w[:, :, None]
    tw = row_t * row_w
    p32 = assemble(grid, weights, positions.to(f32), values.to(f32),
                   gradients=None if gradients is None else gradients.to(f32),
                   point_weights=pw.to(f32))
    pp = PreciseProblem(p32=p32, b64=torch.zeros(grid.shape, dtype=f64, device=dev),
                        corner_idx=corner_idx, rows64=rows64, tw64=tw,
                        grid=grid, weights=weights)
    return dataclasses.replace(pp, b64=pp._scatter(tw))  # b64 = residual64(0)


def sdf_from_points_precise(
    grid: Grid,
    weights: Weights,
    positions: torch.Tensor,
    normals: torch.Tensor,
    point_weights: Optional[torch.Tensor] = None,
    config: SolverConfig = SolverConfig(),
    x0: Optional[torch.Tensor] = None,
    fmg_start: bool | int = False,
) -> tuple[torch.Tensor, SolveInfo]:
    """SDF reconstruction to a TRUE ≤ tol relative residual against the
    float64 normal equations: float64 rows + float32 PCG inner solves +
    float64 iterative refinement. Returns (field float64, SolveInfo).
    ``fmg_start`` as in `sdf_from_points` (the guess is the refinement's
    warm start)."""
    if fmg_start and x0 is None:
        x0 = _fmg_guess(grid, weights, positions, normals, point_weights,
                        config, depth=int(fmg_start))
    zeros = torch.zeros(positions.shape[0], dtype=torch.float32,
                        device=positions.device)
    p64 = assemble_precise(grid, weights, positions, zeros, gradients=normals,
                           point_weights=point_weights)
    return solve_refined(p64, config, x0=x0)
