"""Top-level entry points: SDF from oriented points and value interpolation
(torch).

Counterpart of ``field_interpolation_tpu.sdf``: `sdf_from_points` and
`interpolate` (float32 assembly + PCG), `sdf_from_points_precise` and
`interpolate_precise` (float32 problem + matter-free float64 system +
float64 refinement), each with the nested-iteration start `fmg_start`
(`_fmg_guess`, `_fmg_guess_interp`); `sample_field` and
`sample_field_gradient` read a solved field back at continuous positions.
The H100 has native float64, so `PreciseProblem` keeps its float64 rows and
scatter in plain float64: none of the reference's double-float or
integer-grid emulation is needed.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from . import constraints as cons
from . import debugging, stencils
from .grid import Grid
from .multigrid import prolong
from .operators import Problem, assemble, assemble_lanes, check_inputs, validate_problem
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
    that many levels. The coarse iterations are not counted in SolveInfo.
    ``config.debug=True`` runs the checked pipeline (`_debug_pipeline`)."""
    # The fmg guess comes before the debug dispatch, so debug mode checks
    # the pipeline production runs (the fine solve from the guess).
    if fmg_start and x0 is None:
        x0 = _fmg_guess(grid, weights, positions, normals, point_weights,
                        config, depth=int(fmg_start))
    if config.debug:
        return _debug_pipeline(grid, weights, positions, normals=normals,
                               point_weights=point_weights, config=config, x0=x0,
                               sdf=True)
    problem = assemble_sdf(grid, weights, positions, normals, point_weights)
    return solve(problem, config, x0=x0)


def _debug_pipeline(grid, weights, positions, *, values=None, normals=None,
                    point_weights, config, x0, sdf):
    """Checked assemble + solve (debugging.py), in the reference's order:
    the inputs before assembly (which zero-weights out-of-lattice rows
    silently, so no later check could see them), assembly, the solve with
    ``backend="xla"`` (the reference's choice), the field, then the
    assembled problem (`validate_problem`)."""
    debugging.check_sample_inputs(grid, positions, values=values, gradients=normals,
                                  point_weights=point_weights)
    if sdf:
        problem = assemble_sdf(grid, weights, positions, normals, point_weights)
    else:
        problem = assemble_interpolation(grid, weights, positions, values, point_weights)
    x, info = solve(problem, dataclasses.replace(config, debug=False, backend="xla"),
                    x0=x0)
    debugging.check_solution(x)
    issues = validate_problem(problem)
    if issues:
        raise ValueError("validate_problem: " + "; ".join(issues))
    return x, info


@dataclasses.dataclass(frozen=True)
class PreciseProblem:
    """Mixed-precision problem for solver.solve_refined: the float32 problem
    (densified data stencil, the kernels' path) plus a float64 system kept
    MATTER-FREE as per-sample weighted rows. A batch of problems
    (``batch.assemble_precise_batch``) has a leading lane axis on every
    tensor leaf, its own included: each lane's float64 rows act on that
    lane's field."""

    p32: Problem
    b64: torch.Tensor          # [*grid] float64, Aᵀb of the f64 system
    corner_idx: torch.Tensor   # [n, 2^D] int64
    rows64: torch.Tensor       # [n, R, 2^D] float64, weight-scaled row coeffs
    tw64: torch.Tensor         # [n, R] float64, weight-scaled row targets
    grid: Grid
    weights: Weights

    def _lanes(self) -> tuple[int, ...]:
        """The leading lane axes of a batched problem (``batch``), or ()."""
        return tuple(self.corner_idx.shape[:-2])

    def _rows_apply(self, x: torch.Tensor) -> torch.Tensor:
        """B x: [grid] → [n, R] per-sample row values (each lane's own)."""
        lanes = self._lanes()
        if lanes:
            flat = x.reshape(lanes + (-1,))
            xc = torch.gather(flat, -1, self.corner_idx.reshape(lanes + (-1,))
                              ).reshape(self.corner_idx.shape)  # [B, n, C]
            return torch.einsum("...nrc,...nc->...nr", self.rows64, xc)
        xc = x.reshape(-1)[self.corner_idx]                     # [n, C]
        return torch.einsum("nrc,nc->nr", self.rows64, xc)

    def _scatter(self, y: torch.Tensor) -> torch.Tensor:
        """Bᵀ y: [n, R] row values → [*grid], one float64 index_add_ (over
        [B·N] with each lane's indices offset by its block for lanes)."""
        lanes = self._lanes()
        N = self.grid.num_nodes
        contrib = torch.einsum("...nrc,...nr->...nc", self.rows64, y)  # [n, C]
        out = torch.zeros(math.prod(lanes) * N, dtype=torch.float64,
                          device=contrib.device)
        idx = self.corner_idx
        if lanes:
            idx = idx + (torch.arange(math.prod(lanes), device=idx.device)
                         .reshape(lanes + (1, 1)) * N)
        out.index_add_(0, idx.reshape(-1), contrib.reshape(-1))
        return out.reshape(lanes + self.grid.shape)

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
    check_inputs(grid, positions, values, gradients, point_weights)
    return assemble_precise_lanes(grid, weights, positions, values, gradients,
                                  point_weights)


def assemble_precise_lanes(grid: Grid, weights: Weights, positions: torch.Tensor,
                           values: torch.Tensor, gradients: Optional[torch.Tensor],
                           point_weights: Optional[torch.Tensor]) -> PreciseProblem:
    """`assemble_precise` over any leading lane axes of its inputs
    (positions [*lanes, n, D]; ``batch.assemble_precise_batch``)."""
    f32, f64 = torch.float32, torch.float64
    dev = positions.device
    pw = (torch.ones(positions.shape[:-1], dtype=f64, device=dev)
          if point_weights is None else point_weights.to(f64))
    with_gradient = gradients is not None
    corner_idx, row_coeffs, in_bounds = cons.multilinear_corner_data(
        grid, positions.to(f64))
    row_w = cons.sample_row_weights(weights, in_bounds, pw, grid.ndim,
                                    with_gradient)
    if with_gradient:
        row_t = torch.cat([values[..., None].to(f64), gradients.to(f64)], dim=-1)
    else:
        row_coeffs = row_coeffs[..., :1, :]
        row_w = row_w[..., :1]
        row_t = values[..., None].to(f64)
    rows64 = row_coeffs * row_w[..., None]
    tw = row_t * row_w
    p32 = assemble_lanes(grid, weights, positions.to(f32), values.to(f32),
                         None if gradients is None else gradients.to(f32),
                         pw.to(f32))
    lanes = tuple(positions.shape[:-2])
    pp = PreciseProblem(p32=p32, b64=torch.zeros(lanes + grid.shape, dtype=f64,
                                                 device=dev),
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


def assemble_interpolation(
    grid: Grid,
    weights: Weights,
    positions: torch.Tensor,                  # [n, D]
    values: torch.Tensor,                     # [n]
    point_weights: Optional[torch.Tensor] = None,
) -> Problem:
    """Value-only scattered interpolation: one value row per sample.
    Assembles in float32 on the device of ``positions``."""
    f32 = torch.float32
    return assemble(grid, weights, positions.to(f32), values.to(f32),
                    point_weights=None if point_weights is None
                    else point_weights.to(f32))


def _fmg_guess_interp(grid: Grid, weights: Weights, positions, values,
                      point_weights, config: SolverConfig,
                      depth: int = 1) -> Optional[torch.Tensor]:
    """`_fmg_guess` for value interpolation: the prolonged half-resolution
    solve, not rescaled (values are values, unlike lattice distances)."""
    cshape = tuple(max(2, (n + 1) // 2) for n in grid.shape)
    if cshape == grid.shape:
        return None
    cgrid = Grid(cshape)
    scale = ((np.asarray(cshape, np.float64) - 1.0)
             / (np.asarray(grid.shape, np.float64) - 1.0))
    cpos = positions * torch.as_tensor(scale, dtype=positions.dtype,
                                       device=positions.device)
    cprob = assemble_interpolation(cgrid, weights, cpos, values, point_weights)
    ccfg = dataclasses.replace(config, tol=max(1e-3, config.tol), debug=False)
    cx0 = None
    if depth > 1:
        cx0 = _fmg_guess_interp(cgrid, weights, cpos, values, point_weights,
                                config, depth - 1)
    xc, _ = solve(cprob, ccfg, x0=cx0)
    return prolong(xc, grid.shape)


def interpolate(
    grid: Grid,
    weights: Weights,
    positions: torch.Tensor,
    values: torch.Tensor,
    point_weights: Optional[torch.Tensor] = None,
    config: SolverConfig = SolverConfig(),
    x0: Optional[torch.Tensor] = None,
    fmg_start: bool | int = False,
) -> tuple[torch.Tensor, SolveInfo]:
    """Interpolate scattered values onto the lattice. Returns (field
    [*grid.shape] float32, SolveInfo); warm start via ``x0``; ``fmg_start``
    as in `sdf_from_points` (`_fmg_guess_interp`); ``config.debug=True``
    runs the checked pipeline (`_debug_pipeline`)."""
    if fmg_start and x0 is None:
        x0 = _fmg_guess_interp(grid, weights, positions, values, point_weights,
                               config, depth=int(fmg_start))
    if config.debug:
        return _debug_pipeline(grid, weights, positions, values=values,
                               point_weights=point_weights, config=config, x0=x0,
                               sdf=False)
    problem = assemble_interpolation(grid, weights, positions, values, point_weights)
    return solve(problem, config, x0=x0)


def interpolate_precise(
    grid: Grid,
    weights: Weights,
    positions: torch.Tensor,
    values: torch.Tensor,
    point_weights: Optional[torch.Tensor] = None,
    config: SolverConfig = SolverConfig(),
    x0: Optional[torch.Tensor] = None,
    fmg_start: bool | int = False,
) -> tuple[torch.Tensor, SolveInfo]:
    """Value interpolation to a TRUE ≤ tol relative residual against the
    float64 normal equations (`assemble_precise` without gradient rows,
    then `solve_refined`). Returns (field float64, SolveInfo). ``fmg_start``
    as in `interpolate` (the guess is the refinement's warm start)."""
    if fmg_start and x0 is None:
        x0 = _fmg_guess_interp(grid, weights, positions, values, point_weights,
                               config, depth=int(fmg_start))
    pp = assemble_precise(grid, weights, positions, values,
                          point_weights=point_weights)
    return solve_refined(pp, config, x0=x0)


def _sample(grid: Grid, field: torch.Tensor, positions: torch.Tensor, rows: slice):
    """(Σ_c field[corner c] · row_coeffs[:, rows, c], finite mask): the
    multilinear rows of ``rows`` at ``positions`` (clamped to the lattice),
    summed as plain products in the field's dtype (no matmul, so no TF32)."""
    corner_idx, row_coeffs, _ = cons.multilinear_corner_data(
        grid, positions.to(field.dtype))
    corners = field.reshape(-1)[corner_idx]                   # [n, C]
    out = torch.sum(corners[:, None, :] * row_coeffs[:, rows, :], dim=-1)
    return out, torch.all(torch.isfinite(positions), dim=-1)


def sample_field(grid: Grid, field: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    """Multilinear interpolation of a solved field at continuous positions
    [n, D] → values [n], with the corner weights of the value rows
    (SPEC.md §3). Positions outside the lattice are clamped to it;
    non-finite positions give NaN. Differentiable in field and positions."""
    vals, finite = _sample(grid, field, positions, slice(0, 1))
    return torch.where(finite, vals[:, 0], torch.full_like(vals[:, 0], float("nan")))


def sample_field_gradient(grid: Grid, field: torch.Tensor,
                          positions: torch.Tensor) -> torch.Tensor:
    """Gradient of the multilinearly interpolated field at continuous
    positions [n, D] → [n, D]: the finite-difference gradient the gradient
    rows assert (SPEC.md §4). Clamped and NaN as `sample_field`."""
    grads, finite = _sample(grid, field, positions, slice(1, None))
    return torch.where(finite[:, None], grads, torch.full_like(grads, float("nan")))
