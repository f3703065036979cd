"""Reusable-setup interactive solver: the reference GUI's frame loop (torch).

Counterpart of ``field_interpolation_tpu.session``. The GUI re-solves the
SAME geometry every frame while the user edits values or normals, so only
the right-hand side changes. A cold `sdf_from_points` per frame re-pays the
assembly's geometry (corner rows, the densified data stencil, the operator
diagonal) and the multigrid setup (hierarchy, dense coarsest inverse, kernel
operands). `Solver` builds all of that once at construction, on the device
of the positions; each `Solver.solve` call rebuilds only ``b`` from the new
targets (one small einsum and one ``index_add_``) and runs the solve with
the prepared setup (`solver.prepare`, `multigrid.MGPrep`).

The reusable state belongs to the object and is keyed to inputs that cannot
change under it: new positions or weights mean a new `Solver`. A per-call
config is held to the construction's by `solver._check_prep`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import constraints as cons
from . import stencils
from .grid import Grid
from .operators import Problem
from .ops._build import ensure_full_fp32
from .sdf import PreciseProblem
from .solver import SolveInfo, prepare, solve, solve_refined
from .weights import SolverConfig, Weights


@dataclasses.dataclass(frozen=True)
class _Geometry:
    """What assembly derives from positions and weights alone (no targets):
    the weighted data rows and the operator. ``rows64`` / ``row_w64`` only
    for precise sessions."""

    corner_idx: torch.Tensor           # [n, C] int64
    rows32: torch.Tensor               # [n, R, C] float32 weighted rows (B·w)
    row_w32: torch.Tensor              # [n, R] float32 row weights
    coeff: torch.Tensor                # [3^D, *grid] float32 data stencil
    diag: torch.Tensor                 # [*grid] float32 operator diagonal
    rows64: Optional[torch.Tensor]     # [n, R, C] float64 weighted rows
    row_w64: Optional[torch.Tensor]    # [n, R] float64 row weights
    grid: Grid
    weights: Weights
    with_gradient: bool


def _rows(grid: Grid, weights: Weights, positions, point_weights, with_gradient):
    """(corner_idx, row_coeffs, row weights) in the dtype of ``positions``,
    the value row only unless ``with_gradient``."""
    corner_idx, row_coeffs, in_bounds = cons.multilinear_corner_data(grid, positions)
    row_w = cons.sample_row_weights(weights, in_bounds, point_weights, grid.ndim,
                                    with_gradient)
    if not with_gradient:
        row_coeffs, row_w = row_coeffs[:, :1, :], row_w[:, :1]
    return corner_idx, row_coeffs, row_w


def _build_geometry(grid: Grid, weights: Weights, positions: torch.Tensor,
                    point_weights: torch.Tensor, with_gradient: bool,
                    precise: bool) -> _Geometry:
    """The target-independent part of `operators.assemble` (and, with
    ``precise``, the float64 rows of `sdf.assemble_precise`), once. The data
    stencil is densified with zero targets; its b plane is discarded."""
    f32, f64 = torch.float32, torch.float64
    ensure_full_fp32(positions.device)
    corner_idx, row_coeffs, row_w = _rows(grid, weights, positions.to(f32),
                                          point_weights.to(f32), with_gradient)
    coeff, _ = cons.densify_data_term(grid, corner_idx, row_coeffs, row_w,
                                      torch.zeros_like(row_w))
    diag = (stencils.smoothness_diag(grid.shape, weights, dtype=f32,
                                     device=positions.device)
            + cons.data_diag(coeff, grid.ndim))
    rows64 = row_w64 = None
    if precise:
        _, rc64, row_w64 = _rows(grid, weights, positions.to(f64),
                                 point_weights.to(f64), with_gradient)
        rows64 = rc64 * row_w64[:, :, None]
    return _Geometry(corner_idx=corner_idx, rows32=row_coeffs * row_w[:, :, None],
                     row_w32=row_w, coeff=coeff, diag=diag, rows64=rows64,
                     row_w64=row_w64, grid=grid, weights=weights,
                     with_gradient=with_gradient)


def _scatter(geo: _Geometry, rows: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """Bᵀ (W t): the weighted rows' targets scattered onto the grid in one
    ``index_add_`` (the reference scatters with an einsum and a gated
    matmul: the order of the additions differs)."""
    bvec = torch.einsum("nrc,nr->nc", rows, tw)
    out = torch.zeros(geo.grid.num_nodes, dtype=bvec.dtype, device=bvec.device)
    out.index_add_(0, geo.corner_idx.reshape(-1), bvec.reshape(-1))
    return out.reshape(geo.grid.shape)


def _assemble_b32(geo: _Geometry, row_t: torch.Tensor) -> torch.Tensor:
    """b = Bᵀ W t from new targets: the only assembly a re-solve pays."""
    return _scatter(geo, geo.rows32, row_t.to(torch.float32) * geo.row_w32)


def _row_targets(geo: _Geometry, values: torch.Tensor, gradients) -> torch.Tensor:
    """[n, R] row targets: the values, then the gradients' D columns."""
    dev = geo.coeff.device
    values = torch.as_tensor(values, device=dev)
    if geo.with_gradient:
        if gradients is None:
            raise ValueError("this Solver was built with gradient rows — "
                             "pass gradients (e.g. normals)")
        gradients = torch.as_tensor(gradients, device=dev)
        dt = torch.promote_types(values.dtype, gradients.dtype)
        return torch.cat([values[:, None].to(dt), gradients.to(dt)], dim=1)
    return values[:, None]


def _problem32(geo: _Geometry, row_t: torch.Tensor) -> Problem:
    return Problem(coeff=geo.coeff, b=_assemble_b32(geo, row_t), diag=geo.diag,
                   grid=geo.grid, weights=geo.weights)


def _resolve32(geo: _Geometry, values, gradients, x0, prep, config: SolverConfig):
    """One float32 frame: the new b, then `solve` with the prep."""
    row_t = _row_targets(geo, values, gradients)
    return solve(_problem32(geo, row_t), config, x0=x0, prep=prep)


def _resolve_precise(geo: _Geometry, values, gradients, x0, prep,
                     config: SolverConfig):
    """One precise frame: the new float32 and float64 right-hand sides, then
    `solve_refined` with the prep on the session's float64 rows."""
    row_t = _row_targets(geo, values, gradients)
    tw64 = row_t.to(torch.float64) * geo.row_w64
    pp = PreciseProblem(p32=_problem32(geo, row_t), b64=_scatter(geo, geo.rows64, tw64),
                        corner_idx=geo.corner_idx, rows64=geo.rows64, tw64=tw64,
                        grid=geo.grid, weights=geo.weights)
    return solve_refined(pp, config, x0=x0, prep=prep)


class Solver:
    """Per-session solver with reusable setup (see the module docstring).

    >>> s = Solver(grid, weights, positions, config=cfg)      # once
    >>> x, info = s.solve(values, gradients=normals)          # per frame
    >>> x, info = s.solve(values2, gradients=normals, x0=x)   # warm start

    ``precise=True`` solves every frame to a TRUE ≤ tol relative residual
    (`sdf_from_points_precise` semantics) and keeps the float64 rows for
    the session. ``gradients=False`` builds a value-only session
    (`interpolate` semantics). Construction pays the geometry and the
    multigrid setup once; each ``solve`` pays the right-hand side and the
    iterations. Positions, weights, point weights and the setup-relevant
    config (`multigrid.setup_signature`) are fixed for the object's life;
    tol, maxiter and the rest may change per call via ``config=``."""

    def __init__(self, grid: Grid, weights: Weights, positions: torch.Tensor,
                 point_weights: Optional[torch.Tensor] = None, *,
                 gradients: bool = True, config: SolverConfig = SolverConfig(),
                 precise: bool = False):
        n = positions.shape[0]
        if positions.ndim != 2 or positions.shape[-1] != grid.ndim:
            raise ValueError(
                f"positions must be [n, {grid.ndim}] for grid {grid.shape}, "
                f"got {tuple(positions.shape)}")
        if point_weights is None:
            point_weights = torch.ones((n,), dtype=torch.float32, device=positions.device)
        self.grid, self.weights, self.config = grid, weights, config
        self.precise = precise
        self.n = n
        self._geo = _build_geometry(grid, weights, positions, point_weights,
                                    gradients, precise)
        p_setup = Problem(coeff=self._geo.coeff, b=torch.zeros_like(self._geo.diag),
                          diag=self._geo.diag, grid=grid, weights=weights)
        self._prep = prepare(p_setup, config)

    def solve(self, values, gradients=None, x0: Optional[torch.Tensor] = None,
              config: Optional[SolverConfig] = None) -> tuple[torch.Tensor, SolveInfo]:
        """Solve for new targets on the fixed geometry. ``values`` [n];
        ``gradients`` [n, D] when the session has gradient rows (SDF
        normals); ``x0`` warm-starts from an earlier frame's field;
        ``config`` overrides per call where the setup signature matches
        construction's (else ``ValueError``)."""
        cfg = self.config if config is None else config
        if self.precise:
            return _resolve_precise(self._geo, values, gradients, x0, self._prep, cfg)
        return _resolve32(self._geo, values, gradients, x0, self._prep, cfg)
