"""The matrix-free normal operator and problem assembly (plain torch).

Counterpart of ``field_interpolation_tpu.operators``: ``A x = S x + (DᵀWD) x``
with ``S`` the smoothness normal operator (stencils.py) and ``DᵀWD`` the
scattered-data normal operator densified at assembly into a spatially
varying 3^D stencil (constraints.py); ``b = Aᵀ rhs`` is a grid.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import constraints as cons
from . import stencils
from .grid import Grid
from .ops._build import ensure_full_fp32
from .weights import Weights


@dataclasses.dataclass(frozen=True)
class Problem:
    """Assembled normal-equations problem ``A x = b``."""

    coeff: torch.Tensor       # [3^D, *grid] densified data-term stencil
    b: torch.Tensor           # [*grid] Aᵀb
    diag: torch.Tensor        # [*grid] diag(A), for Jacobi/multigrid
    grid: Grid
    weights: Weights

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """A x. ``x``: [..., *grid] (leading axes = batch)."""
        s = stencils.smoothness_apply(x, self.weights, self.grid.ndim)
        return s + cons.data_apply(x, self.coeff, self.grid.ndim)


def assemble(
    grid: Grid,
    weights: Weights,
    positions: torch.Tensor,                      # [n, D]
    values: torch.Tensor,                         # [n] value-row targets
    gradients: Optional[torch.Tensor] = None,     # [n, D] gradient-row targets
    point_weights: Optional[torch.Tensor] = None,  # [n]
) -> Problem:
    """Vectorized assembly of the full normal-equations problem, in the
    dtype and on the device of ``positions``. Zero-weight samples act as
    padding, so callers can use fixed-size arrays."""
    check_inputs(grid, positions, values, gradients, point_weights)
    return assemble_lanes(grid, weights, positions, values, gradients, point_weights)


def check_inputs(grid: Grid, positions: torch.Tensor, values: torch.Tensor,
                 gradients: Optional[torch.Tensor],
                 point_weights: Optional[torch.Tensor]) -> None:
    """Raise ValueError unless the inputs are one field's: positions [n, D],
    values [n], gradients [n, D], point_weights [n]."""
    if positions.ndim != 2 or positions.shape[-1] != grid.ndim:
        raise ValueError(
            f"positions must be [n, {grid.ndim}] for grid {grid.shape}, "
            f"got {tuple(positions.shape)}")
    n = positions.shape[0]
    if tuple(values.shape) != (n,):
        raise ValueError(f"values must be [{n}], got {tuple(values.shape)}")
    if gradients is not None and tuple(gradients.shape) != (n, grid.ndim):
        raise ValueError(
            f"gradients must be [{n}, {grid.ndim}], got {tuple(gradients.shape)}")
    if point_weights is not None and tuple(point_weights.shape) != (n,):
        raise ValueError(
            f"point_weights must be [{n}], got {tuple(point_weights.shape)}")


def assemble_lanes(grid: Grid, weights: Weights, positions: torch.Tensor,
                   values: torch.Tensor, gradients: Optional[torch.Tensor],
                   point_weights: Optional[torch.Tensor]) -> Problem:
    """`assemble` without its shape checks, over any leading lane axes:
    positions [*lanes, n, D] give a Problem whose leaves lead with the lanes
    (``batch.assemble_batch``: [B, 3^D, *grid], [B, *grid]), all lanes in
    one scatter."""
    ensure_full_fp32(positions.device)
    dtype, dev = positions.dtype, positions.device
    if point_weights is None:
        point_weights = torch.ones(positions.shape[:-1], dtype=dtype, device=dev)
    with_gradient = gradients is not None

    corner_idx, row_coeffs, in_bounds = cons.multilinear_corner_data(grid, positions)
    row_w = cons.sample_row_weights(weights, in_bounds, point_weights.to(dtype),
                                    grid.ndim, with_gradient)
    if with_gradient:
        row_t = torch.cat([values[..., None].to(dtype), gradients.to(dtype)], dim=-1)
    else:
        row_coeffs = row_coeffs[..., :1, :]
        row_w = row_w[..., :1]
        row_t = values[..., None].to(dtype)

    coeff, b = cons.densify_data_term(grid, corner_idx, row_coeffs, row_w, row_t)
    diag = (stencils.smoothness_diag(grid.shape, weights, dtype=dtype, device=dev)
            + cons.data_diag(coeff, grid.ndim))
    return Problem(coeff=coeff, b=b, diag=diag, grid=grid, weights=weights)


def validate_problem(problem: Problem) -> list[str]:
    """Sanity checks of an assembled problem (the reference's
    operators.py:101-125, the same checks and messages). Returns a list of
    human-readable issues (empty = healthy); each check reads one flag back
    from the problem's device."""
    issues = []
    coeff, b, diag = problem.coeff, problem.b, problem.diag
    if not bool(torch.isfinite(coeff).all()):
        issues.append("non-finite entries in the data coefficient tensor")
    if not bool(torch.isfinite(b).all()):
        issues.append("non-finite entries in b")
    if bool((diag < 0).any()):
        issues.append("negative operator diagonal (operator not SPD)")
    if bool((diag == 0).all()):
        issues.append("all-zero diagonal: no constraints at all?")
    center = (3 ** problem.grid.ndim) // 2
    if bool((coeff[center] < -1e-6 * max(1.0, float(coeff.abs().max()))).any()):
        issues.append("negative data-term diagonal entries (bad row weights?)")
    if problem.weights.active_orders() == () and not bool(coeff.any()):
        issues.append("no smoothness weights and no data: singular system")
    return issues
