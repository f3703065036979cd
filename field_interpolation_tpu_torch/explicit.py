"""Explicit row-by-row assembly and sparse solves on the device.

The port's counterpart of ``field_interpolation_tpu.explicit``: the
reference library's own API, row for row (`LinearEquation`/`Triplet` and
``add_equation``, `add_value_constraint`, `add_gradient_constraint`,
`add_field_constraints`, `solve_sparse_linear`,
`solve_sparse_linear_with_guess`, `solve_sparse_linear_approximate_lattice`),
for users who move from the upstream library or write rows of their own.
The rows equal the reference's: the same order, the same columns, the same
float64 values (``rows.py`` builds them, shared with ``native``).

The production path stays matrix-free (operators.py, solver.py); these
rows are materialized. Where a function takes tensors it runs on their
device; where it takes arrays or sequences, or builds rows from nothing,
it takes ``device=``, which is ``cuda`` unless the caller names another
and raises without a card.

Differences from the reference, by design: `LinearEquation.to_sparse` in
place of ``to_scipy`` (a float64 ``torch.sparse_csr`` A and a dense b on
the device), and the direct solve is a dense float64 LU (as SciPy's
``spsolve``, an LU) held to `DIRECT_MAX_UNKNOWNS`: PyTorch's sparse direct
solve needs a build with cuDSS, which the H100 host's PyTorch lacks.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from .grid import Grid
from .rows import (F64, RowBuffer, as64, coarse_lattice, conjugate_gradient, data_rows,
                   field_rows, input_device, model_weights, multilinear_resize,
                   quiet_sparse, resolve_device, sample_rows)
from .rows import normal_equations as _normal_equations
from .weights import Weights

# The dense LU holds AᵀA and its factors, two float64 n² matrices: 68.7 GB
# at 65536 unknowns (256²), which an 80 GB H100 holds.
DIRECT_MAX_UNKNOWNS = 65536


@dataclasses.dataclass
class Triplet:
    row: int
    col: int
    value: float


class LinearEquation:
    """Sparse least-squares rows ``min ||Ax - b||²`` under construction, on
    ``device`` (``cuda`` unless named; raises without a card). Rows added
    one at a time wait in a host buffer; the whole-lattice and per-sample
    adders' rows arrive as tensors; all keep one global row order."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._rows = RowBuffer(self.device)

    @property
    def num_rows(self) -> int:
        return self._rows.num_rows

    def add_equation(self, weight: float, rhs: float,
                     indices: Sequence[int], coeffs: Sequence[float]) -> None:
        """Append one weighted row; a row of weight 0 is not added, zero
        coefficients are skipped, ``rhs`` is scaled by the weight."""
        self._rows.add_equation(weight, rhs, indices, coeffs)

    def export_rows(self):
        """(rows, cols, values, rhs) tensors on the device, in row order."""
        return tuple(self._rows.export())

    @property
    def triplets(self) -> list[Triplet]:
        """The rows' entries as the reference's `Triplet` list (a host copy)."""
        row, col, val, _ = self._rows.export()
        return [Triplet(r, c, v) for r, c, v in zip(row.tolist(), col.tolist(),
                                                     val.tolist())]

    @property
    def rhs(self) -> list[float]:
        """The weighted right-hand sides (a host copy)."""
        return self._rows.export().rhs.tolist()

    def to_sparse(self, num_columns: int, device=None):
        """(A, b): A a float64 ``torch.sparse_csr`` matrix [rows, num_columns]
        (duplicate entries summed, as SciPy's ``csr_matrix`` does), b dense,
        on ``device`` (the equation's unless named)."""
        row, col, val, rhs = self._rows.export()
        dev = self.device if device is None else torch.device(device)
        with quiet_sparse():
            a = torch.sparse_coo_tensor(torch.stack([row, col]), val,
                                        (self.num_rows, num_columns)).coalesce()
            return a.to_sparse_csr().to(dev), rhs.to(dev)


def add_value_constraint(eq: LinearEquation, grid: Grid, pos, value: float,
                         weight: float) -> None:
    """One row: the multilinear interpolation at ``pos`` equals ``value``
    (nothing when ``pos`` is outside the grid or not finite, or weight 0)."""
    pos = torch.as_tensor(pos, dtype=F64).reshape(1, grid.ndim)
    val, w = torch.tensor([[float(value)], [float(weight)]], dtype=F64, device=pos.device)
    eq._rows.add_host_rows(sample_rows(grid, pos, values=val, value_weight=w))


def add_gradient_constraint(eq: LinearEquation, grid: Grid, pos, gradient,
                            weight: float) -> None:
    """D rows: the exact partials of the multilinear interpolant at ``pos``
    equal ``gradient``."""
    pos = torch.as_tensor(pos, dtype=F64).reshape(1, grid.ndim)
    grad = torch.as_tensor(gradient, dtype=F64, device=pos.device).reshape(1, grid.ndim)
    w = torch.tensor([float(weight)], dtype=F64, device=pos.device)
    eq._rows.add_host_rows(sample_rows(grid, pos, gradients=grad, gradient_weight=w))


def add_field_constraints(eq: LinearEquation, grid: Grid, weights: Weights) -> None:
    """Smoothness rows: order 0 once per node; orders 1-3 per axis for every
    stencil window fully inside the grid (dropped-row boundaries), built in
    one pass on the equation's device."""
    eq._rows.append(field_rows(grid, model_weights(weights), eq.device))


def assemble_explicit(
    grid: Grid,
    weights: Weights,
    positions,
    values,
    gradients=None,
    point_weights=None,
    device=None,
) -> LinearEquation:
    """The full explicit system for the same inputs as ``operators.assemble``:
    the smoothness rows, then per sample its value row and D gradient rows.
    Runs on the inputs' device if they are tensors, else on ``device``."""
    dev = input_device(positions, values, gradients, point_weights, device=device)
    eq = LinearEquation(dev)
    add_field_constraints(eq, grid, weights)
    eq._rows.append(data_rows(grid, weights, positions, values, gradients, point_weights,
                              dev))
    return eq


def normal_equations(eq: LinearEquation, num_columns: int):
    """AᵀA (float64 ``torch.sparse_csr``) and Aᵀb on the equation's device."""
    return _normal_equations(eq._rows.export(), num_columns)


def solve_sparse_linear(num_columns: int, eq: LinearEquation) -> torch.Tensor:
    """Direct float64 normal-equations solve: a dense LU of AᵀA on the
    equation's device, up to `DIRECT_MAX_UNKNOWNS` unknowns (ValueError
    above it, before anything is assembled)."""
    if num_columns > DIRECT_MAX_UNKNOWNS:
        raise ValueError(
            f"solve_sparse_linear is a dense float64 LU, held to {DIRECT_MAX_UNKNOWNS} "
            f"unknowns (two n² float64 matrices on the device); got {num_columns}: use "
            "solve_sparse_linear_with_guess or native.NativeEquation.solve")
    ata, atb = normal_equations(eq, num_columns)
    return torch.linalg.solve(ata.to_dense(), atb)


def solve_sparse_linear_with_guess(num_columns: int, eq: LinearEquation,
                                   guess, tol: float = 1e-10,
                                   maxiter: int = 10000) -> torch.Tensor:
    """Warm-started CG in float64 on AᵀA x = Aᵀb with SciPy's ``cg`` rules
    (no preconditioner, stop once ‖r‖ < tol·‖b‖); like SciPy it returns x
    after ``maxiter`` iterations whether or not it converged."""
    ata, atb = normal_equations(eq, num_columns)
    x, _, _ = conjugate_gradient(ata, atb, as64(guess, eq.device), tol=tol,
                                 maxiter=maxiter, jacobi=False)
    return x


def solve_sparse_linear_approximate_lattice(
    grid: Grid, weights: Weights, positions, values,
    gradients=None, point_weights=None, downscale: int = 2, device=None,
) -> torch.Tensor:
    """Solve on a downsampled lattice, then upsample multilinearly: coarse
    sizes max(2, (n - 1) // downscale + 1), positions scaled per axis by
    (cn - 1)/(fn - 1), gradient targets divided by that scale, the coarse
    system solved directly. Returns the flat field (coarse value units)."""
    dev = input_device(positions, values, gradients, point_weights, device=device)
    coarse, pos, grads = coarse_lattice(grid, positions, gradients, downscale, dev)
    eq = assemble_explicit(coarse, weights, pos, as64(values, dev), grads,
                           None if point_weights is None else as64(point_weights, dev))
    xc = solve_sparse_linear(coarse.num_nodes, eq).reshape(coarse.shape)
    return _multilinear_resize(xc, grid.shape).reshape(-1)


def _linspace_sources(n_in: int, n_out: int) -> np.ndarray:
    return np.linspace(0.0, n_in - 1.0, n_out)


def _multilinear_resize(x: torch.Tensor, out_shape: tuple[int, ...]) -> torch.Tensor:
    """Separable linear resample with end points aligned, sources from
    ``np.linspace`` as in the reference's."""
    return multilinear_resize(x, out_shape, _linspace_sources)
