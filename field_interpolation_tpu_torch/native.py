"""The reference's native engine surface, on the port's own torch engine.

The port's counterpart of ``field_interpolation_tpu.native`` (ctypes
bindings to ``native/field_interpolation.cpp``): `NativeEquation` with its
batched adders and its float64 Jacobi-PCG solve, `sdf_from_points_native`
and `solve_approximate_lattice_native`. Nothing here loads the C++
library: the rows come from ``rows.py`` (shared with ``explicit``) and
equal the C++ engine's ``export_rows`` row for row, and the solve is
`rows.conjugate_gradient` under ``pcg_solve``'s rules, on the device.

Where a function takes tensors it runs on their device; where it takes
arrays or sequences, or builds rows from nothing (``NativeEquation(grid)``),
it takes ``device=``: ``cuda`` unless the caller names another, raising
without a card. Results are tensors on that device.
"""

from __future__ import annotations

import numpy as np
import torch

from .grid import Grid
from .rows import (F64, RowBuffer, as64, coarse_lattice, conjugate_gradient, data_rows,
                   field_rows, input_device, model_weights, multilinear_resize,
                   normal_equations, resolve_device, sample_rows)
from .weights import Weights


def is_available() -> bool:
    """True: the port's engine is torch code and needs no compiler."""
    return True


def _solve(rows, num_nodes: int, tol: float, maxiter: int, x0=None) -> tuple[torch.Tensor, int]:
    ata, atb = normal_equations(rows, num_nodes)
    x, it, status = conjugate_gradient(ata, atb, x0, tol=tol, maxiter=maxiter, jacobi=True)
    if status != "converged":
        raise RuntimeError(f"native CG did not converge ({status} after {it} iterations)")
    return x, it


class NativeEquation:
    """The C++ engine's ``LinearEquation`` handle: rows on ``device``
    (``cuda`` unless named; raises without a card)."""

    def __init__(self, grid: Grid, device=None):
        self.grid = grid
        self.device = resolve_device(device)
        self._rows = RowBuffer(self.device)

    @property
    def num_rows(self) -> int:
        return self._rows.num_rows

    @property
    def nnz(self) -> int:
        return self._rows.nnz

    def add_equation(self, weight, rhs, indices, coeffs):
        self._rows.add_equation(weight, rhs, indices, coeffs)

    def add_field_constraints(self, weights: Weights):
        self._rows.append(field_rows(self.grid, model_weights(weights), self.device))

    def _positions(self, positions) -> torch.Tensor:
        return as64(positions, self.device).reshape(-1, self.grid.ndim)

    def add_value_constraints(self, positions, values, weights):
        """One value row per sample, each with its own weight."""
        pos = self._positions(positions)
        n = pos.shape[0]
        self._rows.append(sample_rows(self.grid, pos,
                                      values=as64(values, self.device).reshape(n),
                                      value_weight=as64(weights, self.device).reshape(n)))

    def add_gradient_constraints(self, positions, gradients, weights):
        """D gradient rows per sample, each sample with its own weight."""
        pos = self._positions(positions)
        n = pos.shape[0]
        self._rows.append(sample_rows(self.grid, pos, gradients=self._positions(gradients),
                                      gradient_weight=as64(weights, self.device).reshape(n)))

    def export_rows(self):
        """(rows, cols, values, rhs) tensors on the device, in row order."""
        return tuple(self._rows.export())

    def solve(self, tol: float = 1e-10, maxiter: int = 100000,
              x0=None) -> tuple[torch.Tensor, int]:
        """Normal-equations Jacobi-PCG in float64. Returns (x [*grid.shape],
        iterations); raises RuntimeError where the C++ engine returns -1."""
        x0 = None if x0 is None else as64(x0, self.device)
        x, it = _solve(self._rows.export(), self.grid.num_nodes, tol, maxiter, x0)
        return x.reshape(self.grid.shape), it


def sdf_from_points_native(
    grid: Grid,
    weights: Weights,
    positions,
    normals,
    point_weights=None,
    tol: float = 1e-10,
    maxiter: int = 100000,
    device=None,
) -> tuple[torch.Tensor, int]:
    """One-call SDF reconstruction (``fi_sdf_from_points``): the smoothness
    rows, then per point its value row (value 0, weight data_pos·pw) and its
    gradient rows (the normal, weight data_gradient·pw), solved by
    Jacobi-PCG. Returns (field [*grid.shape], iterations)."""
    dev = input_device(positions, normals, point_weights, device=device)
    rows = RowBuffer(dev)
    rows.append(field_rows(grid, model_weights(weights), dev))
    pos = as64(positions, dev).reshape(-1, grid.ndim)
    rows.append(data_rows(grid, weights, pos, torch.zeros(len(pos), dtype=F64, device=dev),
                          normals, point_weights, dev))
    x, it = _solve(rows.export(), grid.num_nodes, tol, maxiter)
    return x.reshape(grid.shape), it


def _integer_sources(n_in: int, n_out: int) -> np.ndarray:
    """The C++ upsample's source coordinates, r·(n_in - 1)/(n_out - 1)."""
    return np.arange(n_out, dtype=np.float64) * (n_in - 1) / (n_out - 1)


def solve_approximate_lattice_native(
    grid: Grid,
    weights: Weights,
    positions,
    values,
    gradients=None,
    point_weights=None,
    downscale: int = 2,
    tol: float = 1e-10,
    maxiter: int = 100000,
    device=None,
) -> tuple[torch.Tensor, int]:
    """The approximate coarse-lattice solve (``fi_solve_approximate_lattice``):
    the same rows as ``explicit.solve_sparse_linear_approximate_lattice``
    on the downscaled lattice, solved by Jacobi-PCG, then multilinearly
    upsampled (no value rescale). Returns (field [*grid.shape] in coarse
    value units, coarse iterations)."""
    dev = input_device(positions, values, gradients, point_weights, device=device)
    coarse, pos, grads = coarse_lattice(grid, positions, gradients, downscale, dev)
    rows = RowBuffer(dev)
    rows.append(field_rows(coarse, model_weights(weights), dev))
    rows.append(data_rows(coarse, weights, pos, as64(values, dev), grads,
                          None if point_weights is None else as64(point_weights, dev), dev))
    xc, it = _solve(rows.export(), coarse.num_nodes, tol, maxiter)
    return multilinear_resize(xc.reshape(coarse.shape), grid.shape, _integer_sources), it
