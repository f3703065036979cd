"""Smoothness normal operator as exact composite convolutions (plain torch).

Counterpart of ``field_interpolation_tpu.stencils``. Per axis and order the
smoothness rows are all valid length-L windows of taps ``s``, so
``w² BᵀB x = w² · full_conv(valid_corr(x, s), s)``: two 1-D shift-and-add
passes that are exact, including the dropped-row boundary policy (SPEC.md).
The fused apply kernel (ops/stencil.py) computes the same sum per node.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .weights import Weights

# Stencil taps per smoothness order (SPEC.md table).
STENCIL_TAPS: dict[int, tuple[float, ...]] = {
    0: (1.0,),
    1: (-1.0, 1.0),
    2: (1.0, -2.0, 1.0),
    3: (-1.0, 3.0, -3.0, 1.0),
}


def _valid_corr(x: torch.Tensor, taps: tuple[float, ...], axis: int) -> torch.Tensor:
    """y[r] = sum_m s[m] * x[r + m] over all fully-inside windows (length n-L+1)."""
    m = x.shape[axis] - len(taps) + 1
    acc = None
    for k, s in enumerate(taps):
        term = s * x.narrow(axis, k, m)
        acc = term if acc is None else acc + term
    return acc


def _full_conv_t(y: torch.Tensor, taps: tuple[float, ...], axis: int,
                 n: int) -> torch.Tensor:
    """z[i] = sum_m s[m] * y[i - m]  (Bᵀ y; output length n)."""
    shape = list(y.shape)
    shape[axis] = n
    out = torch.zeros(shape, dtype=y.dtype, device=y.device)
    m = y.shape[axis]
    for k, s in enumerate(taps):
        out.narrow(axis, k, m).add_(s * y)
    return out


def axis_normal_apply(x: torch.Tensor, order: int, axis: int) -> torch.Tensor:
    """(BᵀB)x for one axis/order family of smoothness rows (unweighted)."""
    taps = STENCIL_TAPS[order]
    n = x.shape[axis]
    if n < len(taps):  # no rows fit -> zero operator
        return torch.zeros_like(x)
    return _full_conv_t(_valid_corr(x, taps, axis), taps, axis, n)


def smoothness_apply(x: torch.Tensor, weights: Weights,
                     ndim: int | None = None) -> torch.Tensor:
    """S x = Σ_orders Σ_axes w_k² (BᵀB) x, per SPEC.md.

    ``ndim``: number of trailing grid axes of ``x`` (defaults to ``x.ndim``);
    leading axes are treated as batch.
    """
    if ndim is None:
        ndim = x.ndim
    out = torch.zeros_like(x)
    for order in weights.active_orders():
        w2 = weights.model_weight(order) ** 2
        if order == 0:
            out = out + w2 * x  # emitted once per node, not per axis
            continue
        for ax in range(x.ndim - ndim, x.ndim):
            out = out + w2 * axis_normal_apply(x, order, ax)
    return out


@functools.lru_cache(maxsize=None)
def _axis_diag_1d(order: int, n: int) -> np.ndarray:
    """diag(BᵀB) along one axis: diag_i = Σ_{windows r covering i} s[i-r]²."""
    taps = np.asarray(STENCIL_TAPS[order], dtype=np.float64)
    L = len(taps)
    if n < L:
        return np.zeros(n)
    return np.convolve(np.ones(n - L + 1), taps**2)  # length n


def _per_axis_sum(shape: tuple[int, ...], weights: Weights, profile,
                  dtype: torch.dtype, device) -> torch.Tensor:
    out = np.zeros(shape, dtype=np.float64)
    for order in weights.active_orders():
        w2 = weights.model_weight(order) ** 2
        if order == 0:
            out += w2
            continue
        for ax in range(len(shape)):
            bshape = [1] * len(shape)
            bshape[ax] = shape[ax]
            out += w2 * profile(order, shape[ax]).reshape(bshape)
    return torch.as_tensor(out, device=device).to(dtype)


def smoothness_diag(shape: tuple[int, ...], weights: Weights,
                    dtype: torch.dtype = torch.float32,
                    device: torch.device | str = "cpu") -> torch.Tensor:
    """diag(S) as a grid-shaped tensor (Jacobi and multigrid smoothing)."""
    return _per_axis_sum(shape, weights, _axis_diag_1d, dtype, device)


@functools.lru_cache(maxsize=None)
def _axis_rowabs_1d(order: int, n: int) -> np.ndarray:
    """Row absolute sums of the 1-D BᵀB band matrix: rowabs_i = Σ_j |(BᵀB)_ij|.

    Band at offset +d: band_d[i] = Σ_r s_{i-r} s_{i+d-r} over valid windows r,
    i.e. conv(ones(num_rows), t_d) with t_d[m] = s_m s_{m+d}."""
    taps = np.asarray(STENCIL_TAPS[order], dtype=np.float64)
    L = len(taps)
    if n < L:
        return np.zeros(n)
    ones = np.ones(n - L + 1)
    rowabs = np.zeros(n)
    for d in range(L):
        band = np.abs(np.convolve(ones, taps[: L - d] * taps[d:]))  # length n - d
        rowabs[: n - d] += band                         # partner at i + d
        if d > 0:
            rowabs[d:] += band                          # partner at i - d
    return rowabs


def smoothness_row_abs_sum(shape: tuple[int, ...], weights: Weights,
                           dtype: torch.dtype = torch.float32,
                           device: torch.device | str = "cpu") -> torch.Tensor:
    """Σ_j |S_ij| per node: the Gershgorin bound that scales the multigrid
    Jacobi damping (ρ(D⁻¹A) ≤ max rowabs/diag)."""
    return _per_axis_sum(shape, weights, _axis_rowabs_1d, dtype, device)


def max_stencil_radius(weights: Weights) -> int:
    """Operator radius per axis = max active order."""
    orders = [k for k in weights.active_orders() if k > 0]
    return max(orders) if orders else 0
