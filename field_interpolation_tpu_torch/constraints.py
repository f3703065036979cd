"""Vectorized scattered-data constraint assembly (plain torch).

Counterpart of ``field_interpolation_tpu.constraints``:

1. `multilinear_corner_data` computes, for all samples at once, the flat
   corner indices ``[n, 2^D]`` and the per-row coefficient vectors (one value
   row + D gradient rows) of shape ``[n, R, 2^D]``.
2. `densify_data_term` scatter-adds each sample's weighted ``2^D × 2^D``
   normal-equation block into a dense spatially varying 3^D-point stencil
   ``coeff[3^D, *grid]`` (channel-major) plus the right-hand side grid, in ONE
   ``index_add_``. The CG loop then applies the data term as 3^D shifted
   multiply-adds with no scatter.

The reference's other densify and corner-scatter forms (one-hot matmuls,
symmetry-halved scatter, integer-grid f64 emulation) work around the TPU's
scatter cost and its missing float64; the H100 needs none of them.
Out-of-bounds, non-finite and zero-weight samples contribute nothing
(SPEC.md).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .grid import Grid
from .weights import Weights


@functools.lru_cache(maxsize=None)
def corner_bits(ndim: int) -> np.ndarray:
    """[2^D, D] array of corner bit patterns; bit d of corner c is bits[c, d]."""
    c = np.arange(1 << ndim)[:, None]
    return ((c >> np.arange(ndim)[None, :]) & 1).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _offset_channels(ndim: int) -> np.ndarray:
    """[2^D, 2^D] channel index into the 3^D offset box for corner pair (c, d):
    offset = bits[d] - bits[c] ∈ {-1,0,1}^D, channel = C-order index of
    offset+1 in a (3,)*D box."""
    bits = corner_bits(ndim)
    off = bits[None, :, :] - bits[:, None, :] + 1  # [C, C, D] in {0,1,2}
    chan = np.zeros(off.shape[:2], dtype=np.int32)
    for d in range(ndim):
        chan = chan * 3 + off[:, :, d]
    return chan


@functools.lru_cache(maxsize=None)
def offset_list(ndim: int) -> np.ndarray:
    """[3^D, D] the C-ordered offsets of the data-stencil box, in {-1,0,1}."""
    grids = np.meshgrid(*([np.arange(-1, 2)] * ndim), indexing="ij")
    return np.stack([g.ravel() for g in grids], axis=-1).astype(np.int32)


def _cell_frac(grid: Grid, positions: torch.Tensor):
    """(cell [n,D] int64, frac [n,D], in_bounds [n]) for all samples.

    Every op here is exact for lattice coordinates (comparisons, clamp,
    floor, and ``safe_pos - cell``), so fp32 positions cast to float64 give
    bit for bit the reference's float64 rows."""
    shape = torch.as_tensor(grid.shape, dtype=positions.dtype,
                            device=positions.device)
    finite = torch.isfinite(positions)
    in_bounds = torch.all(finite & (positions >= 0.0)
                          & (positions <= shape - 1.0), dim=-1)
    # Replace non-finite coordinates before any arithmetic: a NaN position
    # would otherwise poison the scatter (0-weight × NaN-coefficient = NaN).
    safe_pos = torch.where(finite, positions, torch.zeros_like(positions))
    safe_pos = torch.minimum(safe_pos.clamp_min(0.0), shape - 1.0)
    top = torch.as_tensor(grid.shape, device=positions.device) - 2
    cell = torch.minimum(torch.floor(safe_pos).long().clamp_min(0), top)
    frac = safe_pos - cell.to(positions.dtype)  # [n, D] in [0, 1]
    return cell, frac, in_bounds


def _corner_rows(grid: Grid, cell: torch.Tensor, frac: torch.Tensor):
    """(corner_idx [n,C] int64, row_coeffs [n,1+D,C] in frac's dtype):
    the multilinear value row + D gradient rows (SPEC.md conventions).
    Leading lane axes of cell and frac ([B, n, D]) lead the results."""
    D = grid.ndim
    dev = cell.device
    strides = torch.as_tensor(grid.strides, device=dev)
    bits = torch.as_tensor(corner_bits(D), device=dev).long()  # [C, D]

    corner_coords = cell[..., None, :] + bits                   # [n, C, D]
    corner_idx = torch.sum(corner_coords * strides, dim=-1)     # [n, C]

    # Per-axis 1-D weights at each corner: bits ? frac : 1-frac.
    f = frac[..., None, :].expand(*frac.shape[:-1], bits.shape[0], D)
    w1d = torch.where(bits == 1, f, 1.0 - f)                    # [n, C, D]
    value_row = torch.prod(w1d, dim=-1)                         # [n, C]

    # Gradient row for axis a: sign_a(c) * prod_{d != a} w1d (a masked
    # product, not value_row / w1d, which is unstable at 0).
    grad_rows = []
    for a in range(D):
        keep = torch.as_tensor([d != a for d in range(D)], device=dev)
        partial = torch.prod(torch.where(keep, w1d, torch.ones_like(w1d)),
                             dim=-1)
        sign = torch.where(bits[:, a] == 1, 1.0, -1.0).to(frac.dtype)
        grad_rows.append(sign * partial)                        # [n, C]
    return corner_idx, torch.stack([value_row, *grad_rows], dim=-2)


def multilinear_corner_data(grid: Grid, positions: torch.Tensor):
    """Per-sample cell/corner geometry for all samples at once.

    positions: [n, D] continuous lattice coordinates ([B, n, D] for B
    lanes: every result then leads with B).

    Returns (corner_idx [n, C] int64 flat node indices,
             row_coeffs [n, 1+D, C] (positions' dtype), value then D gradient rows,
             in_bounds [n] bool).
    """
    cell, frac, in_bounds = _cell_frac(grid, positions)
    corner_idx, row_coeffs = _corner_rows(grid, cell, frac)
    return corner_idx, row_coeffs, in_bounds


def densify_data_term(
    grid: Grid,
    corner_idx: torch.Tensor,      # [n, C]
    row_coeffs: torch.Tensor,      # [n, R, C]  (R rows per sample)
    row_weights: torch.Tensor,     # [n, R]     (already includes in-bounds mask)
    row_targets: torch.Tensor,     # [n, R]
):
    """Scatter the data rows' normal-equation contributions into dense form.

    Returns (coeff [3^D, *grid], b [*grid]) with
      (DᵀWD x)_i = Σ_o coeff[o, i] · x_{i+o}     and   b = Dᵀ W t.
    One ``index_add_`` carries the C²+C values of every sample: b rides
    along as plane 3^D of a (3^D + 1)-plane target. With a leading lane
    axis on every input ([B, n, C], ...) the target is [B·(3^D + 1)·N],
    each lane's indices offset by its own block, still one ``index_add_``,
    and the results are [B, 3^D, *grid] and [B, *grid].
    """
    D = grid.ndim
    C = grid.num_corners
    N = grid.num_nodes
    lanes = tuple(corner_idx.shape[:-2])
    n = corner_idx.shape[-2]
    Bw = row_coeffs * row_weights[..., None]           # weighted rows [n, R, C]
    tw = row_targets * row_weights                     # weighted targets [n, R]
    M = torch.einsum("...nrc,...nrd->...ncd", Bw, Bw)  # [n, C, C]
    bvec = torch.einsum("...nrc,...nr->...nc", Bw, tw)  # [n, C]

    dev = corner_idx.device
    chan = torch.as_tensor(_offset_channels(D), device=dev).long()
    idx_cc = corner_idx[..., None].expand(*lanes, n, C, C)
    block = (3**D + 1) * N
    lane_off = (torch.arange(math.prod(lanes), device=dev).reshape(lanes)
                * block)[..., None, None]           # each lane's block start
    flat_idx = torch.cat([(chan * N + idx_cc + lane_off[..., None]).reshape(-1),
                          ((3**D) * N + corner_idx + lane_off).reshape(-1)])
    updates = torch.cat([M.reshape(-1), bvec.reshape(-1)])
    out = torch.zeros(math.prod(lanes) * block, dtype=M.dtype, device=M.device)
    out.index_add_(0, flat_idx, updates)
    out = out.reshape(lanes + (block,))
    # Contiguous (a copy only for lanes): the kernels read by flat index.
    coeff = out[..., :3**D * N].reshape(lanes + (3**D,) + grid.shape).contiguous()
    b = out[..., 3**D * N:].reshape(lanes + grid.shape).contiguous()
    return coeff, b


def _shift(x: torch.Tensor, offset, ndim: int) -> torch.Tensor:
    """result[i] = x[i + offset] with zeros outside; grid axes are trailing."""
    base = x.ndim - ndim
    out = torch.zeros_like(x)
    dst = [slice(None)] * x.ndim
    src = [slice(None)] * x.ndim
    for d, o in enumerate(offset):
        o = int(o)
        n = x.shape[base + d]
        dst[base + d] = slice(max(0, -o), n - max(0, o))
        src[base + d] = slice(max(0, o), n - max(0, -o))
    out[tuple(dst)] = x[tuple(src)]
    return out


def data_apply(x: torch.Tensor, coeff: torch.Tensor, ndim: int) -> torch.Tensor:
    """(DᵀWD) x via the densified varying stencil: Σ_o coeff[..., o] x_{i+o}.

    x: [..., *grid]; coeff: [..., 3^D, *grid].
    """
    offsets = offset_list(ndim)
    out = torch.zeros_like(x)
    grid_sl = (slice(None),) * ndim
    for o_idx in range(offsets.shape[0]):
        c = coeff[(Ellipsis, o_idx) + grid_sl]
        out = out + c * _shift(x, offsets[o_idx], ndim)
    return out


def data_diag(coeff: torch.Tensor, ndim: int) -> torch.Tensor:
    """diag(DᵀWD) = the center channel of the densified stencil."""
    center = (3**ndim) // 2
    return coeff[(Ellipsis, center) + (slice(None),) * ndim]


def sample_row_weights(
    weights: Weights,
    in_bounds: torch.Tensor,          # [n]
    point_weights: torch.Tensor,      # [n]
    ndim: int,
    with_gradient: bool,
) -> torch.Tensor:
    """Per-row weights [n, R]: value row scaled by data_pos, gradient rows by
    data_gradient; out-of-bounds or padded (weight-0) samples contribute
    nothing (SPEC.md). Lanes ([B, n] inputs) give [B, n, R]."""
    wp = torch.where(in_bounds, point_weights, torch.zeros_like(point_weights))
    g = weights.data_gradient if with_gradient else 0.0
    cols = [wp * weights.data_pos] + [wp * g for _ in range(ndim)]
    return torch.stack(cols, dim=-1).to(point_weights.dtype)
