"""Explicit constraint rows on the device: what `explicit` and `native` share.

The reference's row-level API (``field_interpolation_tpu.explicit`` in
NumPy/SciPy, ``native/field_interpolation.cpp`` in C++) builds the
least-squares system row by row. Here the rows come out of vectorized
torch passes on the device, in the reference's order, with its columns and
its float64 values:

- `field_rows`: the smoothness rows, order 0 node by node, then for each
  order and axis the lines in C order and the window starts along each line;
- `sample_rows`: each sample's value row and D gradient rows, out-of-bounds
  and NaN samples dropped, zero coefficients (a sample on a node) skipped;
- `RowBuffer`: rows in one global order, single rows in a host buffer and
  the adders' rows as tensor chunks;
- `normal_equations`: AᵀA from the rows' outer products, coalesced into a
  float64 CSR matrix (no general sparse product), and Aᵀb;
- `conjugate_gradient`: float64 CG under the reference's two stopping rules,
  SciPy's ``cg`` and the C++ engine's Jacobi-PCG.
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .constraints import multilinear_corner_data
from .grid import Grid
from .stencils import STENCIL_TAPS
from .weights import Weights

F64 = torch.float64
# CG iterations between two host reads of the stopping flags; the updates
# past a stop are frozen on the device, so the result does not depend on it.
CHECK_EVERY = 32


def resolve_device(device=None) -> torch.device:
    """The device of an entry point that is given no tensors: ``cuda``
    unless the caller names another; raises when there is no card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to build and "
                               "solve the rows on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def input_device(*arrays, device=None) -> torch.device:
    """The device of the tensors among ``arrays`` (None entries ignored),
    else `resolve_device` of ``device``."""
    devs = {a.device for a in arrays if isinstance(a, torch.Tensor)}
    if len(devs) > 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devs))}")
    if not devs:
        return resolve_device(device)
    dev = devs.pop()
    if device is not None and resolve_device(device) != dev:
        raise ValueError(f"inputs on {dev}, device={device}")
    return dev


def as64(a, device: torch.device) -> torch.Tensor:
    """``a`` (a tensor, an array or a sequence) as float64 on ``device``.
    A tensor on another device raises: nothing moves on its own."""
    if isinstance(a, torch.Tensor) and a.device != device:
        raise ValueError(f"a tensor on {a.device} given to rows on {device}")
    return torch.as_tensor(a, dtype=F64, device=device)


def model_weights(weights: Weights) -> tuple[float, float, float, float]:
    return (weights.model_0, weights.model_1, weights.model_2, weights.model_3)


@contextlib.contextmanager
def quiet_sparse():
    """PyTorch warns that its sparse CSR support is in beta and that sparse
    invariant checks are off; neither concerns matrices built here, whose
    indices are checked or valid by construction."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="Sparse CSR tensor support is in beta")
        warnings.filterwarnings("ignore", message="Sparse invariant checks are implicitly")
        yield


class Rows(NamedTuple):
    """A block of rows as triplets: entries in row order, rows numbered
    from 0 in the block (or globally, in `RowBuffer.export`)."""

    row: torch.Tensor  # [nnz] int64
    col: torch.Tensor  # [nnz] int64
    val: torch.Tensor  # [nnz] float64
    rhs: torch.Tensor  # [rows] float64


def empty_rows(device) -> Rows:
    i = torch.zeros(0, dtype=torch.int64, device=device)
    v = torch.zeros(0, dtype=F64, device=device)
    return Rows(i, i, v, v)


def pack_rows(weight: torch.Tensor, rhs: torch.Tensor, cols: torch.Tensor,
              coeffs: torch.Tensor) -> Rows:
    """Rows with ``add_equation``'s semantics, all at once: row i reads
    weight[i]·Σ_k coeffs[i, k]·x[cols[i, k]] = weight[i]·rhs[i]. A row of
    weight 0 is not added; a zero coefficient is not stored."""
    keep = weight != 0
    weight, rhs, cols, coeffs = weight[keep], rhs[keep], cols[keep], coeffs[keep]
    nz = coeffs != 0
    m, k = coeffs.shape
    row = torch.arange(m, device=coeffs.device)[:, None].expand(m, k)
    return Rows(row[nz], cols[nz], (weight[:, None] * coeffs)[nz], weight * rhs)


def concat_rows(blocks: list[Rows], device) -> Rows:
    """The blocks one after another, each block's rows renumbered after the
    rows before it."""
    if not blocks:
        return empty_rows(device)
    offset, rows = 0, []
    for b in blocks:
        rows.append(b.row + offset)
        offset += b.rhs.numel()
    return Rows(torch.cat(rows), torch.cat([b.col for b in blocks]),
                torch.cat([b.val for b in blocks]), torch.cat([b.rhs for b in blocks]))


def field_rows(grid: Grid, model_w, device) -> Rows:
    """The smoothness rows of ``add_field_constraints``: order 0 once per
    node; orders 1-3 per axis, every stencil window fully inside the grid,
    lines in C order and window starts along each line; ``model_w`` are the
    four model weights."""
    n_nodes = grid.num_nodes
    nodes = torch.arange(n_nodes, device=device)
    blocks = []
    if model_w[0] != 0.0:
        blocks.append(pack_rows(torch.full((n_nodes,), float(model_w[0]), dtype=F64,
                                           device=device),
                                torch.zeros(n_nodes, dtype=F64, device=device),
                                nodes[:, None], torch.ones(n_nodes, 1, dtype=F64,
                                                           device=device)))
    for order in (1, 2, 3):
        w = model_w[order]
        if w == 0.0:
            continue
        taps = torch.tensor(STENCIL_TAPS[order], dtype=F64, device=device)
        L = len(taps)
        for ax, n in enumerate(grid.shape):
            if n < L:
                continue
            # Each line's first node (coordinate 0 along ax), in C order.
            base = nodes.reshape(grid.shape).select(ax, 0).reshape(-1)
            window = (torch.arange(n - L + 1, device=device)[:, None]
                      + torch.arange(L, device=device)) * grid.strides[ax]
            cols = (base[:, None, None] + window).reshape(-1, L)
            m = cols.shape[0]
            blocks.append(pack_rows(torch.full((m,), float(w), dtype=F64, device=device),
                                    torch.zeros(m, dtype=F64, device=device), cols,
                                    taps.expand(m, L)))
    return concat_rows(blocks, device)


def sample_rows(grid: Grid, positions: torch.Tensor, *, values=None, value_weight=None,
                gradients=None, gradient_weight=None) -> Rows:
    """Each sample's rows, sample after sample: its value row (when
    ``value_weight`` is given) and then its D gradient rows (when
    ``gradients`` are given), as ``add_value_constraint`` and
    ``add_gradient_constraint`` make them. All inputs float64 on one
    device: positions [n, D], values and weights [n], gradients [n, D]. A
    sample outside the grid or with a non-finite coordinate adds nothing."""
    n, D = positions.shape
    C = grid.num_corners
    corner_idx, coeffs, in_bounds = multilinear_corner_data(grid, positions)
    ws, ts, cs = [], [], []
    if value_weight is not None:
        ws.append(value_weight[:, None])
        ts.append(values[:, None])
        cs.append(coeffs[:, :1])
    if gradients is not None:
        ws.append(gradient_weight[:, None].expand(n, D))
        ts.append(gradients)
        cs.append(coeffs[:, 1:])
    w = torch.where(in_bounds[:, None], torch.cat(ws, 1), 0.0)   # [n, R]
    R = w.shape[1]
    return pack_rows(w.reshape(-1), torch.cat(ts, 1).reshape(-1),
                     corner_idx[:, None, :].expand(n, R, C).reshape(-1, C),
                     torch.cat(cs, 1).reshape(-1, C))


def data_rows(grid: Grid, weights: Weights, positions, values, gradients, point_weights,
              device) -> Rows:
    """``assemble_explicit``'s sample rows: per sample its value row
    (weight data_pos·pw) and, with gradients, its D gradient rows (weight
    data_gradient·pw)."""
    pos = as64(positions, device).reshape(-1, grid.ndim)
    n = pos.shape[0]
    pw = (torch.ones(n, dtype=F64, device=device) if point_weights is None
          else as64(point_weights, device).reshape(n))
    grads = None if gradients is None else as64(gradients, device).reshape(n, grid.ndim)
    return sample_rows(grid, pos, values=as64(values, device).reshape(n),
                       value_weight=weights.data_pos * pw, gradients=grads,
                       gradient_weight=weights.data_gradient * pw)


def coarse_lattice(grid: Grid, positions, gradients, downscale: int, device):
    """The approximate lattice's conventions (the reference's
    ``field_interpolation_tpu/explicit.py:195-208`` and C++
    ``fi_solve_approximate_lattice``): the coarse grid, max(2, (n - 1) //
    downscale + 1) nodes an axis; positions scaled by (cn - 1)/(fn - 1)
    per axis; per-unit-length gradient targets divided by that scale."""
    coarse = Grid(tuple(max(2, (n - 1) // downscale + 1) for n in grid.shape))
    scale = torch.tensor([(cn - 1) / (fn - 1) for cn, fn in zip(coarse.shape, grid.shape)],
                         dtype=F64, device=device)
    pos = as64(positions, device).reshape(-1, grid.ndim) * scale
    grads = (None if gradients is None
             else as64(gradients, device).reshape(-1, grid.ndim) / scale)
    return coarse, pos, grads


def multilinear_resize(x: torch.Tensor, out_shape: tuple[int, ...],
                       sources: Callable[[int, int], np.ndarray]) -> torch.Tensor:
    """Separable linear resample with the end points aligned, one axis at a
    time; ``sources(n_in, n_out)`` gives the source coordinate of each
    output node (host float64; each reference computes it its own way)."""
    out = x.to(F64)
    for ax, n_out in enumerate(out_shape):
        n_in = out.shape[ax]
        if n_in == n_out:
            continue
        src = sources(n_in, n_out)
        lo = np.clip(np.floor(src).astype(np.int64), 0, n_in - 2)
        shape = [1] * out.ndim
        shape[ax] = n_out
        t = torch.as_tensor(src - lo, device=x.device).reshape(shape)
        lo = torch.as_tensor(lo, device=x.device)
        out = out.index_select(ax, lo) * (1 - t) + out.index_select(ax, lo + 1) * t
    return out


class RowBuffer:
    """Rows in one global order on ``device``. Rows added one at a time
    wait in a host buffer; a block from a whole-lattice or batched adder
    arrives as tensors, the open host rows closed into a block before it."""

    def __init__(self, device: torch.device):
        self.device = device
        self.num_rows = 0
        self.nnz = 0
        self._blocks: list[Rows] = []       # rows numbered globally
        self._host: tuple[list, list, list, list] = ([], [], [], [])

    def add_equation(self, weight, rhs, indices, coeffs) -> None:
        """One weighted row: nothing for weight 0, zero coefficients skipped,
        the right-hand side scaled by the weight."""
        weight = float(weight)
        if weight == 0.0:
            return
        rows, cols, vals, rhss = self._host
        for idx, c in zip(indices, coeffs):
            c = float(c)
            if c != 0.0:
                rows.append(self.num_rows)
                cols.append(int(idx))
                vals.append(weight * c)
                self.nnz += 1
        rhss.append(weight * float(rhs))
        self.num_rows += 1

    def add_host_rows(self, block: Rows) -> None:
        """A block of a few rows (one sample's) into the host buffer."""
        rows, cols, vals, rhss = self._host
        rows.extend((block.row + self.num_rows).tolist())
        cols.extend(block.col.tolist())
        vals.extend(block.val.tolist())
        rhss.extend(block.rhs.tolist())
        self.num_rows += block.rhs.numel()
        self.nnz += block.val.numel()

    def append(self, block: Rows) -> None:
        """A block of rows on the buffer's device, after every row so far."""
        self._close_host()
        self._blocks.append(block._replace(row=block.row + self.num_rows))
        self.num_rows += block.rhs.numel()
        self.nnz += block.val.numel()

    def _close_host(self) -> None:
        rows, cols, vals, rhss = self._host
        if not rhss:
            return
        dev = self.device
        self._blocks.append(Rows(torch.tensor(rows, dtype=torch.int64, device=dev),
                                 torch.tensor(cols, dtype=torch.int64, device=dev),
                                 torch.tensor(vals, dtype=F64, device=dev),
                                 torch.tensor(rhss, dtype=F64, device=dev)))
        self._host = ([], [], [], [])

    def export(self) -> Rows:
        """Every row so far, numbered globally, on the buffer's device."""
        self._close_host()
        if not self._blocks:
            return empty_rows(self.device)
        if len(self._blocks) > 1:
            b = self._blocks
            self._blocks = [Rows(*(torch.cat([blk[k] for blk in b]) for k in range(4)))]
        return self._blocks[0]


def normal_equations(rows: Rows, ncols: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(AᵀA as a float64 CSR matrix, Aᵀb) of the rows, A with ``ncols``
    columns: every row's outer product aᵢaᵢᵀ as (col, col, value) entries,
    coalesced (duplicates summed), as ``normal_equations`` in
    ``native/field_interpolation.cpp`` does; a row has few entries, so no
    general sparse product is needed. Entries must come in row order."""
    row, col, val, rhs = rows
    dev = val.device
    if col.numel() and (int(col.min()) < 0 or int(col.max()) >= ncols):
        raise ValueError(f"a column index outside [0, {ncols})")
    atb = torch.zeros(ncols, dtype=F64, device=dev).index_add_(0, col, val * rhs[row])
    # Pairs (p, q) of entries of one row: each entry p repeats once per
    # entry of its row, q running over that row's entries.
    counts = torch.bincount(row, minlength=rhs.numel())
    per = counts[row]
    n_pairs = int(per.sum())
    p = torch.repeat_interleave(torch.arange(row.numel(), device=dev), per,
                                output_size=n_pairs)
    first = torch.cumsum(counts, 0) - counts                 # each row's first entry
    run = torch.cumsum(per, 0) - per                         # each p's first pair
    q = (first[row[p]] + torch.arange(n_pairs, device=dev)
         - torch.repeat_interleave(run, per, output_size=n_pairs))
    with quiet_sparse():
        ata = torch.sparse_coo_tensor(torch.stack([col[p], col[q]]), val[p] * val[q],
                                      (ncols, ncols)).coalesce()
        return ata.to_sparse_csr(), atb


def csr_diagonal(a: torch.Tensor) -> torch.Tensor:
    """The diagonal of a CSR matrix (zero where it stores none)."""
    n = a.shape[0]
    crow, col, val = a.crow_indices(), a.col_indices(), a.values()
    row = torch.repeat_interleave(torch.arange(n, device=val.device), crow.diff(),
                                  output_size=val.numel())
    on = row == col
    return torch.zeros(n, dtype=val.dtype, device=val.device).index_put_(
        (row[on],), val[on])


def conjugate_gradient(a: torch.Tensor, b: torch.Tensor, x0: Optional[torch.Tensor], *,
                       tol: float, maxiter: int, jacobi: bool) -> tuple[torch.Tensor, int, str]:
    """Float64 CG on a x = b (``a`` symmetric, CSR) from ``x0`` (zeros when
    None), under one of the reference's two rules; returns (x, iterations,
    status), status "converged", "maxiter" or "breakdown".

    ``jacobi=True`` is the C++ engine's ``pcg_solve``
    (``native/field_interpolation.cpp:223-275``): the diagonal of ``a``
    where it is > 0 (else 1) preconditions; the loop stops before an
    update once ‖r‖² ≤ tol²·‖b‖²; pᵀap ≤ 0 is a breakdown. ``jacobi=False``
    is SciPy's ``cg`` without a preconditioner: it stops once ‖r‖ <
    tol·‖b‖. Under both, b = 0 gives zeros at 0 iterations.

    The host reads the stopping flags every `CHECK_EVERY` iterations. An
    iteration after the rule stopped is frozen on the device (its step is
    0), so x and the count are those of a check every iteration."""
    n = b.numel()
    dev = b.device
    x = torch.zeros(n, dtype=F64, device=dev) if x0 is None else x0.reshape(n).to(F64).clone()
    bb = torch.dot(b, b)
    if float(bb) == 0.0:
        return torch.zeros(n, dtype=F64, device=dev), 0, "converged"
    if jacobi:
        d = csr_diagonal(a)
        d = torch.where(d > 0, d, torch.ones_like(d))
    r = b - a @ x
    z = r / d if jacobi else r
    p = z.clone()
    rz = torch.dot(r, z)
    tol2 = tol * tol * bb
    atol = tol * torch.sqrt(bb)
    stop = torch.zeros((), dtype=torch.bool, device=dev)
    broke = torch.zeros((), dtype=torch.bool, device=dev)
    iters = torch.zeros((), dtype=torch.int64, device=dev)
    done = 0
    while done < maxiter:
        steps = min(CHECK_EVERY, maxiter - done)
        for _ in range(steps):
            rr = torch.dot(r, r)
            stop = stop | ((rr <= tol2) if jacobi else (torch.sqrt(rr) < atol))
            ap = a @ p
            pap = torch.dot(p, ap)
            if jacobi:
                broke = broke | (~stop & (pap <= 0))
            active = ~(stop | broke)
            alpha = torch.where(active, rz / pap, 0.0)
            x += alpha * p
            r -= alpha * ap
            z = r / d if jacobi else r
            rz_new = torch.dot(r, z)
            beta = torch.where(active, rz_new / rz, 0.0)
            rz = torch.where(active, rz_new, rz)
            p = z + beta * p
            iters += active
        done += steps
        if bool(stop | broke):
            break
    status = "breakdown" if bool(broke) else "converged" if bool(stop) else "maxiter"
    return x, int(iters), status
