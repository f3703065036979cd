"""Geometric multigrid V-cycle preconditioner (plain torch setup and cycle).

Counterpart of ``field_interpolation_tpu.multigrid``:

* transfers — endpoint-aligned separable linear prolongation ``P``, per axis
  in banded form (`_resize_bands`: ≤ 3 weights per output row, kept on the
  device per shape); the restriction is literally ``Pᵀ``, which with
  symmetric pre/post damped-Jacobi smoothing keeps the V-cycle symmetric
  positive definite (safe in CG). The dense matrices (`_resize_matrix`,
  cached on the device per shape by `_restriction_tensor`) remain for the
  fused segment's and the whole-cycle kernel's operands.
* coarse operators — rediscretized smoothness with energy-matched weights
  ``w_k ← w_k · 2^{(D-2k)/2}`` per coarsening, plus the data term: the
  diagonally lumped ``diag_c = Pᵀ² diag_f`` (``mg_coarse_data="lumped"``) or
  the full Galerkin stencil PᵀAP folded back to 3^D channels
  (``"galerkin"``, `galerkin_coarse_coeff`, built from banded per-axis
  triple products).
* smoothing — damped Jacobi, or Chebyshev (``mg_smoother="chebyshev"`` /
  ``"chebyshev4"``) with the per-level schedule of `chebyshev_coefs`.
* coarsest level — a dense inverse built at setup, one small matvec per cycle.

With ``kernels=True`` (the reference's ``pallas_smooth``) the cycle runs
through the port's kernels, at any size, on CPU and CUDA tensors alike:

* where the reference runs a whole-cycle kernel (`kernel_plan`: a 2-D
  hierarchy whose every level has a kernel smoother, dense coarsest solve,
  ν_pre = ν_post, inside the fused-operand budget), the whole cycle is one
  `ops.cycle.fused_wcycle_2d` (W) or `ops.cycle.fused_vcycle_2d` (V) call on
  the operands of `whole_cycle_operands` (multigrid.py:1017-1042 of the
  reference);
* elsewhere every level smooths through one of the smoothing kernels: a
  2-D level with the full 9-channel data term through the multi-sweep
  kernel (`ops.smooth.fused_smooth_2d`) below radius 3, every other level
  (diagonal data, 3-D, radius-3 weights) through the per-sweep kernel
  (`ops.smooth.fused_smooth`); either
  call also writes the residual the cycle restricts next (after the
  pre-smoothing, and on a W-cycle's level after the first visit's
  post-smoothing); the rest of the cycle (transfers, the dense coarsest
  solve, the residual where no smoothing runs) is plain torch, as it is
  XLA in the reference.

`prepare_mg` builds all of that setup once (`MGPrep`: the hierarchy, the
smoothing steps, the dense coarsest inverse, the fused and whole-cycle
operands, the smoothers' float32 operands, the Chebyshev schedules), so
that a solve handed the prep (``prep=``) does no setup work on the device.

A problem with lanes (every leaf [B, ...]: ``batch.py``'s ``"cycle"``
route) gets the cycle of all B lanes at once, the reference's cycle under
``vmap``: per-lane steps, bounds, schedules and coarsest inverses, each
smoothing phase or whole cycle one kernel call for every lane, the dense
coarsest solve one batched product.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import math

import numpy as np
import torch

from . import stencils
from .constraints import data_apply, data_diag, offset_list
from .grid import Grid
from .operators import Problem
from .ops import _policy
from .ops._policy import fits_vmem
from .ops.smooth import _schedule_entry, fused_smooth, fused_smooth_2d
from .weights import SolverConfig, Weights


@functools.lru_cache(maxsize=None)
def _resize_matrix(n_out: int, n_in: int, square: bool = False) -> np.ndarray:
    """Endpoint-aligned separable linear resample as an explicit [n_out, n_in]
    matrix (the reference's numpy code, unchanged). ``square=True`` squares
    the interpolation weights (Galerkin transfer of diagonal quantities)."""
    src = np.linspace(0.0, n_in - 1.0, n_out)
    lo = np.clip(np.floor(src).astype(int), 0, n_in - 2)
    t = src - lo
    w0, w1 = 1.0 - t, t
    if square:
        w0, w1 = w0 * w0, w1 * w1
    P = np.zeros((n_out, n_in))
    np.add.at(P, (np.arange(n_out), lo), w0)
    np.add.at(P, (np.arange(n_out), lo + 1), w1)
    P.setflags(write=False)  # lru_cached: a caller mutating the returned
    return P                 # array must fail loudly, not poison the cache


@functools.lru_cache(maxsize=None)
def _resize_bands(n_out: int, n_in: int, transpose: bool, square: bool):
    """Banded form (start [n_out] int32, w [W, n_out]) of the resize matrix
    (its transpose when ``transpose``): row r's nonzeros are w[:, r] at
    columns start[r]..start[r]+W-1, W ≤ 2 for prolongation rows and ≤ 3 for
    restriction rows (the reference's numpy code, unchanged)."""
    M = _resize_matrix(n_out, n_in, square=square) if not transpose \
        else _resize_matrix(n_in, n_out, square=square).T
    W = max(int((M[r] != 0).sum()) for r in range(M.shape[0]))
    W = max(W, 1)
    start = np.zeros(M.shape[0], np.int32)
    w = np.zeros((W, M.shape[0]))
    for r in range(M.shape[0]):
        nz = np.nonzero(M[r])[0]
        s = int(nz[0]) if len(nz) else 0
        s = min(s, M.shape[1] - W)
        start[r] = s
        w[:, r] = M[r, s:s + W]
    start.setflags(write=False)
    w.setflags(write=False)
    return start, w


@functools.lru_cache(maxsize=None)
def _band_tensors(n_out: int, n_in: int, transpose: bool, square: bool,
                  dtype: torch.dtype, device: torch.device):
    """`_resize_bands` as tensors on ``device``: (rows [W·n_out] int64, the
    input row of band term t of output row r at t·n_out + r, and
    w [W, n_out]). Made once per key, so the transfers of a cycle copy
    nothing from the host."""
    start, w = _resize_bands(n_out, n_in, transpose, square)
    rows = np.clip(start[None, :] + np.arange(w.shape[0])[:, None], 0, n_in - 1)
    return (torch.tensor(rows.reshape(-1), dtype=torch.int64, device=device),
            torch.tensor(w, dtype=dtype, device=device))


@functools.lru_cache(maxsize=None)
def _restriction_tensor(n_f: int, n_c: int, device: torch.device) -> torch.Tensor:
    """The dense per-axis restriction [n_c, n_f] = `_resize_matrix`(n_f, n_c)ᵀ
    as float32 on ``device``, made once per key (the fused operands)."""
    R = np.ascontiguousarray(_resize_matrix(n_f, n_c).T)
    return torch.tensor(R, dtype=torch.float32, device=device)


def _apply_axis_resize(x: torch.Tensor, n_out: int, axis: int,
                       transpose: bool = False, square: bool = False) -> torch.Tensor:
    """Resize x's ``axis`` to ``n_out`` by the linear map of `_resize_matrix`
    (its transpose with ``transpose``) in banded form: one gather of the
    W ≤ 3 input rows each output row reads, then a weighted sum over them,
    O(N) in three launches, where a dense [n_out, n_in] contraction is
    O(N·n). The reference evaluates the same bands as strided slices, to
    avoid TPU gathers (multigrid.py:100-212); the card gathers well."""
    rows, w = _band_tensors(n_out, x.shape[axis], transpose, square, x.dtype,
                            x.device)
    return apply_bands(x, rows, w, axis)


def apply_bands(x: torch.Tensor, rows: torch.Tensor, w: torch.Tensor,
                axis: int) -> torch.Tensor:
    """Σ_t w[t, r] · x[rows[t·n_out + r]] along ``axis``: a banded matrix
    (W = w.shape[0] terms per output row) applied with one gather."""
    terms = torch.index_select(x, axis, rows).unflatten(axis, tuple(w.shape))
    wshape = [1] * terms.ndim
    wshape[axis:axis + 2] = w.shape
    return (terms * w.view(wshape)).sum(dim=axis)


def prolong(xc: torch.Tensor, fine_shape: tuple[int, ...]) -> torch.Tensor:
    """P: coarse grid -> fine grid (trailing ``len(fine_shape)`` axes)."""
    base = xc.ndim - len(fine_shape)
    out = xc
    for d, n in enumerate(fine_shape):
        if out.shape[base + d] != n:
            out = _apply_axis_resize(out, n, base + d)
    return out


def make_restrict(fine_shape: tuple[int, ...], coarse_shape: tuple[int, ...]):
    """R = Pᵀ exactly (the transpose of the prolongation matrices)."""

    def restrict(rf: torch.Tensor) -> torch.Tensor:
        base = rf.ndim - len(fine_shape)
        out = rf
        for d, (n_f, n_c) in enumerate(zip(fine_shape, coarse_shape)):
            if n_f != n_c:
                out = _apply_axis_resize(out, n_c, base + d, transpose=True)
        return out

    return restrict


def restrict_diag(diag_f: torch.Tensor, coarse_shape: tuple[int, ...]) -> torch.Tensor:
    """Galerkin diagonal transfer: diag_c[j] = Σ_i P_ij² diag_f[i]."""
    base = diag_f.ndim - len(coarse_shape)
    out = diag_f
    for d, n_c in enumerate(coarse_shape):
        if diag_f.shape[base + d] != n_c:
            out = _apply_axis_resize(out, n_c, base + d, transpose=True,
                                     square=True)
    return out


@functools.lru_cache(maxsize=None)
def _galerkin_axis_bands(n_c: int, n_f: int):
    """The reference's per-axis triple-product transfer (multigrid.py:268-290)
    in banded form: T[p, j, o, a] = Σ P[a, j]·P[a+o, j+p] (p ∈ −2..2, o ∈
    −1..1) is nonzero only where P[a, j] ≠ 0, i.e. for a in a window of W
    fine nodes around coarse node j. Returns (start [n_c] int64, the first
    fine node of row j's window, and T_band [5, 3, W, n_c] float64 with
    T_band[p, o, w, j] = T[p, j, o, start[j] + w]). The dense [5, n_c, 3,
    n_f] tensor is never formed: at 4096² it would be ~0.5 GB per axis."""
    P = _resize_matrix(n_f, n_c)  # prolongation [n_f, n_c]
    nz = P != 0
    first = np.argmax(nz, axis=0)
    last = n_f - 1 - np.argmax(nz[::-1], axis=0)
    W = int((last - first).max()) + 1
    start = np.minimum(first, n_f - W).astype(np.int64)
    T = np.zeros((5, 3, W, n_c))
    for a in range(n_f):
        for j in np.flatnonzero(nz[a]):
            pa = P[a, j]
            for oi, o in enumerate((-1, 0, 1)):
                b = a + o
                if 0 <= b < n_f:
                    for j2 in np.flatnonzero(nz[b]):
                        T[j2 - j + 2, oi, a - start[j], j] += pa * P[b, j2]
    start.setflags(write=False)
    T.setflags(write=False)
    return start, T


@functools.lru_cache(maxsize=None)
def _galerkin_band_tensors(n_c: int, n_f: int, dtype: torch.dtype,
                           device: torch.device):
    """`_galerkin_axis_bands` on ``device``: (rows [W, n_c] int64, the fine
    node of window term w of coarse node j; T_band [5, 3, W, n_c]). Made once
    per key."""
    start, T = _galerkin_axis_bands(n_c, n_f)
    rows = start[None, :] + np.arange(T.shape[2])[:, None]
    return (torch.tensor(rows, dtype=torch.int64, device=device),
            torch.tensor(T, dtype=dtype, device=device))


def _galerkin_axis(x: torch.Tensor, d: int, ndim: int, n_c: int,
                   base: int = 0) -> torch.Tensor:
    """Contract the stencil pair of axis d of x [*lanes, (3,)*D, *fine]
    (``base`` lane axes) with the banded triple product: the offset axis d
    (3 wide) becomes p (5 wide), the node axis D + d becomes the coarse one.
    The reference's tensordot (multigrid.py:315-318) over the nonzeros only:
    3·W gathers of n_c rows."""
    rows, T = _galerkin_band_tensors(n_c, x.shape[base + ndim + d], x.dtype, x.device)
    node_ax = base + ndim + d - 1  # the node axis once the offset axis is selected
    out = None
    for o in range(3):
        xo = x.select(base + d, o)
        for w in range(rows.shape[0]):
            g = torch.index_select(xo, node_ax, rows[w]).unsqueeze(0)
            t = T[:, o, w].reshape((5,) + (1,) * node_ax + (n_c,)
                                   + (1,) * (g.ndim - node_ax - 2))
            out = t * g if out is None else out + t * g
    return out.movedim(0, base + d)


def galerkin_coarse_coeff(coeff: torch.Tensor,
                          coarse_shape: tuple[int, ...]) -> torch.Tensor:
    """Full Galerkin transfer of a [3^D, *fine] data stencil to [3^D,
    *coarse] (the reference's multigrid.py:293-342): per-axis contractions
    with the banded triple products give the exact PᵀAP as a radius-2
    stencil; the |p| = 2 entries the endpoint-aligned transfers leave on
    non-dyadic grids are then folded SPD-safely, as the reference does:
    each symmetric pair is dropped and |e| added to both row diagonals,
    A_fold = PᵀAP + Σ |e|·(e_j ∓ e_{j+p})(e_j ∓ e_{j+p})ᵀ ⪰ PᵀAP. (The
    reference found that a row-sum-preserving inward fold makes the
    stencil indefinite and breaks CG; do not fold inward.) Leading lane
    axes of ``coeff`` ([B, 3^D, *fine]) are kept: each lane is transferred
    on its own."""
    ndim = len(coarse_shape)
    lanes = tuple(coeff.shape[:-(ndim + 1)])
    fine_shape = tuple(coeff.shape[-ndim:])
    x = coeff.reshape(lanes + (3,) * ndim + fine_shape)
    widths = []
    for d, (n_f, n_c) in enumerate(zip(fine_shape, coarse_shape)):
        if n_f == n_c:
            widths.append(3)
            continue
        x = _galerkin_axis(x, d, ndim, n_c, len(lanes))
        widths.append(5)
    kept, extra = {}, None
    lane_idx = (slice(None),) * len(lanes)
    for idx in itertools.product(*[range(w) for w in widths]):
        p = tuple(i - w // 2 for i, w in zip(idx, widths))
        term = x[lane_idx + idx]
        if all(abs(c) <= 1 for c in p):
            kept[p] = term
        else:
            extra = term.abs() if extra is None else extra + term.abs()
    center = (0,) * ndim
    chans = []
    for off in offset_list(ndim):
        p = tuple(int(v) for v in off)
        chans.append(kept[p] + extra if extra is not None and p == center
                     else kept[p])
    return torch.stack(chans, dim=len(lanes))


def chebyshev_coefs(rho: torch.Tensor, nu: int, config: SolverConfig) -> torch.Tensor:
    """[ν, 2] float32 Chebyshev schedule on D⁻¹A for the Gershgorin bound
    ``rho`` (a 0-dim tensor; the schedule stays on its device, nothing is
    read back), the reference's multigrid.py:345-380 op for op. The
    recurrence z⁺ = z + c1_k·(z − z_prev) + c2_k·D⁻¹(r − A z) starts from
    z_prev = z (or 0 from zero). "chebyshev": the first-kind polynomial on
    [ρ̂/mg_cheb_ratio, ρ̂]; "chebyshev4": the fourth-kind one on (0, ρ̂],
    c1_k = (2k−3)/(2k+1), c2_k = (8k−4)/((2k+1)·ρ̂), k = 1..ν. A [B] ``rho``
    (one bound per lane) gives the lanes' [B, ν, 2] schedules."""
    if nu <= 0:
        return torch.zeros(tuple(rho.shape) + (0, 2), dtype=torch.float32,
                           device=rho.device)
    if config.mg_smoother == "chebyshev4":
        rows = [torch.stack([torch.full_like(rho, (2.0 * k - 3.0) / (2.0 * k + 1.0)),
                             (8.0 * k - 4.0) / ((2.0 * k + 1.0) * rho)], dim=-1)
                for k in range(1, nu + 1)]
        return torch.stack(rows, dim=-2).to(torch.float32)
    lmax = rho
    lmin = rho / config.mg_cheb_ratio
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma = theta / delta
    rows = [torch.stack([torch.zeros_like(theta), 1.0 / theta], dim=-1)]
    rho_prev = 1.0 / sigma
    for _ in range(1, nu):
        rho_k = 1.0 / (2.0 * sigma - rho_prev)
        rows.append(torch.stack([rho_k * rho_prev, 2.0 * rho_k / delta], dim=-1))
        rho_prev = rho_k
    return torch.stack(rows, dim=-2).to(torch.float32)


@functools.lru_cache(maxsize=None)
def _smoothness_dense_matrix(shape: tuple[int, ...], weights: Weights) -> np.ndarray:
    """Dense matrix of the smoothness normal operator on a (small) grid;
    problem-independent, so the coarsest operator assembles as
    ``S_const + diag(data_diag)``."""
    n = math.prod(shape)
    S = np.zeros((n, n))
    for order in weights.active_orders():
        w2 = weights.model_weight(order) ** 2
        if order == 0:
            S += w2 * np.eye(n)
            continue
        taps = stencils.STENCIL_TAPS[order]
        L = len(taps)
        for ax, m in enumerate(shape):
            if m < L:
                continue
            B = np.zeros((m - L + 1, m))
            for r in range(m - L + 1):
                B[r, r:r + L] = taps
            mats = [np.eye(shape[d]) if d != ax else B.T @ B
                    for d in range(len(shape))]
            K = mats[0]
            for M in mats[1:]:
                K = np.kron(K, M)
            S += w2 * K
    S.setflags(write=False)
    return S


def _dense_data_matrix(data_coeff: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """Dense [n, n] matrix of a 3^D-channel data stencil: A[i, i+o] =
    coeff[o, i] ([B, n, n] for lanes [B, 3^D, *shape]). Entries that would
    wrap across a row are the (zero) out-of-grid coefficients, so diagonal
    placement is exact."""
    ndim = len(shape)
    n = math.prod(shape)
    lanes = tuple(data_coeff.shape[:-(ndim + 1)])
    strides = Grid(shape).strides
    flat = data_coeff.reshape(lanes + (3 ** ndim, n))
    A = torch.zeros(lanes + (n, n), dtype=flat.dtype, device=flat.device)
    for ci, off in enumerate(offset_list(ndim)):
        k = int(sum(int(o) * s for o, s in zip(off, strides)))
        idx = torch.arange(max(0, -k), min(n, n - k), device=flat.device)
        A[..., idx, idx + k] += flat[..., ci, idx]
    return A


def _coarse_dense_inverse(lvl: "_Level") -> torch.Tensor:
    """Exact symmetric inverse of the coarsest operator: constant smoothness
    matrix + the per-problem data term, as L⁻ᵀL⁻¹ from a Cholesky factor and
    one triangular solve, in the level's dtype.

    Factored in float64 and rounded once: the H100 has native float64, and
    at 256 nodes this is setup cost, so the preconditioner gets the
    correctly rounded inverse instead of one carrying float32 factorization
    error (about κ·2⁻²⁴, 4e-5 relative at the 16² level of the 64² tests;
    the reference factors in float32). L⁻ᵀL⁻¹ is symmetric only in exact
    arithmetic, so the 0.5·(X+Xᵀ) repair stays: CG needs an exactly
    symmetric preconditioner. A singular operator (no data rows under a
    smoothness term with a null space) gives NaN, as the reference's
    factorization does, instead of raising: a solve whose right-hand side
    is zero never applies it. A level with lanes ([B, *shape] leaves) gives
    [B, n, n]: one batched factorization, each lane on its own."""
    dtype, dev = lvl.diag.dtype, lvl.diag.device
    f64 = torch.float64
    lanes = tuple(lvl.diag.shape[:-len(lvl.shape)])
    S = torch.tensor(_smoothness_dense_matrix(lvl.shape, lvl.weights),
                     dtype=f64, device=dev)
    if lvl.data_coeff is not None:
        A_c = S + _dense_data_matrix(lvl.data_coeff.to(f64), lvl.shape)
    else:
        A_c = S + torch.diag_embed(lvl.data_diag.reshape(lanes + (-1,)).to(f64))
    L, info = torch.linalg.cholesky_ex(A_c)
    eye = torch.eye(A_c.shape[-1], dtype=f64, device=dev)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    inv = Linv.mT @ Linv
    ok = (info == 0).reshape(lanes + (1, 1))
    inv = torch.where(ok, 0.5 * (inv + inv.mT), torch.nan)
    return inv.to(dtype)


@dataclasses.dataclass(frozen=True)
class _Level:
    """One multigrid level below the fine problem."""

    data_diag: torch.Tensor   # diagonal of the data term [*shape]
    diag: torch.Tensor        # diag of this level's operator [*shape]
    shape: tuple[int, ...]
    weights: Weights
    # The full 3^D-channel stencil (Galerkin coarse data, or the degenerate
    # hierarchy's fine level); None = the lumped diagonal data_diag.
    data_coeff: torch.Tensor | None = None

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        s = stencils.smoothness_apply(x, self.weights, len(self.shape))
        if self.data_coeff is not None:
            return s + data_apply(x, self.data_coeff, len(self.shape))
        return s + self.data_diag * x


def _coarsen_weights(weights: Weights, ndim: int) -> Weights:
    factors = tuple(2.0 ** ((ndim - 2 * k) / 2.0) for k in range(4))
    return weights.scaled_model(factors)


@functools.lru_cache(maxsize=None)
def level_shapes(fine_shape: tuple[int, ...],
                 mg_min_size: int, mg_coarse_solver: str) -> tuple:
    """Shapes of the coarse hierarchy below ``fine_shape``."""
    shapes = []
    shape = fine_shape

    def needs_coarsening(shape):
        if min(shape) > mg_min_size:
            return True
        # With the dense coarsest solver, keep coarsening until the inverse
        # is small (≤ 1024 nodes): it is per-problem setup cost.
        return mg_coarse_solver == "dense" and math.prod(shape) > 1024

    while needs_coarsening(shape):
        coarse = Grid(shape).coarsen()
        if coarse.shape == shape:
            break
        shapes.append(coarse.shape)
        shape = coarse.shape
    return tuple(shapes)


def build_levels(problem: Problem, config: SolverConfig,
                 ddiag: torch.Tensor | None = None) -> list[_Level]:
    """Level hierarchy below the fine problem (level 0 IS the problem), with
    the diagonally lumped coarse data term or, under
    ``mg_coarse_data="galerkin"``, the full Galerkin stencil of each level
    (``data_coeff``; ``data_diag`` is then its center channel). ``ddiag``
    overrides the fine data diagonal the lumped levels coarsen (the sharded
    solve gathers it from the ranks' blocks)."""
    levels: list[_Level] = []
    weights = problem.weights
    ndim = problem.grid.ndim
    galerkin = config.mg_coarse_data == "galerkin"
    if ddiag is None:
        ddiag = data_diag(problem.coeff, ndim)
    dcoeff = problem.coeff if galerkin else None
    for coarse_shape in level_shapes(problem.grid.shape, config.mg_min_size,
                                     config.mg_coarse_solver):
        weights = _coarsen_weights(weights, ndim)
        if galerkin:
            dcoeff = galerkin_coarse_coeff(dcoeff, coarse_shape)
            ddiag = data_diag(dcoeff, ndim)
        else:
            ddiag = restrict_diag(ddiag, coarse_shape)
        diag = stencils.smoothness_diag(coarse_shape, weights, dtype=ddiag.dtype,
                                        device=ddiag.device) + ddiag
        levels.append(_Level(shape=coarse_shape, weights=weights,
                             data_diag=ddiag, diag=diag, data_coeff=dcoeff))
    return levels


def _rho_bound(row_abs: torch.Tensor, diag: torch.Tensor,
               ndim: int | None = None) -> torch.Tensor:
    """Gershgorin bound on ρ(D⁻¹A): max_i (Σ_j |A_ij|) / A_ii; with
    ``ndim``, over the trailing ``ndim`` grid axes only (one bound per
    lane of [B, *grid] operands)."""
    safe = torch.where(diag > 0, diag, torch.ones_like(diag))
    q = row_abs / safe
    if ndim is None or q.ndim == ndim:
        return torch.max(q)
    return torch.amax(q, dim=tuple(range(-ndim, 0)))


def fine_lumped(config: SolverConfig, fine_shape: tuple[int, ...]) -> bool:
    """Whether the fine level smooths with its lumped operator (smoothness +
    diagonal data); "auto" lumps 3-D grids past the `fits_vmem` gate."""
    if config.mg_fine_operator == "auto":
        return len(fine_shape) >= 3 and not fits_vmem(fine_shape)
    return config.mg_fine_operator == "lumped"


def level_rhos(levels) -> list[torch.Tensor]:
    """The Gershgorin bound ρ̂_l of every coarse level."""
    rhos = []
    for lvl in levels:
        nd = len(lvl.shape)
        rowabs = stencils.smoothness_row_abs_sum(lvl.shape, lvl.weights,
                                                 lvl.diag.dtype, lvl.diag.device)
        if lvl.data_coeff is not None:
            rowabs = rowabs + torch.sum(torch.abs(lvl.data_coeff), dim=-(nd + 1))
        else:
            rowabs = rowabs + lvl.data_diag
        rhos.append(_rho_bound(rowabs, lvl.diag, nd))
    return rhos


def build_smoothing_setup(problem: Problem, levels: list, config) -> tuple:
    """(lump, fine_ddiag, taus, rhos): the fine-level lumping decision, the
    per-level damped-Jacobi steps τ_l = 2·mg_omega/ρ̂(D_l⁻¹A_l) and the
    Gershgorin bounds ρ̂_l (the Chebyshev schedules' λmax). Shared by the
    plain V-cycle and the fused operands, as in the reference."""
    ndim = problem.grid.ndim
    dtype, dev = problem.diag.dtype, problem.diag.device
    lump = fine_lumped(config, problem.grid.shape)
    fine_ddiag = data_diag(problem.coeff, ndim)
    base = stencils.smoothness_row_abs_sum(problem.grid.shape, problem.weights,
                                           dtype, dev)
    if lump:
        fine_rowabs = base + fine_ddiag
    else:
        fine_rowabs = base + torch.sum(torch.abs(problem.coeff), dim=-(ndim + 1))
    rhos = [_rho_bound(fine_rowabs, problem.diag, ndim)] + level_rhos(levels)
    taus = [2.0 * config.mg_omega / r for r in rhos]
    return lump, fine_ddiag, taus, rhos


def _inv_diag(diag: torch.Tensor) -> torch.Tensor:
    return torch.where(diag > 0, 1.0 / diag, torch.ones_like(diag))


def _on_lanes(t: torch.Tensor, ndim: int) -> torch.Tensor:
    """A per-level scalar (τ_l), one per lane when [B], shaped to scale
    [B, *grid] arrays."""
    return t.reshape(t.shape + (1,) * ndim) if t.ndim else t


def _dense_solve(inv: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """inv · r on a level of n nodes: inv [n, n] on r [*grid], or per lane
    inv [B, n, n] on r [B, *grid] as one batched product."""
    if inv.ndim == 3:
        return (inv @ r.reshape(r.shape[0], -1, 1)).reshape(r.shape)
    return (inv @ r.reshape(-1)).reshape(r.shape)


def _is_cheb(config: SolverConfig) -> bool:
    return config.mg_smoother.startswith("chebyshev")


def _level_coeffs(problem: Problem, levels) -> list[torch.Tensor]:
    """Per level the data term the fused kernels take: the fine [3^D,
    *shape] stencil, then each coarse level's full Galerkin stencil or its
    [*shape] diagonal (the kernels tell them apart by rank)."""
    return [problem.coeff] + [l.data_diag if l.data_coeff is None else l.data_coeff
                              for l in levels]


def _fused_vcycle_operands(problem, levels, taus, fine_inv_diag, inv_diags,
                           coarse_dense, config, rhos):
    """The per-level operands of the fused segment and whole-cycle kernels
    (the reference's multigrid.py:599-640): (coeffs, sids, Rs per-axis
    restriction matrices, inv32 dense coarsest inverse, level Weights,
    cfs). coeffs as `_level_coeffs`. Jacobi: sids = τ_l·D_l⁻¹, cfs None;
    Chebyshev: sids = D_l⁻¹ unscaled, cfs[l] the [ν, 2] schedule of
    `chebyshev_coefs` for ρ̂_l. None if the working set exceeds the
    reference's 12 MB VMEM budget (TPU policy, kept for parity). On a
    problem with lanes (leaves [B, ...]) every operand but Rs and the level
    Weights has the lane axis first: τ_l, ρ̂_l and the schedules are per
    lane."""
    if not _fused_operands_fit(problem, levels, config):
        return None
    ndim = problem.grid.ndim
    f32 = torch.float32
    shapes_all = [problem.grid.shape] + [l.shape for l in levels]
    # Contiguous: the kernels read every operand by flat index.
    coeffs = [c.to(f32).contiguous() for c in _level_coeffs(problem, levels)]
    lw = [problem.weights] + [l.weights for l in levels]
    inv_all = [fine_inv_diag] + list(inv_diags)
    cfs = None
    if _is_cheb(config):
        sids = [d.to(f32).contiguous() for d in inv_all]
        cfs = [chebyshev_coefs(r, config.mg_pre_smooth, config) for r in rhos]
    else:
        # A lane's τ_l scales that lane's grid.
        sids = [(_on_lanes(t, ndim) * d).to(f32).contiguous()
                for t, d in zip(taus, inv_all)]
    dev = problem.coeff.device
    Rs = [_restriction_tensor(shapes_all[i][d], shapes_all[i + 1][d], dev)
          for i in range(len(shapes_all) - 1) for d in range(ndim)]
    inv32 = coarse_dense.to(f32).contiguous()
    return coeffs, sids, Rs, inv32, lw, cfs


def _operands_fit(shapes, config: SolverConfig) -> bool:
    """The reference's 12 MB VMEM budget for the fused-cycle operands of one
    field (multigrid.py:635-639; TPU policy, kept for parity) on a hierarchy
    of ``shapes`` (the fine grid first): every level's data term (the fine
    level's and a Galerkin level's 3^D channels), the dense coarsest
    inverse and 3 fine arrays of scratch, 4 under Chebyshev (z_prev)."""
    ndim = len(shapes[0])
    coarse_chans = 3 ** ndim if config.mg_coarse_data == "galerkin" else 1
    n_c = math.prod(shapes[-1])
    scratch = 4 if _is_cheb(config) else 3
    est = (sum((3 ** ndim if l == 0 else coarse_chans) * math.prod(s)
               for l, s in enumerate(shapes))
           + n_c * n_c + scratch * math.prod(shapes[0])) * 4
    return est <= 12 * 1024 * 1024


def _fused_operands_fit(problem: Problem, levels, config: SolverConfig) -> bool:
    """`_operands_fit` on a built hierarchy."""
    return _operands_fit([problem.grid.shape] + [l.shape for l in levels], config)


def fused_levels_ok(fine_shape: tuple[int, ...], config: SolverConfig) -> bool:
    """The fused segment's conditions on the hierarchy below ``fine_shape``
    (the reference's multigrid.py:745-752), from shapes and config alone:
    at least one coarse level, a coarsest of ≤ 4096 nodes, every level
    inside `fits_vmem`, a fine level smoothed with its full data stencil
    and the operands inside `_operands_fit`. With `_fused_gate` it decides
    the fused path before anything is built."""
    levels = level_shapes(fine_shape, config.mg_min_size, config.mg_coarse_solver)
    return (bool(levels) and math.prod(levels[-1]) <= 4096
            and all(fits_vmem(s) for s in levels)
            and not fine_lumped(config, fine_shape)
            and _operands_fit((fine_shape,) + levels, config))


def _fused_gate(problem: Problem, config: SolverConfig) -> bool:
    """The fused 2-D PCG path's gate on the problem and config, before any
    level is built (the reference's multigrid.py:729-745)."""
    return (problem.grid.ndim == 2 and config.preconditioner == "multigrid"
            and config.mg_coarse_solver == "dense"
            and config.mg_pre_smooth == config.mg_post_smooth
            and problem.diag.dtype == torch.float32
            and fits_vmem(problem.grid.shape))


def _fused_operands(problem: Problem, config: SolverConfig, levels, setup=None,
                    coarse_dense=None):
    """The fused segment's operands on a built hierarchy past `_fused_gate`,
    or None where the levels rule the path out; ``setup``
    (`build_smoothing_setup`) and ``coarse_dense`` are built when None."""
    if not fused_levels_ok(problem.grid.shape, config):
        return None
    _, _, taus, rhos = (build_smoothing_setup(problem, levels, config)
                        if setup is None else setup)
    if coarse_dense is None:
        coarse_dense = _coarse_dense_inverse(levels[-1])
    return _fused_vcycle_operands(problem, levels, taus, _inv_diag(problem.diag),
                                  [_inv_diag(l.diag) for l in levels],
                                  coarse_dense, config, rhos)


def build_fused_solver_operands(problem: Problem, config: SolverConfig,
                                prep: "MGPrep | None" = None):
    """Setup for the fused 2-D PCG segment, or None when the problem shape
    or config rules the fused path out (the reference's gate,
    multigrid.py:729-752). ``prep`` (`prepare_mg` on the same problem and
    config) hands back its operands instead of building them."""
    if prep is not None:
        if prep.fused is None:
            return None
        coeffs, sids, Rs, inv32, cfs = prep.fused
        lw = [problem.weights] + [l.weights for l in prep.levels]
        return list(coeffs), list(sids), list(Rs), inv32, lw, cfs
    if not _fused_gate(problem, config):
        return None
    return _fused_operands(problem, config, build_levels(problem, config))


def resolve_wdepth(config: SolverConfig, fine_shape: tuple[int, ...]) -> int:
    """Doubled-transition count for the W-cycle (0 = plain V); "auto" picks
    V inside the `fits_vmem` gate and W beyond it (the reference's TPU
    policy, kept for parity)."""
    cycle = config.mg_cycle
    if cycle == "auto":
        cycle = "v" if fits_vmem(fine_shape) else "w"
    return config.mg_wcycle_depth if cycle == "w" else 0


def smoother_plan(shapes, diag_data, radius: int, nu_max: int) -> list:
    """Per level, the reference kernel that smooths it with
    ``pallas_smooth`` on (multigrid.py:959-1004): "fused_smooth" where the
    level fits whole in VMEM, else "fused_smooth_striped" /
    "fused_smooth_tiled" (2-D full data), "fused_sweep_striped2_3d" (3-D
    diagonal data) or "fused_sweep_striped_diag" (2-D diagonal data) where
    that kernel's tiling fits, and None where the reference runs XLA sweeps.
    The port's smoothing kernels stand in for all of them, and run at the
    None levels too.
    ``diag_data[l]``: the level's data term is a diagonal plane; ``radius``:
    the operator radius (≥ 1), the same on every level."""
    plan = []
    for shape, diag in zip(shapes, diag_data):
        ndim = len(shape)
        name = None
        if fits_vmem(shape, diag_data=diag):
            name = "fused_smooth"
        elif ndim == 2 and not diag:
            if _policy.pick_stripe_smooth(shape, radius, nu_max) is not None:
                name = "fused_smooth_striped"
            elif _policy.pick_tile_smooth(shape, radius, nu_max) is not None:
                name = "fused_smooth_tiled"
        elif ndim == 3 and diag:
            if _policy.pick_stripe2_3d_sweep(shape) is not None:
                name = "fused_sweep_striped2_3d"
        elif ndim == 2 and diag:
            if _policy.pick_stripe_sweep_diag(shape) is not None:
                name = "fused_sweep_striped_diag"
        plan.append(name)
    return plan


def kernel_plan(problem: Problem, config: SolverConfig, levels, lump: bool):
    """(per-level smoother names from `smoother_plan`, the reference's
    whole-cycle kernel or None). The whole-cycle kernels
    (``fused_vcycle_2d`` / ``fused_wcycle_2d``, multigrid.py:1017-1042) take
    over a 2-D cycle whose every level has a kernel smoother, with a dense
    coarsest solve and ν_pre = ν_post, inside the fused-operand budget."""
    shapes = [problem.grid.shape] + [l.shape for l in levels]
    radius = max(stencils.max_stencil_radius(problem.weights), 1)
    plan = smoother_plan(shapes, [lump] + [l.data_coeff is None for l in levels],
                         radius, max(config.mg_pre_smooth, config.mg_post_smooth))
    whole = None
    if (problem.grid.ndim == 2 and config.mg_coarse_solver == "dense" and levels
            and math.prod(levels[-1].shape) <= 4096
            and all(n is not None for n in plan)
            and config.mg_pre_smooth == config.mg_post_smooth
            and _fused_operands_fit(problem, levels, config)):
        whole = ("fused_wcycle_2d" if resolve_wdepth(config, problem.grid.shape)
                 else "fused_vcycle_2d")
    return plan, whole


def _kernel_smoother(coeff, sid, weights: Weights, ndim: int, schedule=None):
    """smooth(r, z, sweeps, from_zero, residual) on one level through a
    smoothing kernel: z, or with ``residual`` (z, r − A z), both from the
    kernel's call. ``coeff`` is the level's full stencil or diagonal data
    term. A 2-D full stencil goes to the multi-sweep kernel below radius 3;
    everything else, radius-3 weights included (where the per-sweep kernel
    is the faster on every phase measured, PERF.md), to the per-sweep
    kernel. ``schedule``: None (damped Jacobi, sid = τ·D⁻¹) or a function
    of the sweep count giving its [ν, 2] Chebyshev schedule (sid = D⁻¹)."""
    c32 = coeff.to(torch.float32).contiguous()
    s32 = sid.to(torch.float32).contiguous()
    # The full stencil has one more axis than sid (lanes or not).
    multi = (ndim == 2 and c32.ndim == s32.ndim + 1
             and stencils.max_stencil_radius(weights) < 3)

    def smooth(r, z, sweeps, from_zero, residual):
        cf = None if schedule is None else schedule(sweeps)
        if multi:
            return fused_smooth_2d(r.contiguous(), z.contiguous(), c32, s32, weights, sweeps,
                                   from_zero, cheb_coefs=cf, residual=residual)
        return fused_smooth(r.contiguous(), z.contiguous(), c32, s32, weights, ndim, sweeps,
                            from_zero, cheb_coefs=cf, residual=residual)
    return smooth


def whole_cycle_operands(problem: Problem, config: SolverConfig, levels=None,
                         setup=None, coarse_dense=None):
    """((coeffs, sids, Rs, inv32, lw), wdepth, cfs) that the whole-cycle
    route hands its kernel (the reference's route, multigrid.py:1017-1042),
    or None where `kernel_plan` names no whole-cycle kernel. The operands
    are `_fused_vcycle_operands` with the cycle's own taus and ρ̂: under
    ``mg_fine_operator="lumped"`` those are the lumped fine level's while
    coeffs[0] stays the full 9-channel stencil, as in the reference; cfs
    are the Chebyshev schedules (None under Jacobi). ``levels``, ``setup``
    (`build_smoothing_setup`'s result) and ``coarse_dense`` (the coarsest
    inverse) are reused when given."""
    levels = build_levels(problem, config) if levels is None else levels
    lump, _, taus, rhos = (build_smoothing_setup(problem, levels, config)
                           if setup is None else setup)
    if kernel_plan(problem, config, levels, lump)[1] is None:
        return None
    if coarse_dense is None:
        coarse_dense = _coarse_dense_inverse(levels[-1])
    coeffs, sids, Rs, inv32, lw, cfs = _fused_vcycle_operands(
        problem, levels, taus, _inv_diag(problem.diag),
        [_inv_diag(l.diag) for l in levels], coarse_dense, config, rhos)
    return ((coeffs, sids, Rs, inv32, lw), resolve_wdepth(config, problem.grid.shape),
            cfs)


def _whole_cycle(ops, wdepth: int, cfs, config: SolverConfig):
    """The cycle as one whole-cycle kernel call on `whole_cycle_operands`'
    result: the W-cycle wrapper when ``wdepth > 0``, else the V-cycle's."""
    from .ops import cycle  # ops.cycle imports this module
    if wdepth > 0:
        return lambda r: cycle.fused_wcycle_2d(r.contiguous(), *ops, config.mg_pre_smooth,
                                               cheb_coefs=cfs, wdepth=wdepth)
    return lambda r: cycle.fused_vcycle_2d(r.contiguous(), *ops, config.mg_pre_smooth,
                                           config.mg_post_smooth, cheb_coefs=cfs)


def _degenerate(problem: Problem, levels, config: SolverConfig) -> bool:
    """The grid is already at the coarsening floor: the whole problem is
    the coarsest level, solved exactly with the fine operator's inverse."""
    return (not levels and config.mg_coarse_solver == "dense"
            and math.prod(problem.grid.shape) <= 4096)


def _fine_inverse(problem: Problem) -> torch.Tensor:
    """The degenerate hierarchy's dense inverse of the fine operator (full
    data stencil)."""
    return _coarse_dense_inverse(_Level(
        shape=problem.grid.shape, weights=problem.weights,
        data_diag=data_diag(problem.coeff, problem.grid.ndim), diag=problem.diag,
        data_coeff=problem.coeff))


def _coarsest_inverse(levels, config: SolverConfig):
    """The dense coarsest inverse of a hierarchy, or None where the cycle
    smooths its coarsest level instead."""
    if (config.mg_coarse_solver == "dense" and levels
            and math.prod(levels[-1].shape) <= 4096):
        return _coarse_dense_inverse(levels[-1])
    return None


def _smoother_operands(problem: Problem, config: SolverConfig, levels, setup,
                       inv_diags) -> list:
    """Per level the (data term, sid) pair the smoothing kernels take, as
    float32 contiguous tensors: the lumped diagonal or full stencil, and
    τ_l·D_l⁻¹ (D_l⁻¹ unscaled under Chebyshev, which reads its per-sweep
    scalars off the schedule)."""
    lump, fine_ddiag, taus, _ = setup
    coeffs = [fine_ddiag if lump else problem.coeff] + _level_coeffs(problem, levels)[1:]
    cheb = _is_cheb(config)
    f32 = torch.float32
    nd = problem.grid.ndim
    return [(c.to(f32).contiguous(),
             (d if cheb else _on_lanes(t, nd) * d).to(f32).contiguous())
            for c, t, d in zip(coeffs, taus, inv_diags)]


@dataclasses.dataclass(frozen=True)
class MGPrep:
    """Reusable multigrid setup (the reference's multigrid.py:643-670),
    built once by `prepare_mg` (through ``solver.prepare``) for repeated
    solves on one operator, where only ``b`` changes: everything a solve
    would otherwise build on the device. ``shape``, ``weights`` and ``sig``
    (`setup_signature`) are what ``solver._check_prep`` holds a problem and
    config to, so that a stale prep raises instead of preconditioning with
    the wrong hierarchy."""

    levels: tuple                 # of _Level
    setup: tuple                  # build_smoothing_setup: (lump, fine_ddiag, taus, rhos)
    inv_diags: tuple              # D_l⁻¹, the fine level first
    # The dense coarsest inverse; for a degenerate hierarchy (no levels) the
    # fine operator's. None where the cycle smooths its coarsest level.
    coarse_dense: torch.Tensor | None
    fused: tuple | None           # build_fused_solver_operands: (coeffs, sids, Rs, inv32, cfs)
    whole: tuple | None           # whole_cycle_operands: (operands, cfs)
    smooth_ops: tuple | None      # _smoother_operands, where the cycle runs the kernels
    schedules: dict               # (level, sweeps) → Chebyshev schedule
    kernels: bool                 # built for make_vcycle_preconditioner(kernels=...)
    shape: tuple
    weights: Weights
    sig: tuple


def setup_signature(config: SolverConfig) -> tuple:
    """The SolverConfig fields a prepared setup depends on (the reference's
    multigrid.py:673-680): tol, maxiter and the rest may vary between solves
    that share one MGPrep; these may not."""
    return (config.preconditioner, config.backend, config.mg_pre_smooth,
            config.mg_post_smooth, config.mg_smoother, config.mg_cheb_ratio,
            config.mg_coarse_data, config.mg_coarse_solver,
            config.mg_coarse_iters, config.mg_omega,
            config.mg_fine_operator, config.mg_min_size)


def prepare_mg(problem: Problem, config: SolverConfig, fused: bool = True,
               kernels: bool = False) -> MGPrep:
    """Build the reusable setup of `MGPrep` on the device of ``problem``:
    the fused segment's operands where ``fused`` and the problem takes that
    path (exactly where `build_fused_solver_operands` gives them), and the
    cycle's for ``make_vcycle_preconditioner(kernels=kernels)``."""
    levels = build_levels(problem, config)
    setup = build_smoothing_setup(problem, levels, config)
    inv_diags = tuple(_inv_diag(d) for d in [problem.diag] + [l.diag for l in levels])
    if _degenerate(problem, levels, config):
        coarse_dense = _fine_inverse(problem)
    else:
        coarse_dense = _coarsest_inverse(levels, config)
    fused_ops = None
    if fused and _fused_gate(problem, config):
        ops = _fused_operands(problem, config, levels, setup, coarse_dense)
        if ops is not None:
            coeffs, sids, Rs, inv32, _, cfs = ops
            fused_ops = (tuple(coeffs), tuple(sids), tuple(Rs), inv32, cfs)
    whole = smooth_ops = None
    if kernels:
        w = whole_cycle_operands(problem, config, levels, setup, coarse_dense)
        whole = None if w is None else (w[0], w[2])
        smooth_ops = tuple(_smoother_operands(problem, config, levels, setup, inv_diags))
    schedules = {}
    if _is_cheb(config):
        sweeps = {config.mg_pre_smooth, config.mg_post_smooth}
        if coarse_dense is None:
            sweeps.add(config.mg_coarse_iters)
        rhos = setup[3]
        schedules = {(li, n): chebyshev_coefs(rhos[li], n, config)
                     for li in range(len(rhos)) for n in sweeps}
    return MGPrep(levels=tuple(levels), setup=setup, inv_diags=inv_diags,
                  coarse_dense=coarse_dense, fused=fused_ops, whole=whole,
                  smooth_ops=smooth_ops, schedules=schedules, kernels=kernels,
                  shape=problem.grid.shape, weights=problem.weights,
                  sig=setup_signature(config))


def make_vcycle_preconditioner(problem: Problem, config: SolverConfig,
                               apply_fn=None, kernels: bool = False,
                               prep: MGPrep | None = None):
    """Returns z = M⁻¹ r: one symmetric multigrid cycle with damped-Jacobi
    or Chebyshev smoothing. ``apply_fn`` overrides the fine-level operator
    apply. ``kernels`` (the reference's ``pallas_smooth``): run the cycle as
    one whole-cycle kernel call where the reference does
    (`whole_cycle_operands`), else smooth every level through a smoothing
    kernel (`_kernel_smoother`). The setup comes from ``prep`` (`prepare_mg`
    on the same problem and config, with the same ``kernels``) or is built
    here by `prepare_mg`: a prepared and a cold cycle are one code path.
    On a problem with lanes, z = M⁻¹ r for r [B, *grid], each lane its own
    cycle."""
    if prep is None:
        prep = prepare_mg(problem, config, fused=False, kernels=kernels)
    elif prep.kernels != kernels:
        raise ValueError(f"prep was built for kernels={prep.kernels}, the cycle "
                         f"runs with kernels={kernels}")
    levels = list(prep.levels)
    nu = config.mg_pre_smooth
    ndim = problem.grid.ndim

    if _degenerate(problem, levels, config):
        # The whole problem IS the coarsest level; solve it exactly.
        inv0 = prep.coarse_dense
        return lambda r: _dense_solve(inv0, r)

    if kernels and prep.whole is not None:
        ops, cfs = prep.whole
        return _whole_cycle(ops, resolve_wdepth(config, problem.grid.shape), cfs, config)
    lump, fine_ddiag, taus, rhos = prep.setup
    if lump:
        def fine_apply(x):
            return stencils.smoothness_apply(x, problem.weights, ndim) + fine_ddiag * x
    else:
        fine_apply = problem.apply if apply_fn is None else apply_fn
    inv_diags = prep.inv_diags
    applies = [fine_apply] + [l.apply for l in levels]
    shapes = [problem.grid.shape] + [l.shape for l in levels]
    coarse_dense = prep.coarse_dense
    cheb = _is_cheb(config)

    @functools.lru_cache(maxsize=None)
    def schedule(li, iters):
        # The prep's, or made once per (level, sweep count) on the device of ρ̂_l.
        if (li, iters) in prep.schedules:
            return prep.schedules[li, iters]
        return chebyshev_coefs(rhos[li], iters, config)

    smoothers = [None] * len(shapes)
    if kernels:
        weights = [problem.weights] + [l.weights for l in levels]
        smoothers = [_kernel_smoother(c, sid, w, ndim,
                                      functools.partial(schedule, li) if cheb else None)
                     for li, ((c, sid), w) in enumerate(zip(prep.smooth_ops, weights))]

    def smooth(li, r, z, iters):
        # z None = from zero: the first sweep is sid·r (Jacobi).
        if cheb:
            # z⁺ = z + c1_k·(z − z_prev) + c2_k·D⁻¹(r − A z), z_prev = z at
            # the start (the reference's multigrid.py:862-872).
            cf = schedule(li, iters)
            z = torch.zeros_like(r) if z is None else z
            zp = z
            for k in range(iters):
                c1, c2 = (_schedule_entry(cf, k, j, ndim) for j in (0, 1))
                z, zp = z + c1 * (z - zp) + c2 * inv_diags[li] * (r - applies[li](z)), z
            return z
        for _ in range(iters):
            az = 0.0 if z is None else applies[li](z)
            z = (0.0 if z is None else z) + _on_lanes(taus[li], ndim) * inv_diags[li] * (r - az)
        return z

    def level_smooth(li, r, z, iters, from_zero, residual=False):
        # z, or with ``residual`` (z, r − A z), taken from the smoothing
        # kernel's call where one runs. iters == 0 is NO smoothing: zeros
        # from a zero guess, z untouched otherwise (the kernels count the
        # from-zero step as a sweep, so the guard sits here, as in the
        # reference, multigrid.py:1044-1057).
        if iters == 0:
            z = torch.zeros_like(r) if from_zero else z
        elif smoothers[li] is not None:
            return smoothers[li](r, z, iters, from_zero, residual)
        else:
            z = smooth(li, r, None if from_zero else z, iters)
        return (z, r - applies[li](z)) if residual else z

    wdepth = resolve_wdepth(config, problem.grid.shape)

    def vcycle(r, li, residual=False):
        # The cycle's z on level li, or with ``residual`` (z, r − A_li z).
        if li == len(levels):  # coarsest
            if coarse_dense is not None:
                return _dense_solve(coarse_dense, r)
            return level_smooth(li, r, r, config.mg_coarse_iters, True)
        z, res = level_smooth(li, r, r, nu, True, residual=True)
        rc = make_restrict(shapes[li], shapes[li + 1])(res)
        if wdepth > li and li + 1 < len(levels):
            # W-cycle: a second visit on the residual the first leaves,
            # which the first visit's post-smoothing writes.
            zc, rc2 = vcycle(rc, li + 1, residual=True)
            zc = zc + vcycle(rc2, li + 1)
        else:
            zc = vcycle(rc, li + 1)
        z = z + prolong(zc, shapes[li])
        return level_smooth(li, r, z, config.mg_post_smooth, False, residual)

    return lambda r: vcycle(r, 0)
