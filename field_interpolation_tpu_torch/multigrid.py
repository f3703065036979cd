"""Geometric multigrid V-cycle preconditioner (plain torch setup and cycle).

Counterpart of ``field_interpolation_tpu.multigrid``:

* transfers — endpoint-aligned separable linear prolongation ``P`` as dense
  per-axis matrices (`_resize_matrix`, the reference's numpy constant); the
  restriction is literally ``Pᵀ``, which with symmetric pre/post damped-Jacobi
  smoothing keeps the V-cycle symmetric positive definite (safe in CG).
* coarse operators — rediscretized smoothness with energy-matched weights
  ``w_k ← w_k · 2^{(D-2k)/2}`` per coarsening, plus the diagonally lumped
  data term ``diag_c = Pᵀ² diag_f``.
* coarsest level — a dense inverse built at setup, one small matvec per cycle.

Only the lumped coarse data, the damped-Jacobi smoother and the dense or
Jacobi coarsest solve are ported; Galerkin coarse data and Chebyshev
smoothing raise ``NotImplementedError`` (ROADMAP.md).

With ``kernels=True`` (the reference's ``pallas_smooth``) every level smooths
through the port's sweep kernel (`ops.smooth.fused_smooth`), full or
diagonal data, at any size. The reference's per-level choice
(`smoother_plan`) only decides where a CUDA problem raises
``NotImplementedError``: a level or cycle for which the reference runs a
kernel not ported yet. The cycle itself (residuals, transfers, the dense
coarsest solve) is plain torch, as it is XLA in the reference.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from . import stencils
from .constraints import data_apply, data_diag, offset_list
from .grid import Grid
from .operators import Problem
from .ops import _policy
from .ops._policy import fits_vmem
from .ops.smooth import fused_smooth
from .weights import SolverConfig, Weights


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} needs a TPU kernel that is not ported to CUDA yet (ROADMAP "
        "queue 2); pass SolverConfig(backend='xla') to run plain torch ops")


def _require_ported(config: SolverConfig) -> None:
    if config.mg_coarse_data != "lumped":
        raise NotImplementedError(
            "mg_coarse_data='galerkin' is not ported (ROADMAP queue 1, "
            "Chebyshev / W-cycle / Galerkin)")
    if config.mg_smoother != "jacobi":
        raise NotImplementedError(
            f"mg_smoother={config.mg_smoother!r} is not ported (ROADMAP "
            "queue 1, Chebyshev / W-cycle / Galerkin)")


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


def _apply_axis_matrix(x: torch.Tensor, P: np.ndarray, axis: int) -> torch.Tensor:
    """Contract matrix P [n_out, n_in] with x's ``axis``."""
    Pt = torch.tensor(P, dtype=x.dtype, device=x.device)
    return torch.movedim(torch.tensordot(Pt, x, dims=([1], [axis])), 0, axis)


def prolong(xc: torch.Tensor, fine_shape: tuple[int, ...]) -> torch.Tensor:
    """P: coarse grid -> fine grid (trailing ``len(fine_shape)`` axes)."""
    base = xc.ndim - len(fine_shape)
    out = xc
    for d, n in enumerate(fine_shape):
        if out.shape[base + d] != n:
            out = _apply_axis_matrix(out, _resize_matrix(n, out.shape[base + d]),
                                     base + d)
    return out


def make_restrict(fine_shape: tuple[int, ...], coarse_shape: tuple[int, ...]):
    """R = Pᵀ exactly (the transpose of the prolongation matrices)."""

    def restrict(rf: torch.Tensor) -> torch.Tensor:
        base = rf.ndim - len(fine_shape)
        out = rf
        for d, (n_f, n_c) in enumerate(zip(fine_shape, coarse_shape)):
            if n_f != n_c:
                out = _apply_axis_matrix(out, _resize_matrix(n_f, n_c).T, base + d)
        return out

    return restrict


def restrict_diag(diag_f: torch.Tensor, coarse_shape: tuple[int, ...]) -> torch.Tensor:
    """Galerkin diagonal transfer: diag_c[j] = Σ_i P_ij² diag_f[i]."""
    base = diag_f.ndim - len(coarse_shape)
    out = diag_f
    for d, n_c in enumerate(coarse_shape):
        n_f = diag_f.shape[base + d]
        if n_f != n_c:
            out = _apply_axis_matrix(out, _resize_matrix(n_f, n_c, square=True).T,
                                     base + d)
    return out


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
    coeff[o, i]. Entries that would wrap across a row are the (zero)
    out-of-grid coefficients, so diagonal placement is exact."""
    ndim = len(shape)
    n = math.prod(shape)
    strides = Grid(shape).strides
    flat = data_coeff.reshape(3 ** ndim, n)
    A = torch.zeros((n, n), dtype=flat.dtype, device=flat.device)
    for ci, off in enumerate(offset_list(ndim)):
        k = int(sum(int(o) * s for o, s in zip(off, strides)))
        idx = torch.arange(max(0, -k), min(n, n - k), device=flat.device)
        A[idx, idx + k] += flat[ci][idx]
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
    symmetric preconditioner."""
    dtype, dev = lvl.diag.dtype, lvl.diag.device
    f64 = torch.float64
    S = torch.tensor(_smoothness_dense_matrix(lvl.shape, lvl.weights),
                     dtype=f64, device=dev)
    if lvl.data_coeff is not None:
        A_c = S + _dense_data_matrix(lvl.data_coeff.to(f64), lvl.shape)
    else:
        A_c = S + torch.diag(lvl.data_diag.reshape(-1).to(f64))
    L = torch.linalg.cholesky(A_c)
    eye = torch.eye(A_c.shape[0], dtype=f64, device=dev)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    inv = Linv.T @ Linv
    return (0.5 * (inv + inv.T)).to(dtype)


@dataclasses.dataclass(frozen=True)
class _Level:
    """One multigrid level below the fine problem."""

    data_diag: torch.Tensor   # diagonal of the data term [*shape]
    diag: torch.Tensor        # diag of this level's operator [*shape]
    shape: tuple[int, ...]
    weights: Weights
    data_coeff: torch.Tensor | None = None  # full stencil (degenerate hierarchy)

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


def build_levels(problem: Problem, config: SolverConfig) -> list[_Level]:
    """Level hierarchy below the fine problem (level 0 IS the problem), with
    the diagonally lumped coarse data term."""
    _require_ported(config)
    levels: list[_Level] = []
    weights = problem.weights
    ndim = problem.grid.ndim
    ddiag = data_diag(problem.coeff, ndim)
    for coarse_shape in level_shapes(problem.grid.shape, config.mg_min_size,
                                     config.mg_coarse_solver):
        weights = _coarsen_weights(weights, ndim)
        ddiag = restrict_diag(ddiag, coarse_shape)
        diag = stencils.smoothness_diag(coarse_shape, weights, dtype=ddiag.dtype,
                                        device=ddiag.device) + ddiag
        levels.append(_Level(shape=coarse_shape, weights=weights,
                             data_diag=ddiag, diag=diag))
    return levels


def _rho_bound(row_abs: torch.Tensor, diag: torch.Tensor) -> torch.Tensor:
    """Gershgorin bound on ρ(D⁻¹A): max_i (Σ_j |A_ij|) / A_ii."""
    safe = torch.where(diag > 0, diag, torch.ones_like(diag))
    return torch.max(row_abs / safe)


def build_smoothing_setup(problem: Problem, levels: list, config) -> tuple:
    """(lump, fine_ddiag, taus, rhos): the fine-level lumping decision, the
    per-level damped-Jacobi steps τ_l = 2·mg_omega/ρ̂(D_l⁻¹A_l) and the
    Gershgorin bounds ρ̂_l. Shared by the plain V-cycle and the fused
    operands, as in the reference."""
    ndim = problem.grid.ndim
    dtype, dev = problem.diag.dtype, problem.diag.device
    lump = config.mg_fine_operator == "lumped"
    if config.mg_fine_operator == "auto":
        lump = ndim >= 3 and not fits_vmem(problem.grid.shape)
    fine_ddiag = data_diag(problem.coeff, ndim)
    base = stencils.smoothness_row_abs_sum(problem.grid.shape, problem.weights,
                                           dtype, dev)
    if lump:
        fine_rowabs = base + fine_ddiag
    else:
        fine_rowabs = base + torch.sum(torch.abs(problem.coeff), dim=-(ndim + 1))
    rhos = [_rho_bound(fine_rowabs, problem.diag)]
    for lvl in levels:
        rowabs = stencils.smoothness_row_abs_sum(lvl.shape, lvl.weights,
                                                 lvl.diag.dtype, dev)
        rhos.append(_rho_bound(rowabs + lvl.data_diag, lvl.diag))
    taus = [2.0 * config.mg_omega / r for r in rhos]
    return lump, fine_ddiag, taus, rhos


def _inv_diag(diag: torch.Tensor) -> torch.Tensor:
    return torch.where(diag > 0, 1.0 / diag, torch.ones_like(diag))


def _fused_vcycle_operands(problem, levels, taus, fine_inv_diag, inv_diags,
                           coarse_dense, config):
    """The per-level operands of the fused segment kernel: (coeffs, sids, Rs
    per-axis restriction matrices, inv32 dense coarsest inverse, level
    Weights, None). coeffs[l] is the fine [3^D, *shape] stencil or a coarse
    [*shape] diagonal; sids = τ_l·D_l⁻¹. None if the working set exceeds the
    reference's 12 MB VMEM budget (TPU policy, kept for parity)."""
    ndim = problem.grid.ndim
    f32 = torch.float32
    shapes_all = [problem.grid.shape] + [l.shape for l in levels]
    # Contiguous: the segment kernel reads every operand by flat index.
    coeffs = [c.to(f32).contiguous()
              for c in [problem.coeff] + [l.data_diag for l in levels]]
    lw = [problem.weights] + [l.weights for l in levels]
    inv_all = [fine_inv_diag] + list(inv_diags)
    sids = [(t * d).to(f32).contiguous() for t, d in zip(taus, inv_all)]
    dev = problem.coeff.device
    Rs = []
    for i in range(len(shapes_all) - 1):
        for d in range(ndim):
            R = _resize_matrix(shapes_all[i][d], shapes_all[i + 1][d]).T
            Rs.append(torch.tensor(np.ascontiguousarray(R), dtype=f32, device=dev))
    inv32 = coarse_dense.to(f32).contiguous()
    if not _fused_operands_fit(problem, levels):
        return None
    return coeffs, sids, Rs, inv32, lw, None


def _fused_operands_fit(problem: Problem, levels) -> bool:
    """The reference's 12 MB VMEM budget for the fused-cycle operands
    (multigrid.py:636-639; TPU policy, kept for parity)."""
    n_c = math.prod(levels[-1].shape)
    est = (problem.coeff.numel() + sum(l.data_diag.numel() for l in levels)
           + n_c * n_c + 3 * problem.grid.num_nodes) * 4
    return est <= 12 * 1024 * 1024


def build_fused_solver_operands(problem: Problem, config: SolverConfig):
    """Setup for the fused 2-D PCG segment, or None when the problem shape
    or config rules the fused path out (the reference's gate,
    multigrid.py:729-752)."""
    if (problem.grid.ndim != 2
            or config.preconditioner != "multigrid"
            or config.mg_coarse_solver != "dense"
            or config.mg_pre_smooth != config.mg_post_smooth
            or problem.diag.dtype != torch.float32):
        return None
    if not fits_vmem(problem.grid.shape):
        return None
    levels = build_levels(problem, config)
    if not levels or math.prod(levels[-1].shape) > 4096:
        return None
    if not all(fits_vmem(l.shape) for l in levels):
        return None
    lump, _, taus, _ = build_smoothing_setup(problem, levels, config)
    if lump:
        return None  # the fused kernel smooths with the full data stencil
    coarse_dense = _coarse_dense_inverse(levels[-1])
    return _fused_vcycle_operands(problem, levels, taus, _inv_diag(problem.diag),
                                  [_inv_diag(l.diag) for l in levels],
                                  coarse_dense, config)


def resolve_wdepth(config: SolverConfig, fine_shape: tuple[int, ...]) -> int:
    """Doubled-transition count for the W-cycle (0 = plain V); "auto" picks
    V inside the `fits_vmem` gate and W beyond it (the reference's TPU
    policy, kept for parity)."""
    cycle = config.mg_cycle
    if cycle == "auto":
        cycle = "v" if fits_vmem(fine_shape) else "w"
    return config.mg_wcycle_depth if cycle == "w" else 0


# The reference kernels `smoother_plan` names that the port's sweep kernel
# stands in for; a level planned for any other raises on CUDA tensors.
_PORTED_SMOOTHERS = ("fused_smooth", "fused_sweep_striped2_3d")


def smoother_plan(shapes, diag_data, radius: int, nu_max: int) -> list:
    """Per level, the reference kernel that smooths it with
    ``pallas_smooth`` on (multigrid.py:959-1004): "fused_smooth" where the
    level fits whole in VMEM, else "fused_smooth_striped" /
    "fused_smooth_tiled" (2-D full data), "fused_sweep_striped2_3d" (3-D
    diagonal data) or "fused_sweep_striped_diag" (2-D diagonal data) where
    that kernel's tiling fits, and None where the reference runs XLA sweeps
    (the port runs its sweep kernel there too).
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
    plan = smoother_plan(shapes, [lump] + [True] * len(levels), radius,
                         max(config.mg_pre_smooth, config.mg_post_smooth))
    whole = None
    if (problem.grid.ndim == 2 and config.mg_coarse_solver == "dense" and levels
            and math.prod(levels[-1].shape) <= 4096
            and all(n is not None for n in plan)
            and config.mg_pre_smooth == config.mg_post_smooth
            and _fused_operands_fit(problem, levels)):
        whole = ("fused_wcycle_2d" if resolve_wdepth(config, problem.grid.shape)
                 else "fused_vcycle_2d")
    return plan, whole


def _kernel_smoother(coeff, sid, weights: Weights, ndim: int):
    """smooth(r, z, sweeps, from_zero) on one level through the sweep kernel;
    ``coeff`` is the level's full stencil or diagonal data term."""
    c32 = coeff.to(torch.float32).contiguous()
    s32 = sid.to(torch.float32).contiguous()

    def smooth(r, z, sweeps, from_zero):
        return fused_smooth(r.contiguous(), z.contiguous(), c32, s32, weights,
                            ndim, sweeps, from_zero)
    return smooth


def make_vcycle_preconditioner(problem: Problem, config: SolverConfig,
                               apply_fn=None, kernels: bool = False):
    """Returns z = M⁻¹ r: one symmetric multigrid cycle with damped-Jacobi
    smoothing. ``apply_fn`` overrides the fine-level operator apply.
    ``kernels`` (the reference's ``pallas_smooth``): smooth every level
    through the sweep kernel; on CUDA tensors a level or cycle for which the
    reference runs a kernel not ported yet raises ``NotImplementedError``."""
    _require_ported(config)
    levels = build_levels(problem, config)
    nu = config.mg_pre_smooth
    ndim = problem.grid.ndim

    if (not levels and config.mg_coarse_solver == "dense"
            and math.prod(problem.grid.shape) <= 4096):
        # Degenerate hierarchy: the grid is already at the coarsening floor,
        # so the whole problem IS the coarsest level; solve it exactly.
        inv0 = _coarse_dense_inverse(_Level(
            shape=problem.grid.shape, weights=problem.weights,
            data_diag=data_diag(problem.coeff, ndim), diag=problem.diag,
            data_coeff=problem.coeff))
        return lambda r: (inv0 @ r.reshape(-1)).reshape(r.shape)

    lump, fine_ddiag, taus, _ = build_smoothing_setup(problem, levels, config)
    if lump:
        def fine_apply(x):
            return stencils.smoothness_apply(x, problem.weights, ndim) + fine_ddiag * x
    else:
        fine_apply = problem.apply if apply_fn is None else apply_fn
    inv_diags = [_inv_diag(problem.diag)] + [_inv_diag(l.diag) for l in levels]
    applies = [fine_apply] + [l.apply for l in levels]
    shapes = [problem.grid.shape] + [l.shape for l in levels]

    coarse_dense = None
    if (config.mg_coarse_solver == "dense" and levels
            and math.prod(levels[-1].shape) <= 4096):
        coarse_dense = _coarse_dense_inverse(levels[-1])

    smoothers = [None] * len(shapes)
    if kernels:
        if problem.b.device.type == "cuda":
            plan, whole = kernel_plan(problem, config, levels, lump)
            missing = [f"the {'x'.join(map(str, s))} level ({n})"
                       for s, n in zip(shapes, plan)
                       if n is not None and n not in _PORTED_SMOOTHERS]
            if missing:
                raise _not_ported("smoothing " + ", ".join(missing))
            if whole is not None:
                raise _not_ported(f"the 2-D multigrid cycle outside the fused "
                                 f"PCG path ({whole})")
        coeffs = [fine_ddiag if lump else problem.coeff] + [l.data_diag for l in levels]
        weights = [problem.weights] + [l.weights for l in levels]
        smoothers = [_kernel_smoother(c, t * d, w, ndim)
                     for c, t, d, w in zip(coeffs, taus, inv_diags, weights)]

    def smooth(li, r, z, iters):
        # z None = from zero: the first sweep is sid·r.
        for _ in range(iters):
            az = 0.0 if z is None else applies[li](z)
            z = (0.0 if z is None else z) + taus[li] * inv_diags[li] * (r - az)
        return z

    def level_smooth(li, r, z, iters, from_zero):
        # iters == 0 is NO smoothing: zeros from a zero guess, z untouched
        # otherwise (the kernels count the from-zero step as a sweep, so the
        # guard sits here, as in the reference, multigrid.py:1044-1057).
        if iters == 0:
            return torch.zeros_like(r) if from_zero else z
        if smoothers[li] is not None:
            return smoothers[li](r, z, iters, from_zero)
        return smooth(li, r, None if from_zero else z, iters)

    wdepth = resolve_wdepth(config, problem.grid.shape)

    def vcycle(r, li):
        if li == len(levels):  # coarsest
            if coarse_dense is not None:
                return (coarse_dense @ r.reshape(-1)).reshape(r.shape)
            return level_smooth(li, r, r, config.mg_coarse_iters, True)
        z = level_smooth(li, r, r, nu, True)
        restrict = make_restrict(shapes[li], shapes[li + 1])
        rc = restrict(r - applies[li](z))
        zc = vcycle(rc, li + 1)
        if wdepth > li and li + 1 < len(levels):
            # W-cycle: a second visit on the residual the first leaves.
            zc = zc + vcycle(rc - levels[li].apply(zc), li + 1)
        z = z + prolong(zc, shapes[li])
        return level_smooth(li, r, z, config.mg_post_smooth, False)

    return lambda r: vcycle(r, 0)
