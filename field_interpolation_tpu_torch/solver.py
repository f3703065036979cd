"""Matrix-free preconditioned conjugate gradients (torch).

Counterpart of ``field_interpolation_tpu.solver``:

* `solve` — PCG on ``A x = b`` with float32 iterates and the safeguarded
  stopping rule: every candidate exit is verified against a fresh true
  residual, and CG restarts from it on recurrence drift.
* `solve_refined` — float64 iterative refinement around float32 inner solves,
  to a TRUE relative residual ≤ tol against the float64 system.
* On the fused path (2-D, multigrid, dense coarsest, ν_pre = ν_post, inside
  the `fits_vmem` gate) each CG segment is one `fused_pcg_solve` and each
  exit check one `fused_normal_apply`: the CUDA kernels for CUDA tensors,
  their plain versions for CPU tensors.
* Elsewhere (3-D, large 2-D grids, ν_pre ≠ ν_post, ...) `pcg` runs with
  the apply kernel at every size (`_make_apply`; it stands in for the
  reference's whole-array, striped and two-axis applies and its XLA apply
  alike) and the multigrid cycle runs through the kernels
  (`multigrid.make_vcycle_preconditioner` with ``kernels=True``): as one
  whole-cycle kernel launch where the reference runs ``fused_vcycle_2d`` /
  ``fused_wcycle_2d`` (2-D grids just past the gate, the lumped fine
  operator), else level by level through the multi-sweep kernel on 2-D
  levels with the 9-channel data term and the per-sweep one elsewhere.

Every multigrid option of the reference (damped-Jacobi or Chebyshev
smoothing, lumped or Galerkin coarse data, V or W cycles) runs through the
kernels on CUDA tensors. The reference's ``lax.while_loop``s are Python loops
here that read one scalar per segment (fused path), per iteration (plain
`pcg`) or per round.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from .multigrid import (build_fused_solver_operands, make_vcycle_preconditioner,
                        resolve_wdepth)
from .operators import Problem
from .ops.pcg import fused_pcg_solve
from .ops.stencil import fused_normal_apply
from .weights import SolverConfig


@dataclasses.dataclass(frozen=True)
class SolveInfo:
    iterations: torch.Tensor     # int32
    rel_residual: torch.Tensor   # float32, ||b - Ax|| / ||b|| at exit
    converged: torch.Tensor      # bool


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Full-precision dot over all elements."""
    return torch.sum(a * b)


def _tiny(t: torch.Tensor) -> float:
    return torch.finfo(t.dtype).tiny


def pcg(
    apply_fn: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    precond_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    *,
    tol: float = 1e-6,
    maxiter: int = 2000,
    recompute_every: int = 50,
    max_restarts: int = 8,
) -> tuple[torch.Tensor, SolveInfo]:
    """Preconditioned CG on an SPD operator. Returns (x, SolveInfo).

    The stopping rule is SAFEGUARDED: the in-loop check uses the recurrence
    residual, but every candidate exit is verified against a fresh true
    residual ``b − Ax``; if drift left it above tol, CG restarts from the
    verified residual (at most ``max_restarts`` segments sharing one
    ``maxiter`` budget), so ``converged`` is always backed by a true
    residual."""
    if precond_fn is None:
        precond_fn = lambda r: r  # noqa: E731
    x = torch.zeros_like(b) if x0 is None else x0
    b_norm2 = _dot(b, b)
    tol2 = tol * tol * torch.clamp_min(b_norm2, _tiny(b))
    zero = torch.zeros((), dtype=b.dtype, device=b.device)

    r = b - apply_fn(x)
    k, segments, progressed = 0, 0, True
    while (bool(_dot(r, r) > tol2) and k < maxiter and segments < max_restarts
           and progressed):
        # ``r`` is a verified true residual: start a CG segment from it.
        k_start = k
        z = precond_fn(r)
        p, rz = z, _dot(r, z)
        while k < maxiter:
            Ap = apply_fn(p)
            pAp = _dot(p, Ap)
            alpha = torch.where(pAp > 0, rz / pAp, zero)
            x = x + alpha * p
            if recompute_every > 0 and (k + 1) % recompute_every == 0:
                r = b - apply_fn(x)
            else:
                r = r - alpha * Ap
            z = precond_fn(r)
            rz_new = _dot(r, z)
            beta = torch.where(rz > 0, rz_new / rz, zero)
            p, rz = z + beta * p, rz_new
            k += 1
            if bool(_dot(r, r) <= tol2):
                break
        r = b - apply_fn(x)  # verify the recurrence exit
        segments += 1
        progressed = k > k_start
    rr = _dot(r, r)
    rel = torch.sqrt(rr / torch.clamp_min(b_norm2, _tiny(b)))
    return x, SolveInfo(iterations=torch.tensor(k, dtype=torch.int32),
                        rel_residual=rel, converged=rr <= tol2)


def _pcg_fused(ops, b: torch.Tensor, x0: Optional[torch.Tensor], *, tol,
               maxiter, max_restarts, nu, wdepth=0) -> tuple[torch.Tensor, SolveInfo]:
    """Fused 2-D multigrid PCG: each safeguard SEGMENT is one
    `fused_pcg_solve`; the outer loop verifies each exit against a fresh
    true residual (`fused_normal_apply`) and restarts on drift, the same
    stopping rule as `pcg`. ``ops`` comes from
    multigrid.build_fused_solver_operands. ``tol`` may be a float or a
    0-dim float32 tensor."""
    coeffs, sids, Rs, inv32, lw, cfs = ops

    def apply_f(v):
        return fused_normal_apply(v, coeffs[0], lw[0], 2)

    b_norm2 = _dot(b, b)
    tol2 = tol * tol * torch.clamp_min(b_norm2, _tiny(b))
    tol2_s = tol2.to(torch.float32).reshape(1, 1)

    if x0 is None:
        x, r = torch.zeros_like(b), b  # r(0) = b exactly: skip one apply
    else:
        x, r = x0, b - apply_f(x0)
    k, segments, progressed = 0, 0, True
    while (bool(_dot(r, r) > tol2) and k < maxiter and segments < max_restarts
           and progressed):
        budget = torch.full((1, 1), maxiter - k, dtype=torch.int32, device=b.device)
        x, iters, _ = fused_pcg_solve(x, r, tol2_s, budget, coeffs, sids, Rs,
                                      inv32, lw, nu, cheb_coefs=cfs, wdepth=wdepth)
        n = int(iters.item())
        k += n
        r = b - apply_f(x)  # verify the recurrence exit (see pcg)
        segments += 1
        progressed = n > 0
    rr = _dot(r, r)
    rel = torch.sqrt(rr / torch.clamp_min(b_norm2, _tiny(b)))
    return x, SolveInfo(iterations=torch.tensor(k, dtype=torch.int32),
                        rel_residual=rel, converged=rr <= tol2)


def _fused_solver_ops(problem: Problem, config: SolverConfig):
    """Operands of the fused PCG path, or None when the problem, config or
    backend rules it out (the reference's rule, solver.py:198-210)."""
    if config.backend == "xla" or config.preconditioner != "multigrid":
        return None
    return build_fused_solver_operands(problem, config)


def _make_apply(problem: Problem, config: SolverConfig):
    """The float32 operator apply: the port's apply kernel for a 2-D or 3-D
    grid; plain ops under ``backend="xla"``, for float64 operands and on 1-D
    grids, which no TPU kernel takes either (solver.py:213-249)."""
    if config.backend == "xla" or problem.grid.ndim < 2:
        return problem.apply
    coeff, weights, ndim = problem.coeff, problem.weights, problem.grid.ndim

    def apply_fn(x):
        if x.dtype != torch.float32:
            return problem.apply(x)
        return fused_normal_apply(x, coeff, weights, ndim)

    return apply_fn


def _make_precond(problem: Problem, config: SolverConfig, apply_fn=None):
    if config.preconditioner == "none":
        return None
    if config.preconditioner == "jacobi":
        inv_diag = torch.where(problem.diag > 0, 1.0 / problem.diag,
                               torch.ones_like(problem.diag))
        return lambda r: inv_diag * r
    if config.preconditioner == "multigrid":
        # The reference's pallas_smooth rule (solver.py:263-267); 1-D grids
        # have no smoothing kernel in either package.
        kernels = (config.backend != "xla" and problem.grid.ndim >= 2
                   and problem.diag.dtype == torch.float32)
        return make_vcycle_preconditioner(problem, config, apply_fn=apply_fn,
                                          kernels=kernels)
    raise ValueError(f"unknown preconditioner {config.preconditioner!r}")


def _check_config(config: SolverConfig) -> None:
    if config.debug:
        raise NotImplementedError("SolverConfig(debug=True) is not ported "
                                  "(ROADMAP queue 1, tooling)")


def solve(
    problem: Problem,
    config: SolverConfig = SolverConfig(),
    x0: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, SolveInfo]:
    """Solve the assembled problem (warm start via ``x0``)."""
    _check_config(config)
    fused_ops = _fused_solver_ops(problem, config)
    if fused_ops is not None:
        return _pcg_fused(fused_ops, problem.b, x0, tol=config.tol,
                          maxiter=config.maxiter,
                          max_restarts=config.max_restarts,
                          nu=config.mg_pre_smooth,
                          wdepth=resolve_wdepth(config, problem.grid.shape))
    apply_fn = _make_apply(problem, config)
    return pcg(apply_fn, problem.b, x0=x0,
               precond_fn=_make_precond(problem, config, apply_fn),
               tol=config.tol, maxiter=config.maxiter,
               recompute_every=config.recompute_every,
               max_restarts=config.max_restarts)


def _downcast_problem(p64: Problem) -> Problem:
    return dataclasses.replace(p64, coeff=p64.coeff.to(torch.float32),
                               b=p64.b.to(torch.float32),
                               diag=p64.diag.to(torch.float32))


def solve_refined(
    problem64,
    config: SolverConfig = SolverConfig(),
    x0: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, SolveInfo]:
    """Mixed-precision solve to a TRUE ≤ ``tol`` relative residual.

    ``problem64`` is a PreciseProblem from ``sdf.assemble_precise`` (float32
    problem + matter-free float64 system), or a Problem assembled in float64.
    All CG iterations run in float32; the operator's float64 form, the
    accumulated solution and the outer residual stay in float64 (native on
    the H100). Round 1 is peeled and followed by the one full residual of the
    solve; later rounds update the residual incrementally, r ← r − A·d."""
    _check_config(config)
    if hasattr(problem64, "residual64"):
        p32 = problem64.p32
        residual64 = problem64.residual64
        apply_delta = problem64.apply64_delta
        b64 = problem64.b64
    else:
        p32 = _downcast_problem(problem64)
        residual64 = lambda x: problem64.b - problem64.apply(x)  # noqa: E731
        apply_delta = problem64.apply
        b64 = problem64.b
    fused_ops = _fused_solver_ops(p32, config)
    wdepth = resolve_wdepth(config, p32.grid.shape)
    if fused_ops is None:
        apply32 = _make_apply(p32, config)
        precond = _make_precond(p32, config, apply32)
    bnorm2 = torch.clamp_min(_dot(b64, b64), torch.finfo(torch.float64).tiny)
    tol2 = config.tol * config.tol * bnorm2
    # float32 inner solves stagnate around ~1e-4 relative (rounding floor).
    floor = max(config.tol, 1e-4)

    if x0 is None:
        x = torch.zeros_like(b64)
        r = b64  # r(0) = b: skip one apply
        rr = bnorm2
    else:
        x = x0.to(torch.float64)
        r = residual64(x)
        rr = _dot(r, r)

    def inner(r, rr):
        # Each round only needs to shrink the CURRENT residual to the final
        # target; max_restarts=1 because the f64 outer loop verifies.
        rel = torch.sqrt(rr / bnorm2)
        inner_tol = torch.clamp(0.5 * config.tol / rel, floor, 0.5).to(torch.float32)
        if fused_ops is not None:
            return _pcg_fused(fused_ops, r.to(torch.float32), None, tol=inner_tol,
                              maxiter=config.maxiter, max_restarts=1,
                              nu=config.mg_pre_smooth, wdepth=wdepth)
        return pcg(apply32, r.to(torch.float32), precond_fn=precond,
                   tol=float(inner_tol), maxiter=config.maxiter,
                   recompute_every=config.recompute_every, max_restarts=1)

    # Round 1 (peeled): the big step from (near) zero, then the ONE full
    # float64 residual evaluation of the solve.
    d32, info = inner(r, rr)
    iters = int(info.iterations)
    x = x + d32.to(torch.float64)
    r = residual64(x)
    rr = _dot(r, r)
    k = 1
    while bool(rr > tol2) and k < config.refine_rounds:
        d32, info = inner(r, rr)
        d64 = d32.to(torch.float64)
        x = x + d64
        r = r - apply_delta(d64)  # incremental
        rr = _dot(r, r)
        k += 1
        iters += int(info.iterations)
    rel = torch.sqrt(rr / bnorm2)
    return x, SolveInfo(iterations=torch.tensor(iters, dtype=torch.int32),
                        rel_residual=rel.to(torch.float32),
                        converged=rel <= config.tol)
