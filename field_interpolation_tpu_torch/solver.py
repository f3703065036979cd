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

Over a leading lane axis (``batch``: B independent problems, the
reference's ``vmap``): `pcg_batch`, `_pcg_fused_batch` (one batched
segment launch, `ops.pcg.fused_pcg_solve_batch`, per outer round for all
lanes), `solve_lanes` and `solve_refined_lanes`. Each lane keeps its own
scalars, iteration count, restarts and rounds, and a lane that stops is
frozen while the others run; the host reads one flag per iteration (plain
`pcg_batch`), per segment (fused) or per round for all lanes together,
each through `utils.observe.host_read`. Under a recording torch profiler
they record spans (``mg_setup``, ``refine_round``, ``inner_solve``,
``segment_round``) and counters (``refine_rounds``, ``lanes_offered``,
``lanes_working``; each batched segment launch adds ``runs_offered`` and
``data_runs``) into the batch's record (`utils.observe`).

`prepare` builds a problem's multigrid setup once (`multigrid.MGPrep`);
`solve` and `solve_refined` take it as ``prep=`` and then build nothing
but the right-hand side's residuals. A prep made for another grid, other
`Weights` or another setup-relevant config raises ``ValueError``
(`_check_prep`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from .multigrid import (MGPrep, build_fused_solver_operands,
                        make_vcycle_preconditioner, prepare_mg, resolve_wdepth,
                        setup_signature)
from .operators import Problem
from .ops.pcg import fused_pcg_solve, fused_pcg_solve_batch
from .ops.stencil import fused_normal_apply, fused_normal_apply_batch
from .utils import observe
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


def _lane_dot(a: torch.Tensor, b: torch.Tensor, ndim: int) -> torch.Tensor:
    """Per-lane full-precision dot over the trailing ``ndim`` grid axes."""
    return torch.sum(a * b, dim=tuple(range(-ndim, 0)))


def _on_grid(m: torch.Tensor, ndim: int) -> torch.Tensor:
    """A [B] per-lane tensor shaped to broadcast over [B, *grid]."""
    return m.reshape(m.shape + (1,) * ndim)


def _segment_open(above_tol, k, maxiter, segments, max_restarts, progressed):
    """The safeguard's rule for starting another CG segment: the verified
    true residual is above tol, iterations and restarts are left, and the
    last segment moved. One field passes Python scalars (the residual test
    read to the host: no launch), B lanes [B] tensors."""
    return above_tol & (k < maxiter) & (segments < max_restarts) & progressed


def _exit_info(rr, b_norm2, tol2, k, tiny: float) -> SolveInfo:
    """SolveInfo from the verified true residual's ‖r‖² at exit."""
    rel = torch.sqrt(rr / torch.clamp_min(b_norm2, tiny))
    return SolveInfo(iterations=k, rel_residual=rel, converged=rr <= tol2)


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
    dot_fn: Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = None,
) -> tuple[torch.Tensor, SolveInfo]:
    """Preconditioned CG on an SPD operator. Returns (x, SolveInfo).

    The stopping rule is SAFEGUARDED: the in-loop check uses the recurrence
    residual, but every candidate exit is verified against a fresh true
    residual ``b − Ax``; if drift left it above tol, CG restarts from the
    verified residual (at most ``max_restarts`` segments sharing one
    ``maxiter`` budget), so ``converged`` is always backed by a true
    residual.

    ``dot_fn`` overrides the inner product: the sharded solve passes one
    summed across ranks, so every rank sees the same scalars and takes the
    same branches."""
    if precond_fn is None:
        precond_fn = lambda r: r  # noqa: E731
    dot = _dot if dot_fn is None else dot_fn
    x = torch.zeros_like(b) if x0 is None else x0
    b_norm2 = dot(b, b)
    tol2 = tol * tol * torch.clamp_min(b_norm2, _tiny(b))
    zero = torch.zeros((), dtype=b.dtype, device=b.device)

    r = b - apply_fn(x)
    k, segments, progressed = 0, 0, True
    while _segment_open(bool(dot(r, r) > tol2), k, maxiter, segments, max_restarts,
                        progressed):
        # ``r`` is a verified true residual: start a CG segment from it.
        k_start = k
        z = precond_fn(r)
        p, rz = z, dot(r, z)
        while k < maxiter:
            Ap = apply_fn(p)
            pAp = dot(p, Ap)
            alpha = torch.where(pAp > 0, rz / pAp, zero)
            x = x + alpha * p
            if recompute_every > 0 and (k + 1) % recompute_every == 0:
                r = b - apply_fn(x)
            else:
                r = r - alpha * Ap
            z = precond_fn(r)
            rz_new = dot(r, z)
            beta = torch.where(rz > 0, rz_new / rz, zero)
            p, rz = z + beta * p, rz_new
            k += 1
            if bool(dot(r, r) <= tol2):
                break
        r = b - apply_fn(x)  # verify the recurrence exit
        segments += 1
        progressed = k > k_start
    return x, _exit_info(dot(r, r), b_norm2, tol2, torch.tensor(k, dtype=torch.int32),
                         _tiny(b))


def _pcg_fused(ops, b: torch.Tensor, x0: Optional[torch.Tensor], *, tol,
               maxiter, max_restarts, nu, wdepth=0) -> tuple[torch.Tensor, SolveInfo]:
    """Fused 2-D multigrid PCG: each safeguard SEGMENT is one
    `fused_pcg_solve`; the outer loop verifies each exit against a fresh
    true residual (`fused_normal_apply`) and restarts on drift, the same
    stopping rule as `pcg`. ``ops`` comes from
    multigrid.build_fused_solver_operands. ``tol`` may be a float or a
    0-dim float32 tensor. Kept apart from `_pcg_fused_batch` for the single
    field's host-bound speed: its counters live on the host, where the
    one-lane form of the batched loop launched ~27 more kernels per warm
    `Solver` frame (PERF.md §6)."""
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
    while _segment_open(bool(_dot(r, r) > tol2), k, maxiter, segments, max_restarts,
                        progressed):
        budget = torch.full((1, 1), maxiter - k, dtype=torch.int32, device=b.device)
        x, iters, _ = fused_pcg_solve(x, r, tol2_s, budget, coeffs, sids, Rs,
                                      inv32, lw, nu, cheb_coefs=cfs, wdepth=wdepth)
        n = int(iters.item())
        k += n
        r = b - apply_f(x)  # verify the recurrence exit (see pcg)
        segments += 1
        progressed = n > 0
    return x, _exit_info(_dot(r, r), b_norm2, tol2, torch.tensor(k, dtype=torch.int32),
                         _tiny(b))


def _fused_solver_ops(problem: Problem, config: SolverConfig,
                      prep: Optional[MGPrep] = None):
    """Operands of the fused PCG path, or None when the problem, config or
    backend rules it out (the reference's rule, solver.py:198-210); a
    ``prep`` supplies them."""
    if config.backend == "xla" or config.preconditioner != "multigrid":
        return None
    return build_fused_solver_operands(problem, config, prep)


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


def _mg_kernels(problem: Problem, config: SolverConfig) -> bool:
    """Whether the multigrid cycle runs through the kernels: the reference's
    pallas_smooth rule (solver.py:263-267); 1-D grids have no smoothing
    kernel in either package."""
    return (config.backend != "xla" and problem.grid.ndim >= 2
            and problem.diag.dtype == torch.float32)


def _make_precond(problem: Problem, config: SolverConfig, apply_fn=None,
                  prep: Optional[MGPrep] = None):
    if config.preconditioner == "none":
        return None
    if config.preconditioner == "jacobi":
        inv_diag = torch.where(problem.diag > 0, 1.0 / problem.diag,
                               torch.ones_like(problem.diag))
        return lambda r: inv_diag * r
    if config.preconditioner == "multigrid":
        return make_vcycle_preconditioner(problem, config, apply_fn=apply_fn,
                                          kernels=_mg_kernels(problem, config),
                                          prep=prep)
    raise ValueError(f"unknown preconditioner {config.preconditioner!r}")


def _check_prep(problem: Problem, config: SolverConfig, prep) -> None:
    """A prep built for another grid, other Weights or another setup-relevant
    config (`multigrid.setup_signature`) raises instead of preconditioning
    with the wrong hierarchy (the reference's solver.py:282-303)."""
    if prep is None:
        return
    if prep.shape != problem.grid.shape:
        raise ValueError(
            f"prep was built for grid {prep.shape}, problem has "
            f"{problem.grid.shape} — rebuild with solver.prepare")
    if prep.weights != problem.weights:
        raise ValueError(
            "prep was built for different Weights — the data/smoothness "
            "operator changed; rebuild with solver.prepare")
    if prep.sig != setup_signature(config):
        raise ValueError(
            "prep was built under a different solver/multigrid config "
            "(see multigrid.setup_signature) — rebuild with solver.prepare")


def prepare(problem, config: SolverConfig = SolverConfig()) -> Optional[MGPrep]:
    """The reusable setup of repeated solves on one operator (positions and
    weights fixed; values, i.e. ``b``, free): the multigrid hierarchy, the
    smoothing steps and schedules, the dense coarsest inverse and the fused
    or whole-cycle kernels' operands, built once on the problem's device.
    Pass it to ``solve(problem, config, prep=...)`` or ``solve_refined``;
    ``problem`` may be a PreciseProblem (its float32 problem is prepared).
    None for a config without multigrid (nothing to reuse). The fused
    operands are built exactly where a cold `solve` takes the fused path,
    so a prepared solve equals the cold one. For a loop that also reuses
    the assembly's geometry, see ``session.Solver``."""
    if config.preconditioner != "multigrid":
        return None
    p32 = problem.p32 if hasattr(problem, "p32") else problem
    return prepare_mg(p32, config, fused=config.backend != "xla",
                      kernels=_mg_kernels(p32, config))


def solve(
    problem: Problem,
    config: SolverConfig = SolverConfig(),
    x0: Optional[torch.Tensor] = None,
    prep: Optional[MGPrep] = None,
) -> tuple[torch.Tensor, SolveInfo]:
    """Solve the assembled problem (warm start via ``x0``; ``prep`` from
    `prepare` on the same operator and config skips the multigrid setup)."""
    _check_prep(problem, config, prep)
    fused_ops = _fused_solver_ops(problem, config, prep)
    if fused_ops is not None:
        return _pcg_fused(fused_ops, problem.b, x0, tol=config.tol,
                          maxiter=config.maxiter,
                          max_restarts=config.max_restarts,
                          nu=config.mg_pre_smooth,
                          wdepth=resolve_wdepth(config, problem.grid.shape))
    apply_fn = _make_apply(problem, config)
    return pcg(apply_fn, problem.b, x0=x0,
               precond_fn=_make_precond(problem, config, apply_fn, prep),
               tol=config.tol, maxiter=config.maxiter,
               recompute_every=config.recompute_every,
               max_restarts=config.max_restarts)


def _downcast_problem(p64: Problem) -> Problem:
    return dataclasses.replace(p64, coeff=p64.coeff.to(torch.float32),
                               b=p64.b.to(torch.float32),
                               diag=p64.diag.to(torch.float32))


def _refined_parts(problem64):
    """(p32, residual64, apply_delta, b64) of a PreciseProblem from
    ``sdf.assemble_precise[_lanes]`` or of a Problem assembled in float64."""
    if hasattr(problem64, "residual64"):
        return (problem64.p32, problem64.residual64, problem64.apply64_delta,
                problem64.b64)
    return (_downcast_problem(problem64), lambda x: problem64.b - problem64.apply(x),
            problem64.apply, problem64.b)


def _inner_tol(config: SolverConfig, rr: torch.Tensor, bnorm2: torch.Tensor) -> torch.Tensor:
    """A refinement round's float32 tolerance: each round only needs to
    shrink the CURRENT residual to the final target, and float32 inner
    solves stagnate around ~1e-4 relative (the rounding floor)."""
    rel = torch.sqrt(rr / bnorm2)
    return torch.clamp(0.5 * config.tol / rel, max(config.tol, 1e-4), 0.5).to(torch.float32)


def solve_refined(
    problem64,
    config: SolverConfig = SolverConfig(),
    x0: Optional[torch.Tensor] = None,
    prep: Optional[MGPrep] = None,
) -> tuple[torch.Tensor, SolveInfo]:
    """Mixed-precision solve to a TRUE ≤ ``tol`` relative residual.

    ``problem64`` is a PreciseProblem from ``sdf.assemble_precise`` (float32
    problem + matter-free float64 system), or a Problem assembled in float64.
    All CG iterations run in float32; the operator's float64 form, the
    accumulated solution and the outer residual stay in float64 (native on
    the H100). Round 1 is peeled and followed by the one full residual of the
    solve; later rounds update the residual incrementally, r ← r − A·d.
    ``prep``: `prepare` on the same problem and config. Kept apart from
    `solve_refined_lanes`, as `_pcg_fused` is from `_pcg_fused_batch`."""
    p32, residual64, apply_delta, b64 = _refined_parts(problem64)
    _check_prep(p32, config, prep)
    fused_ops = _fused_solver_ops(p32, config, prep)
    wdepth = resolve_wdepth(config, p32.grid.shape)
    if fused_ops is None:
        apply32 = _make_apply(p32, config)
        precond = _make_precond(p32, config, apply32, prep)
    bnorm2 = torch.clamp_min(_dot(b64, b64), torch.finfo(torch.float64).tiny)
    tol2 = config.tol * config.tol * bnorm2

    if x0 is None:
        x = torch.zeros_like(b64)
        r = b64  # r(0) = b: skip one apply
        rr = bnorm2
    else:
        x = x0.to(torch.float64)
        r = residual64(x)
        rr = _dot(r, r)

    def inner(r, rr):
        # max_restarts=1: the float64 outer loop verifies.
        inner_tol = _inner_tol(config, rr, bnorm2)
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


# ------------------------------------------------------------- lanes (batch)

def pcg_batch(
    apply_fn: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    precond_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    *,
    ndim: int,
    tol=1e-6,
    maxiter: int = 2000,
    recompute_every: int = 50,
    max_restarts: int = 8,
) -> tuple[torch.Tensor, SolveInfo]:
    """`pcg` on B independent systems b [B, *grid] at once (the reference's
    pcg under vmap): each lane has its own α, β, iteration count, periodic
    true residual, exit test and restarts; a lane that stops is frozen
    (masked) while the others iterate. ``tol``: a float or a [B] tensor.
    ``apply_fn`` and ``precond_fn`` act on all lanes. Returns (x, SolveInfo
    of [B] tensors). Kept apart from `pcg`, which serves one field (and
    the sharded solve's ``dot_fn``) with its counters on the host: there
    the periodic true residual costs no host read and the bookkeeping no
    launch."""
    if precond_fn is None:
        precond_fn = lambda r: r  # noqa: E731

    def dot(u, v):
        return _lane_dot(u, v, ndim)

    x = torch.zeros_like(b) if x0 is None else x0
    B, dev = b.shape[0], b.device
    b_norm2 = dot(b, b)
    tol2 = tol * tol * torch.clamp_min(b_norm2, _tiny(b))
    zero = torch.zeros((), dtype=b.dtype, device=dev)
    k = torch.zeros(B, dtype=torch.int32, device=dev)
    segments = torch.zeros_like(k)
    progressed = torch.ones(B, dtype=torch.bool, device=dev)

    r = b - apply_fn(x)
    seg = _segment_open(dot(r, r) > tol2, k, maxiter, segments, max_restarts, progressed)
    while observe.host_read(seg.any()):
        with observe.span("segment_round"):
            # Lanes in ``seg`` start a CG segment from their verified residual.
            k_start = k
            z = precond_fn(r)
            p, rz = z, dot(r, z)
            run = seg & (k < maxiter)
            while observe.host_read(run.any()):
                observe.count("lanes_offered", B)
                observe.count("lanes_working", run)
                on = _on_grid(run, ndim)
                Ap = apply_fn(p)
                pAp = dot(p, Ap)
                alpha = _on_grid(torch.where(pAp > 0, rz / pAp, zero), ndim)
                x = torch.where(on, x + alpha * p, x)
                r_new = r - alpha * Ap
                if recompute_every > 0:
                    refresh = run & ((k + 1) % recompute_every == 0)
                    if observe.host_read(refresh.any()):
                        r_new = torch.where(_on_grid(refresh, ndim), b - apply_fn(x), r_new)
                r = torch.where(on, r_new, r)
                z = precond_fn(r)
                rz_new = dot(r, z)
                beta = _on_grid(torch.where(rz > 0, rz_new / rz, zero), ndim)
                p = torch.where(on, z + beta * p, p)
                rz = torch.where(run, rz_new, rz)
                k = k + run.to(torch.int32)
                run = run & (dot(r, r) > tol2) & (k < maxiter)
            r = torch.where(_on_grid(seg, ndim), b - apply_fn(x), r)  # verify the exits
            segments = segments + seg.to(torch.int32)
            progressed = torch.where(seg, k > k_start, progressed)
            seg = _segment_open(dot(r, r) > tol2, k, maxiter, segments, max_restarts,
                                progressed)
    return x, _exit_info(dot(r, r), b_norm2, tol2, k, _tiny(b))


def _pcg_fused_batch(ops, b: torch.Tensor, x0: Optional[torch.Tensor], *, tol,
                     maxiter, max_restarts, nu, wdepth=0) -> tuple[torch.Tensor, SolveInfo]:
    """`_pcg_fused` on B lanes b [B, n0, n1] (the reference's under vmap):
    every outer round is ONE `fused_pcg_solve_batch` launch for all lanes,
    a lane that has stopped (converged, out of budget or restarts, or no
    progress) passing budget 0, then one batched apply verifies the exits.
    The host reads one flag per round. ``ops``:
    `multigrid.build_fused_solver_operands` of the batched problem.
    ``tol``: a float or a [B] float32 tensor."""
    coeffs, sids, Rs, inv32, lw, cfs = ops

    def apply_f(v):
        return fused_normal_apply_batch(v, coeffs[0], lw[0], 2)

    def dot(u, v):
        return _lane_dot(u, v, 2)

    B, dev = b.shape[0], b.device
    b_norm2 = dot(b, b)
    tol2 = tol * tol * torch.clamp_min(b_norm2, _tiny(b))
    tol2_s = tol2.to(torch.float32).contiguous()
    if x0 is None:
        x, r = torch.zeros_like(b), b  # r(0) = b exactly: skip one apply
    else:
        x = x0.contiguous()
        r = b - apply_f(x)
    k = torch.zeros(B, dtype=torch.int32, device=dev)
    segments = torch.zeros_like(k)
    progressed = torch.ones(B, dtype=torch.bool, device=dev)
    active = _segment_open(dot(r, r) > tol2, k, maxiter, segments, max_restarts, progressed)
    while observe.host_read(active.any()):
        with observe.span("segment_round"):
            budget = torch.where(active, maxiter - k, 0).to(torch.int32)
            x, iters, _ = fused_pcg_solve_batch(x, r.contiguous(), tol2_s, budget, coeffs,
                                                sids, Rs, inv32, lw, nu, cheb_coefs=cfs,
                                                wdepth=wdepth)
            # The lanes that iterated are read later from the counts before
            # and after the launch, tensors the loop makes anyway: no new op.
            k_before, k = k, k + iters
            observe.count("lanes_offered", B)
            observe.count("lanes_working", k, before=k_before)
            r = torch.where(_on_grid(active, 2), b - apply_f(x), r)  # verify (see pcg)
            segments = segments + active.to(torch.int32)
            progressed = torch.where(active, iters > 0, progressed)
            active = _segment_open(dot(r, r) > tol2, k, maxiter, segments, max_restarts,
                                   progressed)
    return x, _exit_info(dot(r, r), b_norm2, tol2, k, _tiny(b))


def _make_apply_lanes(problem: Problem, config: SolverConfig):
    """`_make_apply` for a problem with lanes: the batched apply kernel on
    2-D and 3-D float32 lanes, plain ops elsewhere (as `_make_apply`)."""
    if config.backend == "xla" or problem.grid.ndim < 2:
        return problem.apply
    coeff, weights, ndim = problem.coeff, problem.weights, problem.grid.ndim

    def apply_fn(x):
        if x.dtype != torch.float32:
            return problem.apply(x)
        return fused_normal_apply_batch(x.contiguous(), coeff, weights, ndim)

    return apply_fn


def _lanes_ops(problem: Problem, config: SolverConfig, fused: bool):
    """The fused operands of a problem with lanes (per-lane setup in one
    pass over all lanes), or None for the plain `pcg_batch` route."""
    if not fused:
        return None
    ops = build_fused_solver_operands(problem, config)
    if ops is None:
        raise ValueError("solve_lanes: the problem and config do not take the fused "
                         "path (batch.solve_route)")
    return ops


def solve_lanes(problem: Problem, config: SolverConfig, x0: Optional[torch.Tensor] = None,
                fused: bool = False) -> tuple[torch.Tensor, SolveInfo]:
    """`solve` on a problem whose leaves lead with B lanes: the fused
    segment batched (``fused``; `_pcg_fused_batch`), or `pcg_batch` with the
    batched apply and the preconditioner of all lanes at once (Jacobi, none,
    or the multigrid cycle on lanes: each smoothing phase or whole cycle one
    kernel call for every lane, `multigrid.make_vcycle_preconditioner`)."""
    with observe.span("mg_setup", problem.b.device):
        ops = _lanes_ops(problem, config, fused)
        if ops is None:
            apply_fn = _make_apply_lanes(problem, config)
            precond = _make_precond(problem, config, apply_fn)
    if ops is not None:
        return _pcg_fused_batch(ops, problem.b, x0, tol=config.tol, maxiter=config.maxiter,
                                max_restarts=config.max_restarts, nu=config.mg_pre_smooth,
                                wdepth=resolve_wdepth(config, problem.grid.shape))
    return pcg_batch(apply_fn, problem.b, x0=x0, precond_fn=precond,
                     ndim=problem.grid.ndim, tol=config.tol, maxiter=config.maxiter,
                     recompute_every=config.recompute_every,
                     max_restarts=config.max_restarts)


def solve_refined_lanes(problem64, config: SolverConfig,
                        x0: Optional[torch.Tensor] = None,
                        fused: bool = False) -> tuple[torch.Tensor, SolveInfo]:
    """`solve_refined` on B lanes (the reference's _solve_refined_impl under
    vmap): per-lane inner tolerance, rounds and exit. Every lane runs the
    peeled round 1; after it, a lane that has met ``tol`` or used its
    rounds is frozen, and the inner solve sees a zero residual for it (no
    iterations, no segment work). Inner solves as `solve_lanes`; the host
    reads one flag per round."""
    p32, residual64, apply_delta, b64 = _refined_parts(problem64)
    ndim = p32.grid.ndim
    B, dev = b64.shape[0], b64.device
    with observe.span("mg_setup", dev):
        ops = _lanes_ops(p32, config, fused)
        if ops is None:
            apply32 = _make_apply_lanes(p32, config)
            precond = _make_precond(p32, config, apply32)
    wdepth = resolve_wdepth(config, p32.grid.shape)

    def dot(u, v):
        return _lane_dot(u, v, ndim)

    bnorm2 = torch.clamp_min(dot(b64, b64), torch.finfo(torch.float64).tiny)
    tol2 = config.tol * config.tol * bnorm2
    if x0 is None:
        x, r, rr = torch.zeros_like(b64), b64, bnorm2
    else:
        x = x0.to(torch.float64)
        r = residual64(x)
        rr = dot(r, r)

    def inner(r, rr, active):
        inner_tol = _inner_tol(config, rr, bnorm2)
        r32 = torch.where(_on_grid(active, ndim), r, 0.0).to(torch.float32)
        if ops is not None:
            return _pcg_fused_batch(ops, r32, None, tol=inner_tol, maxiter=config.maxiter,
                                    max_restarts=1, nu=config.mg_pre_smooth,
                                    wdepth=wdepth)
        return pcg_batch(apply32, r32, precond_fn=precond, ndim=ndim, tol=inner_tol,
                         maxiter=config.maxiter, recompute_every=config.recompute_every,
                         max_restarts=1)

    # Round 1 (peeled) for every lane, then the one full float64 residual.
    with observe.span("refine_round", dev):
        with observe.span("inner_solve", dev):
            d32, info = inner(r, rr, torch.ones(B, dtype=torch.bool, device=dev))
        iters = info.iterations
        x = x + d32.to(torch.float64)
        r = residual64(x)
        rr = dot(r, r)
        rounds = torch.ones(B, dtype=torch.int32, device=dev)
        active = (rr > tol2) & (rounds < config.refine_rounds)
    while observe.host_read(active.any()):
        with observe.span("refine_round", dev):
            with observe.span("inner_solve", dev):
                d32, info = inner(r, rr, active)
            d64 = d32.to(torch.float64)
            on = _on_grid(active, ndim)
            x = torch.where(on, x + d64, x)
            r = torch.where(on, r - apply_delta(d64), r)  # incremental
            rr = torch.where(active, dot(r, r), rr)
            iters = iters + torch.where(active, info.iterations, 0)
            rounds = rounds + active.to(torch.int32)
            active = (rr > tol2) & (rounds < config.refine_rounds)
    observe.count("refine_rounds", rounds)
    rel = torch.sqrt(rr / bnorm2)
    return x, SolveInfo(iterations=iters.to(torch.int32), rel_residual=rel.to(torch.float32),
                        converged=rel <= config.tol)
