"""Differentiable solves via the implicit function theorem (torch).

Counterpart of ``field_interpolation_tpu.diff``. The solution satisfies
``A(coeff) x* = b`` with A symmetric positive definite, so the vector-Jacobian
product of ``x*`` needs one ADJOINT solve with the same operator instead of
a backward pass through the CG iterations:

    λ = A⁻¹ x̄            (one more PCG solve, through the same kernels)
    b̄ = λ
    coeff̄[o, i] = −λ_i · x*_{i+o}   (the data term is linear in coeff)

``diag`` only enters the preconditioner, which does not change the converged
solution: its gradient is zero. The smoothness weights are not tensors.
The assembly is ordinary torch, so gradients reach the sample positions,
values, normals and point weights.
"""

from __future__ import annotations

import torch

from . import constraints as cons
from .operators import Problem
from .solver import _make_apply, _make_precond, pcg
from .weights import SolverConfig


def _pcg_solve(coeff, b, diag, grid, weights, config: SolverConfig) -> torch.Tensor:
    """x = A⁻¹ b by `pcg` with the solver's apply and preconditioner (the
    apply kernel and the multigrid cycle's kernels on CUDA tensors)."""
    problem = Problem(coeff=coeff, b=b, diag=diag, grid=grid, weights=weights)
    apply_fn = _make_apply(problem, config)
    x, _ = pcg(apply_fn, b, precond_fn=_make_precond(problem, config, apply_fn),
               tol=config.tol, maxiter=config.maxiter,
               recompute_every=config.recompute_every)
    return x


class _SolveX(torch.autograd.Function):
    """x* = A(coeff)⁻¹ b with the implicit-function VJP."""

    @staticmethod
    def forward(ctx, coeff, b, diag, grid, weights, config):
        x = _pcg_solve(coeff, b, diag, grid, weights, config)
        ctx.save_for_backward(coeff, diag, x)
        ctx.static = (grid, weights, config)
        return x

    @staticmethod
    def backward(ctx, x_bar):
        coeff, diag, x = ctx.saved_tensors
        grid, weights, config = ctx.static
        lam = _pcg_solve(coeff, x_bar.contiguous(), diag, grid, weights, config)
        # coeff̄[o, i] = −λ_i · x_{i+o}: the apply's shifted-read pattern.
        coeff_bar = torch.stack([-lam * cons._shift(x, off, grid.ndim)
                                 for off in cons.offset_list(grid.ndim)])
        return coeff_bar, lam, torch.zeros_like(diag), None, None, None


def solve_implicit(problem: Problem,
                   config: SolverConfig = SolverConfig()) -> torch.Tensor:
    """Differentiable solve: returns x* only; ``torch.autograd`` reaches
    ``problem.coeff`` and ``problem.b`` (and through them the assembly's
    inputs) by one adjoint solve. For diagnostics use ``solver.solve``."""
    return _SolveX.apply(problem.coeff, problem.b, problem.diag, problem.grid,
                         problem.weights, config)
