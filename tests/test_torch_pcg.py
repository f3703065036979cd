"""The port's PCG against the JAX package on identical operands.

The plain `fused_pcg_solve` (the CPU path of the segment kernel) runs on the
operands the reference's `build_fused_solver_operands` made, carried across
with `convert.fused_operands_from_numpy`, and is held against the
reference's Pallas segment kernel in interpret mode. Bars (the reference's
own, tests/test_solver.py:191-195): iterations within ±2, x within
2e-3·max|x|."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import field_interpolation_tpu as fi
from field_interpolation_tpu.multigrid import build_fused_solver_operands
from field_interpolation_tpu.operators import assemble as jassemble
from field_interpolation_tpu.ops import pallas_stencil as ps

import field_interpolation_tpu_torch as ft
from field_interpolation_tpu_torch import multigrid as tmg
from field_interpolation_tpu_torch.convert import (fused_operands_from_numpy,
                                                   problem_from_numpy)
from field_interpolation_tpu_torch.ops import pcg as tpcg

SHAPE = (64, 64)


def _pair(shape=SHAPE, n=100, seed=0, weights=dict(model_2=0.3)):
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0, 2 * np.pi, n)
    nrm = np.stack([np.cos(theta), np.sin(theta)], -1)
    pos = (np.asarray(shape) - 1) / 2.0 + 0.3 * min(shape) * nrm
    jp = jassemble(fi.Grid(shape), fi.Weights(**weights),
                   jnp.asarray(pos, jnp.float32), jnp.zeros(n, jnp.float32),
                   gradients=jnp.asarray(nrm, jnp.float32))
    tp = problem_from_numpy(jp.coeff, jp.b, jp.diag, ft.Grid(shape),
                            ft.Weights(**weights))
    return jp, tp


def _agree(x_t, it_t, x_j, it_j):
    assert abs(int(it_t) - int(it_j)) <= 2, (int(it_t), int(it_j))
    want = np.asarray(x_j)
    np.testing.assert_allclose(np.asarray(x_t), want,
                               atol=2e-3 * np.abs(want).max())


@pytest.mark.parametrize("tol", [1e-3, 1e-4])
def test_plain_segment_matches_reference_kernel(tol):
    jp, _ = _pair()
    j_ops = build_fused_solver_operands(jp, fi.SolverConfig())
    coeffs, sids, Rs, inv32, lw, _ = j_ops
    b = np.array(jp.b)
    tol2 = np.float32(tol * tol * np.sum(b.astype(np.float64) ** 2)).reshape(1, 1)
    budget = np.full((1, 1), 2000, np.int32)
    x0 = np.zeros_like(b)
    xj, itj, rrj = ps.fused_pcg_solve(jnp.asarray(x0), jnp.asarray(b),
                                      jnp.asarray(tol2), jnp.asarray(budget),
                                      coeffs, sids, Rs, inv32, lw, 3, True)
    t_ops = fused_operands_from_numpy(coeffs, sids, Rs, inv32,
                                      [ft.Weights(**vars(w)) for w in lw])
    tc, ts, tR, tinv, tlw, _ = t_ops
    xt, itt, rrt = tpcg.fused_pcg_solve(
        torch.as_tensor(x0), torch.as_tensor(b), torch.as_tensor(tol2),
        torch.as_tensor(budget), tc, ts, tR, tinv, tlw, 3)
    assert itt.dtype == torch.int32 and tuple(itt.shape) == (1, 1)
    assert tuple(rrt.shape) == (1, 1) and float(rrt) <= float(tol2[0, 0])
    _agree(xt, itt[0, 0], xj, np.asarray(itj)[0, 0])


def test_segment_budget_and_exit_semantics():
    """A budget of k stops after k iterations; a tolerance already met runs
    none (the reference's loop condition: rr > tol2 and k < budget)."""
    _, tp = _pair((32, 32))
    ops = tmg.build_fused_solver_operands(tp, ft.SolverConfig())
    coeffs, sids, Rs, inv32, lw, _ = ops
    x0, b = torch.zeros_like(tp.b), tp.b
    tiny = torch.zeros((1, 1))
    for budget, tol2, want in [(3, tiny, 3), (0, tiny, 0),
                               (50, torch.full((1, 1), 1e30), 0)]:
        x, it, rr = tpcg.fused_pcg_solve(
            x0, b, tol2, torch.full((1, 1), budget, dtype=torch.int32),
            coeffs, sids, Rs, inv32, lw, 3)
        assert int(it) == want
        if want == 0:
            assert torch.equal(x, x0)
            assert float(rr) == pytest.approx(float(torch.sum(b * b)), rel=1e-6)


@pytest.mark.parametrize("shape", [SHAPE, (256, 256), (40, 48)])
def test_launch_tables_match_kernel_layout(shape):
    """The operands the port builds pass the CUDA wrapper's checks, and the
    host tables have the lengths csrc/pcg_segment.cu reads (11 + 6L + 6(L−1)
    pointers, 3 + 3L ints, 4L weights), checked here without a card."""
    jp, tp = _pair(shape)
    coeffs, sids, Rs, inv32, lw, _ = tmg.build_fused_solver_operands(
        tp, ft.SolverConfig())
    x0, b = torch.zeros_like(tp.b), tp.b
    tol2 = torch.ones((1, 1))
    budget = torch.ones((1, 1), dtype=torch.int32)
    shapes = tpcg._level_shapes(coeffs)
    tpcg._check_operands(x0, b, tol2, budget, coeffs, sids, Rs, inv32, shapes)
    _, ptrs, ints, w2s, _ = tpcg._launch_tables(x0, b, tol2, budget, coeffs,
                                                sids, Rs, inv32, lw, 3)
    L = len(coeffs)
    assert len(ptrs) == 11 + 6 * L + 6 * (L - 1)
    assert ints[:2] == [L, 3] and len(ints) == 3 + 3 * L
    assert ints[3:6] == [shape[0], shape[1], 0]                 # fine: 9 channels
    assert all(ints[3 + 3 * l + 2] == 1 for l in range(1, L))   # coarse: diagonal
    assert len(w2s) == 4 * L and w2s[2] == pytest.approx(0.09)
    with pytest.raises(ValueError):
        tpcg._check_operands(x0, b, tol2, budget, coeffs, sids,
                             [R.T for R in Rs], inv32, shapes)


def test_band_tables_reproduce_dense_transfers():
    """The kernel reads R only over the band of `_resize_matrix`; over the
    band the banded products equal the dense ones."""
    rng = np.random.default_rng(1)
    for n_f, n_c in [(256, 128), (64, 32), (37, 19), (48, 24), (23, 12)]:
        P = tmg._resize_matrix(n_f, n_c)
        tab = tpcg._band_table(n_f, n_c)
        rb, pb = tab[:2 * n_c].reshape(-1, 2), tab[2 * n_c:].reshape(-1, 2)
        v_f, v_c = rng.standard_normal(n_f), rng.standard_normal(n_c)
        restrict = [sum(P[s + a, j] * v_f[s + a] for a in range(c))
                    for j, (s, c) in enumerate(rb)]
        prolong = [sum(P[i, s + a] * v_c[s + a] for a in range(c))
                   for i, (s, c) in enumerate(pb)]
        np.testing.assert_allclose(restrict, P.T @ v_f, rtol=1e-14, atol=1e-14)
        np.testing.assert_allclose(prolong, P @ v_c, rtol=1e-14, atol=1e-14)
        assert rb[:, 1].max() <= 4 and pb[:, 1].max() <= 2


@pytest.mark.parametrize("backend", ["auto", "xla"])
def test_solve_matches_reference(backend):
    """`solve` on the fused path ("auto": segments + verified exits) and on
    the plain path ("xla": `pcg` + plain V-cycle) against the reference's
    XLA solve of the same problem, at tol 1e-4."""
    jp, tp = _pair()
    xj, ij = fi.solve(jp, fi.SolverConfig(tol=1e-4, backend="xla"))
    xt, it = ft.solve(tp, ft.SolverConfig(tol=1e-4, backend=backend))
    assert bool(ij.converged) and bool(it.converged)
    assert float(it.rel_residual) <= 1e-4
    _agree(xt, it.iterations, xj, ij.iterations)


@pytest.mark.parametrize("preconditioner", ["jacobi", "none"])
def test_plain_pcg_matches_reference(preconditioner):
    jp, tp = _pair((24, 24), n=30)
    jc = fi.SolverConfig(tol=1e-3, preconditioner=preconditioner, maxiter=5000)
    tc = ft.SolverConfig(tol=1e-3, preconditioner=preconditioner, maxiter=5000)
    xj, ij = fi.solve(jp, jc)
    xt, it = ft.solve(tp, tc)
    assert bool(it.converged)
    want = np.asarray(xj)
    np.testing.assert_allclose(xt.numpy(), want, atol=2e-3 * np.abs(want).max())


def test_zero_rhs_and_warm_start():
    _, tp = _pair((32, 32))
    cfg = ft.SolverConfig(tol=1e-4)
    zero = ft.Problem(coeff=tp.coeff, b=torch.zeros_like(tp.b), diag=tp.diag,
                      grid=tp.grid, weights=tp.weights)
    x, info = ft.solve(zero, cfg)
    assert bool(info.converged) and int(info.iterations) == 0
    assert torch.count_nonzero(x) == 0
    x1, info1 = ft.solve(tp, cfg)
    x2, info2 = ft.solve(tp, cfg, x0=x1)
    assert bool(info2.converged) and int(info2.iterations) == 0
    assert torch.equal(x2, x1)


def test_degenerate_hierarchy_matches_reference():
    """A grid already at the coarsening floor has no coarse levels: the
    multigrid preconditioner is the dense inverse of the whole operator
    (full data stencil), and CG converges in a few iterations."""
    jp, tp = _pair((12, 10), n=20)
    xj, ij = fi.solve(jp, fi.SolverConfig(tol=1e-5))
    xt, it = ft.solve(tp, ft.SolverConfig(tol=1e-5))
    assert bool(it.converged) and int(it.iterations) <= 3
    _agree(xt, it.iterations, xj, ij.iterations)
