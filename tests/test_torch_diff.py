"""Implicit differentiation in the port: `solve_implicit` against finite
differences, the JAX package's ``jax.grad`` of its `solve_implicit` on the
same numpy-seeded inputs, and the adjoint formulas
(tests/test_diff.py's cases).

Bars: finite differences as tests/test_diff.py (rtol 2e-2; 5e-2 through
positions); the reference's gradients within 1e-3·max|g| (both sides run
float32 PCG to their rounding floor and differ in the last digits of each
solve); the adjoint b̄ = λ with ‖A λ − x̄‖ ≤ 1e-5·‖x̄‖ (float64 plain
operator), coeff̄ = −λ·shift(x, o) within 1e-6·max and diaḡ = 0."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from field_interpolation_tpu import Grid as JGrid
from field_interpolation_tpu import SolverConfig as JConfig
from field_interpolation_tpu import Weights as JWeights
from field_interpolation_tpu.diff import solve_implicit as jsolve_implicit
from field_interpolation_tpu.operators import assemble as jassemble

import field_interpolation_tpu_torch as ft
from field_interpolation_tpu_torch import constraints as cons
from field_interpolation_tpu_torch.operators import assemble


def _t(a, grad=False):
    return torch.tensor(np.asarray(a, np.float32), requires_grad=grad)


def test_grad_matches_finite_differences():
    """tests/test_diff.py:21."""
    rng = np.random.default_rng(0)
    grid, weights = ft.Grid((12, 12)), ft.Weights(model_2=0.5)
    cfg = ft.SolverConfig(tol=1e-10, maxiter=4000, preconditioner="jacobi")
    n = 15
    pos = _t(rng.uniform(1, 10, (n, 2)))
    vals = _t(rng.standard_normal(n), grad=True)
    pw = torch.ones(n, requires_grad=True)
    target = _t(rng.standard_normal(grid.shape))

    def loss(v, w):
        x = ft.solve_implicit(assemble(grid, weights, pos, v, point_weights=w), cfg)
        return torch.sum((x - target) ** 2)

    g_vals, g_pw = torch.autograd.grad(loss(vals, pw), (vals, pw))
    eps = 1e-2
    with torch.no_grad():
        for i in [0, 7, 14]:
            d = torch.zeros(n)
            d[i] = eps
            fd = (loss(vals + d, pw) - loss(vals - d, pw)) / (2 * eps)
            np.testing.assert_allclose(float(g_vals[i]), float(fd), rtol=2e-2)
        for i in [3, 9]:
            d = torch.zeros(n)
            d[i] = eps
            fd = (loss(vals, pw + d) - loss(vals, pw - d)) / (2 * eps)
            np.testing.assert_allclose(float(g_pw[i]), float(fd), rtol=2e-2)


def test_gradient_descent_recovers_values():
    """tests/test_diff.py:49: fit sample values so the solved field matches
    a target reconstruction."""
    rng = np.random.default_rng(0)
    grid, weights = ft.Grid((10, 10)), ft.Weights(model_2=0.5)
    cfg = ft.SolverConfig(tol=1e-8, maxiter=2000, preconditioner="jacobi")
    n = 10
    pos = _t(rng.uniform(1, 8, (n, 2)))
    true_vals = _t(rng.standard_normal(n))
    target = ft.solve_implicit(assemble(grid, weights, pos, true_vals), cfg)

    def loss(v):
        return torch.sum((ft.solve_implicit(assemble(grid, weights, pos, v), cfg)
                          - target) ** 2)

    vals = torch.zeros(n, requires_grad=True)
    with torch.no_grad():
        l0 = float(loss(vals))
    for _ in range(40):
        (gv,) = torch.autograd.grad(loss(vals), vals)
        with torch.no_grad():
            a0 = float(loss(vals))
            t = 1e-3
            a1 = float(loss(vals - t * gv))
            gg = float(torch.dot(gv, gv))
            c = (a1 - a0 + gg * t) / (t * t)
            alpha = gg / (2 * c) if c > 0 else t
            vals = (vals - alpha * gv).requires_grad_(True)
    with torch.no_grad():
        l1 = float(loss(vals))
    assert l1 < 1e-3 * l0, (l0, l1)


def test_grad_through_positions():
    """tests/test_diff.py:84: gradients reach the sample positions."""
    grid = ft.Grid((10, 10))
    weights = ft.Weights(model_0=0.1, model_2=0.5)
    cfg = ft.SolverConfig(tol=1e-8, maxiter=2000, preconditioner="jacobi")
    pos = _t([[3.3, 4.6], [6.2, 2.7]], grad=True)
    vals = _t([1.0, -1.0])

    def loss(p):
        return torch.sum(ft.solve_implicit(assemble(grid, weights, p, vals), cfg) ** 2)

    (g,) = torch.autograd.grad(loss(pos), pos)
    assert g.shape == (2, 2)
    eps = 1e-2
    with torch.no_grad():
        d = torch.zeros(2, 2)
        d[0, 0] = eps
        fd = (loss(pos + d) - loss(pos - d)) / (2 * eps)
    np.testing.assert_allclose(float(g[0, 0]), float(fd), rtol=5e-2)


@pytest.mark.parametrize("precond", ["jacobi", "multigrid"])
def test_grads_match_reference(precond):
    """∂loss/∂(positions, values, normals, point weights) through the
    assembly with gradient rows, the port's against ``jax.grad`` of the
    reference on the same inputs. "multigrid" at 32² takes the port's
    whole-cycle route (the reference's XLA cycle on the CPU)."""
    rng = np.random.default_rng(7)
    shape = (16, 16) if precond == "jacobi" else (32, 32)
    n = 40
    w = dict(model_1=0.1, model_2=0.5)
    cfg = dict(tol=1e-7, maxiter=3000, preconditioner=precond)
    pos = rng.uniform(2, np.asarray(shape) - 3, (n, 2)).astype(np.float32)
    vals = rng.standard_normal(n).astype(np.float32)
    nrm = rng.standard_normal((n, 2)).astype(np.float32)
    pw = rng.uniform(0.5, 1.5, n).astype(np.float32)
    target = rng.standard_normal(shape).astype(np.float32)

    def tloss(p, v, g, q):
        x = ft.solve_implicit(assemble(ft.Grid(shape), ft.Weights(**w), p, v, gradients=g,
                                       point_weights=q), ft.SolverConfig(**cfg))
        return torch.sum((x - torch.as_tensor(target)) ** 2)

    def jloss(p, v, g, q):
        x = jsolve_implicit(jassemble(JGrid(shape), JWeights(**w), p, v, gradients=g,
                                      point_weights=q), JConfig(**cfg))
        return jnp.sum((x - target) ** 2)

    args = [_t(a, grad=True) for a in (pos, vals, nrm, pw)]
    got = torch.autograd.grad(tloss(*args), args)
    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in
                                                    (pos, vals, nrm, pw)))
    for name, g, wv in zip(("positions", "values", "normals", "point weights"), got, want):
        wv = np.asarray(wv, np.float64)
        assert np.isfinite(g.numpy()).all(), name
        np.testing.assert_allclose(g.numpy(), wv, rtol=0, atol=1e-3 * np.abs(wv).max(),
                                   err_msg=name)


def test_backward_is_the_adjoint_solve():
    """b̄ = λ solves A λ = x̄, coeff̄[o] = −λ·shift(x, o), diaḡ = 0, on the
    32² headline-like problem through the multigrid route. x̄ = A·v for a
    standard-normal v: a white-noise x̄ puts λ = A⁻¹x̄ on the smallest
    eigenvalues, where a float32 residual stalls near κ·2⁻²⁴ relative
    (3.1e-5 here, 2.3e-2 at 256²), in the reference's algorithm alike."""
    rng = np.random.default_rng(8)
    shape = (32, 32)
    theta = rng.uniform(0, 2 * np.pi, 120)
    nrm = np.stack([np.cos(theta), np.sin(theta)], 1).astype(np.float32)
    pts = (15.5 + 10.0 * nrm).astype(np.float32)
    p = ft.assemble_sdf(ft.Grid(shape), ft.Weights(model_2=0.3), torch.as_tensor(pts),
                        torch.as_tensor(nrm))
    coeff = p.coeff.clone().requires_grad_(True)
    b = p.b.clone().requires_grad_(True)
    diag = p.diag.clone().requires_grad_(True)
    cfg = ft.SolverConfig(tol=1e-5)
    x = ft.solve_implicit(ft.Problem(coeff=coeff, b=b, diag=diag, grid=p.grid,
                                     weights=p.weights), cfg)
    p64 = ft.Problem(coeff=p.coeff.double(), b=p.b.double(), diag=p.diag.double(),
                     grid=p.grid, weights=p.weights)
    v = torch.as_tensor(rng.standard_normal(shape))
    x_bar = p64.apply(v).float()
    c_bar, lam, d_bar = torch.autograd.grad(x, (coeff, b, diag), x_bar)
    res = torch.linalg.norm(p64.apply(lam.double()) - x_bar.double())
    assert float(res) <= 1e-5 * float(torch.linalg.norm(x_bar.double()))
    xd = x.detach()
    want = torch.stack([-lam * cons._shift(xd, o, 2) for o in cons.offset_list(2)])
    torch.testing.assert_close(c_bar, want, rtol=0, atol=1e-6 * float(want.abs().max()))
    assert torch.equal(d_bar, torch.zeros_like(diag))
