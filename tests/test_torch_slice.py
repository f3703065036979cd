"""The slice end to end: the port's `sdf_from_points_precise` and
`sdf_from_points` against the JAX package and the float64 oracle on the
headline cloud (bench.py:30-37) cut to 64² and 100 points; the 256² /
1000-point headline itself under ``slow``.

Bars: converged; the TRUE relative residual against the float64 oracle
(`explicit.assemble_explicit` + `normal_equations`) ≤ 1e-6 with the
reported residual within 2% of it (tests/test_solver.py:215-239); the
field within 2e-3·max|x| of the reference's and iterations within ±2
(tests/test_solver.py:191-195)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import field_interpolation_tpu as fi
from field_interpolation_tpu.explicit import assemble_explicit, normal_equations

import field_interpolation_tpu_torch as ft


def _cloud(n, shape, seed=0):
    """bench.make_circle_cloud: noisy oriented points on a circle."""
    rng = np.random.default_rng(seed)
    center = (np.asarray(shape, np.float64) - 1.0) / 2.0
    theta = rng.uniform(0, 2 * np.pi, n)
    normals = np.stack([np.cos(theta), np.sin(theta)], axis=1)
    pts = center + 0.35 * min(shape) * normals + 0.2 * rng.standard_normal((n, 2))
    return pts.astype(np.float32), normals.astype(np.float32)


def _oracle_rel(shape, weights_kw, pts, nrm, x):
    eq = assemble_explicit(fi.Grid(shape), fi.Weights(**weights_kw),
                           pts.astype(np.float64), np.zeros(len(pts)),
                           nrm.astype(np.float64))
    AtA, Atb = normal_equations(eq, int(np.prod(shape)))
    r = Atb - AtA @ np.asarray(x, np.float64).ravel()
    return np.linalg.norm(r) / np.linalg.norm(Atb)


def _check_precise(shape, n, seed=0, **change):
    w = dict(model_2=0.3)
    pts, nrm = _cloud(n, shape, seed)
    cfg = dict(tol=1e-6, preconditioner="multigrid", maxiter=2000, **change)
    xt, it = ft.sdf_from_points_precise(ft.Grid(shape), ft.Weights(**w),
                                        torch.as_tensor(pts), torch.as_tensor(nrm),
                                        config=ft.SolverConfig(**cfg))
    xj, ij = fi.sdf_from_points_precise(fi.Grid(shape), fi.Weights(**w),
                                        jnp.asarray(pts), jnp.asarray(nrm),
                                        config=fi.SolverConfig(**cfg))
    assert xt.dtype == torch.float64 and tuple(xt.shape) == shape
    assert bool(it.converged), float(it.rel_residual)
    true = _oracle_rel(shape, w, pts, nrm, xt.numpy())
    assert true <= 1e-6, true
    assert abs(true - float(it.rel_residual)) <= 0.02 * true, (true, float(it.rel_residual))
    want = np.asarray(xj)
    np.testing.assert_allclose(xt.numpy(), want, atol=2e-3 * np.abs(want).max())
    assert abs(int(it.iterations) - int(ij.iterations)) <= 2


@pytest.mark.parametrize("seed", [0, 1])
def test_sdf_from_points_precise_64(seed):
    _check_precise((64, 64), 100, seed)


def test_sdf_from_points_precise_64_wcycle():
    """The reference's W option (``mg_cycle="w"``): every inner solve is a
    segment whose preconditioner is the W-cycle (wdepth 99)."""
    _check_precise((64, 64), 100, mg_cycle="w")


@pytest.mark.slow
def test_sdf_from_points_precise_256():
    _check_precise((256, 256), 1000)


def test_sdf_from_points_64():
    w = dict(model_2=0.3)
    shape = (64, 64)
    pts, nrm = _cloud(100, shape)
    cfg = dict(tol=1e-4, preconditioner="multigrid")
    xt, it = ft.sdf_from_points(ft.Grid(shape), ft.Weights(**w), torch.as_tensor(pts),
                                torch.as_tensor(nrm), config=ft.SolverConfig(**cfg))
    xj, ij = fi.sdf_from_points(fi.Grid(shape), fi.Weights(**w), jnp.asarray(pts),
                                jnp.asarray(nrm), config=fi.SolverConfig(**cfg))
    assert xt.dtype == torch.float32 and bool(it.converged)
    assert float(it.rel_residual) <= 1e-4
    # Against the float64 oracle: the float32 system's rounding adds slack
    # (the bar of tests/test_solver.py:171).
    assert _oracle_rel(shape, w, pts, nrm, xt.numpy()) <= 1.2e-4
    want = np.asarray(xj)
    np.testing.assert_allclose(xt.numpy(), want, atol=2e-3 * np.abs(want).max())
    assert abs(int(it.iterations) - int(ij.iterations)) <= 2


def test_refined_warm_start_and_plain_backend():
    """A warm start from the solution needs no more rounds, and the
    backend='xla' path (plain pcg + plain V-cycle) meets the same bars."""
    w = dict(model_2=0.3)
    shape = (48, 40)
    pts, nrm = _cloud(80, shape, seed=3)
    args = (ft.Grid(shape), ft.Weights(**w), torch.as_tensor(pts), torch.as_tensor(nrm))
    x, info = ft.sdf_from_points_precise(
        *args, config=ft.SolverConfig(tol=1e-6, backend="xla"))
    true = _oracle_rel(shape, w, pts, nrm, x.numpy())
    assert bool(info.converged) and true <= 1e-6
    assert abs(true - float(info.rel_residual)) <= 0.02 * true
    x2, info2 = ft.sdf_from_points_precise(*args, config=ft.SolverConfig(tol=1e-6),
                                           x0=x)
    assert bool(info2.converged)
    assert _oracle_rel(shape, w, pts, nrm, x2.numpy()) <= 1e-6
