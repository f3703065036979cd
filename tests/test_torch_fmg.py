"""The port's nested-iteration start (`fmg_start`) against the reference's,
at 64² with 300 oriented points on a circle (tests/test_solver.py:635-700):

* `_fmg_guess` at depth 1 and 2 equals the reference's guess within
  2e-3·max|guess| (the coarse solves stop at tol 1e-3, so they agree to the
  solves' float32 rounding, not bit for bit);
* `sdf_from_points(..., fmg_start=1 and 2)` converges within ±2 fine
  iterations of the reference's and in fewer than from zero;
* `sdf_from_points_precise(..., fmg_start=True)` reaches a TRUE ≤ 1e-6
  relative residual from the plain float64 operator."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import field_interpolation_tpu as fi
from field_interpolation_tpu import sdf as jsdf

import field_interpolation_tpu_torch as ft
from field_interpolation_tpu_torch import sdf as tsdf

SHAPE = (64, 64)
CFG = dict(tol=1e-4, preconditioner="multigrid")


@functools.lru_cache(maxsize=None)
def _cloud():
    rng = np.random.default_rng(7)
    theta = rng.uniform(0, 2 * np.pi, 300)
    nrm = np.stack([np.cos(theta), np.sin(theta)], 1).astype(np.float32)
    pts = (31.5 + 20.0 * nrm + 0.2 * rng.standard_normal((300, 2))).astype(np.float32)
    return pts, nrm


def _reference(fn, **kw):
    pts, nrm = _cloud()
    return fn(fi.Grid(SHAPE), fi.Weights(model_2=0.3), jnp.asarray(pts),
              jnp.asarray(nrm), **kw)


def _port(fn, **kw):
    pts, nrm = _cloud()
    return fn(ft.Grid(SHAPE), ft.Weights(model_2=0.3), torch.as_tensor(pts),
              torch.as_tensor(nrm), **kw)


@pytest.mark.parametrize("depth", [1, 2])
def test_fmg_guess_matches_reference(depth):
    want = np.asarray(_reference(jsdf._fmg_guess, point_weights=None,
                                 config=fi.SolverConfig(**CFG), depth=depth))
    got = _port(tsdf._fmg_guess, point_weights=None,
                config=ft.SolverConfig(**CFG), depth=depth)
    assert got.dtype == torch.float32 and tuple(got.shape) == SHAPE
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=2e-3 * np.abs(want).max())


@pytest.mark.parametrize("depth", [1, 2])
def test_fmg_start_matches_reference(depth):
    _, want = _reference(fi.sdf_from_points, config=fi.SolverConfig(**CFG),
                         fmg_start=depth)
    x, got = _port(ft.sdf_from_points, config=ft.SolverConfig(**CFG),
                   fmg_start=depth)
    _, cold = _port(ft.sdf_from_points, config=ft.SolverConfig(**CFG))
    assert bool(got.converged) and bool(torch.isfinite(x).all())
    assert abs(int(got.iterations) - int(want.iterations)) <= 2
    assert int(got.iterations) < int(cold.iterations)


def test_fmg_start_is_ignored_with_x0():
    x1, _ = _port(ft.sdf_from_points, config=ft.SolverConfig(**CFG))
    x2, info = _port(ft.sdf_from_points, config=ft.SolverConfig(**CFG), x0=x1,
                     fmg_start=True)
    assert int(info.iterations) == 0 and torch.equal(x1, x2)


def test_precise_with_fmg_start_reaches_true_tolerance():
    pts, nrm = _cloud()
    x, info = _port(ft.sdf_from_points_precise, config=ft.SolverConfig(tol=1e-6),
                    fmg_start=True)
    pp = ft.assemble_precise(ft.Grid(SHAPE), ft.Weights(model_2=0.3),
                             torch.as_tensor(pts), torch.zeros(300),
                             gradients=torch.as_tensor(nrm))
    true = float(torch.linalg.norm(pp.residual64(x)) / torch.linalg.norm(pp.b64))
    assert bool(info.converged) and true <= 1e-6
    assert abs(float(info.rel_residual) - true) <= 0.02 * true
