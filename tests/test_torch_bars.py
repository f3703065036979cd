"""Two bars of ROADMAP.md §3 pinned on the port, on CPU tensors.

* The headline-family canary of the reference (tests/test_solver.py:741-762):
  a 128² circle-cloud SDF at tol 1e-4 under the production multigrid
  config converges in at most 13 iterations (the reference measures 10-11);
  and its empty- and single-point clouds (765-797): n = 0 is a pure
  smoothness solve, a zero field, converged at once, plain and precise;
  n = 1 converges to a finite field.
* A 3-D solve with kind-4 Chebyshev smoothing and Galerkin coarse data
  against the reference's XLA solve of the same problem: ±2 iterations and
  2e-3·max|x| (tests/test_solver.py:174-195), at 24³ (72³, whose fine level
  is lumped, under ``slow``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import field_interpolation_tpu as fi
from field_interpolation_tpu.sdf import sdf_from_points as jsdf_from_points

import field_interpolation_tpu_torch as ft


def test_headline_family_iteration_count_pinned():
    rng = np.random.default_rng(0)
    theta = rng.uniform(0, 2 * np.pi, 500)
    nrm = np.stack([np.cos(theta), np.sin(theta)], 1).astype(np.float32)
    pts = (63.5 + 44.0 * nrm + 0.2 * rng.standard_normal((500, 2))).astype(np.float32)
    _, info = ft.sdf_from_points(ft.Grid((128, 128)), ft.Weights(model_2=0.3),
                                 torch.as_tensor(pts), torch.as_tensor(nrm),
                                 config=ft.SolverConfig(tol=1e-4, preconditioner="multigrid"))
    assert bool(info.converged)
    assert int(info.iterations) <= 13, int(info.iterations)


def test_empty_and_single_point_clouds():
    g, w = ft.Grid((24, 24)), ft.Weights(model_2=0.3)
    p0 = torch.zeros((0, 2), dtype=torch.float32)
    x, info = ft.sdf_from_points(g, w, p0, p0, config=ft.SolverConfig(tol=1e-4))
    assert bool(info.converged) and int(info.iterations) == 0
    assert float(x.abs().max()) == 0.0
    x, info = ft.sdf_from_points_precise(g, w, p0, p0, config=ft.SolverConfig(tol=1e-6))
    assert bool(info.converged) and float(x.abs().max()) == 0.0
    x, info = ft.sdf_from_points(g, w, torch.tensor([[11.5, 11.5]]), torch.tensor([[1.0, 0.0]]),
                                 config=ft.SolverConfig(tol=1e-4))
    assert bool(info.converged) and bool(torch.isfinite(x).all())


def _sphere(shape, n, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    pts = ((np.asarray(shape) - 1) / 2.0 + 0.3 * shape[0] * u).astype(np.float32)
    return pts, u.astype(np.float32)


def _cheb_galerkin_3d(shape, n):
    pts, nrm = _sphere(shape, n)
    change = dict(tol=1e-4, mg_smoother="chebyshev4", mg_coarse_data="galerkin")
    xr, ir = jsdf_from_points(fi.Grid(shape), fi.Weights(model_2=0.3), jnp.asarray(pts),
                              jnp.asarray(nrm), config=fi.SolverConfig(backend="xla",
                                                                       **change))
    x, info = ft.sdf_from_points(ft.Grid(shape), ft.Weights(model_2=0.3),
                                 torch.as_tensor(pts), torch.as_tensor(nrm),
                                 config=ft.SolverConfig(**change))
    assert bool(info.converged) and bool(ir.converged)
    assert abs(int(info.iterations) - int(ir.iterations)) <= 2
    xr = np.asarray(xr)
    np.testing.assert_allclose(x.numpy(), xr, rtol=0, atol=2e-3 * np.abs(xr).max())


def test_chebyshev_galerkin_3d_matches_reference():
    _cheb_galerkin_3d((24, 24, 24), 400)


@pytest.mark.slow
def test_chebyshev_galerkin_3d_matches_reference_72_cubed():
    _cheb_galerkin_3d((72, 72, 72), 1300)
