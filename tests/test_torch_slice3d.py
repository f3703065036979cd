"""The 3-D slice end to end: the port's `sdf_from_points` and
`sdf_from_points_precise` on a 3-D grid against the JAX package's XLA path
(``backend="xla"``) on the same cloud. The cloud is BASELINE config 4's
(bench.py:217-227: oriented points on a sphere around the grid's center, at
40/128 of its width) cut to 24³ and 300 points; 48³ under ``slow``.

The port runs with ``backend="auto"``: on CPU tensors every kernel wrapper
runs its plain version, so this drives the port's kernel dispatch (the apply
rule and the per-level smoother plan) end to end.

Bars (tests/test_solver.py:191-195, 215-239): converged; iterations within
±2 and the field within 2e-3·max|x| of the reference's; for the refined
solve a TRUE float64 relative residual ≤ 1e-6 (the port's plain float64
operator, held to the reference's at 1e-12 in test_torch_operators.py) with
the reported residual within 2% of it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import field_interpolation_tpu as fi

import field_interpolation_tpu_torch as ft

WEIGHTS = dict(model_2=0.3)


def _sphere_cloud(shape, n, seed=0):
    """bench.py config 4 scaled to ``shape``: n oriented points on a sphere."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    center = (np.asarray(shape, np.float64) - 1.0) / 2.0
    pts = center + (40.0 / 128.0) * shape[0] * u
    return pts.astype(np.float32), u.astype(np.float32)


def _both(fn_name, shape, n, **cfg):
    pts, nrm = _sphere_cloud(shape, n)
    xt, it = getattr(ft, fn_name)(ft.Grid(shape), ft.Weights(**WEIGHTS),
                                  torch.as_tensor(pts), torch.as_tensor(nrm),
                                  config=ft.SolverConfig(**cfg))
    xj, ij = getattr(fi, fn_name)(fi.Grid(shape), fi.Weights(**WEIGHTS),
                                  jnp.asarray(pts), jnp.asarray(nrm),
                                  config=fi.SolverConfig(backend="xla", **cfg))
    assert tuple(xt.shape) == shape and bool(torch.isfinite(xt).all())
    assert bool(it.converged), float(it.rel_residual)
    assert abs(int(it.iterations) - int(ij.iterations)) <= 2, (
        int(it.iterations), int(ij.iterations))
    want = np.asarray(xj)
    np.testing.assert_allclose(xt.numpy(), want, atol=2e-3 * np.abs(want).max())
    return pts, nrm, xt, it


@pytest.mark.parametrize("change", [
    dict(),                                         # 24³ fits: exact, V-cycle
    dict(mg_fine_operator="lumped", mg_cycle="w"),  # the 128³ path's cycle
], ids=str)
def test_sdf_from_points_3d(change):
    _, _, xt, it = _both("sdf_from_points", (24, 24, 24), 300, tol=1e-4, **change)
    assert xt.dtype == torch.float32 and float(it.rel_residual) <= 1e-4


def test_sdf_from_points_precise_3d():
    shape = (24, 24, 24)
    pts, nrm, xt, it = _both("sdf_from_points_precise", shape, 300, tol=1e-6)
    assert xt.dtype == torch.float64
    zeros = torch.zeros(len(pts), dtype=torch.float32)
    pp = ft.assemble_precise(ft.Grid(shape), ft.Weights(**WEIGHTS),
                             torch.as_tensor(pts), zeros,
                             gradients=torch.as_tensor(nrm))
    true = float(torch.linalg.norm(pp.residual64(xt)) / torch.linalg.norm(pp.b64))
    assert true <= 1e-6, true
    assert abs(true - float(it.rel_residual)) <= 0.02 * true


@pytest.mark.slow
def test_sdf_from_points_3d_beyond_the_gate():
    """48³ is past the reference's whole-array gate: "auto" lumps the fine
    operator and runs the W-cycle, as at 128³."""
    _both("sdf_from_points", (48, 48, 48), 1000, tol=1e-4)
