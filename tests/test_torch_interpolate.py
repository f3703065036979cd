"""Value interpolation and sampling in the port against the JAX package, on
the same numpy-seeded inputs: `interpolate`, `interpolate_precise`,
`assemble_interpolation`, `fmg_start` for values, `sample_field` and
`sample_field_gradient`, and the public names.

Bars, the reference's own: assembly within 1e-4·max|want| (float32
rounding, tests/test_operator_vs_oracle.py:38-43); float32 solves within
±2 iterations and 2e-3·max|x| of the reference's
(tests/test_solver.py:174-195); the cases of tests/test_solver.py (config
1, the zero right-hand side, 1-D, the precise 1e-6 bar, fmg) and
tests/test_constraints.py:208 with their own bars; sampling within
1e-5·max|want| (both sides sum the same float32 products; the port adds
them without a matmul) and NaN exactly where the reference gives NaN."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import field_interpolation_tpu as fi
from field_interpolation_tpu.explicit import (assemble_explicit, normal_equations,
                                              solve_sparse_linear)

import field_interpolation_tpu_torch as ft


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _random_problem(rng, shape, n=100, weights=None):
    """tests/test_solver.py:_random_problem."""
    weights = weights or dict(model_1=0.1, model_2=1.0)
    pos = rng.uniform(0, np.asarray(shape) - 1, size=(n, len(shape)))
    vals = rng.standard_normal(n)
    return weights, pos, vals


def _rel_residual_f64(shape, weights, pos, vals, x):
    """The float64 normal equations' relative residual (the oracle)."""
    eq = assemble_explicit(fi.Grid(shape), fi.Weights(**weights), pos, vals)
    AtA, Atb = normal_equations(eq, int(np.prod(shape)))
    r = Atb - AtA @ np.asarray(x, np.float64).ravel()
    return np.linalg.norm(r) / np.linalg.norm(Atb)


def _both(fn, shape, weights, pos, vals, cfg, **kw):
    """fn (a public name) of the port and of the reference on the same
    float32 inputs: ((x_port, info_port), (x_ref, info_ref))."""
    got = getattr(ft, fn)(ft.Grid(shape), ft.Weights(**weights), _t(pos), _t(vals),
                          config=ft.SolverConfig(**cfg), **kw)
    want = getattr(fi, fn)(fi.Grid(shape), fi.Weights(**weights),
                           jnp.asarray(pos, jnp.float32), jnp.asarray(vals, jnp.float32),
                           config=fi.SolverConfig(**cfg), **kw)
    return got, want


def _match(got, want, its=2, bar=2e-3):
    (xt, it), (xj, ij) = got, want
    want_x = np.asarray(xj, np.float64)
    assert bool(it.converged) == bool(ij.converged)
    assert abs(int(it.iterations) - int(ij.iterations)) <= its, (int(it.iterations),
                                                                int(ij.iterations))
    np.testing.assert_allclose(xt.numpy(), want_x, rtol=0,
                               atol=bar * np.abs(want_x).max())


def test_public_names_match_reference():
    assert set(ft.__all__) == set(fi.__all__)
    for name in ft.__all__:
        assert hasattr(ft, name), name


@pytest.mark.parametrize("shape", [(13, 9), (7, 6, 5), (19,)], ids=["2d", "3d", "1d"])
def test_assemble_interpolation_matches_reference(shape):
    rng = np.random.default_rng(11)
    n = 60
    pos = rng.uniform(-1.0, np.asarray(shape, np.float64), (n, len(shape))).astype(np.float32)
    vals = rng.standard_normal(n).astype(np.float32)
    pw = rng.uniform(0.5, 2.0, n).astype(np.float32)
    w = dict(model_1=0.2, model_2=0.7)
    got = ft.assemble_interpolation(ft.Grid(shape), ft.Weights(**w), _t(pos), _t(vals),
                                    point_weights=_t(pw))
    want = fi.assemble_interpolation(fi.Grid(shape), fi.Weights(**w), jnp.asarray(pos),
                                     jnp.asarray(vals), point_weights=jnp.asarray(pw))
    for name in ("coeff", "b", "diag"):
        g, wv = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.dtype == np.float32 and g.shape == wv.shape
        np.testing.assert_allclose(g, wv, rtol=0, atol=1e-4 * np.abs(wv).max())


def test_pr1_config_64x64_plain_cg():
    """BASELINE config 1 (tests/test_solver.py:44): 64², 100 value rows,
    plain CG at tol 5e-4; the float64 residual under 5e-4 and within 1e-2
    of the oracle's solution; and the reference's iterations and field."""
    rng = np.random.default_rng(0)
    shape = (64, 64)
    w, pos, vals = _random_problem(rng, shape)
    cfg = dict(tol=5e-4, preconditioner="none", maxiter=20000)
    got, want = _both("interpolate", shape, w, pos, vals, cfg)
    xt, info = got
    assert xt.dtype == torch.float32 and tuple(xt.shape) == shape
    assert bool(info.converged)
    assert _rel_residual_f64(shape, w, pos, vals, xt.numpy()) < 5e-4
    oracle = solve_sparse_linear(int(np.prod(shape)), assemble_explicit(
        fi.Grid(shape), fi.Weights(**w), pos, vals)).reshape(shape)
    assert np.abs(xt.numpy() - oracle).max() / np.abs(oracle).max() < 1e-2
    _match(got, want)
    # The apply kernel's route and plain torch ops (backend="xla") agree.
    xx, ix = ft.interpolate(ft.Grid(shape), ft.Weights(**w), _t(pos), _t(vals),
                            config=ft.SolverConfig(backend="xla", **cfg))
    assert abs(int(ix.iterations) - int(info.iterations)) <= 2
    np.testing.assert_allclose(xt.numpy(), xx.numpy(), rtol=0,
                               atol=2e-3 * float(xx.abs().max()))


@pytest.mark.parametrize("precond", ["jacobi", "multigrid"])
def test_interpolate_matches_reference(precond):
    rng = np.random.default_rng(2)
    shape = (32, 40)
    w, pos, vals = _random_problem(rng, shape, n=90, weights=dict(model_2=0.5))
    pw = rng.uniform(0.5, 2.0, 90).astype(np.float32)
    cfg = dict(tol=1e-4, preconditioner=precond, maxiter=5000)
    got = ft.interpolate(ft.Grid(shape), ft.Weights(**w), _t(pos), _t(vals),
                         point_weights=_t(pw), config=ft.SolverConfig(**cfg))
    want = fi.interpolate(fi.Grid(shape), fi.Weights(**w), jnp.asarray(pos, jnp.float32),
                          jnp.asarray(vals, jnp.float32), point_weights=jnp.asarray(pw),
                          config=fi.SolverConfig(**cfg))
    assert bool(got[1].converged)
    _match(got, want)


def test_zero_rhs_converges_immediately():
    """tests/test_solver.py:301: a zero-weight sample gives b = 0."""
    x, info = ft.interpolate(ft.Grid((16, 16)), ft.Weights(model_2=1.0),
                             torch.zeros((1, 2)), torch.zeros(1),
                             point_weights=torch.zeros(1))
    assert bool(info.converged) and int(info.iterations) == 0
    assert torch.equal(x, torch.zeros((16, 16)))


def test_1d_end_to_end():
    """tests/test_solver.py:327: a 1-D grid through the whole pipeline."""
    rng = np.random.default_rng(0)
    shape = (128,)
    w = dict(model_2=1.0)
    pos = rng.uniform(0, 127, (30, 1))
    vals = np.sin(pos[:, 0] / 20.0)
    cfg = dict(tol=1e-4, preconditioner="multigrid")
    got, want = _both("interpolate", shape, w, pos, vals, cfg)
    x, info = got
    assert bool(info.converged)
    assert _rel_residual_f64(shape, w, pos, vals, x.numpy()) < 1e-3
    idx = np.clip(np.round(pos[:, 0]).astype(int), 0, 127)
    assert np.median(np.abs(x.numpy()[idx] - vals)) < 0.2
    _match(got, want)


@pytest.mark.parametrize("order", [1, 2, 3])
def test_demo_1d_presets(order):
    """examples/demo_1d.py's preset panels (192 nodes, 9 samples, tol 1e-6,
    multigrid): the port's field against the reference's. The order-3
    panel converges in neither package (both stop at maxiter with a
    residual near 1e-4), so there the port only reports the same."""
    rng = np.random.default_rng(0)
    size = 192
    xs = np.sort(rng.uniform(2.0, size - 3.0, 9))
    t = xs / (size - 1)
    vals = np.sin(2 * np.pi * 1.5 * t) + 0.4 * np.cos(2 * np.pi * 4.0 * t)
    w = {f"model_{order}": 0.5, "data_pos": 1.0}
    if order != 2:
        w["model_2"] = 0.0
    cfg = dict(tol=1e-6, preconditioner="multigrid")
    got, want = _both("interpolate", (size,), w, xs[:, None], vals, cfg)
    if order == 3:
        assert not bool(want[1].converged) and not bool(got[1].converged)
        assert float(got[1].rel_residual) > 1e-6
        return
    assert bool(got[1].converged)
    _match(got, want)


def test_interpolate_precise_hits_1e6():
    """tests/test_solver.py:388: TRUE ≤ 1e-6 against the float64 oracle,
    the reported residual within 2% of it, the reference's field."""
    rng = np.random.default_rng(0)
    shape = (48, 48)
    w, pos, vals = _random_problem(rng, shape, n=80)
    cfg = ft.SolverConfig(tol=1e-6, preconditioner="multigrid")
    x, info = ft.interpolate_precise(ft.Grid(shape), ft.Weights(**w),
                                     torch.as_tensor(pos), torch.as_tensor(vals), config=cfg)
    assert x.dtype == torch.float64 and bool(info.converged)
    true = _rel_residual_f64(shape, w, pos, vals, x.numpy())
    assert true < 1e-6, true
    assert abs(true - float(info.rel_residual)) <= 0.02 * true
    xj, _ = fi.interpolate_precise(fi.Grid(shape), fi.Weights(**w), pos, vals,
                                   config=fi.SolverConfig(tol=1e-6,
                                                          preconditioner="multigrid"))
    want = np.asarray(xj, np.float64)
    np.testing.assert_allclose(x.numpy(), want, rtol=0, atol=2e-3 * np.abs(want).max())


def test_fmg_start_interpolate():
    """tests/test_solver.py:721-739: fewer fine iterations, the same field;
    the port's fmg guess and field against the reference's."""
    from field_interpolation_tpu.sdf import _fmg_guess_interp as jguess

    from field_interpolation_tpu_torch.sdf import _fmg_guess_interp as tguess
    rng = np.random.default_rng(5)
    shape = (64, 64)
    pos = rng.uniform(1, 62, size=(200, 2)).astype(np.float32)
    vals = np.sin(pos[:, 0] / 9.0).astype(np.float32)
    w = dict(model_2=0.3)
    cfg = dict(tol=1e-4, preconditioner="multigrid")
    cold, _ = _both("interpolate", shape, w, pos, vals, cfg)
    fmg, fmg_ref = _both("interpolate", shape, w, pos, vals, cfg, fmg_start=True)
    assert bool(fmg[1].converged)
    assert int(fmg[1].iterations) < int(cold[1].iterations)
    np.testing.assert_allclose(fmg[0].numpy(), cold[0].numpy(), atol=5e-2)
    _match(fmg, fmg_ref)
    cfg_t, cfg_j = ft.SolverConfig(**cfg), fi.SolverConfig(**cfg)
    g = tguess(ft.Grid(shape), ft.Weights(**w), _t(pos), _t(vals), None, cfg_t)
    gj = np.asarray(jguess(fi.Grid(shape), fi.Weights(**w), jnp.asarray(pos),
                           jnp.asarray(vals), None, cfg_j), np.float64)
    np.testing.assert_allclose(g.numpy(), gj, rtol=0, atol=2e-3 * np.abs(gj).max())


def test_sample_field_reads_back_constraints():
    """tests/test_constraints.py:208: data-dominant interpolation read back
    at the constraint positions reproduces the values."""
    rng = np.random.default_rng(1)
    grid = ft.Grid((24, 24))
    pts = _t(rng.uniform(2, 21, (40, 2)))
    vals = _t(rng.standard_normal(40))
    field, info = ft.interpolate(
        grid, ft.Weights(data_pos=30.0, model_2=0.01), pts, vals,
        config=ft.SolverConfig(tol=1e-5, preconditioner="multigrid", backend="xla",
                               maxiter=2000))
    assert bool(info.converged)
    got = ft.sample_field(grid, field, pts)
    np.testing.assert_allclose(got.numpy(), vals.numpy(), atol=5e-2)


def _sample_inputs(shape, seed=3):
    """A field and positions inside the lattice, on and past its edges,
    and non-finite ones."""
    rng = np.random.default_rng(seed)
    D = len(shape)
    field = rng.standard_normal(shape).astype(np.float32)
    pos = rng.uniform(0.0, np.asarray(shape) - 1.0, (40, D))
    pos[:4] = rng.uniform(-5.0, 0.0, (4, D))                       # below
    pos[4:8] = np.asarray(shape) - 1.0 + rng.uniform(0.0, 5.0, (4, D))  # above
    pos[8] = 0.0
    pos[9] = np.asarray(shape) - 1.0
    pos[10, 0], pos[11, -1], pos[12, 0] = np.nan, np.inf, -np.inf
    return field, pos.astype(np.float32)


@pytest.mark.parametrize("shape", [(13, 9), (7, 6, 5), (19,)], ids=["2d", "3d", "1d"])
@pytest.mark.parametrize("fn", ["sample_field", "sample_field_gradient"])
def test_sample_field_matches_reference(shape, fn):
    field, pos = _sample_inputs(shape)
    got = getattr(ft, fn)(ft.Grid(shape), _t(field), _t(pos)).numpy()
    want = np.asarray(getattr(fi, fn)(fi.Grid(shape), jnp.asarray(field), jnp.asarray(pos)))
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    finite = ~np.isnan(want)
    assert np.isnan(want[10:13]).all() and finite[:10].all()
    np.testing.assert_allclose(got[finite], want[finite], rtol=0,
                               atol=1e-5 * np.abs(want[finite]).max())


def test_sample_field_gradient_is_the_derivative():
    """Inside a cell, the autograd derivative of `sample_field` in the
    positions equals `sample_field_gradient` (float64 field)."""
    rng = np.random.default_rng(4)
    shape = (9, 11)
    field = torch.as_tensor(rng.standard_normal(shape))
    pos = torch.tensor(rng.uniform(0.0, np.asarray(shape) - 1.0, (30, 2)),
                       requires_grad=True)
    vals = ft.sample_field(ft.Grid(shape), field, pos)
    assert vals.dtype == torch.float64
    (g,) = torch.autograd.grad(vals.sum(), pos)
    want = ft.sample_field_gradient(ft.Grid(shape), field, pos.detach())
    torch.testing.assert_close(g, want, rtol=1e-12, atol=1e-12)
