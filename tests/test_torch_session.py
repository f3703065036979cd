"""Reusable setup in the port: `prepare` / ``solve(prep=...)`` and the
`Solver` session, against the port's own cold path and the JAX package's
`prepare` / `Solver`, on the same numpy-seeded inputs
(tests/test_session.py's cases).

Bars: a prepared or session solve takes the cold solve's iterations and
gives its field within 1e-5·max|x| (prepared: the same operands, so on CPU
tensors the same bits) or 2e-4·max|x| (session: the right-hand side comes
from the session's own scatter, tests/test_session.py's bar); against the
reference ±2 iterations and 2e-3·max|x| (tests/test_solver.py:174-195); a
precise frame's TRUE residual ≤ tol against the float64 oracle with the
reported one within 2%; a stale prep raises ``ValueError``; a prepared
solve builds no part of the setup (a spy on the setup functions)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import field_interpolation_tpu as fi
from field_interpolation_tpu.explicit import assemble_explicit, normal_equations
from field_interpolation_tpu.solver import prepare as jprepare
from field_interpolation_tpu.solver import solve as jsolve

import field_interpolation_tpu_torch as ft
from field_interpolation_tpu_torch import multigrid as tmg
from field_interpolation_tpu_torch.solver import prepare, solve

CFG = dict(tol=1e-5, preconditioner="multigrid")


def _cloud(rng, shape, n=120):
    """tests/test_session.py:_cloud, as numpy float32."""
    pos = rng.uniform(0, 1, (n, len(shape))) * (np.array(shape) - 1)
    nrm = rng.standard_normal((n, len(shape)))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return (pos.astype(np.float32), nrm.astype(np.float32),
            rng.standard_normal(n).astype(np.float32))


def _t(a):
    return torch.as_tensor(a)


def _close(got, want, bar):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=bar * np.abs(want).max())


def _sdf_problems(shape, w, pos, nrm):
    return (ft.assemble_sdf(ft.Grid(shape), ft.Weights(**w), _t(pos), _t(nrm)),
            fi.assemble_sdf(fi.Grid(shape), fi.Weights(**w), jnp.asarray(pos),
                            jnp.asarray(nrm)))


def test_prepare_solve_matches_cold():
    """tests/test_session.py:29 (48×40: the fused segment's path), and the
    reference's prepared solve."""
    rng = np.random.default_rng(0)
    shape, w = (48, 40), dict(model_2=0.3)
    pos, nrm, _ = _cloud(rng, shape)
    prob, jprob = _sdf_problems(shape, w, pos, nrm)
    cfg = ft.SolverConfig(**CFG)
    x_cold, i_cold = solve(prob, cfg)
    prep = prepare(prob, cfg)
    assert prep is not None and prep.fused is not None
    x_prep, i_prep = solve(prob, cfg, prep=prep)
    assert int(i_prep.iterations) == int(i_cold.iterations)
    _close(x_prep, x_cold, 1e-5)
    jcfg = fi.SolverConfig(**CFG)
    xj, ij = jsolve(jprob, jcfg, prep=jprepare(jprob, jcfg))
    assert abs(int(i_prep.iterations) - int(ij.iterations)) <= 2
    _close(x_prep, xj, 2e-3)


def test_prepare_solve_matches_cold_fused():
    """tests/test_session.py:46: with ``backend="pallas"`` (the reference's
    fused path on the CPU, the port's "auto") the prep holds the fused
    operands and reproduces the cold fused solve; both match the
    reference's prepared fused solve in interpret mode."""
    rng = np.random.default_rng(0)
    shape, w = (32, 32), dict(model_2=0.3)
    pos, nrm, _ = _cloud(rng, shape, n=60)
    prob, jprob = _sdf_problems(shape, w, pos, nrm)
    change = dict(tol=1e-4, preconditioner="multigrid", backend="pallas")
    cfg = ft.SolverConfig(**change)
    x_cold, i_cold = solve(prob, cfg)
    prep = prepare(prob, cfg)
    assert prep.fused is not None
    x_prep, i_prep = solve(prob, cfg, prep=prep)
    assert int(i_prep.iterations) == int(i_cold.iterations)
    _close(x_prep, x_cold, 1e-5)
    jcfg = fi.SolverConfig(**change)
    jprep = jprepare(jprob, jcfg)
    assert jprep.fused is not None
    xj, ij = jsolve(jprob, jcfg, prep=jprep)
    assert abs(int(i_prep.iterations) - int(ij.iterations)) <= 2
    _close(x_prep, xj, 2e-3)


# Every route a prepared solve can take: the plain cycle, the level-by-level
# kernel smoothers (ν_pre ≠ ν_post), their Chebyshev schedules, Galerkin
# levels, a smoothed (not dense) coarsest level, the lumped fine operator's
# whole-cycle route, 3-D, and the degenerate hierarchy's dense inverse.
ROUTES = [((48, 40), dict(backend="xla")),
          ((48, 40), dict(mg_pre_smooth=2)),
          ((48, 40), dict(mg_pre_smooth=2, mg_smoother="chebyshev4")),
          ((48, 40), dict(mg_pre_smooth=2, mg_coarse_data="galerkin")),
          ((40, 40), dict(mg_coarse_solver="jacobi", mg_smoother="chebyshev")),
          ((48, 40), dict(mg_fine_operator="lumped")),
          ((24, 20, 18), dict()),
          ((8, 8), dict())]
ROUTE_IDS = ["xla", "levels", "levels-cheb", "galerkin", "jacobi-coarsest",
             "lumped-whole-cycle", "3d", "degenerate"]


@pytest.mark.parametrize("shape,change", ROUTES, ids=ROUTE_IDS)
def test_prepared_routes_match_cold(shape, change):
    rng = np.random.default_rng(1)
    pos, nrm, _ = _cloud(rng, shape, n=150)
    prob, _ = _sdf_problems(shape, dict(model_2=0.3), pos, nrm)
    cfg = ft.SolverConfig(**CFG, **change)
    x_cold, i_cold = solve(prob, cfg)
    prep = prepare(prob, cfg)
    assert prep.fused is None
    x_prep, i_prep = solve(prob, cfg, prep=prep)
    assert bool(i_prep.converged)
    assert int(i_prep.iterations) == int(i_cold.iterations)
    _close(x_prep, x_cold, 1e-5)


def test_prepare_returns_none_without_multigrid():
    rng = np.random.default_rng(2)
    pos, nrm, _ = _cloud(rng, (16, 16), n=40)
    prob, _ = _sdf_problems((16, 16), dict(model_2=0.3), pos, nrm)
    assert prepare(prob, ft.SolverConfig(preconditioner="jacobi")) is None


@pytest.mark.parametrize("shape,change", [((48, 40), {}), ROUTES[2], ROUTES[5], ROUTES[6]],
                         ids=["fused", "levels-cheb", "lumped-whole-cycle", "3d"])
def test_prepared_solve_builds_nothing(monkeypatch, shape, change):
    """With a prep, neither the fused operands, the whole cycle's, the
    hierarchy, the smoothing setup, the coarsest inverse, the smoothers'
    operands nor a Chebyshev schedule is built during the solve."""
    rng = np.random.default_rng(3)
    pos, nrm, _ = _cloud(rng, shape, n=150)
    prob, _ = _sdf_problems(shape, dict(model_2=0.3), pos, nrm)
    cfg = ft.SolverConfig(**CFG, **change)
    x_cold, _ = solve(prob, cfg)
    prep = prepare(prob, cfg)

    def built(*args, **kwargs):
        raise AssertionError("setup built during a prepared solve")
    for name in ("build_levels", "build_smoothing_setup", "_coarse_dense_inverse",
                 "_fused_vcycle_operands", "_smoother_operands", "chebyshev_coefs",
                 "whole_cycle_operands"):
        monkeypatch.setattr(tmg, name, built)
    x_prep, _ = solve(prob, cfg, prep=prep)
    monkeypatch.undo()
    _close(x_prep, x_cold, 1e-5)


@pytest.mark.slow
def test_prepare_refined_matches_cold():
    """tests/test_session.py:64."""
    rng = np.random.default_rng(0)
    shape, w = (40, 40), dict(model_2=0.3)
    pos, nrm, _ = _cloud(rng, shape)
    cfg = ft.SolverConfig(tol=1e-6, preconditioner="multigrid")
    pp = ft.assemble_precise(ft.Grid(shape), ft.Weights(**w), _t(pos),
                             torch.zeros(len(pos)), gradients=_t(nrm))
    x_cold, i_cold = ft.solve_refined(pp, cfg)
    x_prep, i_prep = ft.solve_refined(pp, cfg, prep=prepare(pp, cfg))
    assert bool(i_prep.converged)
    assert int(i_prep.iterations) == int(i_cold.iterations)
    _close(x_prep, x_cold, 1e-6)


def test_prepare_refined_matches_cold_small():
    """The refined solve with a prep at 24×20 (the segment's path) and with
    the level-by-level cycle."""
    rng = np.random.default_rng(4)
    shape, w = (24, 20), dict(model_2=0.3)
    pos, nrm, _ = _cloud(rng, shape, n=60)
    pp = ft.assemble_precise(ft.Grid(shape), ft.Weights(**w), _t(pos),
                             torch.zeros(len(pos)), gradients=_t(nrm))
    for change in ({}, dict(mg_pre_smooth=2)):
        cfg = ft.SolverConfig(tol=1e-6, preconditioner="multigrid", **change)
        x_cold, i_cold = ft.solve_refined(pp, cfg)
        x_prep, i_prep = ft.solve_refined(pp, cfg, prep=prepare(pp, cfg))
        assert bool(i_prep.converged)
        assert int(i_prep.iterations) == int(i_cold.iterations)
        _close(x_prep, x_cold, 1e-6)


def test_stale_prep_raises():
    """tests/test_session.py:82, and the same checks in solve_refined."""
    rng = np.random.default_rng(0)
    shape, w = (48, 40), dict(model_2=0.3)
    pos, nrm, _ = _cloud(rng, shape)
    prob, _ = _sdf_problems(shape, w, pos, nrm)
    cfg = ft.SolverConfig(**CFG)
    prep = prepare(prob, cfg)

    prob_w2, _ = _sdf_problems(shape, dict(model_2=0.7), pos, nrm)
    with pytest.raises(ValueError, match="Weights"):
        solve(prob_w2, cfg, prep=prep)

    grid2 = (40, 48)
    pos2, nrm2, _ = _cloud(rng, grid2)
    prob_g2, _ = _sdf_problems(grid2, w, pos2, nrm2)
    with pytest.raises(ValueError, match="grid"):
        solve(prob_g2, cfg, prep=prep)

    cfg2 = ft.SolverConfig(tol=1e-5, preconditioner="multigrid",
                           mg_pre_smooth=2, mg_post_smooth=2)
    with pytest.raises(ValueError, match="config"):
        solve(prob, cfg2, prep=prep)
    pp = ft.assemble_precise(ft.Grid(shape), ft.Weights(**w), _t(pos),
                             torch.zeros(len(pos)), gradients=_t(nrm))
    with pytest.raises(ValueError, match="config"):
        ft.solve_refined(pp, cfg2, prep=prep)

    # tol / maxiter changes do NOT invalidate.
    cfg3 = ft.SolverConfig(tol=1e-4, maxiter=500, preconditioner="multigrid")
    x, info = solve(prob, cfg3, prep=prep)
    assert bool(info.converged)


def test_session_solver_matches_cold_sdf():
    """tests/test_session.py:118, and the reference's session."""
    rng = np.random.default_rng(0)
    shape, w = (48, 40), dict(model_2=0.3)
    pos, nrm, _ = _cloud(rng, shape)
    s = ft.Solver(ft.Grid(shape), ft.Weights(**w), _t(pos), config=ft.SolverConfig(**CFG))
    x_s, i_s = s.solve(torch.zeros(len(pos)), gradients=_t(nrm))
    x_c, i_c = ft.sdf_from_points(ft.Grid(shape), ft.Weights(**w), _t(pos), _t(nrm),
                                  config=ft.SolverConfig(**CFG))
    assert bool(i_s.converged)
    assert int(i_s.iterations) == int(i_c.iterations)
    _close(x_s, x_c, 2e-4)
    js = fi.Solver(fi.Grid(shape), fi.Weights(**w), jnp.asarray(pos),
                   config=fi.SolverConfig(**CFG))
    xj, ij = js.solve(jnp.zeros(len(pos)), gradients=jnp.asarray(nrm))
    assert abs(int(i_s.iterations) - int(ij.iterations)) <= 2
    _close(x_s, xj, 2e-3)


def test_session_solver_value_only_and_retarget():
    """tests/test_session.py:133: the first frame equals `interpolate`, and
    a second frame with other values equals a cold solve of those values."""
    rng = np.random.default_rng(0)
    shape, w = (40, 32), dict(model_2=0.5)
    pos, _, vals = _cloud(rng, shape)
    vals2 = rng.standard_normal(len(pos)).astype(np.float32)
    s = ft.Solver(ft.Grid(shape), ft.Weights(**w), _t(pos), gradients=False,
                  config=ft.SolverConfig(**CFG))
    for v in (vals, vals2):
        x, i = s.solve(_t(v))
        xc, ic = ft.interpolate(ft.Grid(shape), ft.Weights(**w), _t(pos), _t(v),
                                config=ft.SolverConfig(**CFG))
        assert int(i.iterations) == int(ic.iterations)
        _close(x, xc, 2e-4)


def test_session_solver_warm_start_cuts_iterations():
    """tests/test_session.py:155."""
    rng = np.random.default_rng(0)
    shape, w = (48, 48), dict(model_2=0.3)
    pos, nrm, _ = _cloud(rng, shape)
    s = ft.Solver(ft.Grid(shape), ft.Weights(**w), _t(pos), config=ft.SolverConfig(**CFG))
    zeros = torch.zeros(len(pos))
    x1, _ = s.solve(zeros, gradients=_t(nrm))
    nrm2 = _t(nrm * 0.98 + 0.02)
    x2, i2 = s.solve(zeros, gradients=nrm2, x0=x1)
    _, i2cold = s.solve(zeros, gradients=nrm2)
    assert bool(i2.converged)
    assert int(i2.iterations) < int(i2cold.iterations)


def _oracle_rel(shape, w, pos, nrm, x):
    eq = assemble_explicit(fi.Grid(shape), fi.Weights(**w), pos.astype(np.float64),
                           np.zeros(len(pos)), gradients=nrm.astype(np.float64))
    AtA, Atb = normal_equations(eq, int(np.prod(shape)))
    r = Atb - AtA @ np.asarray(x, np.float64).ravel()
    return np.linalg.norm(r) / np.linalg.norm(Atb)


def _check_precise_frames(shape, n, seed):
    rng = np.random.default_rng(seed)
    w = dict(model_2=0.3)
    pos, nrm, _ = _cloud(rng, shape, n=n)
    cfg = ft.SolverConfig(tol=1e-6, preconditioner="multigrid")
    s = ft.Solver(ft.Grid(shape), ft.Weights(**w), _t(pos), config=cfg, precise=True)
    zeros = torch.zeros(len(pos))
    x1, i1 = s.solve(zeros, gradients=_t(nrm))
    xc, ic = ft.sdf_from_points_precise(ft.Grid(shape), ft.Weights(**w), _t(pos),
                                        _t(nrm), config=cfg)
    assert x1.dtype == torch.float64
    assert int(i1.iterations) == int(ic.iterations)
    _close(x1, xc, 2e-4)
    nrm2 = np.roll(nrm, 1, axis=0)
    x2, i2 = s.solve(zeros, gradients=_t(nrm2))
    assert bool(i2.converged)
    rel = _oracle_rel(shape, w, pos, nrm2, x2.numpy())
    assert rel < 1e-6, rel
    assert abs(rel - float(i2.rel_residual)) <= 0.02 * rel + 1e-12


def test_session_solver_precise_frames():
    """A precise session's first frame equals `sdf_from_points_precise`,
    and its second (fresh targets, the session's float64 rows) meets the
    TRUE 1e-6 bar against the float64 oracle."""
    _check_precise_frames((24, 24), 50, seed=5)


@pytest.mark.slow
def test_session_solver_precise_true_residual():
    """tests/test_session.py:171 (32×32, 60 points)."""
    _check_precise_frames((32, 32), 60, seed=0)


def test_session_config_override():
    """A per-call config may change tol and maxiter; a setup-relevant field
    raises."""
    rng = np.random.default_rng(6)
    shape, w = (32, 32), dict(model_2=0.3)
    pos, nrm, _ = _cloud(rng, shape, n=60)
    s = ft.Solver(ft.Grid(shape), ft.Weights(**w), _t(pos), config=ft.SolverConfig(**CFG))
    zeros = torch.zeros(len(pos))
    _, i_tight = s.solve(zeros, gradients=_t(nrm))
    _, i_loose = s.solve(zeros, gradients=_t(nrm),
                         config=ft.SolverConfig(tol=1e-3, preconditioner="multigrid"))
    assert bool(i_loose.converged) and int(i_loose.iterations) < int(i_tight.iterations)
    with pytest.raises(ValueError, match="config"):
        s.solve(zeros, gradients=_t(nrm), config=ft.SolverConfig(tol=1e-5, mg_omega=0.8))


def test_session_argument_checks():
    grid = ft.Grid((16, 16))
    with pytest.raises(ValueError, match="positions"):
        ft.Solver(grid, ft.Weights(), torch.zeros((5, 3)))
    s = ft.Solver(grid, ft.Weights(), torch.full((5, 2), 7.0), config=ft.SolverConfig(**CFG))
    with pytest.raises(ValueError, match="gradients"):
        s.solve(torch.zeros(5))
