"""The port's multigrid setup against the JAX package on the same problem:
level shapes, coarse weights and diagonals, the damped-Jacobi steps τ_l and
Gershgorin bounds ρ_l, the fused-segment operands (coeffs, sids, Rs at
rtol 1e-5; inv32 against the exact inverse, see below), and the plain
V-cycle preconditioner."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import field_interpolation_tpu as fi
from field_interpolation_tpu import multigrid as jmg
from field_interpolation_tpu.operators import assemble as jassemble

import field_interpolation_tpu_torch as ft
from field_interpolation_tpu_torch import multigrid as tmg
from field_interpolation_tpu_torch.convert import problem_from_numpy

WEIGHTS = dict(model_2=0.3)


def _pair(shape=(64, 64), n=100, seed=0):
    """The reference's Problem and the port's copy of the same operands."""
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0, 2 * np.pi, n)
    nrm = np.stack([np.cos(theta), np.sin(theta)], -1)
    center = (np.asarray(shape) - 1) / 2.0
    pos = center + 0.3 * min(shape) * nrm
    jp = jassemble(fi.Grid(shape), fi.Weights(**WEIGHTS),
                   jnp.asarray(pos, jnp.float32), jnp.zeros(n, jnp.float32),
                   gradients=jnp.asarray(nrm, jnp.float32))
    tp = problem_from_numpy(jp.coeff, jp.b, jp.diag, ft.Grid(shape),
                            ft.Weights(**WEIGHTS))
    return jp, tp


def _rel(got, want, rtol=1e-5):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("shape", [(256, 256), (64, 64), (40, 48), (37, 23),
                                   (33, 17), (16, 16), (9, 5, 7)])
@pytest.mark.parametrize("solver", ["dense", "jacobi"])
def test_level_shapes_match_reference(shape, solver):
    assert tmg.level_shapes(shape, 16, solver) == jmg.level_shapes(shape, 16, solver)


@pytest.mark.parametrize("shape", [(64, 64), (40, 48)])
def test_levels_match_reference(shape):
    jp, tp = _pair(shape)
    cfg_j, cfg_t = fi.SolverConfig(), ft.SolverConfig()
    jl, tl = jmg.build_levels(jp, cfg_j), tmg.build_levels(tp, cfg_t)
    assert [l.shape for l in tl] == [l.shape for l in jl]
    for a, b in zip(tl, jl):
        assert dataclasses_equal(a.weights, b.weights)
        _rel(a.data_diag, b.data_diag)
        _rel(a.diag, b.diag)
    lump_t, _, taus_t, rhos_t = tmg.build_smoothing_setup(tp, tl, cfg_t)
    lump_j, _, taus_j, rhos_j = jmg.build_smoothing_setup(jp, jl, cfg_j)
    assert lump_t == lump_j
    _rel([float(t) for t in taus_t], [float(t) for t in taus_j])
    _rel([float(r) for r in rhos_t], [float(r) for r in rhos_j])


def dataclasses_equal(a, b):
    return dataclasses.astuple(a) == dataclasses.astuple(b)


def test_fused_operands_match_reference():
    jp, tp = _pair((64, 64))
    j_ops = jmg.build_fused_solver_operands(jp, fi.SolverConfig())
    t_ops = tmg.build_fused_solver_operands(tp, ft.SolverConfig())
    assert j_ops is not None and t_ops is not None
    (jc, js, jR, jinv, jlw, jcf), (tc, ts, tR, tinv, tlw, tcf) = j_ops, t_ops
    assert jcf is None and tcf is None
    assert [dataclasses_equal(a, b) for a, b in zip(tlw, jlw)] == [True] * len(jlw)
    for group_t, group_j in [(tc, jc), (ts, js), (tR, jR)]:
        assert len(group_t) == len(group_j)
        for a, b in zip(group_t, group_j):
            assert tuple(a.shape) == b.shape and a.dtype == torch.float32
            assert a.is_contiguous()
            _rel(a, b)
    # The port factors the coarsest operator in float64 and rounds once; the
    # reference factors in float32. Hold the port to the exact inverse of the
    # reference's own coarsest operator at float32 rounding, and the
    # reference to it within its float32 factorization error, κ·2⁻²³.
    lvl = jmg.build_levels(jp, fi.SolverConfig())[-1]
    A_c = (jmg._smoothness_dense_matrix(lvl.shape, lvl.weights)
           + np.diag(np.asarray(lvl.data_diag, np.float64).ravel()))
    exact = np.linalg.inv(A_c)
    _rel(tinv, exact, rtol=1e-6)
    _rel(jinv, exact, rtol=np.linalg.cond(A_c) * 2.0**-23)
    # Exactly symmetric: CG needs a symmetric preconditioner.
    assert torch.equal(tinv, tinv.T)


@pytest.mark.parametrize("change", [
    dict(mg_pre_smooth=2),              # ν_pre ≠ ν_post
    dict(mg_coarse_solver="jacobi"),    # no dense coarsest
    dict(preconditioner="jacobi"),
])
def test_fused_gate_matches_reference(change):
    jp, tp = _pair((32, 32))
    assert jmg.build_fused_solver_operands(jp, fi.SolverConfig(**change)) is None
    assert tmg.build_fused_solver_operands(tp, ft.SolverConfig(**change)) is None


@pytest.mark.parametrize("shape", [(64, 64), (256, 256), (1024, 1024),
                                   (2048, 2048), (64, 64, 64), (128, 128, 128)])
@pytest.mark.parametrize("cycle", ["auto", "v", "w"])
def test_resolve_wdepth_matches_reference(shape, cycle):
    assert (tmg.resolve_wdepth(ft.SolverConfig(mg_cycle=cycle), shape)
            == jmg.resolve_wdepth(fi.SolverConfig(mg_cycle=cycle), shape))


@pytest.mark.parametrize("cycle", ["v", "w"])
def test_plain_vcycle_matches_reference(cycle):
    """The plain V-cycle (the CPU and backend='xla' preconditioner) against
    the reference's XLA V-cycle on the same residual."""
    jp, tp = _pair((64, 64))
    jcfg = fi.SolverConfig(mg_cycle=cycle)
    tcfg = ft.SolverConfig(mg_cycle=cycle)
    r = np.random.default_rng(3).standard_normal((64, 64)).astype(np.float32)
    want = jmg.make_vcycle_preconditioner(jp, jcfg)(jnp.asarray(r))
    got = tmg.make_vcycle_preconditioner(tp, tcfg)(torch.as_tensor(r))
    _rel(got, want, rtol=1e-4)


def test_transfers_are_transposes():
    x = torch.as_tensor(np.random.default_rng(4).standard_normal((16, 12)))
    y = torch.as_tensor(np.random.default_rng(5).standard_normal((31, 23)))
    restrict = tmg.make_restrict((31, 23), (16, 12))
    lhs = torch.sum(tmg.prolong(x, (31, 23)) * y)
    rhs = torch.sum(x * restrict(y))
    assert abs(float(lhs - rhs)) <= 1e-12 * abs(float(lhs))


def test_unported_options_raise():
    """Galerkin coarse data and Chebyshev smoothing, once refused, build
    the reference's levels: the Galerkin stencil on every coarse level
    (its center channel the data diagonal), the lumped diagonal under
    Chebyshev, with the reference's τ_l and ρ̂_l."""
    jp, tp = _pair((32, 32))
    for change in [dict(mg_coarse_data="galerkin"), dict(mg_smoother="chebyshev")]:
        cfg_j, cfg_t = fi.SolverConfig(**change), ft.SolverConfig(**change)
        jl, tl = jmg.build_levels(jp, cfg_j), tmg.build_levels(tp, cfg_t)
        assert [l.shape for l in tl] == [l.shape for l in jl] and tl
        for a, b in zip(tl, jl):
            assert (a.data_coeff is None) == (b.data_coeff is None)
            if b.data_coeff is not None:
                _rel(a.data_coeff, b.data_coeff)
            _rel(a.data_diag, b.data_diag)
            _rel(a.diag, b.diag)
        _, _, taus_t, rhos_t = tmg.build_smoothing_setup(tp, tl, cfg_t)
        _, _, taus_j, rhos_j = jmg.build_smoothing_setup(jp, jl, cfg_j)
        _rel([float(t) for t in taus_t], [float(t) for t in taus_j])
        _rel([float(r) for r in rhos_t], [float(r) for r in rhos_j])
