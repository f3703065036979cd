"""Chebyshev smoothing in the port against the JAX package, on the same
numpy-seeded inputs:

* `multigrid.chebyshev_coefs` against the reference's schedule, kinds 1 and
  4, ν = 0..4, to float32 rounding (the same float32 operations in the same
  order, within one unit in the last place);
* `fused_smooth` / `fused_smooth_2d` with ``cheb_coefs`` (on CPU tensors
  `fused_smooth_plain`, the function the CUDA kernels compute) against the
  reference's ``fused_smooth``, ``fused_smooth_striped`` and
  ``fused_smooth_tiled`` in their Chebyshev mode (interpret mode), from zero
  and from z, at the reference's bar 2e-5 (tests/test_mg_options.py:346);
* `ops.cycle.fused_vcycle_2d` / `fused_wcycle_2d` with per-level schedules
  (`mg_cycle_plain`) against the reference's whole-cycle kernels, lumped
  and Galerkin coarse levels, at 3e-5·max|want|
  (tests/test_mg_options.py:269-271);
* the plain and the kernel-route preconditioners against the reference's;
* solves with every smoother / coarse-data combination against the
  reference's ``backend="pallas"`` solve (its fused segment in interpret
  mode), within ±2 iterations and 5e-3 (tests/test_mg_options.py:171-192);
* ν = 0: the Chebyshev cycle is the Jacobi one, bit for bit
  (tests/test_mg_options.py:194-209)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import field_interpolation_tpu as fi
from field_interpolation_tpu import multigrid as jmg
from field_interpolation_tpu import operators as jops
from field_interpolation_tpu import solver as jsolver
from field_interpolation_tpu.constraints import data_diag
from field_interpolation_tpu.ops import pallas_stencil as ps

import field_interpolation_tpu_torch as ft
from field_interpolation_tpu_torch import multigrid as tmg
from field_interpolation_tpu_torch.convert import (fused_operands_from_numpy,
                                                   problem_from_numpy)
from field_interpolation_tpu_torch.ops import cycle
from field_interpolation_tpu_torch.ops.smooth import fused_smooth, fused_smooth_2d

COMBOS = [("chebyshev", "lumped"), ("chebyshev4", "lumped"),
          ("jacobi", "galerkin"), ("chebyshev4", "galerkin")]


def _t(a):
    return torch.as_tensor(np.array(a, np.float32))


@functools.lru_cache(maxsize=None)
def _problem(shape=(48, 40), n=600, seed=0, weights=(("model_2", 1.0),)):
    """tests/test_mg_options.py:_problem_2d (scattered values and gradients)
    and the port's copy of it."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, min(shape) - 1.001, size=(n, 2))
    vals = rng.normal(size=(n,))
    grads = rng.normal(size=(n, 2))
    w = dict(weights)
    jp = jops.assemble(fi.Grid(shape), fi.Weights(**w), jnp.asarray(pos, jnp.float32),
                       jnp.asarray(vals, jnp.float32), jnp.asarray(grads, jnp.float32))
    tp = problem_from_numpy(jp.coeff, jp.b, jp.diag, ft.Grid(shape), ft.Weights(**w))
    return jp, tp


@pytest.mark.parametrize("kind", ["chebyshev", "chebyshev4"])
@pytest.mark.parametrize("nu", [0, 1, 2, 3, 4])
def test_chebyshev_coefs_match_reference(kind, nu):
    for rho in (2.0, 2.7183, 0.61):
        want = np.asarray(jmg.chebyshev_coefs(jnp.float32(rho), nu,
                                              fi.SolverConfig(mg_smoother=kind)))
        got = tmg.chebyshev_coefs(torch.tensor(rho, dtype=torch.float32), nu,
                                  ft.SolverConfig(mg_smoother=kind))
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (nu, 2)
        # The same float32 operations; XLA's CPU division may round c2 one
        # unit in the last place off the correctly rounded quotient.
        np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=1)


def _smooth_operands(shape, seed, n, diag=False):
    """numpy (r, z, coeff, D⁻¹) of an assembled scattered problem, and its
    Weights(model_2=1.0); coeff is the 3^D stencil or its diagonal."""
    rng = np.random.default_rng(seed)
    nd = len(shape)
    pos = rng.uniform(0, min(shape) - 1.001, size=(n, nd))
    jp = jops.assemble(fi.Grid(shape), fi.Weights(model_2=1.0),
                       jnp.asarray(pos, jnp.float32),
                       jnp.asarray(rng.normal(size=n), jnp.float32))
    r, z = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    inv_d = np.asarray(jnp.where(jp.diag > 0, 1.0 / jp.diag, 1.0), np.float32)
    coeff = np.asarray(data_diag(jp.coeff, nd) if diag else jp.coeff, np.float32)
    return r, z, coeff, inv_d


def _schedule(kind="chebyshev4", nu=3, rho=2.0):
    return jmg.chebyshev_coefs(jnp.float32(rho), nu, fi.SolverConfig(mg_smoother=kind))


@pytest.mark.parametrize("from_zero", [True, False])
@pytest.mark.parametrize("shape,diag", [((32, 24), False), ((32, 24), True),
                                        ((12, 10, 8), True), ((12, 10, 8), False)],
                         ids=["2d-9ch", "2d-diag", "3d-diag", "3d-27ch"])
def test_fused_smooth_chebyshev_matches_reference(shape, diag, from_zero):
    """The per-sweep kernel's wrapper in Chebyshev form against the
    reference's whole-level fused_smooth (pallas_stencil.py:537)."""
    r, z, coeff, inv_d = _smooth_operands(shape, 3, 200, diag)
    cf = _schedule()
    want = ps.fused_smooth(jnp.asarray(r), jnp.asarray(z), jnp.asarray(coeff),
                           jnp.asarray(inv_d), fi.Weights(model_2=1.0), len(shape),
                           sweeps=3, from_zero=from_zero, interpret=True,
                           diag_data=diag, cheb_coefs={3: cf})
    got = fused_smooth(_t(r), _t(z), _t(coeff), _t(inv_d), ft.Weights(model_2=1.0),
                       len(shape), 3, from_zero, cheb_coefs=_t(cf))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("from_zero", [True, False])
@pytest.mark.parametrize("kernel,shape,tiling", [
    (ps.fused_smooth_striped, (64, 40), dict(stripe=16)),
    (ps.fused_smooth_tiled, (64, 256), dict(tiles=(8, 128))),
], ids=["striped", "tiled"])
def test_fused_smooth_2d_chebyshev_matches_reference(kernel, shape, tiling, from_zero):
    """The multi-sweep kernel's wrapper in Chebyshev form against the
    reference's striped and tiled smoothers' Chebyshev mode (689-750,
    921-991), whose stripes and tiles carry z_prev across their seams."""
    r, z, coeff, inv_d = _smooth_operands(shape, 5, 500)
    cf = _schedule()
    want = kernel(jnp.asarray(r), jnp.asarray(z), jnp.asarray(coeff), jnp.asarray(inv_d),
                  fi.Weights(model_2=1.0), sweeps=3, from_zero=from_zero,
                  interpret=True, cheb_coefs={3: cf}, **tiling)
    got = fused_smooth_2d(_t(r), _t(z), _t(coeff), _t(inv_d), ft.Weights(model_2=1.0),
                          3, from_zero, cheb_coefs=_t(cf))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_smoothing_wrappers_check_the_schedule():
    r = torch.zeros((8, 6))
    w = ft.Weights(model_2=0.3)
    for bad in (torch.zeros((2, 2)), torch.zeros((3, 1)), torch.zeros(6),
                torch.zeros((3, 2), dtype=torch.float64), np.zeros((3, 2), np.float32)):
        with pytest.raises(ValueError, match="Chebyshev schedule"):
            fused_smooth(r, r, r, r, w, 2, 3, cheb_coefs=bad)
        with pytest.raises(ValueError, match="Chebyshev schedule"):
            fused_smooth_2d(r, r, torch.zeros((9, 8, 6)), r, w, 3, cheb_coefs=bad)
    # 0 sweeps from zero are zeros under Chebyshev (the reference's
    # _cheb_inplace), one sid·r step under Jacobi.
    got = fused_smooth(r + 1, r, r, r + 2, w, 2, 0, True, cheb_coefs=torch.zeros((0, 2)))
    assert torch.equal(got, r)


@functools.lru_cache(maxsize=None)
def _cycle_operands(smoother, coarse_data):
    """The reference's fused-cycle operands at 48×40 (five levels would be
    too many; 48×40 has three) and the port's copy, schedules included."""
    jp, _ = _problem((48, 40), 400, 14)
    cfg = fi.SolverConfig(mg_smoother=smoother, mg_coarse_data=coarse_data)
    coeffs, sids, Rs, inv32, lw, cfs = jmg.build_fused_solver_operands(jp, cfg)
    t_ops = fused_operands_from_numpy(coeffs, sids, Rs, inv32,
                                      [ft.Weights(**vars(w)) for w in lw])
    t_cfs = None if cfs is None else [_t(c) for c in cfs]
    return (coeffs, sids, Rs, inv32, lw), cfs, t_ops[:5], t_cfs


def _close(got, want, bar=3e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=bar * np.abs(want).max())


@pytest.mark.parametrize("smoother,coarse_data,wdepth", [
    ("chebyshev4", "lumped", 0), ("chebyshev4", "galerkin", 99),
    ("jacobi", "galerkin", 0)], ids=str)
def test_cycle_chebyshev_matches_reference_kernels(smoother, coarse_data, wdepth):
    """wdepth 0: the reference's _vc_down_call + matvec + _vc_up_call; 99:
    its fused_wcycle_2d; each with its per-level schedules in SMEM and, under
    Galerkin, 9-channel coarse levels."""
    j_ops, j_cfs, t_ops, t_cfs = _cycle_operands(smoother, coarse_data)
    if coarse_data == "galerkin":
        assert all(c.ndim == 3 for c in t_ops[0])
    r = np.random.default_rng(15).standard_normal((48, 40)).astype(np.float32)
    if wdepth:
        want = ps.fused_wcycle_2d(jnp.asarray(r), *j_ops, 3, interpret=True,
                                  cheb_coefs=j_cfs, wdepth=wdepth)
        got = cycle.fused_wcycle_2d(_t(r), *t_ops, 3, cheb_coefs=t_cfs, wdepth=wdepth)
    else:
        want = ps.fused_vcycle_2d(jnp.asarray(r), *j_ops, 3, 3, interpret=True,
                                  cheb_coefs=j_cfs)
        got = cycle.fused_vcycle_2d(_t(r), *t_ops, 3, 3, cheb_coefs=t_cfs)
    assert got.dtype == torch.float32 and tuple(got.shape) == r.shape
    _close(got, want)


def test_plain_preconditioner_matches_reference():
    """The plain cycle (CPU tensors, backend="xla") against the reference's
    XLA cycle, with its first-kind Chebyshev recurrence and Galerkin
    levels."""
    jp, tp = _problem()
    change = dict(mg_smoother="chebyshev", mg_coarse_data="galerkin")
    r = np.random.default_rng(3).standard_normal((48, 40)).astype(np.float32)
    want = jmg.make_vcycle_preconditioner(jp, fi.SolverConfig(**change))(jnp.asarray(r))
    got = tmg.make_vcycle_preconditioner(tp, ft.SolverConfig(**change))(_t(r))
    _close(got, want, 1e-4)


@pytest.mark.parametrize("change", [
    dict(mg_smoother="chebyshev", mg_coarse_data="galerkin", mg_pre_smooth=2),
    dict(mg_smoother="chebyshev4", mg_fine_operator="lumped", mg_cycle="w"),
], ids=str)
def test_kernel_route_matches_reference_kernel_route(change):
    """The cycle through the smoothing wrappers (ν_pre ≠ ν_post: every
    level, Galerkin ones included, through `fused_smooth_2d`, each with its
    schedule for ν_pre and ν_post) or the whole-cycle wrapper
    (the lumped fine operator) against the reference's pallas_smooth route
    in interpret mode."""
    jp, tp = _problem((48, 40), 600, 2, (("model_2", 0.3),))
    cfg = ft.SolverConfig(**change)
    whole = tmg.kernel_plan(tp, cfg, tmg.build_levels(tp, cfg),
                            cfg.mg_fine_operator == "lumped")[1]
    assert (whole is None) == (change.get("mg_pre_smooth") == 2)
    r = np.random.default_rng(5).standard_normal((48, 40)).astype(np.float32)
    want = jmg.make_vcycle_preconditioner(jp, fi.SolverConfig(**change), pallas_smooth=True,
                                          pallas_interpret=True)(jnp.asarray(r))
    got = tmg.make_vcycle_preconditioner(tp, ft.SolverConfig(**change), kernels=True)(_t(r))
    _close(got, want)


@pytest.mark.parametrize("smoother,coarse_data", COMBOS, ids=str)
def test_solve_matches_reference_fused_solve(smoother, coarse_data):
    """tests/test_mg_options.py:171-192: the reference's backend="pallas"
    solve runs its fused segment (interpret mode) with the option's kernels;
    the port's solve on CPU tensors runs the segment's plain version."""
    jp, tp = _problem()
    change = dict(tol=1e-5, mg_smoother=smoother, mg_coarse_data=coarse_data)
    assert tmg.build_fused_solver_operands(tp, ft.SolverConfig(**change)) is not None
    xj, ij = jsolver.solve(jp, fi.SolverConfig(backend="pallas", **change))
    xt, it = ft.solve(tp, ft.SolverConfig(**change))
    assert bool(ij.converged) and bool(it.converged)
    assert abs(int(it.iterations) - int(ij.iterations)) <= 2
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0, atol=5e-3)


@pytest.mark.parametrize("kernels", [False, True])
def test_zero_sweeps_chebyshev_is_jacobi(kernels):
    """ν = 0 never runs the smoother, so the Chebyshev cycle equals the
    Jacobi one bit for bit (tests/test_mg_options.py:194-209)."""
    _, tp = _problem()
    r = _t(np.random.default_rng(9).standard_normal((48, 40)))
    zs = [tmg.make_vcycle_preconditioner(
        tp, ft.SolverConfig(mg_smoother=sm, mg_pre_smooth=0, mg_post_smooth=0),
        kernels=kernels)(r) for sm in ("jacobi", "chebyshev4")]
    assert torch.equal(zs[0], zs[1])
