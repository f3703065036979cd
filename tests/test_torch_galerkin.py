"""Galerkin coarse data in the port against the JAX package:

* the banded per-axis triple product (`multigrid._galerkin_axis_bands`)
  equals the reference's dense ``_galerkin_axis_tensor`` entry for entry,
  and stays a few fine nodes wide per coarse node (no dense
  [5, n_c, 3, n_f] tensor, which at 4096² would be ~0.5 GB per axis);
* `multigrid.galerkin_coarse_coeff` against the reference's at 12×10,
  48×40 and 12×10×8, within 1e-6·max|want| (float32 sums in another order),
  and the reference's own checks of it (tests/test_mg_options.py:45-83):
  symmetric, the fold PSD against the exact PᵀAP, radius-1 channels equal
  to the exact product;
* `build_levels` / `build_smoothing_setup` under ``mg_coarse_data=
  "galerkin"`` and the fused operands (9-channel coarse levels, Chebyshev
  schedules) against the reference's, and the dense coarsest inverse of a
  Galerkin level against the exact one."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import field_interpolation_tpu as fi
from field_interpolation_tpu import constraints as jcons
from field_interpolation_tpu import multigrid as jmg
from field_interpolation_tpu import operators as jops

import field_interpolation_tpu_torch as ft
from field_interpolation_tpu_torch import multigrid as tmg
from field_interpolation_tpu_torch.convert import problem_from_numpy


@functools.lru_cache(maxsize=None)
def _problem(shape, n, seed, gradients=True):
    """tests/test_mg_options.py:_problem_2d (any rank) and the port's copy."""
    rng = np.random.default_rng(seed)
    nd = len(shape)
    pos = rng.uniform(0, min(shape) - 1.001, size=(n, nd))
    vals = rng.normal(size=(n,))
    grads = jnp.asarray(rng.normal(size=(n, nd)), jnp.float32) if gradients else None
    jp = jops.assemble(fi.Grid(shape), fi.Weights(model_2=1.0),
                       jnp.asarray(pos, jnp.float32), jnp.asarray(vals, jnp.float32), grads)
    tp = problem_from_numpy(jp.coeff, jp.b, jp.diag, ft.Grid(shape),
                            ft.Weights(model_2=1.0))
    return jp, tp


def _close(got, want, bar=1e-6):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=bar * np.abs(want).max())


@pytest.mark.parametrize("n_c,n_f", [(6, 12), (5, 10), (20, 40), (24, 48), (13, 25),
                                     (64, 128), (4, 5)])
def test_banded_triple_product_is_the_reference_tensor(n_c, n_f):
    start, band = tmg._galerkin_axis_bands(n_c, n_f)
    want = jmg._galerkin_axis_tensor(n_c, n_f)              # [5, n_c, 3, n_f]
    dense = np.zeros_like(want)
    for w in range(band.shape[2]):
        for j in range(n_c):
            dense[:, j, :, start[j] + w] += band[:, :, w, j]
    np.testing.assert_array_equal(dense, want)


def test_banded_triple_product_stays_narrow_at_4096():
    """Config 5's first coarsening: the band is [5, 3, W, 2048] with W ≤ 4
    fine nodes per coarse node, where the dense tensor has 4096."""
    start, band = tmg._galerkin_axis_bands(2048, 4096)
    assert band.shape[:2] == (5, 3) and band.shape[3] == 2048 and band.shape[2] <= 4
    assert start.min() >= 0 and start.max() + band.shape[2] <= 4096


@pytest.mark.parametrize("shape,n", [((12, 10), 150), ((48, 40), 600),
                                     ((12, 10, 8), 300)], ids=str)
def test_galerkin_coeff_matches_reference(shape, n):
    jp, tp = _problem(shape, n, 1, gradients=False)
    coarse = ft.Grid(shape).coarsen().shape
    want = jmg.galerkin_coarse_coeff(jp.coeff, coarse)
    got = tmg.galerkin_coarse_coeff(tp.coeff, coarse)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    _close(got, want)


def _dense_from_stencil(C, shape):
    """[n, n] dense matrix of a [9, n0, n1] channel stencil
    (tests/test_mg_options.py:29-41)."""
    offs = jcons.offset_list(2)
    n0, n1 = shape
    M = np.zeros((n0 * n1, n0 * n1))
    for ci in range(offs.shape[0]):
        o = offs[ci]
        for i0 in range(n0):
            for i1 in range(n1):
                j0, j1 = i0 + o[0], i1 + o[1]
                if 0 <= j0 < n0 and 0 <= j1 < n1:
                    M[i0 * n1 + i1, j0 * n1 + j1] += C[ci, i0, i1]
    return M


def test_galerkin_coeff_is_symmetric_and_dominates_the_exact_product():
    """The reference's test of its own stencil, on the port's: PᵀAP densely
    up to the SPD-safe fold of the |p| = 2 entries (A_fold − PᵀAP ⪰ 0),
    symmetric, radius-1 off-diagonal channels equal to the exact product."""
    _, tp = _problem((12, 10), 150, 1, gradients=False)
    coeff = tp.coeff.double()
    coarse = ft.Grid((12, 10)).coarsen().shape
    A = _dense_from_stencil(coeff.numpy(), (12, 10))
    P = np.kron(tmg._resize_matrix(12, coarse[0]), tmg._resize_matrix(10, coarse[1]))
    exact = P.T @ A @ P
    Cd = _dense_from_stencil(tmg.galerkin_coarse_coeff(coeff, coarse).numpy(), coarse)
    scale = np.abs(exact).max()
    assert np.abs(Cd - Cd.T).max() < 1e-12 * scale
    assert np.linalg.eigvalsh(Cd - exact).min() > -1e-12 * scale
    off = ~np.eye(Cd.shape[0], dtype=bool) & (Cd != 0)
    assert np.abs(Cd - exact)[off].max() < 1e-12 * scale


def test_galerkin_coeff_is_identity_when_no_axis_coarsens():
    _, tp = _problem((12, 10), 80, 2, gradients=False)
    assert torch.equal(tmg.galerkin_coarse_coeff(tp.coeff, (12, 10)), tp.coeff)


@pytest.mark.parametrize("shape,n", [((48, 40), 600), ((24, 24, 24), 400)], ids=str)
def test_galerkin_levels_match_reference(shape, n):
    """Every coarse level carries the Galerkin stencil of the one above, its
    center channel as data_diag; ρ̂_l sums |data_coeff| over the channels."""
    jp, tp = _problem(shape, n, 0)
    cfg_j = fi.SolverConfig(mg_coarse_data="galerkin")
    cfg_t = ft.SolverConfig(mg_coarse_data="galerkin")
    jl, tl = jmg.build_levels(jp, cfg_j), tmg.build_levels(tp, cfg_t)
    assert [l.shape for l in tl] == [l.shape for l in jl] and len(tl) >= 2
    for a, b in zip(tl, jl):
        assert a.data_coeff is not None and tuple(a.data_coeff.shape) == b.data_coeff.shape
        _close(a.data_coeff, b.data_coeff, 1e-5)
        _close(a.data_diag, b.data_diag, 1e-5)
        _close(a.diag, b.diag, 1e-5)
    lump_t, _, taus_t, rhos_t = tmg.build_smoothing_setup(tp, tl, cfg_t)
    lump_j, _, taus_j, rhos_j = jmg.build_smoothing_setup(jp, jl, cfg_j)
    assert lump_t == lump_j
    np.testing.assert_allclose([float(r) for r in rhos_t], [float(r) for r in rhos_j],
                               rtol=1e-5)
    np.testing.assert_allclose([float(t) for t in taus_t], [float(t) for t in taus_j],
                               rtol=1e-5)


def test_galerkin_fused_operands_match_reference():
    """The segment's operands under Galerkin and Chebyshev: 9-channel coarse
    levels, sids = D⁻¹ unscaled, the per-level schedules; the coarsest
    inverse is the exact inverse of the Galerkin coarsest operator."""
    jp, tp = _problem((48, 40), 600, 0)
    change = dict(mg_coarse_data="galerkin", mg_smoother="chebyshev4")
    jc, js, jR, _, _, jcf = jmg.build_fused_solver_operands(jp, fi.SolverConfig(**change))
    tc, ts, tR, tinv, _, tcf = tmg.build_fused_solver_operands(tp, ft.SolverConfig(**change))
    assert [tuple(c.shape) for c in tc] == [c.shape for c in jc]
    assert all(c.ndim == 3 for c in tc)
    for group_t, group_j in [(tc, jc), (ts, js), (tR, jR), (tcf, jcf)]:
        assert len(group_t) == len(group_j)
        for a, b in zip(group_t, group_j):
            assert a.dtype == torch.float32 and a.is_contiguous()
            _close(a, b, 1e-5)
    lvl = tmg.build_levels(tp, ft.SolverConfig(**change))[-1]
    A_c = (tmg._smoothness_dense_matrix(lvl.shape, lvl.weights)
           + _dense_from_stencil(lvl.data_coeff.double().numpy(), lvl.shape))
    _close(tinv, np.linalg.inv(A_c), 1e-5)
    assert torch.equal(tinv, tinv.T)
