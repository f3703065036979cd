"""The port's whole-cycle wrappers against the JAX package.

`ops.cycle.fused_vcycle_2d` / `fused_wcycle_2d` (on CPU tensors: their plain
version `mg_cycle_plain`, the cycle the CUDA kernel computes) run on the
operands the reference's `build_fused_solver_operands` (its
`_fused_vcycle_operands`) made, carried across with
`convert.fused_operands_from_numpy`, and are held against the reference's
Pallas kernels in interpret mode: ``_vc_down_call`` + matvec +
``_vc_up_call`` (its `fused_vcycle_2d`) and `fused_wcycle_2d`. Bar: the
reference's own, atol 3e-5·max|want| (tests/test_mg_options.py:269-271).
A four-level hierarchy, where wdepth 1 and 99 differ, is held against the
reference's XLA W-cycle (the cheaper twin)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import field_interpolation_tpu as fi
from field_interpolation_tpu import multigrid as jmg
from field_interpolation_tpu import operators as jops
from field_interpolation_tpu.ops import pallas_stencil as ps

import field_interpolation_tpu_torch as ft
from field_interpolation_tpu_torch import multigrid as tmg
from field_interpolation_tpu_torch.convert import (fused_operands_from_numpy,
                                                   problem_from_numpy)
from field_interpolation_tpu_torch.ops import cycle
from field_interpolation_tpu_torch.ops.stencil import fused_normal_apply_plain


def _scattered(shape, n=400, seed=14):
    """tests/test_mg_options.py:_problem_2d: scattered values and gradients,
    Weights(model_2=1.0)."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, min(shape) - 1.001, size=(n, 2))
    vals = rng.normal(size=(n,))
    grads = rng.normal(size=(n, 2))
    return jops.assemble(fi.Grid(shape), fi.Weights(model_2=1.0),
                         jnp.asarray(pos, jnp.float32), jnp.asarray(vals, jnp.float32),
                         jnp.asarray(grads, jnp.float32))


def _circle(shape, n=80, seed=0):
    """tests/test_utils_extras.py:test_fused_vcycle_solve_matches_xla's
    oriented circle (a non-square grid), Weights(model_2=0.3)."""
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0, 2 * np.pi, n)
    nrm = np.stack([np.cos(theta), np.sin(theta)], 1)
    pts = np.array([23.5, 31.5]) + 14 * nrm
    return jops.assemble(fi.Grid(shape), fi.Weights(model_2=0.3),
                         jnp.asarray(pts, jnp.float32), jnp.zeros(n, jnp.float32),
                         jnp.asarray(nrm, jnp.float32))


PROBLEMS = {"scattered 48x40": lambda: _scattered((48, 40)),
            "scattered 96x80": lambda: _scattered((96, 80)),
            "circle 48x64": lambda: _circle((48, 64))}


@functools.lru_cache(maxsize=None)
def _operands(problem):
    """The reference's fused-cycle operands of a problem of PROBLEMS, and the
    port's copy of them (made once per module: the tests only read them)."""
    jp = PROBLEMS[problem]()
    ops = jmg.build_fused_solver_operands(jp, fi.SolverConfig())
    coeffs, sids, Rs, inv32, lw, _ = ops
    t_ops = fused_operands_from_numpy(coeffs, sids, Rs, inv32,
                                      [ft.Weights(**vars(w)) for w in lw])
    return ops[:5], t_ops[:5]


def _residual(shape, seed=15):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=3e-5 * np.abs(want).max())


@pytest.mark.parametrize("problem,wdepth,nu", [
    ("scattered 48x40", 0, 3),
    ("scattered 48x40", 1, 2), ("scattered 48x40", 1, 3),
    ("scattered 48x40", 99, 2), ("scattered 48x40", 99, 3),
    ("circle 48x64", 99, 3),
])
def test_wcycle_matches_reference_kernel(problem, wdepth, nu):
    j_ops, t_ops = _operands(problem)
    r = _residual(j_ops[0][0].shape[1:])
    want = ps.fused_wcycle_2d(jnp.asarray(r), *j_ops, nu, interpret=True,
                              wdepth=wdepth)
    got = cycle.fused_wcycle_2d(torch.as_tensor(r), *t_ops, nu, wdepth=wdepth)
    assert got.dtype == torch.float32 and tuple(got.shape) == r.shape
    _close(got, want)


@pytest.mark.parametrize("problem,nu_pre,nu_post", [
    ("scattered 48x40", 2, 3), ("scattered 48x40", 3, 2),
    ("scattered 48x40", 3, 3), ("circle 48x64", 1, 3),
])
def test_vcycle_matches_reference_kernels(problem, nu_pre, nu_post):
    """ν_pre ≠ ν_post: the reference's down call smooths ν_pre times, its up
    call ν_post times; the port's one launch does both."""
    j_ops, t_ops = _operands(problem)
    r = _residual(j_ops[0][0].shape[1:])
    want = ps.fused_vcycle_2d(jnp.asarray(r), *j_ops, nu_pre, nu_post, interpret=True)
    got = cycle.fused_vcycle_2d(torch.as_tensor(r), *t_ops, nu_pre, nu_post)
    _close(got, want)


@pytest.mark.parametrize("wdepth", [0, 99])
def test_fine_residual_matches_reference_kernel(wdepth):
    """z on a standard-normal r is dominated by the coarse correction, so an
    error of the fine level's sweeps or prolongation hides under the bar
    above. On r = A·x the fine residual r - A·z (float64) sees it (it moves
    by a quarter of its size), while the float32 rounding of the coarsest
    solve, which moves z itself by ~4e-4 of max|z| between the two
    packages, moves it by ~4e-6. Same bar."""
    j_ops, t_ops = _operands("circle 48x64")
    coeff64 = t_ops[0][0].double()

    def fine_residual(r, z):
        return r.double() - fused_normal_apply_plain(torch.as_tensor(np.array(z)).double(),
                                                     coeff64, t_ops[4][0], 2)

    x = torch.as_tensor(_residual((48, 64), seed=16))
    r = fused_normal_apply_plain(x, t_ops[0][0], t_ops[4][0], 2)
    want = ps.fused_wcycle_2d(jnp.asarray(r.numpy()), *j_ops, 3, interpret=True,
                              wdepth=wdepth)
    got = cycle.fused_wcycle_2d(r, *t_ops, 3, wdepth=wdepth)
    _close(fine_residual(r, got), fine_residual(r, want))


@pytest.mark.parametrize("wdepth", [0, 1, 2, 99])
def test_four_level_wcycle_matches_reference_xla_cycle(wdepth):
    """96×80 has four levels (96×80 … 12×10), so wdepth 1, 2 and 99 differ;
    the reference's plain XLA cycle with ``mg_wcycle_depth`` is the twin."""
    jp = _scattered((96, 80))
    cfg = fi.SolverConfig(mg_cycle="w" if wdepth else "v", mg_wcycle_depth=max(wdepth, 1))
    assert jmg.resolve_wdepth(cfg, (96, 80)) == wdepth
    j_ops, t_ops = _operands("scattered 96x80")
    assert len(j_ops[0]) == 4
    r = _residual((96, 80))
    want = jmg.make_vcycle_preconditioner(jp, cfg)(jnp.asarray(r))
    got = cycle.fused_wcycle_2d(torch.as_tensor(r), *t_ops, cfg.mg_pre_smooth,
                                wdepth=wdepth)
    _close(got, want)


def test_wcycle_is_symmetric():
    """u·Mv = v·Mu for the plain W-cycle (tests/test_mg_options.py:245-254):
    CG needs a symmetric preconditioner."""
    _, t_ops = _operands("scattered 48x40")
    rng = np.random.default_rng(13)
    u, v = (torch.as_tensor(rng.standard_normal((48, 40)), dtype=torch.float32)
            for _ in range(2))
    uMv = float(torch.sum(u * cycle.fused_wcycle_2d(v, *t_ops, 3)))
    vMu = float(torch.sum(v * cycle.fused_wcycle_2d(u, *t_ops, 3)))
    assert abs(uMv - vMu) < 1e-4 * abs(uMv)


def test_wrappers_refuse_chebyshev_and_negative_counts():
    """A Chebyshev schedule of the wrong shape, type or count raises
    ValueError before any work (on CPU tensors too), as do negative counts."""
    _, t_ops = _operands("scattered 48x40")
    r = torch.as_tensor(_residual((48, 40)))
    L = len(t_ops[0])
    good = [torch.zeros((3, 2)) for _ in range(L)]
    for bad in ([torch.zeros((2, 2))] * L,              # fewer rows than ν = 3
                [torch.zeros((3, 3))] * L,              # not [ν, 2]
                [np.zeros((3, 2), np.float32)] * L,     # not a tensor
                [torch.zeros((3, 2), dtype=torch.float64)] * L,
                good[:L - 2],                           # a level without one
                torch.zeros((3, 2))):                   # not a list
        with pytest.raises(ValueError, match="Chebyshev schedule"):
            cycle.fused_wcycle_2d(r, *t_ops, 3, cheb_coefs=bad)
        with pytest.raises(ValueError, match="Chebyshev schedule"):
            cycle.fused_vcycle_2d(r, *t_ops, 3, 3, cheb_coefs=bad)
    with pytest.raises(ValueError):
        cycle.fused_vcycle_2d(r, *t_ops, -1, 3)


def test_cycle_tables_match_kernel_layout():
    """The host tables have the lengths csrc/mg_cycle2d.cuh:fill_cycle reads
    (6 pointers per level, level 0's r left 0, 6 per transfer, then one
    Chebyshev schedule per level, 0 under Jacobi and on the coarsest level;
    ints L, ν_pre, ν_post, wdepth, then 3 per level; 4 w² per level),
    checked without a card; the operands pass the CUDA wrappers' checks."""
    _, (coeffs, sids, Rs, inv32, lw) = _operands("scattered 48x40")
    L = len(coeffs)
    ptrs, ints, w2s, _ = cycle.cycle_tables(coeffs, sids, Rs, lw, 2, 3, 99,
                                            torch.device("cpu"))
    n_tab = 6 * L + 6 * (L - 1)
    assert len(ptrs) == n_tab + L and ptrs[2] == 0
    assert all(p != 0 for i, p in enumerate(ptrs[:n_tab]) if i != 2)
    assert ptrs[n_tab:] == [0] * L
    cfs = [torch.zeros((3, 2)) for _ in range(L)]
    cheb = cycle.cycle_tables(coeffs, sids, Rs, lw, 2, 3, 99, torch.device("cpu"), cfs)[0]
    assert cheb[n_tab:] == [cf.data_ptr() for cf in cfs[:-1]] + [0]
    assert ints[:4] == [L, 2, 3, 99] and len(ints) == 4 + 3 * L
    assert ints[4:7] == [48, 40, 0]                            # fine: 9 channels
    assert all(ints[4 + 3 * l + 2] == 1 for l in range(1, L))  # coarse: diagonal
    assert len(w2s) == 4 * L and w2s[2] == pytest.approx(1.0)
    cycle.check_cycle_operands("test", torch.device("cpu"), coeffs, sids, Rs, inv32, [])
    with pytest.raises(ValueError):
        cycle.check_cycle_operands("test", torch.device("cpu"), coeffs, sids,
                                   [R.T for R in Rs], inv32, [])


@pytest.mark.parametrize("change,wdepth", [({}, 0), (dict(mg_cycle="w"), 99),
                                           (dict(mg_pre_smooth=2), None)], ids=str)
def test_whole_cycle_operands_are_the_references(change, wdepth):
    """`multigrid.whole_cycle_operands`, what the route hands its kernel:
    the reference's fused-cycle operands and W depth where it plans a
    whole-cycle kernel, None where it smooths level by level (ν_pre ≠
    ν_post). The coarsest inverse is factored in float64 here, in float32
    there."""
    jp = _circle((48, 64))
    tp = problem_from_numpy(jp.coeff, jp.b, jp.diag, ft.Grid((48, 64)),
                            ft.Weights(model_2=0.3))
    got = tmg.whole_cycle_operands(tp, ft.SolverConfig(**change))
    if wdepth is None:
        assert got is None
        return
    (coeffs, sids, Rs, inv32, lw), wd, cfs = got
    assert wd == wdepth == jmg.resolve_wdepth(fi.SolverConfig(**change), (48, 64))
    assert cfs is None
    j_coeffs, j_sids, j_Rs, j_inv32, j_lw, _ = jmg.build_fused_solver_operands(
        jp, fi.SolverConfig(**change))
    assert len(coeffs) == len(j_coeffs) == len(lw) == len(j_lw)
    for t, j in zip(coeffs + sids + Rs, list(j_coeffs) + list(j_sids) + list(j_Rs)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-6 * np.abs(np.asarray(j)).max())
    j_inv = np.asarray(j_inv32)
    np.testing.assert_allclose(inv32.numpy().reshape(j_inv.shape), j_inv, rtol=0,
                               atol=1e-3 * np.abs(j_inv).max())


@pytest.mark.parametrize("change", [dict(mg_fine_operator="lumped"),
                                    dict(mg_fine_operator="lumped", mg_cycle="w")])
def test_lumped_preconditioner_matches_reference_whole_cycle(change):
    """Under ``mg_fine_operator="lumped"`` the reference's whole-cycle route
    smooths with the lumped fine level's τ and the FULL 9-channel stencil
    (its multigrid.py:1027-1029); the port's `make_vcycle_preconditioner`
    with kernels does the same, and equals the reference's interpret-mode
    kernel on the same residual."""
    jp = _circle((48, 64))
    tp = problem_from_numpy(jp.coeff, jp.b, jp.diag, ft.Grid((48, 64)),
                            ft.Weights(model_2=0.3))
    r = _residual((48, 64))
    want = jmg.make_vcycle_preconditioner(jp, fi.SolverConfig(**change),
                                          pallas_smooth=True, pallas_interpret=True)(
        jnp.asarray(r))
    got = tmg.make_vcycle_preconditioner(tp, ft.SolverConfig(**change),
                                         kernels=True)(torch.as_tensor(r))
    _close(got, want)
