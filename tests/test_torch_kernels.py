"""The CUDA kernels against their plain versions, on the card.

Marked ``gpu``: each test skips without a CUDA card. On the GPU host run

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py

(``--noconftest`` because tests/conftest.py configures JAX, which this file
does not use). Bars: the apply within 1e-5·max|plain| and a sweep within
2e-5·max|plain| (float32 sums in another order); the segment and the solves
within ±2 iterations and 2e-3·max|x| (tests/test_solver.py:191-195), the
batched ones lane by lane; the whole-cycle kernel within 3e-5·max|plain|
(tests/test_mg_options.py:269-271)."""

import math

import numpy as np
import pytest
import torch

import field_interpolation_tpu_torch as ft
from field_interpolation_tpu_torch import multigrid as tmg
from field_interpolation_tpu_torch.ops.cycle import (fused_vcycle_2d, fused_wcycle_2d,
                                                     mg_cycle_plain)
from field_interpolation_tpu_torch.ops.pcg import (LANE_GEOMETRIES, fused_pcg_solve,
                                                   fused_pcg_solve_plain)
from field_interpolation_tpu_torch.ops.smooth import (fused_smooth, fused_smooth_2d,
                                                      fused_smooth_plain, fused_sweep,
                                                      multisweep_max_halo)
from field_interpolation_tpu_torch.ops.stencil import (fused_normal_apply,
                                                       fused_normal_apply_plain)
from field_interpolation_tpu_torch.ops.stencil_ext import (
    MODES, ExtLevel, fused_normal_apply_ext, fused_normal_apply_ext_plain,
    fused_normal_apply_ext_slabs_plain, fused_normal_apply_ext_striped,
    fused_normal_apply_ext_striped_plain)

pytestmark = pytest.mark.gpu

ORDER_WEIGHTS = [
    dict(model_0=0.3, model_2=0.0),
    dict(model_1=0.7, model_2=0.0),
    dict(model_2=1.0),
    dict(model_3=0.5, model_2=0.0),
    dict(model_0=0.1, model_1=0.2, model_2=1.0, model_3=0.4),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc to build the kernels)")
    return torch.device("cuda", 0)


def _problem(shape, device, n=100, seed=0, weights=dict(model_2=0.3)):
    rng = np.random.default_rng(seed)
    if len(shape) == 2:
        theta = rng.uniform(0, 2 * np.pi, n)
        nrm = np.stack([np.cos(theta), np.sin(theta)], 1).astype(np.float32)
    else:  # points on a sphere (bench.py config 4)
        nrm = rng.standard_normal((n, 3))
        nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(np.float32)
    pts = ((np.asarray(shape) - 1) / 2.0 + 0.3 * min(shape) * nrm).astype(np.float32)
    return ft.assemble_sdf(ft.Grid(shape), ft.Weights(**weights),
                           torch.as_tensor(pts, device=device),
                           torch.as_tensor(nrm, device=device))


@pytest.mark.parametrize("shape", [(256, 256), (40, 48), (40, 3), (33, 17)])
@pytest.mark.parametrize("weights_kw", ORDER_WEIGHTS)
@pytest.mark.parametrize("diag", [False, True])
def test_apply_kernel_matches_plain(cuda, shape, weights_kw, diag):
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.standard_normal(shape).astype(np.float32), device=cuda)
    w = ft.Weights(**weights_kw)
    if diag:
        coeff = torch.as_tensor(rng.uniform(0, 2, shape).astype(np.float32), device=cuda)
    else:
        coeff = _problem(shape, cuda, weights=weights_kw).coeff
    before = fused_normal_apply.launches
    got = fused_normal_apply(x, coeff, w, 2)
    want = fused_normal_apply_plain(x, coeff, w, 2)
    torch.cuda.synchronize()
    assert fused_normal_apply.launches == before + 1
    err = float((got - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max()), err


@pytest.mark.parametrize("shape", [(64, 64), (256, 256), (40, 48)])
def test_segment_kernel_matches_plain(cuda, shape):
    problem = _problem(shape, cuda)
    coeffs, sids, Rs, inv32, lw, _ = tmg.build_fused_solver_operands(
        problem, ft.SolverConfig())
    b = problem.b
    tol2 = (1e-4 ** 2 * torch.sum(b * b)).reshape(1, 1)
    budget = torch.full((1, 1), 2000, dtype=torch.int32, device=cuda)
    args = (torch.zeros_like(b), b, tol2, budget, coeffs, sids, Rs, inv32, lw, 3)
    before = fused_pcg_solve.launches
    xk, ik, rrk = fused_pcg_solve(*args)
    xp, ip, rrp = fused_pcg_solve_plain(*args)
    torch.cuda.synchronize()
    assert fused_pcg_solve.launches == before + 1
    assert abs(int(ik) - int(ip)) <= 2
    assert float(rrk) <= float(tol2)
    scale = float(xp.abs().max())
    assert float((xk - xp).abs().max()) <= 2e-3 * scale


def test_segment_kernel_is_deterministic(cuda):
    problem = _problem((64, 64), cuda)
    coeffs, sids, Rs, inv32, lw, _ = tmg.build_fused_solver_operands(
        problem, ft.SolverConfig())
    b = problem.b
    tol2 = (1e-6 ** 2 * torch.sum(b * b)).reshape(1, 1)
    budget = torch.full((1, 1), 2000, dtype=torch.int32, device=cuda)
    runs = [fused_pcg_solve(torch.zeros_like(b), b, tol2, budget, coeffs, sids, Rs,
                            inv32, lw, 3) for _ in range(3)]
    for x, it, rr in runs[1:]:
        assert torch.equal(x, runs[0][0]) and int(it) == int(runs[0][1])


def test_precise_sdf_on_card_matches_cpu(cuda):
    shape = (64, 64)
    rng = np.random.default_rng(2)
    theta = rng.uniform(0, 2 * np.pi, 100)
    nrm = np.stack([np.cos(theta), np.sin(theta)], 1).astype(np.float32)
    pts = (31.5 + 20.0 * nrm + 0.2 * rng.standard_normal((100, 2))).astype(np.float32)
    args = (ft.Grid(shape), ft.Weights(model_2=0.3))
    cfg = ft.SolverConfig(tol=1e-6)
    xg, ig = ft.sdf_from_points_precise(*args, torch.as_tensor(pts, device=cuda),
                                        torch.as_tensor(nrm, device=cuda), config=cfg)
    xc, ic = ft.sdf_from_points_precise(*args, torch.as_tensor(pts),
                                        torch.as_tensor(nrm), config=cfg)
    assert bool(ig.converged) and float(ig.rel_residual) <= 1e-6
    assert abs(int(ig.iterations) - int(ic.iterations)) <= 2
    scale = float(xc.abs().max())
    assert float((xg.cpu() - xc).abs().max()) <= 2e-3 * scale


@pytest.mark.parametrize("shape", [(128, 128, 128), (32, 32, 32), (9, 5, 7), (40, 3, 17)])
@pytest.mark.parametrize("weights_kw", ORDER_WEIGHTS)
@pytest.mark.parametrize("diag", [False, True])
def test_apply_kernel_3d_matches_plain(cuda, shape, weights_kw, diag):
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.standard_normal(shape).astype(np.float32), device=cuda)
    w = ft.Weights(**weights_kw)
    if diag:
        coeff = torch.as_tensor(rng.uniform(0, 2, shape).astype(np.float32), device=cuda)
    else:
        coeff = _problem(shape, cuda, n=400, weights=weights_kw).coeff
    before = fused_normal_apply.launches
    got = fused_normal_apply(x, coeff, w, 3)
    want = fused_normal_apply_plain(x, coeff, w, 3)
    torch.cuda.synchronize()
    assert fused_normal_apply.launches == before + 1
    err = float((got - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max()), err


def _sweep_operands(shape, cuda, diag, weights_kw=dict(model_1=0.2, model_2=1.0)):
    problem = _problem(shape, cuda, n=200, weights=weights_kw)
    rng = np.random.default_rng(3)
    r, z = (torch.as_tensor(rng.standard_normal(shape).astype(np.float32), device=cuda)
            for _ in range(2))
    coeff = problem.coeff[(3 ** len(shape)) // 2].contiguous() if diag else problem.coeff
    sid = (0.3 / problem.diag).contiguous()
    return r, z, coeff, sid, ft.Weights(**weights_kw)


def _phase_launches(sweeps, from_zero, residual, cheb=False):
    """Kernel launches of one fused_smooth call: one per sweep that reads
    neighbours (the from-zero step rides on the next launch), one for the
    residual; a from-zero step alone is one launch, its residual included."""
    if cheb and from_zero and sweeps == 0:
        return 0
    steps = (max(sweeps, 1) - 1 if not cheb else sweeps - 1) if from_zero else sweeps
    if from_zero and steps == 0:
        return 1
    return steps + residual


def _check_phase(got, want, residual):
    """z within 2e-5·max|z|, the residual within 2e-5·max|r − A z|."""
    torch.cuda.synchronize()
    for g, w in zip(got, want) if residual else [(got, want)]:
        err = float((g - w).abs().max())
        assert bool(torch.isfinite(g).all()) and err <= 2e-5 * float(w.abs().max()), err


@pytest.mark.parametrize("shape", [(64, 48), (24, 20, 18), (37, 5, 70)])
@pytest.mark.parametrize("diag", [False, True])
@pytest.mark.parametrize("from_zero", [False, True])
@pytest.mark.parametrize("sweeps", [0, 1, 2, 3])
@pytest.mark.parametrize("residual", [False, True])
def test_sweep_kernel_matches_plain(cuda, shape, diag, from_zero, sweeps, residual):
    """One call per smoothing phase: the sweeps and, with ``residual``,
    r − A z, against the plain version; tiles cut at odd extents."""
    r, z, coeff, sid, w = _sweep_operands(shape, cuda, diag)
    nd = len(shape)
    before = fused_smooth.launches
    got = fused_smooth(r, z, coeff, sid, w, nd, sweeps, from_zero, residual=residual)
    want = fused_smooth_plain(r, z, coeff, sid, w, nd, sweeps, from_zero, residual=residual)
    assert fused_smooth.launches == before + _phase_launches(sweeps, from_zero, residual)
    _check_phase(got, want, residual)


@pytest.mark.parametrize("weights_kw", [dict(model_1=0.2, model_2=1.0),
                                        dict(model_2=0.5, model_3=0.8)])
@pytest.mark.parametrize("residual", [False, True])
def test_single_sweep_kernel_matches_plain(cuda, weights_kw, residual):
    r, z, cdiag, sid, w = _sweep_operands((128, 128, 128), cuda, True, weights_kw)
    before = fused_smooth.launches
    got = fused_sweep(r, z, cdiag, sid, w, residual=residual)
    want = fused_smooth_plain(r, z, cdiag, sid, w, 3, 1, residual=residual)
    assert fused_smooth.launches == before + 1 + residual
    _check_phase(got, want, residual)


def _solve_both(cuda, shape, fn, n=300, **cfg):
    """The same cloud solved on the card and on the CPU."""
    rng = np.random.default_rng(2)
    u = rng.standard_normal((n, len(shape)))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    pts = ((np.asarray(shape) - 1) / 2.0 + 0.3 * min(shape) * u).astype(np.float32)
    nrm = u.astype(np.float32)
    args = (ft.Grid(shape), ft.Weights(model_2=0.3))
    config = ft.SolverConfig(**cfg)
    xg, ig = fn(*args, torch.as_tensor(pts, device=cuda),
                torch.as_tensor(nrm, device=cuda), config=config)
    xc, ic = fn(*args, torch.as_tensor(pts), torch.as_tensor(nrm), config=config)
    assert bool(ig.converged) and bool(ic.converged)
    assert abs(int(ig.iterations) - int(ic.iterations)) <= 2
    scale = float(xc.abs().max())
    assert float((xg.cpu() - xc).abs().max()) <= 2e-3 * scale
    return ig


@pytest.mark.parametrize("change", [dict(), dict(mg_fine_operator="lumped", mg_cycle="w")])
def test_3d_solve_on_card_matches_cpu(cuda, change):
    before = (fused_normal_apply.launches, fused_smooth.launches)
    _solve_both(cuda, (24, 24, 24), ft.sdf_from_points, tol=1e-4, **change)
    assert fused_normal_apply.launches > before[0]
    assert fused_smooth.launches > before[1]


def test_odd_3d_size_runs_through_the_kernels(cuda):
    """129³: odd extents, so the reference's rules name no apply kernel and
    no fine-level sweep kernel (it runs XLA there); the port launches its
    kernels at that size and matches its own plain solve (backend="xla")."""
    shape = (129, 129, 129)
    rng = np.random.default_rng(4)
    u = rng.standard_normal((4000, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    pts = torch.as_tensor(64.0 + 40.0 * u, dtype=torch.float32, device=cuda)
    nrm = torch.as_tensor(u, dtype=torch.float32, device=cuda)
    args = (ft.Grid(shape), ft.Weights(model_2=0.3), pts, nrm)
    before = (fused_normal_apply.launches, fused_smooth.launches)
    x, info = ft.sdf_from_points(*args, config=ft.SolverConfig(tol=1e-4))
    assert fused_normal_apply.launches > before[0]
    assert fused_smooth.launches > before[1]
    xr, ir = ft.sdf_from_points(*args, config=ft.SolverConfig(tol=1e-4, backend="xla"))
    assert bool(info.converged) and bool(ir.converged)
    assert abs(int(info.iterations) - int(ir.iterations)) <= 2
    assert float((x - xr).abs().max()) <= 2e-3 * float(xr.abs().max())


def test_3d_precise_solve_on_card_matches_cpu(cuda):
    info = _solve_both(cuda, (24, 24, 24), ft.sdf_from_points_precise, tol=1e-6)
    assert float(info.rel_residual) <= 1e-6


@pytest.mark.parametrize("change", [dict(mg_pre_smooth=2),
                                    dict(mg_coarse_solver="jacobi")])
def test_smooth_kernel_configs_run_on_card(cuda, change):
    """2-D configurations off the fused PCG path whose every smoothing call
    is the reference's fused_smooth: they run on the card and match CPU."""
    before = fused_smooth.launches
    _solve_both(cuda, (64, 64), ft.sdf_from_points, n=100, tol=1e-4, **change)
    assert fused_smooth.launches > before


@pytest.mark.parametrize("shape,change,counter", [
    ((64, 64), dict(mg_smoother="chebyshev"), fused_pcg_solve),
    ((64, 64), dict(mg_smoother="chebyshev4", mg_coarse_data="galerkin"), fused_pcg_solve),
    ((64, 64), dict(mg_smoother="chebyshev4", mg_pre_smooth=2), fused_smooth_2d),
    ((64, 64), dict(mg_coarse_data="galerkin", mg_fine_operator="lumped"), fused_vcycle_2d),
    ((24, 24, 24), dict(mg_smoother="chebyshev"), fused_smooth),
    ((24, 24, 24), dict(mg_smoother="chebyshev4", mg_coarse_data="galerkin"), fused_smooth),
], ids=["64-cheb", "64-cheb4-galerkin", "64-cheb4-levels", "64-galerkin-lumped",
        "24-cheb", "24-cheb4-galerkin"])
def test_unported_cuda_configs_raise(cuda, shape, change, counter):
    """The Chebyshev and Galerkin configurations, once refused on the card,
    launch their kernels (the segment, the multi-sweep or per-sweep
    smoother, the whole cycle) and match the same solve on CPU tensors."""
    problem = _problem(shape, cuda)
    cfg = ft.SolverConfig(tol=1e-4, **change)
    before = counter.launches
    x, info = ft.solve(problem, cfg)
    torch.cuda.synchronize()
    assert counter.launches > before
    cpu = ft.Problem(coeff=problem.coeff.cpu(), b=problem.b.cpu(), diag=problem.diag.cpu(),
                     grid=problem.grid, weights=problem.weights)
    xc, ic = ft.solve(cpu, cfg)
    assert bool(info.converged) and bool(ic.converged)
    assert abs(int(info.iterations) - int(ic.iterations)) <= 2
    assert float((x.cpu() - xc).abs().max()) <= 2e-3 * float(xc.abs().max())


@pytest.mark.parametrize("shape,n,change,counter", [
    ((64, 64), 100, dict(mg_cycle="w"), fused_pcg_solve),     # W inside the segment
    ((440, 440), 2000, dict(), fused_wcycle_2d),             # whole W-cycle past the gate
    ((64, 64), 100, dict(mg_fine_operator="lumped"), fused_vcycle_2d),
], ids=["64-w", "440", "64-lumped"])
def test_whole_cycle_configs_solve_on_card(cuda, shape, n, change, counter):
    """The configurations the reference runs through its whole-cycle kernels
    or the W-cycle segment: on the card they launch the port's kernel and
    match the same solve on CPU tensors (the plain versions)."""
    problem = _problem(shape, cuda, n=n)
    cfg = ft.SolverConfig(tol=1e-4, **change)
    before = counter.launches
    x, info = ft.solve(problem, cfg)
    torch.cuda.synchronize()
    assert counter.launches > before
    cpu = ft.Problem(coeff=problem.coeff.cpu(), b=problem.b.cpu(), diag=problem.diag.cpu(),
                     grid=problem.grid, weights=problem.weights)
    xc, ic = ft.solve(cpu, cfg)
    assert bool(info.converged) and bool(ic.converged)
    assert abs(int(info.iterations) - int(ic.iterations)) <= 2
    assert float((x.cpu() - xc).abs().max()) <= 2e-3 * float(xc.abs().max())


def test_fmg_guess_in_the_whole_cycle_band_runs(cuda):
    """880²: ``fmg_start=1`` first solves the same cloud on 440², where the
    reference runs fused_wcycle_2d; the port launches its whole-cycle
    kernel there and the call matches the same call under backend="xla"."""
    rng = np.random.default_rng(4)
    theta = rng.uniform(0, 2 * np.pi, 2000)
    u = np.stack([np.cos(theta), np.sin(theta)], 1)
    args = (ft.Grid((880, 880)), ft.Weights(model_2=0.3),
            torch.as_tensor(439.5 + 264.0 * u, dtype=torch.float32, device=cuda),
            torch.as_tensor(u, dtype=torch.float32, device=cuda))
    before = fused_wcycle_2d.launches
    x, info = ft.sdf_from_points(*args, config=ft.SolverConfig(tol=1e-4), fmg_start=1)
    torch.cuda.synchronize()
    assert fused_wcycle_2d.launches > before
    xr, ir = ft.sdf_from_points(*args, config=ft.SolverConfig(tol=1e-4, backend="xla"),
                                fmg_start=1)
    assert bool(info.converged) and bool(ir.converged)
    assert abs(int(info.iterations) - int(ir.iterations)) <= 2
    assert float((x - xr).abs().max()) <= 2e-3 * float(xr.abs().max())


def _cycle_operands(shape, cuda):
    problem = _problem(shape, cuda, n=300)
    coeffs, sids, Rs, inv32, lw, _ = tmg.build_fused_solver_operands(
        problem, ft.SolverConfig())
    return (coeffs, sids, Rs, inv32, lw), problem


@pytest.mark.parametrize("shape", [(45, 61), (97, 130)])
@pytest.mark.parametrize("wdepth,nu_pre,nu_post", [
    (0, 1, 1), (0, 2, 3), (0, 3, 3), (1, 1, 1), (1, 3, 3), (99, 1, 1), (99, 2, 2),
    (99, 3, 3)])
def test_cycle_kernel_matches_plain(cuda, shape, wdepth, nu_pre, nu_post):
    """Odd, non-square grids (three and four levels, so wdepth 1 and 99
    differ at 97×130); V with ν_pre ≠ ν_post through fused_vcycle_2d. z on
    a standard-normal r is dominated by the coarse correction, so the fine
    residual r - A·z (float64) on r = A·x is held to the same bar: an error
    of the fine level's sweeps or prolongation moves it by a quarter of its
    size, the float32 rounding of the coarsest solve (~1% of z there) by
    ~1e-5."""
    ops, _ = _cycle_operands(shape, cuda)
    rng = np.random.default_rng(7)
    x, r = (torch.as_tensor(rng.standard_normal(shape).astype(np.float32), device=cuda)
            for _ in range(2))
    r_ax = fused_normal_apply_plain(x, ops[0][0], ops[4][0], 2)

    def fine_residual(z):
        return r_ax.double() - fused_normal_apply_plain(z.double(), ops[0][0].double(),
                                                        ops[4][0], 2)

    counter = fused_wcycle_2d if wdepth else fused_vcycle_2d
    for rhs, seen in ((r, lambda z: z), (r_ax, fine_residual)):
        before = counter.launches
        if wdepth:
            got = fused_wcycle_2d(rhs, *ops, nu_pre, wdepth=wdepth)
        else:
            got = fused_vcycle_2d(rhs, *ops, nu_pre, nu_post)
        want = mg_cycle_plain(rhs, *ops, nu_pre, nu_post, wdepth)
        torch.cuda.synchronize()
        assert counter.launches == before + 1
        got, want = seen(got), seen(want)
        err = float((got - want).abs().max())
        assert err <= 3e-5 * float(want.abs().max()), err


def _float64(ops):
    coeffs, sids, Rs, inv32, lw = ops
    return ([c.double() for c in coeffs], [s.double() for s in sids],
            [R.double() for R in Rs], inv32.double(), lw)


@pytest.mark.parametrize("shape", [(45, 61), (97, 130)])
@pytest.mark.parametrize("nu_pre", [1, 3])
def test_cycle_kernel_without_post_smoothing_near_float64(cuda, shape, nu_pre):
    """A V-cycle with ν_post = 0 ends in the prolongation, so nothing smooths
    the float32 rounding of the coarse levels out of the fine residual: at
    97×130, ν_pre = 3, plain float32 itself sits ~3.1e-5·max from the
    float64 cycle (tests/test_torch_cycle_float64.py). So the kernel's fine
    residual on r = A·x is held to the float64 cycle's (float64 operands):
    within 3e-5·max, or within twice plain float32's own distance where
    that is larger; z on a standard-normal r within 3e-5·max|plain| of the
    plain float32 cycle."""
    ops, _ = _cycle_operands(shape, cuda)
    ops64 = _float64(ops)
    rng = np.random.default_rng(7)
    x, r = (torch.as_tensor(rng.standard_normal(shape).astype(np.float32), device=cuda)
            for _ in range(2))
    r_ax = fused_normal_apply_plain(x, ops[0][0], ops[4][0], 2)

    def fine_residual(z):
        return r_ax.double() - fused_normal_apply_plain(z.double(), ops64[0][0], ops[4][0], 2)

    want = fine_residual(mg_cycle_plain(r_ax.double(), *ops64, nu_pre, 0, 0))
    plain = fine_residual(mg_cycle_plain(r_ax, *ops, nu_pre, 0, 0))
    got = fine_residual(fused_vcycle_2d(r_ax, *ops, nu_pre, 0))
    scale = float(want.abs().max())
    gap = float((plain - want).abs().max())
    err = float((got - want).abs().max())
    assert err <= max(3e-5 * scale, 2 * gap), (err / scale, gap / scale)
    z, zp = fused_vcycle_2d(r, *ops, nu_pre, 0), mg_cycle_plain(r, *ops, nu_pre, 0, 0)
    assert float((z - zp).abs().max()) <= 3e-5 * float(zp.abs().max())


def test_cycle_kernel_is_symmetric_and_deterministic(cuda):
    ops, _ = _cycle_operands((97, 130), cuda)
    rng = np.random.default_rng(8)
    u, v = (torch.as_tensor(rng.standard_normal((97, 130)).astype(np.float32), device=cuda)
            for _ in range(2))
    Mv = fused_wcycle_2d(v, *ops, 3)
    uMv = float(torch.sum(u * Mv))
    vMu = float(torch.sum(v * fused_wcycle_2d(u, *ops, 3)))
    assert abs(uMv - vMu) < 1e-4 * abs(uMv)
    assert torch.equal(fused_wcycle_2d(v, *ops, 3), Mv)


def test_segment_wcycle_matches_plain(cuda):
    problem = _problem((97, 130), cuda, n=300)
    coeffs, sids, Rs, inv32, lw, _ = tmg.build_fused_solver_operands(
        problem, ft.SolverConfig())
    b = problem.b
    tol2 = (1e-4 ** 2 * torch.sum(b * b)).reshape(1, 1)
    budget = torch.full((1, 1), 2000, dtype=torch.int32, device=cuda)
    args = (torch.zeros_like(b), b, tol2, budget, coeffs, sids, Rs, inv32, lw, 3)
    xk, ik, rrk = fused_pcg_solve(*args, wdepth=99)
    xp, ip, _ = fused_pcg_solve_plain(*args, wdepth=99)
    torch.cuda.synchronize()
    assert abs(int(ik) - int(ip)) <= 2 and float(rrk) <= float(tol2)
    assert float((xk - xp).abs().max()) <= 2e-3 * float(xp.abs().max())


def test_large_2d_solve_runs_through_the_smoothing_kernels(cuda):
    """1024²: the reference smooths its fine level with fused_smooth_striped
    and its 512² level with fused_smooth; the port launches the multi-sweep
    and per-sweep kernels and matches its plain solve (backend="xla").
    100 points leave a 1024² float32 solve stuck near 3e-4 (plain ops on
    CPU too); 2000 points on its circle converge."""
    problem = _problem((1024, 1024), cuda, n=2000)
    before = (fused_smooth_2d.launches, fused_smooth.launches,
              fused_normal_apply.launches, fused_pcg_solve.launches)
    x, info = ft.solve(problem, ft.SolverConfig(tol=1e-4))
    after = (fused_smooth_2d.launches, fused_smooth.launches,
             fused_normal_apply.launches, fused_pcg_solve.launches)
    assert all(a > b for a, b in zip(after[:3], before[:3]))
    assert after[3] == before[3]
    xr, ir = ft.solve(problem, ft.SolverConfig(tol=1e-4, backend="xla"))
    assert bool(info.converged) and bool(ir.converged)
    assert abs(int(info.iterations) - int(ir.iterations)) <= 2
    assert float((x - xr).abs().max()) <= 2e-3 * float(xr.abs().max())


MULTISWEEP_WEIGHTS = {1: dict(model_0=0.1, model_1=0.7, model_2=0.0),
                      2: dict(model_1=0.2, model_2=1.0),
                      3: dict(model_2=0.5, model_3=0.8)}  # by operator radius


def _multisweep_launches(sweeps, from_zero, residual, radius, cheb=False):
    """Kernel launches of one fused_smooth_2d call (Jacobi from zero counts
    its from-zero step as a sweep): the neighbour-reading stages (sweeps,
    then the residual) split into launches of at most max_halo // ρ; a
    from-zero step alone is one launch. With no sweep to run (0 sweeps from
    z without the residual, or 0 Chebyshev sweeps from zero) the wrapper
    answers without a launch."""
    if sweeps == 0 and ((cheb and from_zero) or not (from_zero or residual)):
        return 0
    stages = sweeps - (1 if from_zero else 0) + (1 if residual else 0)
    return max(1, math.ceil(stages / (multisweep_max_halo() // radius)))


def _check_multisweep(r, z, coeff, sid, w, sweeps, from_zero, residual, radius, cf=None):
    """One fused_smooth_2d call against the plain version: the launches it
    makes, z within 2e-5·max|z| and the residual within 2e-5·max|r − A z|."""
    before = fused_smooth_2d.launches
    got = fused_smooth_2d(r, z, coeff, sid, w, sweeps, from_zero, cheb_coefs=cf,
                          residual=residual)
    want = fused_smooth_plain(r, z, coeff, sid, w, 2, sweeps, from_zero, cheb_coefs=cf,
                              residual=residual)
    assert fused_smooth_2d.launches == before + _multisweep_launches(
        sweeps, from_zero, residual, radius, cf is not None)
    _check_phase(got, want, residual)


@pytest.mark.parametrize("shape", [(100, 130), (37, 201), (5, 7)])
@pytest.mark.parametrize("radius", [1, 2, 3])
@pytest.mark.parametrize("sweeps", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("from_zero", [False, True])
@pytest.mark.parametrize("residual", [False, True])
def test_multisweep_kernel_matches_plain(cuda, shape, radius, sweeps, from_zero, residual):
    """Odd sizes that cut into several strips and row segments, one that is
    smaller than a strip, and phases that need more than one launch
    (stages·ρ > 8, the residual a stage); with ``residual`` the call also
    returns r − A z (from z with 0 sweeps: a launch with the residual stage
    alone)."""
    r, z, coeff, sid, w = _sweep_operands(shape, cuda, False, MULTISWEEP_WEIGHTS[radius])
    _check_multisweep(r, z, coeff, sid, w, sweeps, from_zero, residual, radius)


@pytest.mark.parametrize("shape,radius", [((4096, 4096), 2), ((2048, 2048), 2),
                                          ((992, 992), 2), ((1000, 1030), 3)])
@pytest.mark.parametrize("kind", ["jacobi", "chebyshev4"])
@pytest.mark.parametrize("from_zero", [False, True])
def test_multisweep_phase_at_main_path_sizes(cuda, shape, radius, kind, from_zero):
    """The cycle's 9-channel phases at the main paths' sizes (config 5's
    4096² fine level and 2048² fmg grid, field C's 992², a ragged 1000×1030
    with radius-3 weights whose phase from z takes two launches): ν = 3
    with the residual, and without it, against the plain version, with the
    launches each call makes."""
    weights = dict(model_2=0.3) if radius == 2 else MULTISWEEP_WEIGHTS[3]
    r, z, coeff, sid, w = _sweep_operands(shape, cuda, False, weights)
    cf = None
    if kind != "jacobi":
        cf, sid = _schedule(3, kind, device=cuda), sid / 0.3
    for residual in (True, False):
        _check_multisweep(r, z, coeff, sid, w, 3, from_zero, residual, radius, cf)


def _schedule(sweeps, kind="chebyshev4", rho=2.3, device=None):
    """A [ν, 2] Chebyshev schedule (multigrid.chebyshev_coefs) on the card."""
    return tmg.chebyshev_coefs(torch.tensor(rho, device=device), sweeps,
                               ft.SolverConfig(mg_smoother=kind))


@pytest.mark.parametrize("shape", [(64, 48), (24, 20, 18)])
@pytest.mark.parametrize("diag", [False, True])
@pytest.mark.parametrize("from_zero", [False, True])
@pytest.mark.parametrize("sweeps,kind", [(0, "chebyshev4"), (1, "chebyshev4"),
                                         (3, "chebyshev4"), (4, "chebyshev")])
@pytest.mark.parametrize("residual", [False, True])
def test_sweep_kernel_chebyshev_matches_plain(cuda, shape, diag, from_zero, sweeps, kind,
                                              residual):
    """The per-sweep kernel's Chebyshev mode, one call per phase, z⁺
    written over z_prev's buffer from the third sweep on, z_prev of the
    sweep after the from-zero step recomputed at the node."""
    r, z, coeff, sid, w = _sweep_operands(shape, cuda, diag)
    cf = _schedule(sweeps, kind, device=cuda)
    nd = len(shape)
    before = fused_smooth.launches
    got = fused_smooth(r, z, coeff, sid, w, nd, sweeps, from_zero, cheb_coefs=cf,
                       residual=residual)
    want = fused_smooth_plain(r, z, coeff, sid, w, nd, sweeps, from_zero, cheb_coefs=cf,
                              residual=residual)
    assert fused_smooth.launches == before + _phase_launches(sweeps, from_zero, residual,
                                                             cheb=True)
    _check_phase(got, want, residual)


@pytest.mark.parametrize("shape", [(100, 130), (37, 201), (5, 7)])
@pytest.mark.parametrize("radius", [1, 2, 3])
@pytest.mark.parametrize("sweeps", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("from_zero", [False, True])
@pytest.mark.parametrize("residual", [False, True])
def test_multisweep_kernel_chebyshev_matches_plain(cuda, shape, radius, sweeps, from_zero,
                                                   residual):
    """The multi-sweep kernel's Chebyshev mode at odd sizes; where the halo
    splits a phase into several launches (stages·ρ > 8), each launch hands
    the next its z and z_prev and the schedule row; z_prev of the sweep
    after the from-zero step is zero, of a later one the z two stages back."""
    r, z, coeff, sid, w = _sweep_operands(shape, cuda, False, MULTISWEEP_WEIGHTS[radius])
    cf = _schedule(sweeps, device=cuda)
    _check_multisweep(r, z, coeff, sid, w, sweeps, from_zero, residual, radius, cf)


def _cheb_cycle_operands(shape, cuda, change):
    problem = _problem(shape, cuda, n=300)
    coeffs, sids, Rs, inv32, lw, cfs = tmg.build_fused_solver_operands(
        problem, ft.SolverConfig(**change))
    assert cfs is not None
    return (coeffs, sids, Rs, inv32, lw), cfs


@pytest.mark.parametrize("shape", [(45, 61), (97, 130)])
@pytest.mark.parametrize("change", [dict(mg_smoother="chebyshev4"),
                                    dict(mg_smoother="chebyshev"),
                                    dict(mg_smoother="chebyshev4", mg_coarse_data="galerkin")],
                         ids=["cheb4", "cheb", "cheb4-galerkin"])
@pytest.mark.parametrize("wdepth,nu_pre,nu_post", [(0, 3, 3), (0, 2, 3), (1, 3, 3),
                                                   (99, 1, 1), (99, 3, 3)])
def test_cycle_kernel_chebyshev_matches_plain(cuda, shape, change, wdepth, nu_pre, nu_post):
    """The cycle kernel's Chebyshev mode, as test_cycle_kernel_matches_plain:
    z on a standard-normal r and the float64 fine residual on r = A·x."""
    ops, cfs = _cheb_cycle_operands(shape, cuda, dict(change, mg_pre_smooth=3,
                                                      mg_post_smooth=3))
    rng = np.random.default_rng(7)
    x, r = (torch.as_tensor(rng.standard_normal(shape).astype(np.float32), device=cuda)
            for _ in range(2))
    r_ax = fused_normal_apply_plain(x, ops[0][0], ops[4][0], 2)

    def fine_residual(z):
        return r_ax.double() - fused_normal_apply_plain(z.double(), ops[0][0].double(),
                                                        ops[4][0], 2)

    counter = fused_wcycle_2d if wdepth else fused_vcycle_2d
    for rhs, seen in ((r, lambda z: z), (r_ax, fine_residual)):
        before = counter.launches
        if wdepth:
            got = fused_wcycle_2d(rhs, *ops, nu_pre, cheb_coefs=cfs, wdepth=wdepth)
        else:
            got = fused_vcycle_2d(rhs, *ops, nu_pre, nu_post, cheb_coefs=cfs)
        want = mg_cycle_plain(rhs, *ops, nu_pre, nu_post, wdepth, cheb_coefs=cfs)
        torch.cuda.synchronize()
        assert counter.launches == before + 1
        got, want = seen(got), seen(want)
        err = float((got - want).abs().max())
        assert err <= 3e-5 * float(want.abs().max()), err


@pytest.mark.parametrize("change", [dict(mg_smoother="chebyshev4"),
                                    dict(mg_smoother="chebyshev4", mg_coarse_data="galerkin"),
                                    dict(mg_coarse_data="galerkin")], ids=str)
@pytest.mark.parametrize("wdepth", [0, 99])
def test_segment_chebyshev_galerkin_matches_plain(cuda, change, wdepth):
    problem = _problem((97, 130), cuda, n=300)
    coeffs, sids, Rs, inv32, lw, cfs = tmg.build_fused_solver_operands(
        problem, ft.SolverConfig(**change))
    b = problem.b
    tol2 = (1e-4 ** 2 * torch.sum(b * b)).reshape(1, 1)
    budget = torch.full((1, 1), 2000, dtype=torch.int32, device=cuda)
    args = (torch.zeros_like(b), b, tol2, budget, coeffs, sids, Rs, inv32, lw, 3)
    before = fused_pcg_solve.launches
    xk, ik, rrk = fused_pcg_solve(*args, cheb_coefs=cfs, wdepth=wdepth)
    xp, ip, _ = fused_pcg_solve_plain(*args, cheb_coefs=cfs, wdepth=wdepth)
    torch.cuda.synchronize()
    assert fused_pcg_solve.launches == before + 1
    assert abs(int(ik) - int(ip)) <= 2 and float(rrk) <= float(tol2)
    assert float((xk - xp).abs().max()) <= 2e-3 * float(xp.abs().max())


# ---- the sharded slice: the ext kernels and four ranks on the card ----------

EXT_WEIGHTS = {1: dict(model_1=0.7, model_2=0.0), 2: dict(model_2=0.3),
               3: dict(model_0=0.1, model_1=0.2, model_2=1.0, model_3=0.3)}


def _blocks(shape, shards, r):
    """(block slices, slices of its extended block in the field padded by r,
    global start) per block of the layout."""
    import itertools
    loc = [n // s for n, s in zip(shape, shards)]
    for idx in itertools.product(*[range(s) for s in shards]):
        gs = [i * n for i, n in zip(idx, loc)]
        yield (tuple(slice(g, g + n) for g, n in zip(gs, loc)),
               tuple(slice(g, g + n + 2 * r) for g, n in zip(gs, loc)), gs)


def _close(got, want, bar):
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    assert bool(torch.isfinite(got).all())
    assert err <= bar * float(want.abs().max()), err


@pytest.mark.parametrize("shape,shards", [((45, 61), (3, 1)), ((40, 62), (2, 2)),
                                          ((20, 18, 22), (2, 2, 1)),
                                          ((9, 14, 10), (1, 2, 2))], ids=str)
@pytest.mark.parametrize("radius", [1, 2, 3])
@pytest.mark.parametrize("diag", [False, True])
def test_ext_kernel_matches_plain(cuda, shape, shards, radius, diag):
    rng = np.random.default_rng(radius)
    nd = len(shape)
    w = ft.Weights(**EXT_WEIGHTS[radius])
    x = torch.as_tensor(rng.standard_normal(shape).astype(np.float32), device=cuda)
    cshape = shape if diag else (3 ** nd,) + shape
    coeff = torch.as_tensor(rng.uniform(-1, 2, cshape).astype(np.float32), device=cuda)
    xp = torch.nn.functional.pad(x, (radius,) * (2 * nd))
    for blk, ext, gs in _blocks(shape, shards, radius):
        c = coeff[blk if diag else (slice(None),) + blk].contiguous()
        args = (xp[ext].contiguous(), c, gs, w, nd, radius, shape)
        before = fused_normal_apply_ext.launches
        got = fused_normal_apply_ext(*args)
        assert fused_normal_apply_ext.launches == before + 1
        _close(got, fused_normal_apply_ext_plain(*args), 1e-5)


@pytest.mark.parametrize("shape,shards", [((64, 48), (4, 1)), ((36, 53), (3, 1)),
                                          ((40, 62), (2, 2))], ids=str)
@pytest.mark.parametrize("radius", [1, 2, 3])
def test_ext_striped_kernel_matches_plain(cuda, shape, shards, radius):
    """The three operands read where they lie: rows from the top slab, the
    block and the bottom slab; on a 2 x 2 layout the axis-1 halo and the
    slabs' corners are neighbour data."""
    rng = np.random.default_rng(7 + radius)
    w = ft.Weights(**EXT_WEIGHTS[radius])
    r = radius
    x = torch.as_tensor(rng.standard_normal(shape).astype(np.float32), device=cuda)
    coeff = torch.as_tensor(rng.uniform(-1, 2, (9,) + shape).astype(np.float32),
                            device=cuda)
    xp = torch.nn.functional.pad(x, (r,) * 4)
    for blk, (rows, cols), gs in _blocks(shape, shards, r):
        args = (xp[rows.start + r:rows.stop - r, cols].contiguous(),
                xp[rows.start:rows.start + r, cols].contiguous(),
                xp[rows.stop - r:rows.stop, cols].contiguous(),
                coeff[(slice(None),) + blk].contiguous(), gs, w, r, shape)
        before = fused_normal_apply_ext_striped.launches
        got = fused_normal_apply_ext_striped(*args)
        assert fused_normal_apply_ext_striped.launches == before + 1
        _close(got, fused_normal_apply_ext_striped_plain(*args), 1e-5)


def _block_slabs(xp, blk, r, order, shape):
    """The halo slabs of block ``blk`` cut from the zero-padded field ``xp``
    in exchange ``order``, None where a slab lies past the global grid."""
    nd = len(shape)
    slabs = []
    for k, axis in enumerate(order):
        pair = []
        for low in (True, False):
            sl = [slice(b.start, b.stop + 2 * r) if d in order[:k]
                  else slice(b.start + r, b.stop + r) for d, b in enumerate(blk)]
            b = blk[axis]
            sl[axis] = slice(b.start, b.start + r) if low else slice(b.stop + r, b.stop + 2 * r)
            past = b.start == 0 if low else b.stop == shape[axis]
            pair.append(None if past else xp[tuple(sl)].contiguous())
        slabs.append(tuple(pair))
    return slabs


@pytest.mark.parametrize("shape,layout,form", [
    ((45, 63), (3, 3), "whole"), ((45, 63), (3, 3), "diag"), ((45, 63), (3, 3), "striped"),
    ((40, 61), (2, 1), "whole"), ((40, 61), (2, 1), "diag"), ((40, 61), (2, 1), "striped"),
    ((21, 27, 10), (3, 3, 1), "whole"), ((21, 27, 10), (3, 3, 1), "diag"),
    ((9, 14, 11), (1, 2, 1), "whole"), ((9, 14, 11), (1, 2, 1), "diag")], ids=str)
@pytest.mark.parametrize("radius", [1, 2, 3])
def test_ext_level_modes_match_plain(cuda, shape, layout, form, radius):
    """`ExtLevel` in every mode on every block of the layout (interior
    blocks, blocks at the global edge whose slabs there are None, odd
    extents), against its plain version; each call one launch, counted
    under its form and mode."""
    rng = np.random.default_rng(40 + radius)
    nd = len(shape)
    w = ft.Weights(**EXT_WEIGHTS[radius])

    def rand(s, lo=None, hi=None):
        a = rng.standard_normal(s) if lo is None else rng.uniform(lo, hi, s)
        return torch.as_tensor(a.astype(np.float32), device=cuda)

    x = rand(shape)
    coeff = rand(shape if form == "diag" else (3 ** nd,) + shape, -1, 2)
    xp = torch.nn.functional.pad(x, (radius,) * (2 * nd))
    order = (1, 0) if form == "striped" else tuple(range(nd))
    for blk, _, gs in _blocks(shape, layout, radius):
        c = coeff[blk if form == "diag" else (slice(None),) + blk].contiguous()
        level = ExtLevel(c, gs, w, radius, shape, striped=form == "striped")
        z, slabs = x[blk].contiguous(), _block_slabs(xp, blk, radius, order, shape)
        loc = z.shape
        ops = dict(r=rand(loc), inv_d=rand(loc, 0.05, 0.5), z_prev=rand(loc), s0=0.7, s1=0.4)
        counter = fused_normal_apply_ext_striped if form == "striped" else fused_normal_apply_ext
        for mode in MODES:
            before, before_mode = counter.launches, counter.modes[mode]
            got = level(z, slabs, mode, **ops)
            assert (counter.launches, counter.modes[mode]) == (before + 1, before_mode + 1)
            want = fused_normal_apply_ext_slabs_plain(z, slabs, c, gs, w, radius, shape,
                                                      order, mode, **ops)
            _close(got, want, 1e-5 if mode == "apply" else 2e-5)


def test_ext_level_raises_on_bad_operands(cuda):
    """No fallback: a CUDA call with a slab or operand of the wrong shape, no
    slab at a seam (the kernel reads nothing past a face without one), or a
    halo wider than the kernel stages, raises."""
    w = ft.Weights(model_2=0.3)
    level = ExtLevel(torch.ones(8, 10, device=cuda), [0, 0], w, 2, (16, 10))
    z = torch.zeros(8, 10, device=cuda)
    with pytest.raises(ValueError, match="slab"):
        level(z, [(None, torch.zeros(2, 9, device=cuda))])
    with pytest.raises(ValueError, match="seam"):
        level(z, [(None, None)])
    with pytest.raises(ValueError, match="residual"):
        level(z, (), "residual", r=torch.zeros(8, 9, device=cuda))
    wide = ExtLevel(torch.ones(8, 10, device=cuda), [0, 0], w, 4, (16, 10))
    with pytest.raises(ValueError, match="halo"):
        wide(z)


def test_sharded_solves_on_card_launch_the_ext_kernels(cuda):
    """Four ranks on the card (gloo): a 1024² problem on a 2 x 2 mesh (512²
    blocks: the striped form, the diagonal form on the sharded levels) and a
    48³ one (the whole form), each within ±2 iterations and 2e-3·max|x| of
    the unsharded solve on the card, every rank launching its kernels."""
    from field_interpolation_tpu_torch.parallel.cases import Cloud, run_cases, stitch
    from field_interpolation_tpu_torch.parallel.launch import run_ranks
    clouds = []
    for shape, n in [((1024, 1024), 4000), ((48, 48, 48), 1300)]:
        rng = np.random.default_rng(0)
        nd = len(shape)
        nrm = rng.standard_normal((n, nd))
        nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(np.float32)
        pts = ((np.asarray(shape) - 1) / 2.0 + 0.3 * min(shape) * nrm).astype(np.float32)
        clouds.append(Cloud(shape, ft.Weights(model_2=0.3), pts, None, nrm))
    cfg = ft.SolverConfig(tol=1e-4, maxiter=500)
    res = run_ranks(run_cases, 4, [("sharded_solve", dict(cloud=c, mesh_shape=(2, 2),
                                                          config=cfg)) for c in clouds],
                    device="cuda")
    for k, (c, kernels) in enumerate(zip(clouds, [
            ("fused_normal_apply_ext_striped", "fused_normal_apply_ext"),
            ("fused_normal_apply_ext",)])):
        parts = [r[k] for r in res]
        x = stitch(parts, "x")
        xr, ir = ft.solve(c.problem(cuda), cfg)
        assert all(p["converged"] for p in parts)
        assert abs(parts[0]["iterations"] - int(ir.iterations)) <= 2
        assert float((x - xr.cpu()).abs().max()) <= 2e-3 * float(xr.abs().max())
        for name in kernels:
            assert all(p["launches"][name] > 0 for p in parts), (name, parts[0]["launches"])


# ---- the public-API slice: interpolate, prepare, the session, solve_implicit -----


def _values_cloud(shape, n=100, seed=0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, np.asarray(shape) - 1, (n, len(shape))).astype(np.float32)
    return pos, rng.standard_normal(n).astype(np.float32)


@pytest.mark.parametrize("cfg", [dict(tol=5e-4, preconditioner="none", maxiter=20000),
                                 dict(tol=1e-4)], ids=["config1-cg", "multigrid"])
def test_interpolate_on_card_matches_cpu(cuda, cfg):
    pos, vals = _values_cloud((64, 64))
    args = (ft.Grid((64, 64)), ft.Weights(model_1=0.1, model_2=1.0))
    before = fused_normal_apply.launches
    xg, ig = ft.interpolate(*args, torch.as_tensor(pos, device=cuda),
                            torch.as_tensor(vals, device=cuda), config=ft.SolverConfig(**cfg))
    assert fused_normal_apply.launches > before
    xc, ic = ft.interpolate(*args, torch.as_tensor(pos), torch.as_tensor(vals),
                            config=ft.SolverConfig(**cfg))
    assert bool(ig.converged) and bool(ic.converged)
    assert abs(int(ig.iterations) - int(ic.iterations)) <= 2
    assert float((xg.cpu() - xc).abs().max()) <= 2e-3 * float(xc.abs().max())


@pytest.mark.parametrize("shape,change", [((64, 64), {}), ((64, 64), dict(mg_pre_smooth=2)),
                                          ((24, 24, 24), {})], ids=["fused", "levels", "3d"])
def test_prepared_solve_on_card_matches_cold(cuda, shape, change):
    """The same operands with and without a prep: the same iterations and
    field on the card."""
    p = _problem(shape, cuda, n=300)
    cfg = ft.SolverConfig(tol=1e-4, **change)
    x, info = ft.solve(p, cfg)
    xp, ip = ft.solve(p, cfg, prep=ft.prepare(p, cfg))
    assert bool(ip.converged) and int(ip.iterations) == int(info.iterations)
    assert float((xp - x).abs().max()) <= 1e-5 * float(x.abs().max())


def test_session_on_card_matches_cold(cuda):
    """A precise session's frame equals sdf_from_points_precise on the card
    and launches the segment kernel."""
    shape, n = (64, 64), 150
    rng = np.random.default_rng(2)
    theta = rng.uniform(0, 2 * np.pi, n)
    nrm = torch.as_tensor(np.stack([np.cos(theta), np.sin(theta)], 1).astype(np.float32),
                          device=cuda)
    pts = 31.5 + 20.0 * nrm
    grid, w, cfg = ft.Grid(shape), ft.Weights(model_2=0.3), ft.SolverConfig(tol=1e-6)
    s = ft.Solver(grid, w, pts, config=cfg, precise=True)
    before = fused_pcg_solve.launches
    x, info = s.solve(torch.zeros(n, device=cuda), gradients=nrm)
    assert fused_pcg_solve.launches > before
    xc, ic = ft.sdf_from_points_precise(grid, w, pts, nrm, config=cfg)
    assert bool(info.converged) and abs(int(info.iterations) - int(ic.iterations)) <= 2
    assert float((x - xc).abs().max()) <= 2e-4 * float(xc.abs().max())


def test_solve_implicit_on_card_matches_cpu(cuda):
    """Gradients through the assembly on the card (apply and whole V-cycle
    kernels, forward and adjoint) against the same on CPU tensors, within
    1e-3·max|g| (float32 solves to tol 1e-6 in another order)."""
    shape, n = (32, 32), 40
    rng = np.random.default_rng(7)
    pos = rng.uniform(2, 29, (n, 2)).astype(np.float32)
    vals = rng.standard_normal(n).astype(np.float32)
    target = rng.standard_normal(shape).astype(np.float32)
    grid, w = ft.Grid(shape), ft.Weights(model_1=0.1, model_2=0.5)
    cfg = ft.SolverConfig(tol=1e-6, maxiter=3000)

    def grads(device):
        p = torch.tensor(pos, device=device, requires_grad=True)
        v = torch.tensor(vals, device=device, requires_grad=True)
        x = ft.solve_implicit(ft.operators.assemble(grid, w, p, v), cfg)
        loss = torch.sum((x - torch.as_tensor(target, device=device)) ** 2)
        return [g.cpu() for g in torch.autograd.grad(loss, (p, v))]
    before = (fused_normal_apply.launches, fused_vcycle_2d.launches)
    got = grads(cuda)
    assert fused_normal_apply.launches > before[0] and fused_vcycle_2d.launches > before[1]
    for g, want in zip(got, grads(torch.device("cpu"))):
        assert float((g - want).abs().max()) <= 1e-3 * float(want.abs().max())


def test_radius3_cycle_smooths_through_the_per_sweep_kernel(cuda):
    """A level-by-level 2-D cycle with radius-3 weights and Galerkin coarse
    data: every 9-channel phase goes to the per-sweep kernel, none to the
    multi-sweep kernel; the cycle equals the plain one (kernels=False)."""
    p = _problem((64, 64), cuda, n=300, weights=dict(model_2=0.5, model_3=0.8))
    cfg = ft.SolverConfig(mg_pre_smooth=2, mg_cycle="w", mg_coarse_data="galerkin")
    r = torch.as_tensor(np.random.default_rng(5).standard_normal((64, 64)).astype(np.float32),
                        device=cuda)
    before = (fused_smooth.launches, fused_smooth_2d.launches)
    got = tmg.make_vcycle_preconditioner(p, cfg, kernels=True)(r)
    assert fused_smooth.launches > before[0] and fused_smooth_2d.launches == before[1]
    want = tmg.make_vcycle_preconditioner(p, cfg)(r)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


# ---- the batch slice: a lane index inside the segment and apply kernels -----

def _batch(shape, device, B, n=256, seed=1, zero_lanes=(), weights=dict(model_2=0.3)):
    """B circles (config 3's cloud, bench.py:166-171) assembled as lanes;
    ``zero_lanes`` have every point out of bounds (b = 0)."""
    from field_interpolation_tpu_torch import batch as tb
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0, 2 * np.pi, (B, n))
    nrm = np.stack([np.cos(theta), np.sin(theta)], -1).astype(np.float32)
    radii = rng.uniform(0.25, 0.4, (B, 1, 1)) * min(shape)
    pts = ((np.asarray(shape) - 1) / 2.0 + radii * nrm).astype(np.float32)
    pts[list(zero_lanes)] += 1e4
    return tb.assemble_batch(ft.Grid(shape), ft.Weights(**weights),
                             torch.as_tensor(pts, device=device),
                             torch.zeros(B, n, device=device),
                             gradients=torch.as_tensor(nrm, device=device))


def _segment_batch_check(probs, cfg, budget=None, nu=3):
    from field_interpolation_tpu_torch.ops.pcg import (fused_pcg_solve_batch,
                                                       fused_pcg_solve_batch_plain)
    ops = tmg.build_fused_solver_operands(probs, cfg)
    coeffs, sids, Rs, inv32, lw, cfs = ops
    b = probs.b
    B = b.shape[0]
    x0 = torch.zeros_like(b)
    tol2 = (1e-4 ** 2 * torch.sum(b * b, dim=(1, 2))).contiguous()
    if budget is None:
        budget = torch.full((B,), 2000, dtype=torch.int32, device=b.device)
    wdepth = tmg.resolve_wdepth(cfg, tuple(b.shape[1:]))
    args = (x0, b, tol2, budget, coeffs, sids, Rs, inv32, lw, nu)
    before = fused_pcg_solve_batch.launches
    xk, ik, rrk = fused_pcg_solve_batch(*args, cheb_coefs=cfs, wdepth=wdepth)
    xp, ip, _ = fused_pcg_solve_batch_plain(*args, cheb_coefs=cfs, wdepth=wdepth)
    torch.cuda.synchronize()
    assert fused_pcg_solve_batch.launches == before + 1
    assert ik.dtype == torch.int32 and tuple(ik.shape) == (B,) and tuple(rrk.shape) == (B,)
    assert int((ik - ip).abs().max()) <= 2, (ik.tolist(), ip.tolist())
    for i in range(B):
        scale = float(xp[i].abs().max())
        assert float((xk[i] - xp[i]).abs().max()) <= 2e-3 * scale, i
        if int(ik[i]) > 0:
            assert float(rrk[i]) <= float(tol2[i])
    frozen = (budget == 0) | (torch.sum(b * b, dim=(1, 2)) == 0)
    assert torch.equal(xk[frozen], x0[frozen]) and int(ik[frozen].abs().sum()) == 0
    return ik


@pytest.mark.parametrize("change", [{}, dict(mg_cycle="w"), dict(mg_smoother="chebyshev4"),
                                    dict(mg_coarse_data="galerkin"),
                                    dict(mg_smoother="chebyshev4", mg_coarse_data="galerkin")],
                         ids=str)
def test_segment_batch_matches_plain(cuda, change):
    """The batched segment on ragged lanes: a lane with b = 0 and a lane with
    budget 0 run no iteration and keep x; the others match the plain
    batched segment lane by lane."""
    probs = _batch((128, 128), cuda, 6, zero_lanes=(0,))
    budget = torch.tensor([2000, 2000, 0, 2000, 2000, 2000], dtype=torch.int32, device=cuda)
    ik = _segment_batch_check(probs, ft.SolverConfig(tol=1e-4, **change), budget)
    assert int(ik[1]) > 0


@pytest.mark.parametrize("shape,B", [((97, 130), 3), ((256, 256), 2), ((32, 32), 9)], ids=str)
def test_segment_batch_shapes(cuda, shape, B):
    _segment_batch_check(_batch(shape, cuda, B, n=200), ft.SolverConfig(tol=1e-4))


@pytest.mark.parametrize("shape,B,cfg", [((30, 42), 3, {}), ((18, 10), 4, dict(mg_min_size=4)),
                                         ((61, 45), 2, dict(mg_smoother="chebyshev4"))], ids=str)
def test_segment_batch_ragged_runs_and_small_coarse_levels(cuda, shape, B, cfg):
    """Rows whose length is not a multiple of the lane body's 4-node run
    (42, 10, 45 and their coarse levels), and coarse levels with fewer
    nodes than a warp (18×10 → 9×5 → 5×3)."""
    _segment_batch_check(_batch(shape, cuda, B, n=120), ft.SolverConfig(tol=1e-4, **cfg))


@pytest.mark.parametrize("geometry", LANE_GEOMETRIES, ids=str)
def test_segment_batch_256_w_chebyshev_galerkin(cuda, geometry, monkeypatch):
    """Both lane widths on 256² lanes (five levels; the 128² level's arrays
    in global memory) with a W-cycle, Chebyshev smoothing and Galerkin
    coarse levels."""
    from field_interpolation_tpu_torch.ops import pcg
    monkeypatch.setattr(pcg, "LANE_GEOMETRY", geometry)
    _segment_batch_check(_batch((256, 256), cuda, 2, n=400), ft.SolverConfig(
        tol=1e-4, mg_cycle="w", mg_smoother="chebyshev4", mg_coarse_data="galerkin"))


def test_segment_batch_same_bits_every_run(cuda):
    """64 lanes twice: the same x, iterations and ‖r‖² to the bit (every
    sum in a fixed order, no atomics)."""
    from field_interpolation_tpu_torch.ops.pcg import fused_pcg_solve_batch
    probs = _batch((128, 128), cuda, 64)
    coeffs, sids, Rs, inv32, lw, _ = tmg.build_fused_solver_operands(
        probs, ft.SolverConfig(tol=1e-4))
    b = probs.b
    tol2 = (1e-4 ** 2 * torch.sum(b * b, dim=(1, 2))).contiguous()
    budget = torch.full((64,), 2000, dtype=torch.int32, device=cuda)
    args = (torch.zeros_like(b), b, tol2, budget, coeffs, sids, Rs, inv32, lw, 3)
    x1, i1, r1 = fused_pcg_solve_batch(*args)
    x2, i2, r2 = fused_pcg_solve_batch(*args)
    assert torch.equal(x1, x2) and torch.equal(i1, i2) and torch.equal(r1, r2)
    assert int(i1.min()) > 0


def test_segment_batch_lane_bits_do_not_depend_on_the_batch(cuda, monkeypatch):
    """A lane gives the same bits in a batch of 200 (two lanes of 256
    threads an SM on an H100), alone (one lane of 1024 threads) and at
    every lane geometry: its dot products sum in one order at every width."""
    from field_interpolation_tpu_torch.ops import pcg
    from field_interpolation_tpu_torch.ops.pcg import fused_pcg_solve_batch
    B = 200
    probs = _batch((128, 128), cuda, B)
    coeffs, sids, Rs, inv32, lw, _ = tmg.build_fused_solver_operands(
        probs, ft.SolverConfig(tol=1e-4))
    b = probs.b
    tol2 = (1e-4 ** 2 * torch.sum(b * b, dim=(1, 2))).contiguous()
    budget = torch.full((B,), 2000, dtype=torch.int32, device=cuda)

    def solve(lanes):
        return fused_pcg_solve_batch(torch.zeros_like(b[lanes]), b[lanes].contiguous(),
                                     tol2[lanes].contiguous(), budget[lanes].contiguous(),
                                     [c[lanes].contiguous() for c in coeffs],
                                     [s[lanes].contiguous() for s in sids], Rs,
                                     inv32[lanes].contiguous(), lw, 3)
    whole = solve(slice(0, B))
    assert int(whole[1].min()) > 0
    for i in (0, 57, B - 1):
        alone = solve(slice(i, i + 1))
        assert all(torch.equal(a[0], w[i]) for a, w in zip(alone, whole)), i
    for geometry in LANE_GEOMETRIES:
        monkeypatch.setattr(pcg, "LANE_GEOMETRY", geometry)
        again = solve(slice(0, B))
        assert all(torch.equal(a, w) for a, w in zip(again, whole)), geometry


@pytest.mark.parametrize("geometry", LANE_GEOMETRIES, ids=str)
def test_segment_batch_lanes_equal_single_kernel(cuda, geometry, monkeypatch):
    """Each lane of a batch, at either lane width, runs the single-field
    kernel's iteration count within ±2 (the same cycle and CG, one block a
    lane), and is the same on every run (fixed-order reductions)."""
    from field_interpolation_tpu_torch.ops import pcg
    from field_interpolation_tpu_torch.ops.pcg import fused_pcg_solve_batch
    monkeypatch.setattr(pcg, "LANE_GEOMETRY", geometry)
    probs = _batch((128, 128), cuda, 4)
    coeffs, sids, Rs, inv32, lw, cfs = tmg.build_fused_solver_operands(
        probs, ft.SolverConfig(tol=1e-4))
    b = probs.b
    tol2 = (1e-4 ** 2 * torch.sum(b * b, dim=(1, 2))).contiguous()
    budget = torch.full((4,), 2000, dtype=torch.int32, device=cuda)
    args = (torch.zeros_like(b), b, tol2, budget, coeffs, sids, Rs, inv32, lw, 3)
    x1, i1, _ = fused_pcg_solve_batch(*args)
    x2, i2, _ = fused_pcg_solve_batch(*args)
    assert torch.equal(x1, x2) and torch.equal(i1, i2)
    for i in range(4):
        xs, its, _ = fused_pcg_solve(torch.zeros_like(b[i]), b[i], tol2[i].reshape(1, 1),
                                     budget[i].reshape(1, 1), [c[i] for c in coeffs],
                                     [s[i] for s in sids], Rs, inv32[i], lw, 3)
        assert abs(int(its) - int(i1[i])) <= 2
        assert float((xs - x1[i]).abs().max()) <= 2e-3 * float(xs.abs().max())


def _lanes(shape, device, clouds, weights=dict(model_0=0.05, model_2=0.3)):
    """One lane per cloud: oriented points (``(pts, nrm)``, normals as data
    gradients) or value points (``(pts, None)``), padded to a common count
    with points out of bounds (dropped by the assembly)."""
    from field_interpolation_tpu_torch import batch as tb
    n = max(len(p) for p, _ in clouds)
    pts = np.full((len(clouds), n, 2), 1e4, np.float32)
    nrm = np.zeros((len(clouds), n, 2), np.float32)
    for i, (p, g) in enumerate(clouds):
        pts[i, :len(p)] = p
        if g is not None:
            nrm[i, :len(g)] = g
    grads = None if all(g is None for _, g in clouds) else torch.as_tensor(nrm, device=device)
    return tb.assemble_batch(ft.Grid(shape), ft.Weights(**weights),
                             torch.as_tensor(pts, device=device),
                             torch.ones(len(clouds), n, device=device), gradients=grads)


def _counted(call):
    """``call()`` inside a batch record under a CPU profiler: (its result,
    the record's counters)."""
    from torch.profiler import ProfilerActivity, profile

    from field_interpolation_tpu_torch.utils import observe
    observe.clear_records()
    with profile(activities=[ProfilerActivity.CPU]), observe.span("batch"):
        out = call()
    (rec,) = observe.batch_records()
    observe.clear_records()
    return out, rec["counters"]


def _run_mask_check(probs, cfg=ft.SolverConfig(tol=1e-4)):
    """The batched segment with level 0's run mask: each lane's x,
    iterations and ‖r‖² equal the same lane solved alone (torch.equal);
    every lane is held to the plain batched segment at the bars of
    `_segment_batch_check`; the data runs the kernel counts, for the batch
    and for each lane alone, equal `lane_data_runs`. Returns (iterations,
    data runs a lane) on the CPU."""
    from field_interpolation_tpu_torch.ops.pcg import (fused_pcg_solve_batch,
                                                       fused_pcg_solve_batch_plain,
                                                       lane_data_runs, lane_runs)
    coeffs, sids, Rs, inv32, lw, cfs = tmg.build_fused_solver_operands(probs, cfg)
    b = probs.b
    B = b.shape[0]
    tol2 = (1e-4 ** 2 * torch.sum(b * b, dim=(1, 2))).contiguous()
    budget = torch.full((B,), 2000, dtype=torch.int32, device=b.device)
    kw = dict(cheb_coefs=cfs, wdepth=tmg.resolve_wdepth(cfg, tuple(b.shape[1:])))
    args = (torch.zeros_like(b), b, tol2, budget, coeffs, sids, Rs, inv32, lw,
            cfg.mg_pre_smooth)
    whole, counters = _counted(lambda: fused_pcg_solve_batch(*args, **kw))
    xk, ik, rrk = whole
    runs = lane_data_runs(coeffs[0], ik).cpu()
    assert counters == {"runs_offered": B * lane_runs(tuple(b.shape[1:])),
                        "data_runs": int(runs.sum())}, counters
    xp, ip, _ = fused_pcg_solve_batch_plain(*args, **kw)
    assert int((ik - ip).abs().max()) <= 2, (ik.tolist(), ip.tolist())
    for i in range(B):
        assert float((xk[i] - xp[i]).abs().max()) <= 2e-3 * float(xp[i].abs().max()), i
        if int(ik[i]) > 0:
            assert float(rrk[i]) <= float(tol2[i])
        one = slice(i, i + 1)
        alone, counters = _counted(lambda: fused_pcg_solve_batch(
            torch.zeros_like(b[one]), b[one].contiguous(), tol2[one].contiguous(),
            budget[one].contiguous(), [c[one].contiguous() for c in coeffs],
            [s[one].contiguous() for s in sids], Rs, inv32[one].contiguous(), lw,
            cfg.mg_pre_smooth, cheb_coefs=None if cfs is None else [
                None if cf is None else cf[one].contiguous() for cf in cfs],
            wdepth=kw["wdepth"]))
        assert all(torch.equal(a[0], w[i]) for a, w in zip(alone, whole)), i
        assert counters["data_runs"] == int(runs[i]), (i, counters)
    return ik.cpu(), runs


def test_run_mask_corners_and_edges(cuda):
    """Points in the grid's corner and edge cells (the runs there take the
    guarded loads), one lane with its data on one node of one run (a value
    point on a node: one nonzero coefficient), and a lane with no point
    (b = 0: it runs no cycle and marks nothing)."""
    from field_interpolation_tpu_torch.ops.pcg import lane_runs
    n = 64
    edge = [(0.2, 0.3), (0.4, n - 1.2), (n - 1.3, 0.1), (n - 1.1, n - 1.4), (0.5, 31.5),
            (31.7, 0.2), (n - 1.2, 30.1), (29.6, n - 1.3)]
    rng = np.random.default_rng(8)
    theta = rng.uniform(0, 2 * np.pi, 60)
    ring = np.stack([31.5 + 20 * np.cos(theta), 31.5 + 20 * np.sin(theta)], 1)
    clouds = [(np.concatenate([ring, edge]).astype(np.float32), None),
              (np.asarray([[20.0, 21.0]], np.float32), None),
              (np.asarray([[1e4, 1e4]], np.float32), None)]
    probs = _lanes((n, n), cuda, clouds)
    assert int(torch.count_nonzero(probs.coeff[1])) == 1
    ik, runs = _run_mask_check(probs)
    assert int(ik[0]) > 0 and int(ik[1]) > 0 and int(ik[2]) == 0
    assert 0 < int(runs[0]) < lane_runs((n, n)) and int(runs[1]) == 1 and int(runs[2]) == 0


@pytest.mark.parametrize("shape", [(61, 45), (30, 42), (97, 130)], ids=str)
def test_run_mask_ragged_rows(cuda, shape):
    """Rows whose length is not a multiple of 4 (a level-0 row of 45 or 42
    nodes: no 16-byte loads, a ragged last run) and 130 (16-byte rows, a
    ragged last run of 2), with points in the last run of a row."""
    rng = np.random.default_rng(9)
    clouds = []
    for s in range(3):
        theta = rng.uniform(0, 2 * np.pi, 80)
        c = (np.asarray(shape) - 1) / 2.0
        r = (0.25 + 0.05 * s) * min(shape)
        pts = np.stack([c[0] + r * np.cos(theta), c[1] + r * np.sin(theta)], 1)
        pts = np.concatenate([pts, [[c[0], shape[1] - 1.3], [1.5, shape[1] - 1.1]]])
        nrm = np.concatenate([np.stack([np.cos(theta), np.sin(theta)], 1), [[0, 1], [0, 1]]])
        clouds.append((pts.astype(np.float32), nrm.astype(np.float32)))
    _run_mask_check(_lanes(shape, cuda, clouds, dict(model_2=0.3)))


def test_run_mask_dense_cloud(cuda):
    """A cloud with data in every run: the mask is all ones and every apply
    does what it did without it."""
    from field_interpolation_tpu_torch.ops.pcg import lane_runs
    rng = np.random.default_rng(10)
    n = 64
    clouds = []
    for _ in range(2):
        theta = rng.uniform(0, 2 * np.pi, 12000)
        pts = rng.uniform(0, n - 1, (12000, 2))
        clouds.append((pts.astype(np.float32),
                       np.stack([np.cos(theta), np.sin(theta)], 1).astype(np.float32)))
    _, runs = _run_mask_check(_lanes((n, n), cuda, clouds, dict(model_2=0.3)))
    assert runs.tolist() == [lane_runs((n, n))] * 2


@pytest.mark.parametrize("geometry", LANE_GEOMETRIES, ids=str)
def test_run_mask_config3_lanes(cuda, geometry, monkeypatch):
    """Config 3 × 64 lanes at either lane width: ~6% of the runs hold data."""
    from field_interpolation_tpu_torch.ops import pcg
    monkeypatch.setattr(pcg, "LANE_GEOMETRY", geometry)
    _, runs = _run_mask_check(_batch((128, 128), cuda, 64))
    share = float(runs.sum()) / (64 * pcg.lane_runs((128, 128)))
    assert 0.02 < share < 0.12, share


@pytest.mark.parametrize("shape,B", [((128, 128), 16), ((33, 17), 5), ((20, 18, 22), 4),
                                     ((128, 128), 1)], ids=str)
@pytest.mark.parametrize("diag", [False, True])
def test_apply_batch_matches_plain(cuda, shape, B, diag):
    from field_interpolation_tpu_torch.ops.stencil import fused_normal_apply_batch
    rng = np.random.default_rng(2)
    x = torch.as_tensor(rng.standard_normal((B,) + shape).astype(np.float32), device=cuda)
    w = ft.Weights(model_1=0.2, model_2=0.3)
    cshape = (B,) + shape if diag else (B, 3 ** len(shape)) + shape
    coeff = torch.as_tensor(rng.uniform(0, 2, cshape).astype(np.float32), device=cuda)
    before = fused_normal_apply_batch.launches
    got = fused_normal_apply_batch(x, coeff, w, len(shape))
    assert fused_normal_apply_batch.launches == before + 1
    _close(got, fused_normal_apply_plain(x, coeff, w, len(shape)), 1e-5)


def test_batch_kernels_past_2gib_of_coefficients(cuda):
    """Lane offsets are 64-bit: 4,096 lanes of 128² hold 2.4 GB of
    coefficient planes (past 2³¹ bytes). The last lanes' applies and
    segments match their plain versions."""
    from field_interpolation_tpu_torch.ops.pcg import fused_pcg_solve_batch
    from field_interpolation_tpu_torch.ops.stencil import fused_normal_apply_batch
    B, shape = 4096, (128, 128)
    probs = _batch(shape, cuda, B, n=64)
    assert probs.coeff.numel() * 4 > 2 ** 31
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.standard_normal((B,) + shape).astype(np.float32), device=cuda)
    got = fused_normal_apply_batch(x, probs.coeff, probs.weights, 2)
    tail = slice(B - 3, B)
    _close(got[tail], fused_normal_apply_plain(x[tail], probs.coeff[tail], probs.weights, 2),
           1e-5)
    del got, x
    coeffs, sids, Rs, inv32, lw, _ = tmg.build_fused_solver_operands(
        probs, ft.SolverConfig(tol=1e-4))
    b = probs.b
    tol2 = (1e-4 ** 2 * torch.sum(b * b, dim=(1, 2))).contiguous()
    budget = torch.zeros(B, dtype=torch.int32, device=cuda)
    budget[-2:] = 2000  # only the last two lanes work
    xk, ik, _ = fused_pcg_solve_batch(torch.zeros_like(b), b, tol2, budget, coeffs, sids, Rs,
                                      inv32, lw, 3)
    for i in (B - 2, B - 1):
        xs, its, _ = fused_pcg_solve_plain(torch.zeros_like(b[i]), b[i],
                                           tol2[i].reshape(1, 1),
                                           budget[i].reshape(1, 1),
                                           [c[i] for c in coeffs], [s[i] for s in sids], Rs,
                                           inv32[i], lw, 3)
        assert abs(int(its) - int(ik[i])) <= 2 and int(ik[i]) > 0
        assert float((xs - xk[i]).abs().max()) <= 2e-3 * float(xs.abs().max())
    assert int(ik[:-2].abs().sum()) == 0


def test_config3_batch_on_card_matches_cpu(cuda):
    """sdf_from_points_batch on the card (the batched fused route) against
    the same batch on the CPU (the plain versions), lane by lane; and
    sdf_from_points_precise_batch to a TRUE 1e-6."""
    from field_interpolation_tpu_torch import batch as tb
    rng = np.random.default_rng(4)
    B, n, shape = 8, 200, (128, 128)  # the smallest batch of 128² that takes the route
    theta = rng.uniform(0, 2 * np.pi, (B, n))
    nrm = np.stack([np.cos(theta), np.sin(theta)], -1).astype(np.float32)
    pts = (63.5 + rng.uniform(0.25, 0.4, (B, 1, 1)) * 128 * nrm).astype(np.float32)
    g, w, cfg = ft.Grid(shape), ft.Weights(model_2=0.3), ft.SolverConfig(tol=1e-4)
    from field_interpolation_tpu_torch.ops.pcg import fused_pcg_solve_batch
    before = fused_pcg_solve_batch.launches
    xg, ig = tb.sdf_from_points_batch(g, w, torch.as_tensor(pts, device=cuda),
                                      torch.as_tensor(nrm, device=cuda), config=cfg)
    assert fused_pcg_solve_batch.launches > before
    xc, ic = tb.sdf_from_points_batch(g, w, torch.as_tensor(pts), torch.as_tensor(nrm),
                                      config=cfg)
    assert bool(ig.converged.all())
    assert int((ig.iterations.cpu() - ic.iterations).abs().max()) <= 2
    for i in range(B):
        assert float((xg[i].cpu() - xc[i]).abs().max()) <= 2e-3 * float(xc[i].abs().max())
    xp, ip = tb.sdf_from_points_precise_batch(g, w, torch.as_tensor(pts, device=cuda),
                                              torch.as_tensor(nrm, device=cuda),
                                              config=ft.SolverConfig(tol=1e-6))
    pp = tb.assemble_precise_batch(g, w, torch.as_tensor(pts, device=cuda),
                                   torch.zeros(B, n, device=cuda),
                                   gradients=torch.as_tensor(nrm, device=cuda))
    true = (torch.linalg.vector_norm(pp.residual64(xp), dim=(1, 2))
            / torch.linalg.vector_norm(pp.b64, dim=(1, 2)))
    assert bool(ip.converged.all()) and float(true.max()) <= 1e-6
    assert float(((true - ip.rel_residual.double()).abs() / true).max()) <= 0.02


def test_batch_launches_do_not_grow_with_lanes(cuda):
    """torch.profiler: the launch calls of a config-3 batch come from its
    setup and outer rounds, not its lanes: B = 1024 makes no more than
    B = 64 does, beyond the rounds a slower lane adds."""
    from torch.profiler import ProfilerActivity, profile

    from field_interpolation_tpu_torch import batch as tb
    from field_interpolation_tpu_torch.ops.pcg import fused_pcg_solve_batch
    probs = _batch((128, 128), cuda, 1024)
    cfg = ft.SolverConfig(tol=1e-4)
    counts = {}
    for B in (64, 1024):
        sub = ft.Problem(coeff=probs.coeff[:B], b=probs.b[:B], diag=probs.diag[:B],
                         grid=probs.grid, weights=probs.weights)
        tb.solve_batch(sub, cfg)  # warm-up
        torch.cuda.synchronize()
        before = fused_pcg_solve_batch.launches
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            tb.solve_batch(sub, cfg)
            torch.cuda.synchronize()
        rounds = fused_pcg_solve_batch.launches - before
        calls = sum(e.count for e in prof.key_averages()
                    if e.key in ("cudaLaunchKernel", "cudaLaunchCooperativeKernel"))
        counts[B] = (calls, rounds)
    (c64, r64), (c1024, r1024) = counts[64], counts[1024]
    assert r1024 >= 1 and c1024 > 0, counts
    per_round = c64 / max(r64, 1)
    assert c1024 <= c64 + per_round * max(r1024 - r64, 0) + 16, counts


# ---- the lane forms of the smoothing-phase, multi-sweep and cycle kernels ---

def _lane_operands(shape, cuda, B, diag, weights_kw=dict(model_1=0.2, model_2=1.0)):
    """B lanes of `_sweep_operands`: lane i's problem from seed i, its own
    r and z; sid = 0.3/D."""
    lanes = [_problem(shape, cuda, n=200, seed=i, weights=weights_kw) for i in range(B)]
    rng = np.random.default_rng(5)
    r, z = (torch.as_tensor(rng.standard_normal((B,) + shape).astype(np.float32), device=cuda)
            for _ in range(2))
    coeff = torch.stack([p.coeff[(3 ** len(shape)) // 2] if diag else p.coeff for p in lanes])
    sid = torch.stack([0.3 / p.diag for p in lanes]).contiguous()
    return r, z, coeff.contiguous(), sid, ft.Weights(**weights_kw)


def _lane_schedules(B, sweeps, cuda, kind="chebyshev4"):
    """[B, ν, 2] schedules, one Gershgorin bound a lane."""
    rho = torch.linspace(2.1, 2.6, B, device=cuda)
    return tmg.chebyshev_coefs(rho, sweeps, ft.SolverConfig(mg_smoother=kind)).contiguous()


def _lanes_equal_single(got, single, residual):
    """Lane i of the batched call is the single-field call on lane i, bit
    for bit (z and, with ``residual``, r − A z)."""
    torch.cuda.synchronize()
    outs = got if residual else (got,)
    for i, one in enumerate(single):
        for g, s in zip(outs, one if residual else (one,)):
            assert torch.equal(g[i], s), (i, float((g[i] - s).abs().max()))


@pytest.mark.parametrize("shape,B,diag", [
    ((64, 48), 5, False), ((64, 48), 5, True), ((24, 20, 18), 3, False),
    ((24, 20, 18), 3, True), ((37, 5, 70), 2, False), ((37, 5, 70), 2, True),
    ((128, 128, 128), 2, True)], ids=str)
@pytest.mark.parametrize("from_zero", [False, True])
@pytest.mark.parametrize("kind", ["jacobi", "chebyshev4"])
@pytest.mark.parametrize("residual", [False, True])
def test_sweep_kernel_lanes_equal_single_and_plain(cuda, shape, B, diag, from_zero, kind,
                                                   residual):
    """fused_smooth on B lanes: one call's launches for all lanes (as one
    field's), each lane's output the single-field kernel's bits, all lanes
    within the single-field bars of the plain version; tiles cut at odd
    extents, 128³ at the size of config 4's lumped (diagonal) fine level."""
    r, z, coeff, sid, w = _lane_operands(shape, cuda, B, diag)
    nd, sweeps = len(shape), 3
    cf = None
    if kind != "jacobi":
        cf, sid = _lane_schedules(B, sweeps, cuda, kind), (sid / 0.3).contiguous()
    before, lanes_before = fused_smooth.launches, fused_smooth.lane_launches
    got = fused_smooth(r, z, coeff, sid, w, nd, sweeps, from_zero, cheb_coefs=cf,
                       residual=residual)
    launches = fused_smooth.launches - before
    assert launches == _phase_launches(sweeps, from_zero, residual, cf is not None)
    assert fused_smooth.lane_launches - lanes_before == launches
    single = [fused_smooth(r[i], z[i], coeff[i], sid[i], w, nd, sweeps, from_zero,
                           cheb_coefs=None if cf is None else cf[i], residual=residual)
              for i in range(B)]
    _lanes_equal_single(got, single, residual)
    _check_phase(got, fused_smooth_plain(r, z, coeff, sid, w, nd, sweeps, from_zero,
                                         cheb_coefs=cf, residual=residual), residual)


@pytest.mark.parametrize("shape,B,radius", [((100, 128), 3, 2), ((37, 201), 4, 2),
                                            ((992, 992), 2, 2), ((1000, 1030), 2, 3),
                                            ((5, 7), 3, 1)], ids=str)
@pytest.mark.parametrize("from_zero", [False, True])
@pytest.mark.parametrize("kind", ["jacobi", "chebyshev4"])
@pytest.mark.parametrize("residual", [False, True])
def test_multisweep_kernel_lanes_equal_single_and_plain(cuda, shape, B, radius, from_zero,
                                                        kind, residual):
    """fused_smooth_2d on B lanes: one field's launches for all lanes (a
    radius-3 phase from z with the residual takes two), each lane the
    single-field kernel's bits, all within the bars of the plain version;
    rows 16-byte aligned (100 × 128, 992²) and ragged (1000 × 1030, 37 ×
    201: the scalar path for the whole launch)."""
    r, z, coeff, sid, w = _lane_operands(shape, cuda, B, False, MULTISWEEP_WEIGHTS[radius])
    sweeps = 3
    cf = None
    if kind != "jacobi":
        cf, sid = _lane_schedules(B, sweeps, cuda, kind), (sid / 0.3).contiguous()
    before, lanes_before = fused_smooth_2d.launches, fused_smooth_2d.lane_launches
    got = fused_smooth_2d(r, z, coeff, sid, w, sweeps, from_zero, cheb_coefs=cf,
                          residual=residual)
    launches = fused_smooth_2d.launches - before
    assert launches == _multisweep_launches(sweeps, from_zero, residual, radius,
                                            cf is not None)
    assert fused_smooth_2d.lane_launches - lanes_before == launches
    single = [fused_smooth_2d(r[i], z[i], coeff[i], sid[i], w, sweeps, from_zero,
                              cheb_coefs=None if cf is None else cf[i], residual=residual)
              for i in range(B)]
    _lanes_equal_single(got, single, residual)
    _check_phase(got, fused_smooth_plain(r, z, coeff, sid, w, 2, sweeps, from_zero,
                                         cheb_coefs=cf, residual=residual), residual)


@pytest.mark.parametrize("shape,B", [((45, 61), 3), ((97, 130), 2), ((440, 440), 2)],
                         ids=str)
@pytest.mark.parametrize("change", [{}, dict(mg_smoother="chebyshev4"),
                                    dict(mg_coarse_data="galerkin")], ids=str)
@pytest.mark.parametrize("wdepth,nu_pre,nu_post", [(0, 2, 3), (0, 3, 3), (99, 3, 3)])
def test_cycle_kernel_lanes_equal_single_and_plain(cuda, shape, B, change, wdepth, nu_pre,
                                                   nu_post):
    """The whole-cycle kernel on B lanes: ONE launch for the batch, each
    lane's z the single-field kernel's bits, all lanes within 3e-5·max of
    mg_cycle_plain on lanes; per-lane steps, schedules and coarsest
    inverses, lumped and Galerkin coarse levels (440²: inside the
    whole-cycle band of every mode)."""
    probs = _batch(shape, cuda, B)
    (coeffs, sids, Rs, inv32, lw), _, cfs = tmg.whole_cycle_operands(
        probs, ft.SolverConfig(**change))
    r = torch.as_tensor(np.random.default_rng(8).standard_normal((B,) + shape)
                        .astype(np.float32), device=cuda)
    counter = fused_wcycle_2d if wdepth else fused_vcycle_2d

    def call(rr, cs, ss, inv, cf):
        if wdepth:
            return fused_wcycle_2d(rr, cs, ss, Rs, inv, lw, nu_pre, cheb_coefs=cf,
                                   wdepth=wdepth)
        return fused_vcycle_2d(rr, cs, ss, Rs, inv, lw, nu_pre, nu_post, cheb_coefs=cf)

    before, lanes_before = counter.launches, counter.lane_launches
    got = call(r, coeffs, sids, inv32, cfs)
    assert counter.launches == before + 1 and counter.lane_launches == lanes_before + 1
    single = [call(r[i], [c[i] for c in coeffs], [s[i] for s in sids], inv32[i],
                   None if cfs is None else [cf[i] for cf in cfs]) for i in range(B)]
    _lanes_equal_single(got, single, False)
    _close(got, mg_cycle_plain(r, coeffs, sids, Rs, inv32, lw, nu_pre, nu_post, wdepth, cfs),
           3e-5)
