"""The CUDA kernels against their plain versions, on the card.

Marked ``gpu``: each test skips without a CUDA card. On the GPU host run

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py

(``--noconftest`` because tests/conftest.py configures JAX, which this file
does not use). Bars: the apply within 1e-5·max|plain| and a sweep within
2e-5·max|plain| (float32 sums in another order); the segment and the solves
within ±2 iterations and 2e-3·max|x| (tests/test_solver.py:191-195)."""

import numpy as np
import pytest
import torch

import field_interpolation_tpu_torch as ft
from field_interpolation_tpu_torch import multigrid as tmg
from field_interpolation_tpu_torch.ops.pcg import fused_pcg_solve, fused_pcg_solve_plain
from field_interpolation_tpu_torch.ops.smooth import (fused_smooth, fused_smooth_plain,
                                                      fused_sweep)
from field_interpolation_tpu_torch.ops.stencil import (fused_normal_apply,
                                                       fused_normal_apply_plain)

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


@pytest.mark.parametrize("shape", [(64, 48), (24, 20, 18)])
@pytest.mark.parametrize("diag", [False, True])
@pytest.mark.parametrize("from_zero", [False, True])
@pytest.mark.parametrize("sweeps", [1, 3])
def test_sweep_kernel_matches_plain(cuda, shape, diag, from_zero, sweeps):
    r, z, coeff, sid, w = _sweep_operands(shape, cuda, diag)
    nd = len(shape)
    before = fused_smooth.launches
    got = fused_smooth(r, z, coeff, sid, w, nd, sweeps, from_zero)
    want = fused_smooth_plain(r, z, coeff, sid, w, nd, sweeps, from_zero)
    torch.cuda.synchronize()
    assert fused_smooth.launches == before + sweeps
    err = float((got - want).abs().max())
    assert err <= 2e-5 * float(want.abs().max()), err


@pytest.mark.parametrize("weights_kw", [dict(model_1=0.2, model_2=1.0),
                                        dict(model_2=0.5, model_3=0.8)])
def test_single_sweep_kernel_matches_plain(cuda, weights_kw):
    r, z, cdiag, sid, w = _sweep_operands((128, 128, 128), cuda, True, weights_kw)
    before = fused_smooth.launches
    got = fused_sweep(r, z, cdiag, sid, w)
    want = fused_smooth_plain(r, z, cdiag, sid, w, 3, 1)
    torch.cuda.synchronize()
    assert fused_smooth.launches == before + 1
    err = float((got - want).abs().max())
    assert err <= 2e-5 * float(want.abs().max()), err


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


@pytest.mark.parametrize("shape,change", [
    ((64, 64), dict(mg_cycle="w")),                     # W-cycle in the fused kernel
    ((1024, 1024), dict()),                             # fused_smooth_striped
    ((64, 64), dict(mg_fine_operator="lumped")),        # fused_vcycle_2d
    ((64, 64), dict(mg_smoother="chebyshev")),
    ((24, 24, 24), dict(mg_smoother="chebyshev")),
])
def test_unported_cuda_configs_raise(cuda, shape, change):
    # 100 points leave a 1024² float32 solve stuck near 3e-4 (plain ops on
    # CPU too); 2000 points on its circle converge.
    problem = _problem(shape, cuda, n=2000 if max(shape) >= 1024 else 100)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ft.solve(problem, ft.SolverConfig(tol=1e-4, **change))
    if "mg_smoother" in change:
        return  # Chebyshev is not ported to plain ops either
    x, info = ft.solve(problem, ft.SolverConfig(tol=1e-4, backend="xla", **change))
    assert bool(info.converged)
