"""The CUDA kernels against their plain versions, on the card.

Marked ``gpu``: each test skips without a CUDA card. On the GPU host run

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py

(``--noconftest`` because tests/conftest.py configures JAX, which this file
does not use). Bars: the apply within 1e-5·max|plain| (float32 sums in
another order); the segment within ±2 iterations and 2e-3·max|x|
(tests/test_solver.py:191-195)."""

import numpy as np
import pytest
import torch

import field_interpolation_tpu_torch as ft
from field_interpolation_tpu_torch import multigrid as tmg
from field_interpolation_tpu_torch.ops.pcg import fused_pcg_solve, fused_pcg_solve_plain
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
    theta = rng.uniform(0, 2 * np.pi, n)
    nrm = np.stack([np.cos(theta), np.sin(theta)], 1).astype(np.float32)
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


@pytest.mark.parametrize("change", [dict(mg_cycle="w"),
                                    dict(mg_pre_smooth=2),
                                    dict(preconditioner="multigrid",
                                         mg_coarse_solver="jacobi")])
def test_unported_cuda_configs_raise(cuda, change):
    problem = _problem((64, 64), cuda)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ft.solve(problem, ft.SolverConfig(tol=1e-4, **change))
    x, info = ft.solve(problem, ft.SolverConfig(tol=1e-4, backend="xla", **change))
    assert bool(info.converged)
