"""The batched multigrid cycle (`batch.py`'s ``"cycle"`` route) against the
JAX package's cycle and solves under ``vmap``, on identical numpy inputs.

* The cycle: `multigrid.make_vcycle_preconditioner(kernels=True)` on a
  problem with lanes (on CPU tensors every smoothing and whole-cycle call is
  its kernel's plain version) against ``jax.vmap`` of the reference's
  ``make_vcycle_preconditioner``: 3-D lumped and Galerkin, 2-D with the
  Jacobi coarsest, ν_pre ≠ ν_post, Chebyshev, W, and the lumped W whole
  cycle. Bar 1e-5·max|want|. The reference runs its Pallas kernels in
  interpret mode (``pallas_smooth=True``) on the 2-D cases with dense
  coarsest levels, and its XLA cycle, the same smoothing arithmetic, where
  the kernels' interpret-mode compile takes 15-25 s a case (3-D; the Jacobi
  coarsest's 32 sweeps); tests/test_torch_smooth_phase.py holds the
  smoothing phases to those kernels.
* The same batched cycle against the port's single-field cycle lane by lane.
  Bar 2e-6·max|z|: the batched float64 Cholesky and the batched coarsest
  product sum in another order than one lane's (the Jacobi coarsest, which
  has neither, agrees to the bit).
* The solves: `solve_batch` against the reference's ``solve_batch`` on 16³
  × 3 lanes and on 48² with ``mg_coarse_solver="jacobi"`` (each lane within
  ±2 iterations and 2e-3·max|x|); `sdf_from_points_precise_batch` on 16³ ×
  2 lanes (a TRUE ≤ 1e-6 against the port's plain float64 operator, the
  reported residual within 2% of it).
* The route's work: a spy shows one smoothing-wrapper call per phase with
  [B, ...] operands (as many calls as one field's cycle makes), one
  whole-cycle call per cycle for all lanes, and no single-field solve.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import field_interpolation_tpu as fi
from field_interpolation_tpu import batch as jb
from field_interpolation_tpu import multigrid as jmg
from field_interpolation_tpu.operators import assemble as jassemble

import field_interpolation_tpu_torch as ft
from field_interpolation_tpu_torch import batch as tb
from field_interpolation_tpu_torch import multigrid as tmg
from field_interpolation_tpu_torch.convert import problems_from_numpy
from field_interpolation_tpu_torch.ops import cycle as tcycle

W = dict(model_2=0.3)

# (grid, config change, the reference runs its Pallas kernels). 16³ with
# mg_min_size 4: a smoothed 8³ level above the 4³ coarsest.
CASES = {
    "3d_lumped": ((16, 16, 16), dict(mg_fine_operator="lumped", mg_min_size=4), False),
    "3d_galerkin": ((16, 16, 16), dict(mg_coarse_data="galerkin", mg_min_size=4), False),
    "2d_jacobi_coarsest": ((48, 48), dict(mg_coarse_solver="jacobi"), False),
    "2d_pre_ne_post": ((64, 64), dict(mg_post_smooth=2), True),
    "2d_chebyshev": ((64, 64), dict(mg_smoother="chebyshev4"), True),
    "2d_w": ((64, 64), dict(mg_cycle="w"), True),
    "2d_w_lumped_whole_cycle": ((64, 64), dict(mg_cycle="w", mg_fine_operator="lumped"),
                                True),
}


def _tcfg(cfg: fi.SolverConfig) -> ft.SolverConfig:
    return ft.SolverConfig(**{f.name: getattr(cfg, f.name)
                              for f in dataclasses.fields(ft.SolverConfig)})


def _clouds(shape, B, seed, n=120):
    """B clouds of oriented points (numpy, seeded): inside the grid for a
    cycle's operands, a circle or sphere per lane for a solve."""
    rng = np.random.default_rng(seed)
    D = len(shape)
    pts = rng.uniform(1, np.asarray(shape) - 2, (B, n, D)).astype(np.float32)
    nrm = rng.standard_normal((B, n, D)).astype(np.float32)
    return pts, nrm, rng


def _spheres(shape, B, seed, n):
    """Per lane n oriented points on a circle (2-D) or sphere (3-D) about
    the center, its own radius (tests/test_batch.py's clouds)."""
    rng = np.random.default_rng(seed)
    D = len(shape)
    nrm = rng.standard_normal((B, n, D))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    radii = rng.uniform(0.2, 0.4, (B, 1, 1)) * min(shape)
    pts = (np.asarray(shape) - 1.0) / 2.0 + radii * nrm
    return pts.astype(np.float32), nrm.astype(np.float32)


def _both(shape, pts, nrm):
    """The reference's batched problem and the port's, carried across."""
    B, n = pts.shape[:2]
    jps = [jassemble(fi.Grid(shape), fi.Weights(**W), jnp.asarray(pts[i]),
                     jnp.zeros(n, jnp.float32), gradients=jnp.asarray(nrm[i]))
           for i in range(B)]
    js = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *jps)
    return js, problems_from_numpy(js, ft.Grid(shape), ft.Weights(**W))


@pytest.mark.parametrize("case", list(CASES))
def test_batched_cycle_matches_reference_under_vmap(case):
    shape, change, pallas = CASES[case]
    pts, nrm, rng = _clouds(shape, 3, 1)
    js, tp = _both(shape, pts, nrm)
    r = rng.standard_normal((3,) + shape).astype(np.float32)
    cfg = fi.SolverConfig(**change)
    want = np.asarray(jax.vmap(lambda p, rr: jmg.make_vcycle_preconditioner(
        p, cfg, pallas_smooth=pallas, pallas_interpret=True)(rr))(js, jnp.asarray(r)))
    got = tmg.make_vcycle_preconditioner(tp, _tcfg(cfg), kernels=True)(torch.as_tensor(r))
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("kernels", [True, False])
@pytest.mark.parametrize("case", list(CASES))
def test_batched_cycle_equals_single_field_lanes(case, kernels):
    shape, change, _ = CASES[case]
    pts, nrm, rng = _clouds(shape, 3, 2)
    _, tp = _both(shape, pts, nrm)
    r = torch.as_tensor(rng.standard_normal((3,) + shape).astype(np.float32))
    cfg = ft.SolverConfig(**change)
    z = tmg.make_vcycle_preconditioner(tp, cfg, kernels=kernels)(r)
    for i in range(3):
        zi = tmg.make_vcycle_preconditioner(tb.lane(tp, i), cfg, kernels=kernels)(r[i])
        np.testing.assert_allclose(z[i].numpy(), zi.numpy(),
                                   atol=2e-6 * float(zi.abs().max()))


def _lanes_agree(xt, info, xj, ij):
    """Per lane: iterations within ±2, x within 2e-3·max|x|."""
    xj, it = np.asarray(xj), np.asarray(ij.iterations)
    assert tuple(xt.shape) == xj.shape and bool(info.converged.all())
    for i in range(xj.shape[0]):
        assert abs(int(info.iterations[i]) - int(it[i])) <= 2, (i, info.iterations, it)
        np.testing.assert_allclose(xt[i].numpy(), xj[i], atol=2e-3 * np.abs(xj[i]).max())


@pytest.mark.parametrize("shape,B,change", [((16, 16, 16), 3, {}),
                                            ((48, 48), 3, dict(mg_coarse_solver="jacobi"))],
                         ids=["16cubed_x3", "48sq_jacobi_coarsest"])
def test_solve_batch_cycle_route_matches_reference(shape, B, change):
    pts, nrm = _spheres(shape, B, 3, 400 if len(shape) == 3 else 80)
    js, tp = _both(shape, pts, nrm)
    cfg = fi.SolverConfig(tol=1e-4, **change)
    assert tb.solve_route(tp, tb._batch_config(tp.grid, _tcfg(cfg), B)) == "cycle"
    xj, ij = jb.solve_batch(js, cfg)
    xt, it = tb.solve_batch(tp, _tcfg(cfg))
    _lanes_agree(xt, it, xj, ij)


def test_precise_batch_cycle_route_meets_true_bar():
    shape, B = (16, 16, 16), 2
    pts, nrm = _spheres(shape, B, 4, 400)
    g, w = ft.Grid(shape), ft.Weights(**W)
    cfg = ft.SolverConfig(tol=1e-6)
    x, info = tb.sdf_from_points_precise_batch(g, w, torch.as_tensor(pts),
                                               torch.as_tensor(nrm), config=cfg)
    assert x.dtype == torch.float64 and bool(info.converged.all())
    for i in range(B):
        pp = ft.assemble_precise(g, w, torch.as_tensor(pts[i]), torch.zeros(pts.shape[1]),
                                 gradients=torch.as_tensor(nrm[i]))
        true = float(torch.linalg.norm(pp.residual64(x[i])) / torch.linalg.norm(pp.b64))
        assert true <= 1e-6
        assert abs(float(info.rel_residual[i]) - true) <= 0.02 * true


SPY_CASES = {"3d_lumped": ((16, 16, 16), dict(mg_fine_operator="lumped", mg_min_size=4)),
             "2d_jacobi_coarsest": ((48, 48), dict(mg_coarse_solver="jacobi")),
             "2d_w_lumped_whole_cycle": ((64, 64), dict(mg_cycle="w",
                                                        mg_fine_operator="lumped"))}


@pytest.mark.parametrize("case", list(SPY_CASES))
def test_cycle_route_calls_each_kernel_once_for_all_lanes(case, monkeypatch):
    shape, change = SPY_CASES[case]
    B = 3
    pts, nrm = _spheres(shape, B, 5, 400 if len(shape) == 3 else 80)
    _, tp = _both(shape, pts, nrm)
    cfg = ft.SolverConfig(tol=1e-4, **change)
    calls = []

    def spy(name, fn):
        def wrapped(r, *a, **k):
            calls.append((name, tuple(r.shape)))
            return fn(r, *a, **k)
        return wrapped

    for name in ("fused_smooth", "fused_smooth_2d"):
        monkeypatch.setattr(tmg, name, spy(name, getattr(tmg, name)))
    for name in ("fused_wcycle_2d", "fused_vcycle_2d"):
        monkeypatch.setattr(tcycle, name, spy(name, getattr(tcycle, name)))
    singles = []
    single = tb.solve
    monkeypatch.setattr(tb, "solve", lambda *a, **k: singles.append(1) or single(*a, **k))

    r = torch.as_tensor(np.random.default_rng(6).standard_normal((B,) + shape),
                        dtype=torch.float32)
    tmg.make_vcycle_preconditioner(tb.lane(tp, 0), cfg, kernels=True)(r[0])
    one_field = [name for name, _ in calls]
    calls.clear()
    tmg.make_vcycle_preconditioner(tp, cfg, kernels=True)(r)
    assert [name for name, _ in calls] == one_field and one_field
    assert all(s[0] == B and len(s) == len(shape) + 1 for _, s in calls)
    whole = "whole_cycle" in case
    assert any(name.startswith("fused_wcycle") for name in one_field) == whole

    calls.clear()
    x, info = tb.solve_batch(tp, cfg)
    assert tb.solve_route(tp, cfg) == "cycle" and bool(info.converged.all())
    assert not singles and calls and all(s[0] == B and len(s) == len(shape) + 1
                                         for _, s in calls)
    cycles = sum(name.startswith("fused_wcycle") for name, _ in calls)
    assert (cycles > 0) == whole
