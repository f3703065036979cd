"""The port's batched solves (`field_interpolation_tpu_torch.batch`) against
the JAX package's ``batch`` module (its ``vmap``) on identical inputs.

* tests/test_batch.py's seven cases through both packages on the same numpy
  inputs (its three slow cases stay slow here);
* tests/test_solver.py's ``vmap`` + ``backend="pallas"`` case: the
  reference's Pallas kernels in interpret mode under ``vmap`` against the
  port's batched fused path (its plain versions on the CPU);
* the batched segment and apply (plain versions) against the reference's
  kernels under ``vmap`` and against per-lane single-field plain calls,
  ragged and frozen lanes included; the batched multigrid setup against
  the reference's per-lane setup;
* frozen lanes, warm starts, `_dense_coarsest_ok` against the reference's,
  the route each config takes, and `convert.problems_from_numpy`.

Bars (ROADMAP.md North star): float32 solves ±2 iterations and
2e-3·max|x| per lane; applies atol 1e-4·max|want|; refined solves a TRUE
≤ 1e-6 per lane against the float64 operator with the reported residual
within 2% of it.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import field_interpolation_tpu as fi
from field_interpolation_tpu import batch as jb
from field_interpolation_tpu.multigrid import build_fused_solver_operands as j_fused_ops
from field_interpolation_tpu.operators import assemble as jassemble
from field_interpolation_tpu.ops import pallas_stencil as ps

import field_interpolation_tpu_torch as ft
from field_interpolation_tpu_torch import batch as tb
from field_interpolation_tpu_torch import multigrid as tmg
from field_interpolation_tpu_torch import solver as tsolver
from field_interpolation_tpu_torch.convert import (fused_operands_from_numpy,
                                                   problems_from_numpy)
from field_interpolation_tpu_torch.ops import cycle as tcycle
from field_interpolation_tpu_torch.ops import pcg as tpcg
from field_interpolation_tpu_torch.ops import stencil as tst


def _cloud(rng, batch, n, shape):
    """tests/test_batch.py's clouds: a circle per lane, its own radius."""
    center = (np.asarray(shape) - 1.0) / 2.0
    theta = rng.uniform(0, 2 * np.pi, (batch, n))
    normals = np.stack([np.cos(theta), np.sin(theta)], axis=-1)
    radii = rng.uniform(0.2, 0.4, (batch, 1, 1)) * min(shape)
    pts = center + radii * normals
    return pts.astype(np.float32), normals.astype(np.float32)


def _tw(w: fi.Weights) -> ft.Weights:
    return ft.Weights(**vars(w))


def _tcfg(cfg: fi.SolverConfig) -> ft.SolverConfig:
    return ft.SolverConfig(**{f.name: getattr(cfg, f.name)
                              for f in dataclasses.fields(ft.SolverConfig)})


def _t(a):
    return torch.as_tensor(np.array(a))


def _lanes_agree(xt, it, xj, ij):
    """Per lane: iterations within ±2, x within 2e-3·max|x|."""
    xj, ij = np.asarray(xj), np.asarray(ij)
    assert tuple(xt.shape) == xj.shape
    assert it.dtype == torch.int32 and tuple(it.shape) == (xj.shape[0],)
    for i in range(xj.shape[0]):
        assert abs(int(it[i]) - int(ij[i])) <= 2, (i, np.asarray(it), ij)
        scale = np.abs(xj[i]).max()
        np.testing.assert_allclose(xt[i].numpy(), xj[i], atol=2e-3 * scale)


def _sdf_both(grid_shape, weights, pts, nrm, cfg, x0=None, precise=False):
    """The same clouds through both packages' batched SDF entry points."""
    j_fn = jb.sdf_from_points_precise_batch if precise else jb.sdf_from_points_batch
    t_fn = tb.sdf_from_points_precise_batch if precise else tb.sdf_from_points_batch
    xj, ij = j_fn(fi.Grid(grid_shape), weights, jnp.asarray(pts), jnp.asarray(nrm),
                  config=cfg, x0=None if x0 is None else jnp.asarray(x0))
    xt, it = t_fn(ft.Grid(grid_shape), _tw(weights), _t(pts), _t(nrm), config=_tcfg(cfg),
                  x0=None if x0 is None else _t(x0))
    return (xt, it), (xj, ij)


def _oracle_rel(grid_shape, weights, pts, nrm, x):
    """Per lane ‖b − A x‖/‖b‖ from the port's plain float64 operator of
    one field."""
    out = []
    for i in range(pts.shape[0]):
        pp = ft.assemble_precise(ft.Grid(grid_shape), _tw(weights), _t(pts[i]),
                                 torch.zeros(pts.shape[1]), gradients=_t(nrm[i]))
        out.append(float(torch.linalg.norm(pp.residual64(x[i].double()))
                         / torch.linalg.norm(pp.b64)))
    return np.asarray(out)


def _refined_bar(grid_shape, weights, pts, nrm, xt, it, tol=1e-6):
    assert bool(it.converged.all())
    true = _oracle_rel(grid_shape, weights, pts, nrm, xt)
    rep = it.rel_residual.numpy().astype(np.float64)
    assert (true <= tol).all(), true
    np.testing.assert_allclose(rep, true, rtol=0.02)


# ---------------------------------------------- tests/test_batch.py's cases

def test_batched_equals_individual(rng):
    grid = fi.Grid((24, 24))
    weights = fi.Weights(model_2=0.3)
    cfg = fi.SolverConfig(tol=1e-4, preconditioner="jacobi", maxiter=3000)
    pts, nrm = _cloud(rng, 5, 40, grid.shape)
    (xt, it), (xj, ij) = _sdf_both(grid.shape, weights, pts, nrm, cfg)
    assert bool(it.converged.all())
    _lanes_agree(xt, it.iterations, xj, ij.iterations)
    for i in range(5):  # and each lane its own single-field solve
        xi, ii = ft.sdf_from_points(ft.Grid(grid.shape), _tw(weights), _t(pts[i]),
                                    _t(nrm[i]), config=_tcfg(cfg))
        assert abs(int(it.iterations[i]) - int(ii.iterations)) <= 2
        np.testing.assert_allclose(xt[i].numpy(), xi.numpy(),
                                   atol=2e-3 * float(xi.abs().max()))


def test_batched_convergence_is_per_field(rng):
    """Finished lanes are frozen, not corrupted, while slow lanes run: an
    all-out-of-bounds lane is exactly 0 after 0 iterations."""
    grid = fi.Grid((16, 16))
    weights = fi.Weights(model_2=0.3)
    pts, nrm = _cloud(rng, 4, 30, grid.shape)
    pts[0] += 1e4
    cfg = fi.SolverConfig(tol=1e-4, preconditioner="jacobi", maxiter=3000)
    (xt, it), (xj, ij) = _sdf_both(grid.shape, weights, pts, nrm, cfg)
    assert bool(it.converged.all())
    assert torch.equal(xt[0], torch.zeros_like(xt[0])) and int(it.iterations[0]) == 0
    assert float(xt[1:].abs().max()) > 0.1
    _lanes_agree(xt, it.iterations, xj, ij.iterations)


def test_batched_multigrid(rng):
    grid = fi.Grid((32, 32))
    weights = fi.Weights(model_2=0.3)
    cfg = fi.SolverConfig(tol=1e-4, preconditioner="multigrid")
    pts, nrm = _cloud(rng, 3, 50, grid.shape)
    (xt, it), (xj, ij) = _sdf_both(grid.shape, weights, pts, nrm, cfg)
    assert bool(it.converged.all()) and int(it.iterations.max()) < 200
    _lanes_agree(xt, it.iterations, xj, ij.iterations)


def test_batched_value_interpolation(rng):
    grid = fi.Grid((20, 20))
    weights = fi.Weights(model_1=0.1, model_2=1.0)
    pos = rng.uniform(0, 19, (6, 25, 2)).astype(np.float32)
    vals = rng.standard_normal((6, 25)).astype(np.float32)
    jp = jb.assemble_batch(grid, weights, jnp.asarray(pos), jnp.asarray(vals),
                           with_gradient=False)
    xj, ij = jb.solve_batch(jp, fi.SolverConfig(tol=1e-4))
    tp = tb.assemble_batch(ft.Grid(grid.shape), _tw(weights), _t(pos), _t(vals),
                           with_gradient=False)
    for name in ("coeff", "b", "diag"):
        want = np.asarray(getattr(jp, name))
        np.testing.assert_allclose(getattr(tp, name).numpy(), want,
                                   atol=1e-4 * np.abs(want).max())
    xt, it = tb.solve_batch(tp, ft.SolverConfig(tol=1e-4))
    assert xt.shape == (6, 20, 20) and bool(it.converged.all())
    _lanes_agree(xt, it.iterations, xj, ij.iterations)


@pytest.mark.slow
def test_sdf_precise_batch_matches_unbatched(rng):
    grid = fi.Grid((32, 32))
    weights = fi.Weights(model_2=0.3)
    pts, nrm = _cloud(rng, 3, 50, grid.shape)
    cfg = fi.SolverConfig(tol=1e-6, preconditioner="multigrid", backend="xla",
                          maxiter=3000)
    (xt, it), (xj, ij) = _sdf_both(grid.shape, weights, pts, nrm, cfg, precise=True)
    assert xt.shape == (3, 32, 32) and xt.dtype == torch.float64
    _refined_bar(grid.shape, weights, pts, nrm, xt, it)
    for i in range(3):  # both are true-1e-6 solutions of the same system
        np.testing.assert_allclose(xt[i].numpy(), np.asarray(xj[i]),
                                   atol=1e-4 * np.abs(np.asarray(xj[i])).max())


@pytest.mark.slow
def test_batched_refined_to_1e6(rng):
    """A batch assembled in float64 (the legacy form) to TRUE 1e-6."""
    grid = fi.Grid((32, 32))
    weights = fi.Weights(model_2=0.3)
    B = 3
    theta = rng.uniform(0, 2 * np.pi, (B, 60))
    nrm = np.stack([np.cos(theta), np.sin(theta)], -1)
    pts = 15.5 + 10.0 * nrm
    cfg = fi.SolverConfig(tol=1e-6, preconditioner="multigrid", backend="xla")
    with jax.enable_x64():
        p64 = jax.vmap(lambda p, n: jassemble(grid, weights, p, jnp.zeros(60, jnp.float64),
                                              gradients=n))(
            jnp.asarray(pts, jnp.float64), jnp.asarray(nrm, jnp.float64))
    xj, ij = jb.solve_refined_batch(p64, cfg)
    tp64 = tb.assemble_batch(ft.Grid(grid.shape), _tw(weights), _t(pts),
                             torch.zeros(B, 60, dtype=torch.float64), gradients=_t(nrm))
    assert tp64.coeff.dtype == torch.float64
    xt, it = tb.solve_refined_batch(tp64, _tcfg(cfg))
    assert bool(it.converged.all()) and float(it.rel_residual.max()) <= 1e-6
    for i in range(B):
        np.testing.assert_allclose(xt[i].numpy(), np.asarray(xj[i]),
                                   atol=1e-4 * np.abs(np.asarray(xj[i])).max())


@pytest.mark.slow
def test_precise_batch_warm_start_cuts_iterations(rng):
    grid = fi.Grid((32, 32))
    weights = fi.Weights(model_2=0.3)
    pts, nrm = _cloud(rng, 3, 50, grid.shape)
    cfg = fi.SolverConfig(tol=1e-6, preconditioner="multigrid", backend="xla",
                          maxiter=3000)
    (xt, _), _ = _sdf_both(grid.shape, weights, pts, nrm, cfg, precise=True)
    pts2 = pts + 0.05 * rng.standard_normal(pts.shape).astype(np.float32)
    x0 = xt.numpy().astype(np.float32)
    (xw, iw), (_, ijw) = _sdf_both(grid.shape, weights, pts2, nrm, cfg, x0=x0,
                                   precise=True)
    (_, ic), _ = _sdf_both(grid.shape, weights, pts2, nrm, cfg, precise=True)
    _refined_bar(grid.shape, weights, pts2, nrm, xw, iw)
    assert int(iw.iterations.sum()) < int(ic.iterations.sum())
    assert abs(int(iw.iterations.sum()) - int(np.asarray(ijw.iterations).sum())) <= 2 * 3


# ------------------------------------ the reference's kernels under vmap

def test_batched_solve_vmap_pallas_matches_fused_batch(rng):
    """tests/test_solver.py's vmap + backend="pallas" case (the reference's
    Pallas segment and apply in interpret mode under vmap), B = 4 at 32²,
    against the port's batched fused path."""
    B, n = 4, 50
    theta = rng.uniform(0, 2 * np.pi, (B, n))
    nrm = np.stack([np.cos(theta), np.sin(theta)], -1).astype(np.float32)
    pts = (15.5 + 8.0 * nrm).astype(np.float32)
    cfg = fi.SolverConfig(tol=1e-4, preconditioner="multigrid", backend="pallas",
                          maxiter=2000)
    tcfg = dataclasses.replace(_tcfg(cfg), backend="auto")
    probs = tb.assemble_batch(ft.Grid((32, 32)), ft.Weights(model_2=0.3), _t(pts),
                              torch.zeros(B, n), gradients=_t(nrm))
    assert tb.solve_route(probs, tcfg) == "fused"
    xj, ij = jb.sdf_from_points_batch(fi.Grid((32, 32)), fi.Weights(model_2=0.3),
                                      jnp.asarray(pts), jnp.asarray(nrm), config=cfg)
    xt, it = tb.sdf_from_points_batch(ft.Grid((32, 32)), ft.Weights(model_2=0.3),
                                      _t(pts), _t(nrm), config=tcfg)
    assert bool(np.asarray(ij.converged).all()) and bool(it.converged.all())
    _lanes_agree(xt, it.iterations, xj, ij.iterations)


def _ref_lanes(shape, B, seed, cfg, n=60):
    """B reference problems (one per lane) and the port's batched problem
    carried across from them."""
    rng = np.random.default_rng(seed)
    pts, nrm = _cloud(rng, B, n, shape)
    jps = [jassemble(fi.Grid(shape), fi.Weights(model_2=0.3), jnp.asarray(pts[i]),
                     jnp.zeros(n, jnp.float32), gradients=jnp.asarray(nrm[i]))
           for i in range(B)]
    jstack = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *jps)
    return jps, problems_from_numpy(jstack, ft.Grid(shape), ft.Weights(model_2=0.3))


MODES = {"v": {}, "w": dict(mg_cycle="w"),
         "cheb": dict(mg_smoother="chebyshev4"),
         "cheb_galerkin": dict(mg_smoother="chebyshev4", mg_coarse_data="galerkin")}


@pytest.mark.parametrize("mode", ["v", "cheb_galerkin"])
def test_batched_setup_matches_reference_per_lane(mode):
    """The fused operands built for all lanes at once (per-lane τ, ρ̂,
    schedules and coarsest inverses) against the reference's built lane by
    lane."""
    cfg = fi.SolverConfig(**MODES[mode])
    jps, tp = _ref_lanes((32, 32), 3, 1, cfg)
    coeffs, sids, Rs, inv32, lw, cfs = tmg.build_fused_solver_operands(tp, _tcfg(cfg))
    for i, jp in enumerate(jps):
        jc, js, jR, jinv, jlw, jcf = j_fused_ops(jp, cfg)
        for got, want in zip(coeffs + sids, list(jc) + list(js)):
            want = np.asarray(want)
            np.testing.assert_allclose(got[i].numpy(), want, rtol=1e-5,
                                       atol=1e-6 * np.abs(want).max())
        for got, want in zip(Rs, jR):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        want = np.asarray(jinv)  # the port factors in float64 (ROADMAP §3)
        np.testing.assert_allclose(inv32[i].numpy(), want, atol=2e-4 * np.abs(want).max())
        if jcf is None:
            assert cfs is None
        else:
            for got, want in zip(cfs, jcf):
                np.testing.assert_allclose(got[i].numpy(), np.asarray(want), rtol=1e-5)


@pytest.mark.parametrize("mode", list(MODES))
def test_batched_plain_segment_matches_reference_under_vmap(mode):
    """`fused_pcg_solve_batch` (its plain version on CPU tensors) against the
    reference's `fused_pcg_solve` under vmap in interpret mode, on the
    reference's per-lane operands, with one ragged lane: budget 0."""
    cfg = fi.SolverConfig(**MODES[mode])
    B = 3
    jps, _ = _ref_lanes((32, 32), B, 2, cfg)
    ops = [j_fused_ops(jp, cfg) for jp in jps]
    stack = [np.stack([np.asarray(o[k][l]) for o in ops])
             for k in (0, 1) for l in range(len(ops[0][0]))]
    L = len(ops[0][0])
    coeffs, sids = stack[:L], stack[L:]
    inv = np.stack([np.asarray(o[3]) for o in ops])
    Rs, lw = ops[0][2], ops[0][4]
    cfs = None if ops[0][5] is None else [np.stack([np.asarray(o[5][l]) for o in ops])
                                         for l in range(len(ops[0][5]))]
    b = np.stack([np.asarray(jp.b) for jp in jps])
    tol2 = (1e-8 * np.sum(b.astype(np.float64) ** 2, axis=(1, 2))).astype(np.float32)
    budget = np.array([2000, 0, 2000], np.int32)
    wdepth = 99 if mode == "w" else 0

    def one(x, r, t2, bud, c, s, inv_c, cf):
        return ps.fused_pcg_solve(x, r, t2.reshape(1, 1), bud.reshape(1, 1), c, s, Rs,
                                  inv_c, lw, 3, True, cheb_coefs=cf, wdepth=wdepth)
    xj, itj, _ = jax.vmap(one)(jnp.zeros_like(jnp.asarray(b)), jnp.asarray(b),
                               jnp.asarray(tol2), jnp.asarray(budget),
                               [jnp.asarray(c) for c in coeffs],
                               [jnp.asarray(s) for s in sids], jnp.asarray(inv),
                               None if cfs is None else [jnp.asarray(c) for c in cfs])
    tc, ts, tR, tinv, tlw, _ = fused_operands_from_numpy(coeffs, sids, Rs, inv,
                                                         [_tw(w) for w in lw])
    tcf = None if cfs is None else [_t(c) for c in cfs]
    xt, itt, rrt = tpcg.fused_pcg_solve_batch(torch.zeros(b.shape), _t(b), _t(tol2),
                                              _t(budget), tc, ts, tR, tinv, tlw, 3,
                                              cheb_coefs=tcf, wdepth=wdepth)
    assert itt.dtype == torch.int32 and tuple(itt.shape) == (B,) and tuple(rrt.shape) == (B,)
    assert int(itt[1]) == 0 and torch.equal(xt[1], torch.zeros_like(xt[1]))
    _lanes_agree(xt, itt, xj, np.asarray(itj).reshape(B))


@pytest.mark.parametrize("mode", list(MODES))
def test_batched_plain_segment_matches_single_lanes(mode):
    """A lane of the batched plain segment against the same lane run alone
    (`fused_pcg_solve_plain`, the batched plain on one lane), on the port's
    own batched operands: a zero lane (b = 0), a lane with budget 0 and two
    working lanes, so other lanes never change a lane's result."""
    cfg = ft.SolverConfig(**MODES[mode])
    rng = np.random.default_rng(3)
    pts, nrm = _cloud(rng, 4, 60, (32, 32))
    pts[0] += 1e4
    tp = tb.assemble_batch(ft.Grid((32, 32)), ft.Weights(model_2=0.3), _t(pts),
                           torch.zeros(4, 60), gradients=_t(nrm))
    coeffs, sids, Rs, inv32, lw, cfs = tmg.build_fused_solver_operands(tp, cfg)
    b = tp.b
    tol2 = 1e-8 * torch.sum(b * b, dim=(1, 2))
    budget = torch.tensor([2000, 2000, 0, 2000], dtype=torch.int32)
    wdepth = tmg.resolve_wdepth(cfg, (32, 32)) if mode != "w" else 99
    x0 = torch.zeros_like(b)
    xb, ib, rrb = tpcg.fused_pcg_solve_batch(x0, b, tol2, budget, coeffs, sids, Rs,
                                             inv32, lw, 3, cheb_coefs=cfs, wdepth=wdepth)
    assert torch.equal(xb[0], x0[0]) and torch.equal(xb[2], x0[2])
    assert int(ib[0]) == 0 and int(ib[2]) == 0
    for i in (1, 3):
        xi, ii, rri = tpcg.fused_pcg_solve_plain(
            x0[i], b[i], tol2[i].reshape(1, 1), budget[i].reshape(1, 1),
            [c[i] for c in coeffs], [s[i] for s in sids], Rs, inv32[i], lw, 3,
            None if cfs is None else [c[i] for c in cfs], wdepth)
        assert abs(int(ib[i]) - int(ii)) <= 2
        np.testing.assert_allclose(xb[i].numpy(), xi.numpy(),
                                   atol=2e-3 * float(xi.abs().max()))


@pytest.mark.parametrize("shape", [(32, 32), (12, 10, 11)])
@pytest.mark.parametrize("diag", [False, True])
def test_batched_apply_matches_reference_under_vmap(shape, diag):
    """`fused_normal_apply_batch` (plain on CPU tensors) against the
    reference's `fused_normal_apply` under vmap in interpret mode (full
    data stencils: the reference kernel takes no bare diagonal), and against
    the single-field plain apply lane by lane."""
    rng = np.random.default_rng(4)
    B, nd = 3, len(shape)
    w = fi.Weights(model_1=0.2, model_2=0.3)
    cshape = (B,) + shape if diag else (B, 3 ** nd) + shape
    coeff = np.abs(rng.standard_normal(cshape)).astype(np.float32)
    x = rng.standard_normal((B,) + shape).astype(np.float32)
    got = tst.fused_normal_apply_batch(_t(x), _t(coeff), _tw(w), nd)
    if not diag:
        want = np.asarray(jax.vmap(lambda xi, ci: ps.fused_normal_apply(xi, ci, w, nd, True))(
            jnp.asarray(x), jnp.asarray(coeff)))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4 * np.abs(want).max())
    for i in range(B):
        one = tst.fused_normal_apply_plain(_t(x[i]), _t(coeff[i]), _tw(w), nd)
        np.testing.assert_allclose(got[i].numpy(), one.numpy(),
                                   atol=1e-4 * float(one.abs().max()))


# ------------------------------------------------------------ port rules

@pytest.mark.parametrize("cfg", [dict(preconditioner="multigrid"),
                                 dict(preconditioner="jacobi", maxiter=3000),
                                 dict(preconditioner="multigrid",
                                      mg_coarse_solver="jacobi")])
def test_zero_lanes_stay_zero_on_every_route(cfg):
    """b = 0 (every point out of bounds) gives exactly 0 after 0 iterations,
    converged, on the fused, plain-pcg and lane-by-lane routes, float32 and
    precise."""
    rng = np.random.default_rng(5)
    pts, nrm = _cloud(rng, 3, 40, (24, 24))
    pts[1] += 1e4
    g, w = ft.Grid((24, 24)), ft.Weights(model_2=0.3)
    c = ft.SolverConfig(tol=1e-4, **cfg)
    for fn, tol in ((tb.sdf_from_points_batch, 1e-4),
                    (tb.sdf_from_points_precise_batch, 1e-6)):
        x, info = fn(g, w, _t(pts), _t(nrm), config=dataclasses.replace(c, tol=tol))
        assert torch.equal(x[1], torch.zeros_like(x[1])), fn.__name__
        assert int(info.iterations[1]) == 0 and bool(info.converged.all())
        assert float(x[0].abs().max()) > 0.1


def test_warm_start_every_lane():
    """x0 warm-starts every lane: each lane's own solution as x0 converges
    in 0 iterations; x0 on one lane only leaves the others' solves alone."""
    rng = np.random.default_rng(6)
    pts, nrm = _cloud(rng, 3, 50, (32, 32))
    g, w = ft.Grid((32, 32)), ft.Weights(model_2=0.3)
    cfg = ft.SolverConfig(tol=1e-4)
    x, info = tb.sdf_from_points_batch(g, w, _t(pts), _t(nrm), config=cfg)
    xw, iw = tb.sdf_from_points_batch(g, w, _t(pts), _t(nrm), config=cfg, x0=x)
    assert bool(iw.converged.all()) and int(iw.iterations.max()) == 0
    assert torch.equal(xw, x)
    x0 = torch.zeros_like(x)
    x0[2] = x[2]
    xp, ip = tb.sdf_from_points_batch(g, w, _t(pts), _t(nrm), config=cfg, x0=x0)
    assert int(ip.iterations[2]) == 0
    assert torch.equal(ip.iterations[:2], info.iterations[:2])
    assert torch.equal(xp[:2], x[:2])


def test_refined_fused_batch_meets_true_bar(rng):
    """The batched precise entry point on the fused route (the default config) at
    TRUE 1e-6 per lane, and each lane's iterations against its single-field
    precise solve."""
    pts, nrm = _cloud(rng, 3, 50, (32, 32))
    g, w = ft.Grid((32, 32)), ft.Weights(model_2=0.3)
    cfg = ft.SolverConfig(tol=1e-6)
    probs = tb.assemble_precise_batch(g, w, _t(pts), torch.zeros(3, 50), gradients=_t(nrm))
    assert tb.solve_route(probs.p32, cfg) == "fused"
    xt, it = tb.solve_refined_batch(probs, cfg)
    _refined_bar((32, 32), fi.Weights(model_2=0.3), pts, nrm, xt, it)
    for i in range(3):
        xi, ii = ft.sdf_from_points_precise(g, w, _t(pts[i]), _t(nrm[i]), config=cfg)
        assert abs(int(it.iterations[i]) - int(ii.iterations)) <= 2
        np.testing.assert_allclose(xt[i].numpy(), xi.numpy(),
                                   atol=1e-4 * float(xi.abs().max()))


SHAPES_B = [((128, 128), 1024), ((128, 128), 4096), ((32, 32), 8), ((24, 24, 24), 16),
            ((64, 64), 3000), ((17,), 4), ((20, 20), 6)]
CONFIGS_B = [{}, dict(mg_min_size=8), dict(mg_coarse_solver="jacobi"),
             dict(mg_min_size=64)]


@pytest.mark.parametrize("shape,B", SHAPES_B)
@pytest.mark.parametrize("cfg", CONFIGS_B)
def test_dense_coarsest_ok_equals_reference(shape, B, cfg):
    assert (tb._dense_coarsest_ok(ft.Grid(shape), ft.SolverConfig(**cfg), B)
            == jb._dense_coarsest_ok(fi.Grid(shape), fi.SolverConfig(**cfg), B))


def _stub(shape, B=2, dtype=torch.float32):
    """A batched Problem for routing only: the route reads the grid, the
    dtype, the config and the number of lanes, nothing of the data (B
    lanes that view one stored field)."""
    z = torch.zeros(shape, dtype=dtype)
    c = torch.zeros((3 ** len(shape),) + shape, dtype=dtype)
    return ft.Problem(coeff=c.expand((B,) + c.shape), b=z.expand((B,) + shape),
                      diag=(z + 1.0).expand((B,) + shape), grid=ft.Grid(shape),
                      weights=ft.Weights(model_2=0.3))


ROUTE_CASES = [
    ((128, 128), {}, 1024, "fused"),                    # BASELINE config 3
    ((32, 32), dict(mg_smoother="chebyshev4", mg_coarse_data="galerkin"), 4, "fused"),
    ((32, 32), dict(mg_cycle="w"), 4, "fused"),
    ((128, 128), dict(preconditioner="jacobi"), 4, "pcg"),
    ((128, 128), dict(preconditioner="none"), 4, "pcg"),
    ((24, 24, 24), dict(preconditioner="jacobi"), 4, "pcg"),
    ((24, 24, 24), {}, 4, "cycle"),                     # 3-D
    ((1024, 1024), {}, 2, "cycle"),                     # past fits_vmem
    ((128, 128), dict(mg_post_smooth=2), 4, "cycle"),   # ν_pre ≠ ν_post
    ((128, 128), dict(mg_coarse_solver="jacobi"), 4, "cycle"),
    ((128, 128), {}, 4096, "cycle"),                    # _dense_coarsest_ok swaps
    ((128, 128), dict(backend="xla"), 4, "cycle"),
    ((6, 6), {}, 4, "cycle"),                           # degenerate hierarchy
    # The same rules on batches large enough for the batched segment:
    ((1024, 1024), {}, 1024, "cycle"),
    ((128, 128), dict(mg_post_smooth=2), 1024, "cycle"),
    ((128, 128), dict(mg_coarse_solver="jacobi"), 1024, "cycle"),
    ((128, 128), dict(backend="xla"), 1024, "cycle"),
    # One lane off the fused path (`_cycle_wins`: B ≥ 2):
    ((24, 24, 24), {}, 1, "lanes"),
    ((1024, 1024), {}, 1, "lanes"),
    # Batch size (`_batch_wins`: B ≥ 2 and one lane per 16384 nodes):
    ((32, 32), {}, 1, "lanes"),
    ((32, 32), {}, 2, "fused"),
    ((64, 64), {}, 2, "fused"),
    ((128, 128), {}, 1, "lanes"),
    ((128, 128), {}, 2, "fused"),
    ((256, 256), {}, 3, "lanes"),
    ((256, 256), {}, 4, "fused"),
]


@pytest.mark.parametrize("shape,cfg,B,route", ROUTE_CASES)
def test_route_per_config(shape, cfg, B, route):
    """The route each config takes, decided before anything is built; the
    fused route exactly where a single field takes the fused segment and
    the batch is large enough for it."""
    config = tb._batch_config(ft.Grid(shape), ft.SolverConfig(**cfg), B)
    assert tb.solve_route(_stub(shape, B), config) == route
    if math.prod(shape) <= 64 * 64:
        lane = tb.lane(_stub(shape), 0)
        single = tsolver._fused_solver_ops(lane, config) is not None
        if tb._batch_wins(ft.Grid(shape), B):
            assert single == (route == "fused")
        else:
            assert route != "fused"


def test_routes_launch_what_they_say(monkeypatch):
    """A spy on each route's work: the fused route runs one batched segment
    call per outer round for all lanes and no single-field solve; the cycle
    route (here the Jacobi coarsest) neither; the lane-by-lane route (one
    lane of that config) runs a single-field solve and no batched segment."""
    rng = np.random.default_rng(7)
    pts, nrm = _cloud(rng, 3, 50, (32, 32))
    g, w = ft.Grid((32, 32)), ft.Weights(model_2=0.3)
    calls = {"batch": 0, "single": 0}
    seg, single = tsolver.fused_pcg_solve_batch, tb.solve

    def spy_seg(x, *a, **k):
        calls["batch"] += 1
        assert x.shape[0] == 3
        return seg(x, *a, **k)

    def spy_single(*a, **k):
        calls["single"] += 1
        return single(*a, **k)
    monkeypatch.setattr(tsolver, "fused_pcg_solve_batch", spy_seg)
    monkeypatch.setattr(tb, "solve", spy_single)
    _, info = tb.sdf_from_points_batch(g, w, _t(pts), _t(nrm), config=ft.SolverConfig(tol=1e-4))
    assert calls == {"batch": 1, "single": 0} and bool(info.converged.all())
    calls.update(batch=0)
    jacobi = ft.SolverConfig(tol=1e-4, mg_coarse_solver="jacobi")
    _, info = tb.sdf_from_points_batch(g, w, _t(pts), _t(nrm), config=jacobi)
    assert calls == {"batch": 0, "single": 0} and bool(info.converged.all())
    tb.sdf_from_points_batch(g, w, _t(pts[:1]), _t(nrm[:1]), config=jacobi)
    assert calls == {"batch": 0, "single": 1}


def test_problems_from_numpy_feeds_both_packages(rng):
    """A reference batched Problem carried across solves to the reference's
    answer lane by lane (identical operands in both packages)."""
    grid, weights = fi.Grid((24, 24)), fi.Weights(model_2=0.3)
    pts, nrm = _cloud(rng, 4, 40, grid.shape)
    jp = jb.assemble_batch(grid, weights, jnp.asarray(pts), jnp.zeros((4, 40), jnp.float32),
                           gradients=jnp.asarray(nrm))
    tp = problems_from_numpy(jp, ft.Grid(grid.shape), _tw(weights))
    assert tp.coeff.shape == (4, 9, 24, 24) and tp.b.dtype == torch.float32
    for name in ("coeff", "b", "diag"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(), np.asarray(getattr(jp, name)))
    cfg = fi.SolverConfig(tol=1e-4, preconditioner="multigrid")
    xj, ij = jb.solve_batch(jp, cfg)
    xt, it = tb.solve_batch(tp, _tcfg(cfg))
    _lanes_agree(xt, it.iterations, xj, ij.iterations)
    jpp = jb.assemble_precise_batch(grid, weights, jnp.asarray(pts),
                                    jnp.zeros((4, 40), jnp.float32), gradients=jnp.asarray(nrm))
    tpp = problems_from_numpy(jpp, ft.Grid(grid.shape), _tw(weights))
    assert tpp.b64.shape == (4, 24, 24) and tpp.rows64.dtype == torch.float64
    x = torch.as_tensor(rng.standard_normal((4, 24, 24)))
    for i in range(4):
        np.testing.assert_array_equal(tpp.b64[i].numpy(), np.asarray(jpp.b64[i]))
        one = tb.lane(tpp, i)
        np.testing.assert_allclose(tpp.residual64(x)[i].numpy(),
                                   one.residual64(x[i]).numpy(), rtol=1e-12, atol=1e-9)


# ---- the batched segment's lane geometry (csrc/lane2d.cuh) ---------------

def _hierarchy(shape, **cfg):
    config = ft.SolverConfig(**cfg)
    shapes = [shape] + list(tmg.level_shapes(shape, config.mg_min_size,
                                             config.mg_coarse_solver))
    return shapes, [False] + [config.mg_coarse_data != "galerkin"] * (len(shapes) - 1)


@pytest.mark.parametrize("geometry", tpcg.LANE_GEOMETRIES, ids=str)
@pytest.mark.parametrize("shape,cfg", [((128, 128), {}), ((256, 256), {}), ((97, 130), {}),
                                       ((32, 32), {}), ((128, 128), dict(mg_cycle="w")),
                                       ((128, 128), dict(mg_coarse_data="galerkin")),
                                       ((64, 64), {}), ((45, 61), dict(mg_min_size=4)),
                                       ((256, 256), dict(mg_cycle="w", mg_coarse_data="galerkin"))],
                         ids=str)
def test_lane_plan_fills_its_share(shape, cfg, geometry):
    """A lane's shared memory stays within its share, never holds level
    0's own arrays, and leaves out no candidate that would still fit."""
    shapes, diags = _hierarchy(shape, **cfg)
    wdepth = tmg.resolve_wdepth(ft.SolverConfig(**cfg), shape)
    t, per_sm, mask, az0, nbytes = tpcg.lane_plan(shapes, diags, 3, wdepth, geometry)
    assert (t, per_sm) == geometry and 0 < nbytes <= tpcg.LANE_SMEM_BYTES[per_sm]
    assert not mask & 1 and az0 in (0, 1)
    bands, items = tpcg._lane_candidates(shapes, diags, 3, wdepth)
    chosen = [bool(mask >> l & 1) for l in range(1, len(shapes))] + [bool(az0)]
    assert nbytes == 4 * (bands + sum(w for (w, _), c in zip(items, chosen) if c))
    for (words, _), c in zip(items, chosen):
        assert c or nbytes + 4 * words > tpcg.LANE_SMEM_BYTES[per_sm]


@pytest.mark.parametrize("B,sms,want", [(1, 132, (1024, 1)), (132, 132, (1024, 1)),
                                        (133, 132, (256, 2)), (256, 132, (256, 2)),
                                        (264, 132, (256, 2)), (265, 132, (256, 2)),
                                        (396, 132, (256, 2)), (528, 132, (256, 2)),
                                        (700, 132, (256, 2)), (1024, 132, (256, 2)),
                                        (41, 40, (256, 2))])
def test_lane_geometry_follows_the_lanes(B, sms, want, monkeypatch):
    """One wide lane an SM while the lanes fit one wave of them; past it
    two narrow lanes an SM (the fewest waves, the fewest lanes an SM on a
    tie): the 1e-6 form's B = 256 and config 3's 1024 among them;
    LANE_GEOMETRY overrides the rule."""
    assert tpcg.lane_geometry(B, sms) == want
    monkeypatch.setattr(tpcg, "LANE_GEOMETRY", (256, 2))
    assert tpcg.lane_geometry(1, sms) == (256, 2)


def test_lane_plan_of_config3():
    """Config 3's 128² lanes: one lane an SM holds the 64², 32² and 16²
    levels (level 0's residual would pass the share); two lanes an SM the
    16² level and level 0's residual. A 32² lane holds both its arrays."""
    shapes, diags = _hierarchy((128, 128))
    assert tpcg.lane_plan(shapes, diags, geometry=(1024, 1))[:4] == (1024, 1, 0b1110, 0)
    assert tpcg.lane_plan(shapes, diags, geometry=(256, 2))[:4] == (256, 2, 0b1000, 1)
    assert tpcg.lane_plan(*_hierarchy((32, 32)), geometry=(1024, 1))[:4] == (1024, 1, 0b10, 1)
    with pytest.raises(ValueError, match="lane geometry"):
        tpcg.lane_plan(shapes, diags, geometry=(512, 4))


@pytest.mark.parametrize("shape,words", [((128, 128), 128), ((256, 256), 512), ((97, 130), 104),
                                         ((32, 32), 8), ((45, 61), 24), ((18, 10), 4)], ids=str)
def test_lane_plan_reserves_the_run_mask_first(shape, words):
    """Level 0's run mask (one bit a run of 4 nodes along axis 1, the last
    run of a row ragged; words rounded to 4) is held by every lane beside
    the transfer bands, before any coarse level or level 0's residual:
    97×130 has 97 · 33 = 3,201 runs, 101 words, 104 rounded."""
    shapes, diags = _hierarchy(shape, mg_min_size=4)
    assert tpcg._mask_words(shape) == words
    fixed, _ = tpcg._lane_candidates(shapes, diags, 3, 0)
    bands = sum(2 * tpcg._round4(nc) + nc * 4 + 2 * tpcg._round4(nf) + nf * 2
                for (f0, f1), (c0, c1) in zip(shapes, shapes[1:])
                for nf, nc in ((f0, c0), (f1, c1)))
    assert fixed == bands + words
    for geometry in tpcg.LANE_GEOMETRIES:
        assert tpcg.lane_plan(shapes, diags, 3, 0, geometry)[4] >= 4 * fixed


@pytest.mark.parametrize("geometry,before", [((1024, 1), (0b1110, 0, 141_568)),
                                             ((256, 2), (0b1000, 1, 84_224))], ids=str)
def test_lane_plan_of_config3_keeps_its_choice_with_the_mask(geometry, before):
    """At config 3's shapes the mask takes 128 words (4,096 runs), and
    each geometry keeps the coarse levels and level 0's residual it held
    without it: the bytes grow by the mask's 512 alone."""
    mask, az0, nbytes = before
    got = tpcg.lane_plan(*_hierarchy((128, 128)), geometry=geometry)
    assert got[2:] == (mask, az0, nbytes + 512)
    assert got[4] <= tpcg.LANE_SMEM_BYTES[geometry[1]]


def test_lane_data_runs_counted_by_hand():
    """`lane_data_runs` (csrc/lane2d.cuh:mark_runs' rule) against a count
    by hand on 64² lanes: a run of 4 nodes along axis 1 counts once when any
    of its 36 coefficients is nonzero (NaN too, −0.0 not); a lane that ran
    no iteration counts 0; a 64×10 lane's last run holds 2 nodes."""
    c = torch.zeros(3, 9, 64, 64)
    c[0, 4, 0, 0] = 1.0            # run (0, 0)
    c[0, 0, 10, 5] = c[0, 8, 10, 6] = 2.0   # both in run (10, 1)
    c[0, 3, 20, 7] = c[0, 5, 20, 8] = 3.0   # runs (20, 1) and (20, 2)
    c[0, 1, 30, 30] = float("nan")          # run (30, 7)
    c[0, 2, 40, 40] = -0.0                  # no run
    c[0, 7, 63, 63] = 1e-30                 # run (63, 15)
    c[1, 4, 5, 9] = 1.0
    c[2] = c[0]
    got = tpcg.lane_data_runs(c, torch.tensor([4, 1, 0], dtype=torch.int32))
    assert got.dtype == torch.int32 and got.tolist() == [6, 1, 0]
    r = torch.zeros(1, 9, 64, 10)
    r[0, 6, 3, 9] = r[0, 6, 4, 8] = 1.0     # both in the ragged run (·, 2) of rows 3, 4
    r[0, 6, 4, 7] = 1.0                     # run (4, 1)
    assert tpcg.lane_data_runs(r, torch.ones(1, dtype=torch.int32)).tolist() == [3]
    assert tpcg.lane_runs((64, 10)) == 192 and tpcg.lane_runs((64, 64)) == 1024


def test_lane_data_runs_of_an_assembled_lane():
    """On config 3's cloud at 64² (two lanes of 128 oriented points), the
    rule counts the runs a loop over rows and runs finds, and only a few
    percent of the runs hold data."""
    rng = np.random.default_rng(11)
    pts, nrm = _cloud(rng, 2, 128, (64, 64))
    probs = tb.assemble_batch(ft.Grid((64, 64)), ft.Weights(model_2=0.3), torch.as_tensor(pts),
                              torch.zeros(2, 128), gradients=torch.as_tensor(nrm))
    coeff = probs.coeff
    want = []
    for lane in range(2):
        nz = (coeff[lane] != 0).any(dim=0).tolist()
        want.append(sum(any(row[j:j + 4]) for row in nz for j in range(0, 64, 4)))
    got = tpcg.lane_data_runs(coeff, torch.ones(2, dtype=torch.int32)).tolist()
    assert got == want and all(0 < w < 0.25 * tpcg.lane_runs((64, 64)) for w in want)


def test_batched_segment_records_its_data_runs():
    """`fused_pcg_solve_batch` adds its lanes' data runs (none for a lane
    with budget 0) and the runs it offered to the open batch record's
    counters, and nothing without one."""
    from torch.profiler import ProfilerActivity, profile

    from field_interpolation_tpu_torch.utils import observe
    rng = np.random.default_rng(12)
    pts, nrm = _cloud(rng, 3, 60, (32, 32))
    probs = tb.assemble_batch(ft.Grid((32, 32)), ft.Weights(model_2=0.3), torch.as_tensor(pts),
                              torch.zeros(3, 60), gradients=torch.as_tensor(nrm))
    coeffs, sids, Rs, inv32, lw, _ = tmg.build_fused_solver_operands(
        probs, ft.SolverConfig(tol=1e-4))
    b = probs.b
    tol2 = 1e-8 * torch.sum(b * b, dim=(1, 2))
    budget = torch.tensor([50, 0, 50], dtype=torch.int32)
    args = (torch.zeros_like(b), b, tol2, budget, coeffs, sids, Rs, inv32, lw, 3)
    observe.clear_records()
    tpcg.fused_pcg_solve_batch(*args)
    assert observe.batch_records() == []
    with profile(activities=[ProfilerActivity.CPU]):
        with observe.span("batch"):
            _, iters, _ = tpcg.fused_pcg_solve_batch(*args)
    (rec,) = observe.batch_records()
    observe.clear_records()
    runs = tpcg.lane_data_runs(coeffs[0], iters)
    assert int(runs[1]) == 0 and int(runs[0]) > 0 and int(runs[2]) > 0
    assert rec["counters"] == {"runs_offered": 3 * 32 * 8, "data_runs": int(runs.sum())}


@pytest.mark.parametrize("shape", [(32, 32), (64, 64), (97, 130), (128, 128), (256, 256),
                                   (18, 10), (45, 61)], ids=str)
def test_lane_bands_fit_the_lane_body(shape):
    """The hierarchy's transfers keep ≤ 4 fine indices per restriction row
    and ≤ 2 coarse per prolongation row (csrc/lane2d.cuh's bands)."""
    tpcg._check_lane_bands(_hierarchy(shape, mg_min_size=4)[0])


def test_lane_bands_refuse_wider_transfers():
    with pytest.raises(ValueError, match="bands wider"):
        tpcg._check_lane_bands([(10, 10), (3, 3)])


def test_batch_tables_carry_the_lane_plan():
    """fi_pcg_segment_batch's int table: B, the scratch floats of a lane,
    the schedule strides, the lane geometry and plan with the plan's bytes
    (the kernel refuses a launch whose layout differs), then the cycle's
    ints."""
    rng = np.random.default_rng(3)
    pts, nrm = _cloud(rng, 3, 40, (32, 32))
    probs = tb.assemble_batch(ft.Grid((32, 32)), ft.Weights(model_2=0.3), torch.as_tensor(pts),
                              torch.zeros(3, 40), gradients=torch.as_tensor(nrm))
    coeffs, sids, Rs, inv32, lw, cfs = tmg.build_fused_solver_operands(
        probs, ft.SolverConfig(tol=1e-4))
    b = probs.b
    outs, ptrs, ints, w2s, keep = tpcg._batch_tables(
        torch.zeros_like(b), b, torch.ones(3), torch.full((3,), 5, dtype=torch.int32), coeffs,
        sids, Rs, inv32, lw, 3, 0, cfs)
    shapes, diags = _hierarchy((32, 32))
    L = len(shapes)
    assert ints[:2] == [3, keep[2].numel() // 3]
    assert ints[2:2 + tcycle.MAX_LEVELS] == [0] * tcycle.MAX_LEVELS
    threads, per_sm, mask, az0, nbytes = tpcg.lane_plan(shapes, diags, geometry=(1024, 1))
    assert ints[10:15] == [threads, mask, az0, per_sm, nbytes]
    assert ints[15:19] == [L, 3, 3, 0]
    assert len(ptrs) == 11 + 6 * L + 6 * (L - 1) + L and len(w2s) == 4 * L
    assert ptrs[10] == outs[3].data_ptr() and outs[3].dtype == torch.int32
    assert [tuple(t.shape) for t in outs] == [(3, 32, 32), (3,), (3,), (3,)]
