"""Debug mode, `SolverConfig(debug=True)`, against the reference's.

`sdf_from_points` and `interpolate` run the checked pipeline
(`sdf._debug_pipeline`, debugging.py): poisoned inputs raise ValueError
with the reference's messages (tests/test_debug.py's five cases, the same
``match=`` strings, each also raised by the reference), a clean debug solve
equals the reference's debug solve (±2 iterations, 2e-3·max|x|), and every
other entry point ignores the flag, as the reference does."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import field_interpolation_tpu as fi

import field_interpolation_tpu_torch as ft
from field_interpolation_tpu_torch import batch as tb

KW = dict(tol=1e-4, preconditioner="jacobi", maxiter=3000)
DBG, DBG_REF = ft.SolverConfig(**KW, debug=True), fi.SolverConfig(**KW, debug=True)


def _cloud(rng, n, shape):
    center = (np.asarray(shape) - 1.0) / 2.0
    theta = rng.uniform(0, 2 * np.pi, n)
    normals = np.stack([np.cos(theta), np.sin(theta)], axis=-1)
    pts = center + 0.3 * min(shape) * normals
    return pts.astype(np.float32), normals.astype(np.float32)


def _both_raise(match, port, ref):
    with pytest.raises(ValueError, match=match):
        port()
    with pytest.raises(Exception, match=match):
        ref()


def _sdf_both(shape, pts, nrm, pw=None, port_cfg=DBG, ref_cfg=DBG_REF, **kw):
    t = lambda a: None if a is None else torch.as_tensor(a)  # noqa: E731
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    return (lambda: ft.sdf_from_points(ft.Grid(shape), ft.Weights(model_2=0.3), t(pts),
                                       t(nrm), point_weights=t(pw), config=port_cfg, **kw),
            lambda: fi.sdf_from_points(fi.Grid(shape), fi.Weights(model_2=0.3), j(pts),
                                       j(nrm), point_weights=j(pw), config=ref_cfg, **kw))


@pytest.mark.parametrize("fmg_start", [False, 1])
def test_debug_clean_inputs_pass(rng, fmg_start):
    """A clean debug solve: converged, finite, and within ±2 iterations and
    2e-3·max|x| of the reference's debug solve."""
    pts, nrm = _cloud(rng, 30, (16, 16))
    port, ref = _sdf_both((16, 16), pts, nrm, fmg_start=fmg_start)
    (x, info), (xr, ir) = port(), ref()
    assert bool(info.converged) and bool(torch.isfinite(x).all())
    assert abs(int(info.iterations) - int(ir.iterations)) <= 2
    np.testing.assert_allclose(x.numpy(), np.asarray(xr),
                               atol=2e-3 * float(np.abs(np.asarray(xr)).max()))


def test_debug_nan_position_raises(rng):
    pts, nrm = _cloud(rng, 30, (16, 16))
    pts[3, 0] = np.nan
    _both_raise("non-finite sample position", *_sdf_both((16, 16), pts, nrm))


def test_debug_nan_weight_raises(rng):
    pts, nrm = _cloud(rng, 30, (16, 16))
    pw = np.ones(30, np.float32)
    pw[7] = np.nan
    _both_raise("non-finite point weight", *_sdf_both((16, 16), pts, nrm, pw))


def test_debug_negative_weight_raises(rng):
    pts, nrm = _cloud(rng, 30, (16, 16))
    pw = np.ones(30, np.float32)
    pw[2] = -1.0
    _both_raise("negative point weight", *_sdf_both((16, 16), pts, nrm, pw))


def test_debug_nan_normal_raises(rng):
    pts, nrm = _cloud(rng, 30, (16, 16))
    nrm[4, 1] = np.inf
    _both_raise("non-finite sample gradient", *_sdf_both((16, 16), pts, nrm))


def test_debug_out_of_bounds_raises(rng):
    """Checked before assembly, which would zero-weight the row silently."""
    pts, nrm = _cloud(rng, 30, (16, 16))
    pts[0] = (40.0, 2.0)
    _both_raise("outside the lattice", *_sdf_both((16, 16), pts, nrm))
    x, info = ft.sdf_from_points(ft.Grid((16, 16)), ft.Weights(model_2=0.3),
                                 torch.as_tensor(pts), torch.as_tensor(nrm),
                                 config=dataclasses.replace(DBG, debug=False))
    assert bool(info.converged)


def test_debug_interpolate_nan_value_raises(rng):
    pos = rng.uniform(0, 11, (20, 2)).astype(np.float32)
    vals = rng.standard_normal(20).astype(np.float32)
    vals[5] = np.inf
    _both_raise("non-finite sample value",
                lambda: ft.interpolate(ft.Grid((12, 12)), ft.Weights(model_2=1.0),
                                       torch.as_tensor(pos), torch.as_tensor(vals),
                                       config=DBG),
                lambda: fi.interpolate(fi.Grid((12, 12)), fi.Weights(model_2=1.0),
                                       jnp.asarray(pos), jnp.asarray(vals), config=DBG_REF))


def test_debug_interpolate_clean_matches_reference(rng):
    pos = rng.uniform(0, 11, (40, 2)).astype(np.float32)
    vals = rng.standard_normal(40).astype(np.float32)
    x, info = ft.interpolate(ft.Grid((12, 12)), ft.Weights(model_2=1.0),
                             torch.as_tensor(pos), torch.as_tensor(vals), config=DBG)
    xr, ir = fi.interpolate(fi.Grid((12, 12)), fi.Weights(model_2=1.0), jnp.asarray(pos),
                            jnp.asarray(vals), config=DBG_REF)
    assert bool(info.converged) and abs(int(info.iterations) - int(ir.iterations)) <= 2
    np.testing.assert_allclose(x.numpy(), np.asarray(xr),
                               atol=2e-3 * float(np.abs(np.asarray(xr)).max()))


def test_debug_problem_audit_raises():
    """Clean inputs, a singular system (no smoothness, every point weight
    zero): the solve gives a finite zero field, and `validate_problem`
    raises after it, naming its issues."""
    pts, nrm = _cloud(np.random.default_rng(1), 10, (8, 8))
    with pytest.raises(ValueError, match="validate_problem: all-zero diagonal"):
        ft.sdf_from_points(ft.Grid((8, 8)), ft.Weights(model_2=0.0),
                           torch.as_tensor(pts), torch.as_tensor(nrm),
                           point_weights=torch.zeros(10), config=DBG)


def test_debug_solves_with_plain_ops(rng, monkeypatch):
    """Debug mode solves with backend="xla", the reference's choice."""
    from field_interpolation_tpu_torch import sdf as tsdf
    seen = []
    inner = tsdf.solve
    monkeypatch.setattr(tsdf, "solve", lambda p, cfg, **kw: seen.append(cfg) or inner(
        p, cfg, **kw))
    pts, nrm = _cloud(rng, 30, (16, 16))
    _sdf_both((16, 16), pts, nrm)[0]()
    assert [(c.backend, c.debug) for c in seen] == [("xla", False)]


def _problem(rng, shape=(16, 16)):
    pts, nrm = _cloud(rng, 40, shape)
    return ft.assemble_sdf(ft.Grid(shape), ft.Weights(model_2=0.3), torch.as_tensor(pts),
                           torch.as_tensor(nrm)), pts, nrm


@pytest.mark.parametrize("entry", ["solve", "solve_refined", "sdf_from_points_precise",
                                   "interpolate_precise", "solve_batch"])
def test_debug_flag_ignored_elsewhere(rng, entry):
    """Where the reference ignores ``debug``, the port gives the same
    result with and without it."""
    p, pts, nrm = _problem(rng)
    grid, w = ft.Grid((16, 16)), ft.Weights(model_2=0.3)
    pts_t, nrm_t = torch.as_tensor(pts), torch.as_tensor(nrm)

    def run(cfg):
        if entry == "solve":
            return ft.solve(p, cfg)
        if entry == "solve_refined":
            return ft.solve_refined(ft.assemble_precise(grid, w, pts_t, torch.zeros(40),
                                                        gradients=nrm_t), cfg)
        if entry == "sdf_from_points_precise":
            return ft.sdf_from_points_precise(grid, w, pts_t, nrm_t, config=cfg)
        if entry == "interpolate_precise":
            return ft.interpolate_precise(grid, w, pts_t, torch.sin(pts_t[:, 0]), config=cfg)
        probs = tb.assemble_batch(grid, w, torch.stack([pts_t, pts_t.flip(0)]),
                                  torch.zeros(2, 40), gradients=torch.stack([nrm_t,
                                                                             nrm_t.flip(0)]))
        return tb.solve_batch(probs, cfg)

    cfg = ft.SolverConfig(tol=1e-6 if "precise" in entry or "refined" in entry else 1e-4)
    x, info = run(cfg)
    xd, infod = run(dataclasses.replace(cfg, debug=True))
    assert torch.equal(x, xd)
    assert torch.equal(torch.as_tensor(info.iterations), torch.as_tensor(infod.iterations))


def test_checked_call_runs_and_raises():
    """`debugging.checked_call`: the function's result, or the first
    failing check's ValueError (the reference's checkify messages)."""
    from field_interpolation_tpu_torch import debugging
    x = torch.ones(3)
    assert debugging.checked_call(lambda a: a * 2, x).tolist() == [2.0, 2.0, 2.0]
    with pytest.raises(ValueError, match="solver produced a non-finite field"):
        debugging.checked_call(debugging.check_solution, torch.tensor([1.0, float("nan")]))
    with pytest.raises(ValueError, match="non-finite sample position"):
        debugging.checked_call(debugging.check_sample_inputs, ft.Grid((4, 4)),
                               torch.tensor([[float("inf"), 1.0]]))
