"""The smoothing phase with its residual, against the JAX package, on the
same numpy-seeded inputs:

* `fused_smooth(..., residual=True)` (on CPU tensors `fused_smooth_plain`,
  the function csrc/jacobi_sweep.cu computes): its z against the
  reference's ``fused_smooth`` (Jacobi and Chebyshev) in interpret mode,
  its r − A z against the reference's plain operator on the reference's z;
  2-D at 64² and 3-D at 24³, diagonal and 3^D-channel data, from zero and
  from z, ν = 0..3; `fused_sweep` with the residual against
  ``fused_sweep_striped2_3d`` and ``fused_sweep_striped_diag``. Bars: z
  within 2e-5·max|z| and the residual within 2e-5·max|r − A z| (the card
  tests' bars; here both sides are float32 XLA and torch ops).
* `make_vcycle_preconditioner(kernels=True)` — whose per-sweep levels take
  the residual they restrict from the smoothing call — against the
  reference's plain cycle (``backend="xla"``) at 24³ (lumped fine level)
  and 64² (lumped fine level, ν_pre ≠ ν_post, so no whole-cycle kernel),
  V and W, at tests/test_torch_multigrid.py's bar rtol 1e-4.
* the residual the cycle takes from a smoothing call equals its own
  r − A z, and where no smoothing call runs (ν_post = 0) the cycle
  computes r − A z itself."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import field_interpolation_tpu as fi
from field_interpolation_tpu import multigrid as jmg
from field_interpolation_tpu import stencils as jstencils
from field_interpolation_tpu.constraints import data_apply as jdata_apply
from field_interpolation_tpu.constraints import data_diag
from field_interpolation_tpu.operators import assemble as jassemble
from field_interpolation_tpu.ops import pallas_stencil as ps

import field_interpolation_tpu_torch as ft
from field_interpolation_tpu_torch import multigrid as tmg
from field_interpolation_tpu_torch.convert import problem_from_numpy
from field_interpolation_tpu_torch.ops import smooth
from field_interpolation_tpu_torch.ops.smooth import fused_smooth, fused_sweep
from field_interpolation_tpu_torch.ops.stencil import fused_normal_apply_plain

SHAPES = {2: (64, 64), 3: (24, 24, 24)}
W = dict(model_1=0.2, model_2=1.0)


def _operands(shape, weights_kw, diag, seed=0, n=200):
    """numpy (r, z, coeff, sid) of an assembled reference problem; coeff is
    the data stencil or, with ``diag``, its center plane; sid = 0.3/D."""
    rng = np.random.default_rng(seed)
    D = len(shape)
    pos = rng.uniform(0, np.asarray(shape) - 1, (n, D)).astype(np.float32)
    vals = rng.standard_normal(n).astype(np.float32)
    grads = rng.standard_normal((n, D)).astype(np.float32)
    jp = jassemble(fi.Grid(shape), fi.Weights(**weights_kw), jnp.asarray(pos),
                   jnp.asarray(vals), gradients=jnp.asarray(grads))
    coeff = data_diag(jp.coeff, D) if diag else jp.coeff
    sid = jnp.where(jp.diag > 0, 0.3 / jp.diag, 1.0)
    r = rng.standard_normal(shape).astype(np.float32)
    z = rng.standard_normal(shape).astype(np.float32)
    return r, z, np.array(coeff, np.float32), np.array(sid, np.float32)


def _ref_residual(r, z, coeff, weights_kw, ndim):
    """r − A z with the reference's plain operator (XLA ops)."""
    z = jnp.asarray(z)
    s = jstencils.smoothness_apply(z, fi.Weights(**weights_kw), ndim)
    data = (jnp.asarray(coeff) * z if coeff.ndim == ndim
            else jdata_apply(z, jnp.asarray(coeff), ndim))
    return np.asarray(jnp.asarray(r) - (s + data))


def _close(got, want, bar=2e-5):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=bar * np.abs(want).max())


def _t(*arrays):
    return [torch.as_tensor(np.array(a)) for a in arrays]


@pytest.mark.parametrize("sweeps", [0, 1, 2, 3])
@pytest.mark.parametrize("from_zero", [False, True])
@pytest.mark.parametrize("diag", [False, True])
@pytest.mark.parametrize("kind", ["jacobi", "chebyshev4"])
@pytest.mark.parametrize("ndim", [2, 3])
def test_phase_with_residual_matches_reference(ndim, kind, diag, from_zero, sweeps):
    r, z, coeff, sid = _operands(SHAPES[ndim], W, diag)
    cf = None
    if kind != "jacobi":
        # Chebyshev takes D⁻¹ unscaled and the [ν, 2] schedule.
        sid = sid / 0.3
        cf = jmg.chebyshev_coefs(jnp.float32(2.0), sweeps, fi.SolverConfig(mg_smoother=kind))
    if cf is not None and sweeps == 0:
        # The reference's cycle never calls its kernel at ν = 0; its
        # Chebyshev phase is then zeros from zero and z from z.
        want = np.zeros_like(r) if from_zero else z
    else:
        want = np.asarray(ps.fused_smooth(
            *(jnp.asarray(a) for a in (r, z, coeff, sid)), fi.Weights(**W), ndim, sweeps,
            from_zero=from_zero, interpret=True, diag_data=diag,
            cheb_coefs=None if cf is None else {sweeps: cf}))
    got, res = fused_smooth(*_t(r, z, coeff, sid), ft.Weights(**W), ndim, sweeps,
                            from_zero, None if cf is None else _t(cf)[0], residual=True)
    assert got.dtype == res.dtype == torch.float32
    assert tuple(got.shape) == tuple(res.shape) == r.shape
    _close(got, want)
    _close(res, _ref_residual(r, want, coeff, W, ndim))


@pytest.mark.parametrize("weights_kw", [W, dict(model_2=0.5, model_3=0.8)])
@pytest.mark.parametrize("ndim", [2, 3])
def test_single_sweep_with_residual_matches_striped_kernels(ndim, weights_kw):
    """One sweep from z with its residual, against the reference's striped
    sweeps: fused_sweep_striped2_3d cut into 2×2 tiles, fused_sweep_
    striped_diag into four stripes."""
    shape = (64, 48) if ndim == 2 else (16, 16, 12)
    r, z, cdiag, sid = _operands(shape, weights_kw, True, seed=1)
    args = [jnp.asarray(a) for a in (r, z, cdiag, sid)]
    if ndim == 3:
        want = ps.fused_sweep_striped2_3d(*args, fi.Weights(**weights_kw), tiles=(8, 8),
                                          interpret=True)
    else:
        want = ps.fused_sweep_striped_diag(*args, fi.Weights(**weights_kw), stripe=16,
                                           interpret=True)
    got, res = fused_sweep(*_t(r, z, cdiag, sid), ft.Weights(**weights_kw), residual=True)
    _close(got, want)
    _close(res, _ref_residual(r, want, cdiag, weights_kw, ndim))


def _pair(shape, n=300, seed=0):
    """The reference's Problem and the port's copy: oriented points on a
    circle or sphere (tests/test_torch_multigrid.py:_pair in 2-D)."""
    rng = np.random.default_rng(seed)
    nrm = rng.standard_normal((n, len(shape)))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    pos = (np.asarray(shape) - 1) / 2.0 + 0.3 * min(shape) * nrm
    jp = jassemble(fi.Grid(shape), fi.Weights(model_2=0.3),
                   jnp.asarray(pos, jnp.float32), jnp.zeros(n, jnp.float32),
                   gradients=jnp.asarray(nrm, jnp.float32))
    tp = problem_from_numpy(jp.coeff, jp.b, jp.diag, ft.Grid(shape),
                            ft.Weights(model_2=0.3))
    return jp, tp


# The per-sweep route's cycles: every level diagonal (the lumped fine level),
# ν_pre ≠ ν_post in 2-D so that no whole-cycle kernel takes the cycle.
CYCLES = [((24, 24, 24), dict(mg_fine_operator="lumped", mg_cycle="v")),
          ((24, 24, 24), dict(mg_fine_operator="lumped", mg_cycle="w")),
          ((64, 64), dict(mg_fine_operator="lumped", mg_pre_smooth=2, mg_cycle="v")),
          ((64, 64), dict(mg_fine_operator="lumped", mg_pre_smooth=2, mg_cycle="w"))]


@pytest.mark.parametrize("smoother", ["jacobi", "chebyshev4"])
@pytest.mark.parametrize("shape,change", CYCLES, ids=["24-v", "24-w", "64-v", "64-w"])
def test_kernel_cycle_matches_reference_cycle(shape, change, smoother):
    jp, tp = _pair(shape)
    change = dict(change, mg_smoother=smoother)
    cfg = ft.SolverConfig(**change)
    levels = tmg.build_levels(tp, cfg)
    assert tmg.kernel_plan(tp, cfg, levels, True)[1] is None
    r = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    want = jmg.make_vcycle_preconditioner(jp, fi.SolverConfig(**change))(jnp.asarray(r))
    got = tmg.make_vcycle_preconditioner(tp, cfg, kernels=True)(torch.as_tensor(r))
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("post", [3, 0])
@pytest.mark.parametrize("shape", [(24, 24, 24), (64, 64)])
def test_cycle_takes_the_residual_from_the_smoothing_call(monkeypatch, shape, post):
    """Every residual the W-cycle restricts or revisits comes from a
    smoothing call and equals that level's r − A z; with ν_post = 0 the
    second visit's residual is the cycle's own r − A z (one level apply
    per W step), and the cycle equals the plain one (kernels=False)."""
    _, tp = _pair(shape)
    change = dict(mg_fine_operator="lumped", mg_cycle="w", mg_post_smooth=post)
    if len(shape) == 2:
        change["mg_pre_smooth"] = 2
    cfg = ft.SolverConfig(**change)
    calls, applies = [], []
    inner = smooth.fused_smooth

    def spy(r, z, coeff, sid, weights, ndim, sweeps, from_zero=False, cheb_coefs=None,
            residual=False):
        out = inner(r, z, coeff, sid, weights, ndim, sweeps, from_zero, cheb_coefs, residual)
        if residual:
            calls.append((out, fused_normal_apply_plain(out[0], coeff, weights, ndim), r))
        return out

    level_apply = tmg._Level.apply

    def apply_spy(self, x):
        applies.append(self.shape)
        return level_apply(self, x)

    monkeypatch.setattr(tmg, "fused_smooth", spy)
    monkeypatch.setattr(tmg._Level, "apply", apply_spy)
    r = torch.as_tensor(np.random.default_rng(4).standard_normal(shape).astype(np.float32))
    got = tmg.make_vcycle_preconditioner(tp, cfg, kernels=True)(r)
    levels = tmg.build_levels(tp, cfg)
    # Two levels below the fine one: a W step on level 1 only, the
    # coarsest solved densely.
    assert len(levels) == 2 and tmg.resolve_wdepth(cfg, shape) >= 1
    # Pre-smoothing of the fine level and of both visits of level 1; the
    # first visit's post-smoothing where it runs.
    assert len(calls) == 3 + (post > 0)
    assert applies == ([] if post else [levels[0].shape])
    for (z, res), az, rl in calls:
        _close(res, rl - az)
    monkeypatch.undo()
    want = tmg.make_vcycle_preconditioner(tp, cfg)(r)
    _close(got, want, 1e-4)
