"""The 2-D 9-channel smoothing phase with its residual, against the JAX
package, on the same numpy-seeded inputs:

* `fused_smooth_2d(..., residual=True)` (on CPU tensors `fused_smooth_plain`,
  the function csrc/jacobi_multisweep2d.cu computes): its z against the
  reference's whole-level 2-D ``fused_smooth`` (ν = 0..5, so phases that
  take several launches on the card are covered) and against
  ``fused_smooth_striped`` and ``fused_smooth_tiled`` as far as their 8-row
  halo reaches, all in interpret mode, Jacobi and Chebyshev, radius 2 and 3,
  from zero and from z; its r − A z against the reference's plain operator
  on the reference's z. Bars: z within 2e-5·max|z| and the residual within
  2e-5·max|r − A z| (the card tests' bars; here both sides are float32 XLA
  and torch ops).
* `make_vcycle_preconditioner(kernels=True)` on 2-D hierarchies whose
  9-channel levels (the fine level; with Galerkin coarse data every level)
  smooth through `fused_smooth_2d` and take the residual they restrict from
  it, against the reference's plain cycle, V and W, ν_post = 0 included, at
  tests/test_torch_multigrid.py's bar rtol 1e-4.
* the residual the cycle takes from each 9-channel smoothing call equals
  that level's r − A z, and no level apply computes it (a spy on
  `multigrid.fused_smooth_2d`, `_Level.apply` and the fine apply).
* the route of each 9-channel phase: the multi-sweep kernel below radius 3,
  the per-sweep kernel (`fused_smooth`) at radius 3, where it is the faster
  on every such phase measured on the card (PERF.md); a spy on both
  wrappers, and the cycle against the reference's at both radii."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import field_interpolation_tpu as fi
from field_interpolation_tpu import multigrid as jmg
from field_interpolation_tpu import stencils as jstencils
from field_interpolation_tpu.constraints import data_apply as jdata_apply
from field_interpolation_tpu.operators import assemble as jassemble
from field_interpolation_tpu.ops import pallas_stencil as ps

import field_interpolation_tpu_torch as ft
from field_interpolation_tpu_torch import multigrid as tmg
from field_interpolation_tpu_torch.convert import problem_from_numpy
from field_interpolation_tpu_torch.ops.smooth import fused_smooth_2d
from field_interpolation_tpu_torch.ops.stencil import fused_normal_apply_plain

# By operator radius: the weights of tests/test_torch_smooth2d.py.
WEIGHTS = {2: dict(model_1=0.2, model_2=1.0), 3: dict(model_2=0.5, model_3=0.8)}


@functools.lru_cache(maxsize=None)
def _assembled(shape, radius, seed=0, n=80):
    """numpy (r, z, coeff, D) of an assembled reference problem."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, np.asarray(shape) - 1, (n, 2)).astype(np.float32)
    vals = rng.standard_normal(n).astype(np.float32)
    jp = jassemble(fi.Grid(shape), fi.Weights(**WEIGHTS[radius]), jnp.asarray(pos),
                   jnp.asarray(vals))
    r = rng.standard_normal(shape).astype(np.float32)
    z = rng.standard_normal(shape).astype(np.float32)
    return r, z, np.array(jp.coeff, np.float32), np.array(jp.diag, np.float32)


def _operands(shape, radius, kind, sweeps):
    """(r, z, coeff, sid, cf): sid = 0.3/D under Jacobi, D⁻¹ and the [ν, 2]
    schedule cf (numpy) under Chebyshev."""
    r, z, coeff, diag = _assembled(shape, radius)
    if kind == "jacobi":
        return r, z, coeff, np.where(diag > 0, 0.3 / diag, 1.0).astype(np.float32), None
    cf = np.array(jmg.chebyshev_coefs(jnp.float32(2.0), sweeps,
                                      fi.SolverConfig(mg_smoother=kind)))
    return r, z, coeff, np.where(diag > 0, 1.0 / diag, 1.0).astype(np.float32), cf


def _ref_residual(r, z, coeff, radius):
    """r − A z with the reference's plain operator (XLA ops)."""
    z = jnp.asarray(z)
    s = jstencils.smoothness_apply(z, fi.Weights(**WEIGHTS[radius]), 2)
    return np.asarray(jnp.asarray(r) - (s + jdata_apply(z, jnp.asarray(coeff), 2)))


def _close(got, want, bar=2e-5):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=bar * np.abs(want).max())


def _check(want, r, z, coeff, sid, cf, radius, sweeps, from_zero):
    """The port's phase with its residual against the reference's z."""
    got, res = fused_smooth_2d(*(torch.as_tensor(a) for a in (r, z, coeff, sid)),
                               ft.Weights(**WEIGHTS[radius]), sweeps, from_zero,
                               None if cf is None else torch.as_tensor(cf), residual=True)
    assert got.dtype == res.dtype == torch.float32
    assert tuple(got.shape) == tuple(res.shape) == r.shape
    _close(got, want)
    _close(res, _ref_residual(r, want, coeff, radius))


@pytest.mark.parametrize("from_zero", [False, True])
@pytest.mark.parametrize("kind", ["jacobi", "chebyshev4"])
@pytest.mark.parametrize("radius,sweeps", [(2, nu) for nu in range(6)]
                         + [(3, nu) for nu in range(4)])
def test_phase_with_residual_matches_whole_level_kernel(radius, sweeps, kind, from_zero):
    """Against the reference's whole-level 2-D fused_smooth (513), which has
    no halo: ν·ρ up to 10 nodes, where the card splits the phase."""
    r, z, coeff, sid, cf = _operands((16, 12), radius, kind, sweeps)
    if cf is not None and sweeps == 0:
        # The reference's cycle never calls its kernel at ν = 0; its
        # Chebyshev phase is then zeros from zero and z from z.
        want = np.zeros_like(r) if from_zero else z
    else:
        want = np.asarray(ps.fused_smooth(
            *(jnp.asarray(a) for a in (r, z, coeff, sid)), fi.Weights(**WEIGHTS[radius]), 2,
            sweeps, from_zero=from_zero, interpret=True,
            cheb_coefs=None if cf is None else {sweeps: jnp.asarray(cf)}))
    _check(want, r, z, coeff, sid, cf, radius, sweeps, from_zero)


@pytest.mark.parametrize("from_zero", [False, True])
@pytest.mark.parametrize("kind", ["jacobi", "chebyshev4"])
@pytest.mark.parametrize("radius,sweeps", [(2, 3), (3, 2)], ids=["radius2", "radius3"])
@pytest.mark.parametrize("kernel,shape,tiling", [
    (ps.fused_smooth_striped, (32, 96), dict(stripe=8)),
    (ps.fused_smooth_tiled, (16, 256), dict(tiles=(8, 128))),
], ids=["striped", "tiled"])
def test_phase_with_residual_matches_striped_and_tiled_kernels(kernel, shape, tiling, radius,
                                                               sweeps, kind, from_zero):
    """Against the reference's multi-sweep kernels (653, 876), cut into
    several stripes or tiles, at the ν·ρ their 8-row halo holds."""
    r, z, coeff, sid, cf = _operands(shape, radius, kind, sweeps)
    want = np.asarray(kernel(
        *(jnp.asarray(a) for a in (r, z, coeff, sid)), fi.Weights(**WEIGHTS[radius]),
        sweeps=sweeps, from_zero=from_zero, interpret=True,
        cheb_coefs=None if cf is None else {sweeps: jnp.asarray(cf)}, **tiling))
    _check(want, r, z, coeff, sid, cf, radius, sweeps, from_zero)


def _pair(shape, n=300, seed=0, weights=dict(model_2=0.3)):
    """The reference's Problem and the port's copy: oriented points on a
    circle (tests/test_torch_multigrid.py:_pair)."""
    rng = np.random.default_rng(seed)
    nrm = rng.standard_normal((n, 2))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    pos = (np.asarray(shape) - 1) / 2.0 + 0.3 * min(shape) * nrm
    jp = jassemble(fi.Grid(shape), fi.Weights(**weights),
                   jnp.asarray(pos, jnp.float32), jnp.zeros(n, jnp.float32),
                   gradients=jnp.asarray(nrm, jnp.float32))
    tp = problem_from_numpy(jp.coeff, jp.b, jp.diag, ft.Grid(shape),
                            ft.Weights(**weights))
    return jp, tp


# Level-by-level 2-D cycles (ν_pre ≠ ν_post, or ν_post = 0, rules the
# whole-cycle kernels out) with a 9-channel fine level; Galerkin coarse data
# makes every level 9-channel.
CYCLES = [((64, 64), dict(mg_pre_smooth=2, mg_cycle="v")),
          ((64, 64), dict(mg_pre_smooth=2, mg_cycle="w")),
          ((64, 64), dict(mg_post_smooth=0, mg_cycle="w")),
          ((96, 80), dict(mg_pre_smooth=2, mg_cycle="w", mg_coarse_data="galerkin"))]


@pytest.mark.parametrize("smoother", ["jacobi", "chebyshev4"])
@pytest.mark.parametrize("shape,change", CYCLES, ids=["64-v", "64-w", "64-w-post0", "96x80-w-gal"])
def test_kernel_cycle_matches_reference_cycle(shape, change, smoother):
    jp, tp = _pair(shape)
    change = dict(change, mg_smoother=smoother)
    cfg = ft.SolverConfig(**change)
    levels = tmg.build_levels(tp, cfg)
    lump = tmg.build_smoothing_setup(tp, levels, cfg)[0]
    assert not lump and tmg.kernel_plan(tp, cfg, levels, lump)[1] is None
    r = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    want = jmg.make_vcycle_preconditioner(jp, fi.SolverConfig(**change))(jnp.asarray(r))
    got = tmg.make_vcycle_preconditioner(tp, cfg, kernels=True)(torch.as_tensor(r))
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("post", [3, 0])
def test_cycle_takes_the_residual_from_the_multisweep_call(monkeypatch, post):
    """Every residual a W-cycle with Galerkin coarse data restricts or
    revisits comes from a fused_smooth_2d call and equals that level's
    r − A z; neither the fine apply nor a level apply computes one, except,
    with ν_post = 0, the second visit's residual on level 1, where no
    smoothing runs (one level apply per W step). The cycle equals the plain
    one (kernels=False)."""
    shape = (64, 64)
    _, tp = _pair(shape)
    cfg = ft.SolverConfig(mg_pre_smooth=2, mg_post_smooth=post, mg_cycle="w",
                          mg_coarse_data="galerkin")
    calls, applies, fine_applies = [], [], []
    inner = tmg.fused_smooth_2d

    def spy(r, z, coeff, sid, weights, sweeps, from_zero=False, cheb_coefs=None,
            residual=False):
        out = inner(r, z, coeff, sid, weights, sweeps, from_zero, cheb_coefs, residual)
        if residual:
            calls.append((out, fused_normal_apply_plain(out[0], coeff, weights, 2), r))
        return out

    level_apply = tmg._Level.apply

    def apply_spy(self, x):
        applies.append(self.shape)
        return level_apply(self, x)

    def fine_apply(x):
        fine_applies.append(tuple(x.shape))
        return tp.apply(x)

    monkeypatch.setattr(tmg, "fused_smooth_2d", spy)
    monkeypatch.setattr(tmg._Level, "apply", apply_spy)
    r = torch.as_tensor(np.random.default_rng(4).standard_normal(shape).astype(np.float32))
    got = tmg.make_vcycle_preconditioner(tp, cfg, apply_fn=fine_apply, kernels=True)(r)
    levels = tmg.build_levels(tp, cfg)
    # Two levels below the fine one, both 9-channel: a W step on level 1
    # only, the coarsest solved densely.
    assert len(levels) == 2 and all(l.data_coeff is not None for l in levels)
    assert tmg.resolve_wdepth(cfg, shape) >= 1
    # Pre-smoothing of the fine level and of both visits of level 1; the
    # first visit's post-smoothing where it runs.
    assert len(calls) == 3 + (post > 0)
    assert fine_applies == []
    assert applies == ([] if post else [levels[0].shape])
    for (z, res), az, rl in calls:
        _close(res, rl - az)
    monkeypatch.undo()
    want = tmg.make_vcycle_preconditioner(tp, cfg)(r)
    _close(got, want, 1e-4)


@pytest.mark.parametrize("radius", [2, 3])
def test_nine_channel_phases_route_by_radius(monkeypatch, radius):
    """Every 9-channel smoothing phase of a W-cycle with Galerkin coarse
    data goes to `fused_smooth_2d` at radius 2 and to `fused_smooth` at
    radius 3; the cycle equals the reference's XLA cycle either way
    (rtol 1e-4, as test_kernel_cycle_matches_reference_cycle)."""
    shape = (64, 64)
    change = dict(mg_pre_smooth=2, mg_cycle="w", mg_coarse_data="galerkin")
    jp, tp = _pair(shape, weights=WEIGHTS[radius])
    cfg = ft.SolverConfig(**change)
    routes = []
    inner2d, inner = tmg.fused_smooth_2d, tmg.fused_smooth

    def spy2d(r, z, coeff, *args, **kwargs):
        routes.append(("multi-sweep", coeff.ndim))
        return inner2d(r, z, coeff, *args, **kwargs)

    def spy(r, z, coeff, *args, **kwargs):
        routes.append(("per-sweep", coeff.ndim))
        return inner(r, z, coeff, *args, **kwargs)

    monkeypatch.setattr(tmg, "fused_smooth_2d", spy2d)
    monkeypatch.setattr(tmg, "fused_smooth", spy)
    r = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    got = tmg.make_vcycle_preconditioner(tp, cfg, kernels=True)(torch.as_tensor(r))
    monkeypatch.undo()
    levels = tmg.build_levels(tp, cfg)
    assert len(levels) == 2 and all(l.data_coeff is not None for l in levels)
    # The fine level and both visits of level 1, pre- and post-smoothing.
    assert len(routes) == 6
    want_route = "multi-sweep" if radius < 3 else "per-sweep"
    assert routes == [(want_route, 3)] * 6
    want = jmg.make_vcycle_preconditioner(jp, fi.SolverConfig(**change))(jnp.asarray(r))
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
