"""Which reference kernel the port stands in for, call by call.

* The port's copies of the reference's tiling rules (`ops._policy`) equal
  the reference's own on large, small and odd shapes.
* The apply: `_policy.apply_plan` names the kernel the reference's
  `_make_apply` picks (solver.py:213-249).
* The smoothing: the reference's multigrid cycle is built with
  ``pallas_smooth=True`` and run once with its kernels replaced by recorders;
  the port's `multigrid.kernel_plan` must name, level by level, the kernels
  the reference called (multigrid.py:934-1042). The 128³ plan of the slice
  (BASELINE config 4) is checked from its shapes.
* The port's cycle at 72³, the smallest cube whose lumped fine level is past
  the reference's whole-array gate, smooths every level through
  `fused_smooth` and equals the plain cycle.
* Where the reference's rules name no kernel (odd 3-D extents past the
  gate, where it runs XLA), the port's solve still goes through its apply
  and sweep wrappers, which launch the kernels on CUDA tensors."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import field_interpolation_tpu as fi
from field_interpolation_tpu import multigrid as jmg
from field_interpolation_tpu.operators import assemble as jassemble
from field_interpolation_tpu.ops import pallas_stencil as ps

import field_interpolation_tpu_torch as ft
from field_interpolation_tpu_torch import multigrid as tmg
from field_interpolation_tpu_torch import solver as tsolver
from field_interpolation_tpu_torch.convert import problem_from_numpy
from field_interpolation_tpu_torch.ops import _policy
from field_interpolation_tpu_torch.stencils import max_stencil_radius

SHAPES = [(128,) * 3, (256,) * 3, (64,) * 3, (72,) * 3, (32,) * 3, (41,) * 3,
          (1024, 1024), (4096, 4096), (2048, 2048), (512, 512), (256, 256),
          (9, 5, 7), (40, 3, 17), (24, 16, 12), (16, 24, 20), (96, 64, 64),
          (33, 17), (1000, 1000), (3000, 768), (1024, 4096), (8, 8), (100,)]
SWEEP_CASES = [(1, 3), (2, 3), (3, 2), (2, 4), (1, 8), (3, 3)]  # (radius, ν)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_policy_matches_reference(shape):
    for diag in (False, True):
        assert _policy.fits_vmem(shape, diag_data=diag) == ps.fits_vmem(
            shape, diag_data=diag)
    for radius in (1, 2, 3):
        assert _policy.halo(len(shape), radius) == ps._halo(len(shape), radius)
        assert _policy.pick_stripe(shape, radius) == ps.pick_stripe(shape, radius)
    for radius, nu in SWEEP_CASES:
        assert (_policy.pick_stripe_smooth(shape, radius, nu)
                == ps.pick_stripe_smooth(shape, radius, nu))
        assert (_policy.pick_tile_smooth(shape, radius, nu)
                == ps.pick_tile_smooth(shape, radius, nu))
    assert _policy.pick_stripe2_3d(shape) == ps.pick_stripe2_3d(shape)
    assert _policy.pick_stripe2_3d_sweep(shape) == ps.pick_stripe2_3d_sweep(shape)
    assert _policy.pick_stripe_sweep_diag(shape) == ps.pick_stripe_sweep_diag(shape)


@pytest.mark.parametrize("shape,weights_kw,want", [
    ((128,) * 3, dict(model_2=0.3), "fused_normal_apply_striped"),
    ((128,) * 3, dict(model_2=0.5, model_3=0.8), "fused_normal_apply_striped2_3d"),
    ((256,) * 3, dict(model_2=0.3), "fused_normal_apply_striped2_3d"),
    ((32,) * 3, dict(model_2=0.3), "fused_normal_apply"),
    ((256, 256), dict(model_2=0.3), "fused_normal_apply"),
    ((1024, 1024), dict(model_2=0.3), "fused_normal_apply_striped"),
    ((131, 131, 131), dict(model_2=0.3), None),
    ((100,), dict(model_2=0.3), None),
], ids=str)
def test_apply_plan_matches_reference_rule(shape, weights_kw, want):
    """The port's choice against the reference's rule, evaluated with the
    reference's own functions (solver.py:221-227)."""
    w = fi.Weights(**weights_kw)
    radius = max(fi.stencils.max_stencil_radius(w), 1)
    whole = ps.fits_vmem(shape)
    stripe = None if whole else ps.pick_stripe(shape, radius)
    tiles2 = None if whole or stripe is not None else ps.pick_stripe2_3d(shape)
    ref = ("fused_normal_apply" if whole else "fused_normal_apply_striped"
           if stripe is not None else "fused_normal_apply_striped2_3d"
           if tiles2 is not None else None)
    assert ref == want
    tradius = max(max_stencil_radius(ft.Weights(**weights_kw)), 1)
    assert _policy.apply_plan(shape, tradius) == want


def test_plan_at_128_cubed():
    """BASELINE config 4: the lumped 128³ fine level sweeps through
    fused_sweep_striped2_3d, the 64³/32³/16³ levels fit whole
    (fused_smooth), the 8³ coarsest level is solved densely."""
    cfg = ft.SolverConfig(tol=1e-4)
    shape = (128,) * 3
    shapes = [shape] + list(tmg.level_shapes(shape, cfg.mg_min_size,
                                             cfg.mg_coarse_solver))
    assert shapes == [(128,) * 3, (64,) * 3, (32,) * 3, (16,) * 3, (8,) * 3]
    assert not ps.fits_vmem(shape)  # so "auto" lumps the fine operator
    assert ps.pick_stripe2_3d_sweep(shape) == (16, 64)
    plan = tmg.smoother_plan(shapes, [True] * 5, 2, 3)
    assert plan == ["fused_sweep_striped2_3d"] + ["fused_smooth"] * 4
    assert tmg.resolve_wdepth(cfg, shape) == jmg.resolve_wdepth(fi.SolverConfig(), shape) > 0


def _reference_calls(monkeypatch, jp, jcfg):
    """Build and run the reference's cycle once with pallas_smooth=True and
    its kernels replaced by recorders; returns {(kernel, shape)}."""
    calls = set()

    def recorder(name):
        def kernel(r, *args, **kwargs):
            calls.add((name, tuple(r.shape)))
            return jnp.zeros_like(r)
        return kernel

    for name in ("fused_smooth", "fused_smooth_striped", "fused_smooth_tiled",
                 "fused_sweep_striped2_3d", "fused_sweep_striped_diag",
                 "fused_vcycle_2d", "fused_wcycle_2d"):
        monkeypatch.setattr(ps, name, recorder(name))
    pc = jmg.make_vcycle_preconditioner(jp, jcfg, pallas_smooth=True,
                                        pallas_interpret=True)
    pc(jnp.ones(jp.grid.shape, jnp.float32)).block_until_ready()
    return calls


def _pair(shape, n=60, seed=0):
    rng = np.random.default_rng(seed)
    D = len(shape)
    u = rng.standard_normal((n, D))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    pos = (np.asarray(shape) - 1) / 2.0 + 0.3 * min(shape) * u
    w = dict(model_2=0.3)
    jp = jassemble(fi.Grid(shape), fi.Weights(**w), jnp.asarray(pos, jnp.float32),
                   jnp.zeros(n, jnp.float32), gradients=jnp.asarray(u, jnp.float32))
    tp = problem_from_numpy(jp.coeff, jp.b, jp.diag, ft.Grid(shape), ft.Weights(**w))
    return jp, tp


def _check_plan(monkeypatch, shape, change):
    jp, tp = _pair(shape)
    calls = _reference_calls(monkeypatch, jp, fi.SolverConfig(**change))
    cfg = ft.SolverConfig(**change)
    levels = tmg.build_levels(tp, cfg)
    lump = tmg.build_smoothing_setup(tp, levels, cfg)[0]
    plan, whole = tmg.kernel_plan(tp, cfg, levels, lump)
    if whole is not None:
        assert calls == {(whole, shape)}
        return
    shapes = [shape] + [l.shape for l in levels]
    if cfg.mg_coarse_solver == "dense":  # the coarsest level never smooths
        shapes, plan = shapes[:-1], plan[:-1]
    want = {(n, s) for s, n in zip(shapes, plan) if n is not None}
    assert calls == want


@pytest.mark.parametrize("shape,change", [
    ((64, 64), dict(mg_pre_smooth=2)),                  # every level fused_smooth
    ((64, 64), dict(mg_coarse_solver="jacobi")),        # the coarsest smooths too
    ((64, 64), dict(mg_fine_operator="lumped")),        # whole-V-cycle kernel
    ((64, 64), dict(mg_fine_operator="lumped", mg_cycle="w")),  # whole W-cycle
    ((24, 24, 24), dict(mg_fine_operator="lumped", mg_cycle="w")),
    ((24, 24, 24), dict(mg_fine_operator="exact")),     # 27-channel fine level
], ids=str)
def test_smoother_plan_matches_reference_calls(monkeypatch, shape, change):
    _check_plan(monkeypatch, shape, change)


@pytest.mark.slow
def test_smoother_plan_matches_reference_calls_72_cubed(monkeypatch):
    _check_plan(monkeypatch, (72, 72, 72), {})


def _sphere_problem(shape, n, seed=0):
    """Config 4's cloud (bench.py:217-227) scaled to ``shape``."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    pts = (np.asarray(shape) - 1) / 2.0 + (40.0 / 128.0) * shape[0] * u
    return ft.assemble_sdf(ft.Grid(shape), ft.Weights(model_2=0.3),
                           torch.as_tensor(pts, dtype=torch.float32),
                           torch.as_tensor(u, dtype=torch.float32)), rng


def _spy(monkeypatch, seen, module, names):
    """Replace ``module.<name>`` by recorders of (name, grid shape) into
    ``seen``."""
    for name in names:
        fn = getattr(module, name)

        def spy(x, *args, _fn=fn, _name=name, **kwargs):
            seen.add((_name, tuple(x.shape)))
            return _fn(x, *args, **kwargs)
        monkeypatch.setattr(module, name, spy)


def test_cycle_at_72_cubed_goes_through_the_sweep_wrappers(monkeypatch):
    """On CPU tensors the wrappers run their plain versions: the kernel
    route of the cycle equals the plain route, and smooths every level,
    the lumped fine one included, through fused_smooth."""
    shape = (72, 72, 72)
    tp, rng = _sphere_problem(shape, 200)
    seen = set()
    _spy(monkeypatch, seen, tmg, ["fused_smooth"])
    cfg = ft.SolverConfig(mg_cycle="v")
    r = torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32)
    got = tmg.make_vcycle_preconditioner(tp, cfg, kernels=True)(r)
    want = tmg.make_vcycle_preconditioner(tp, cfg, kernels=False)(r)
    assert seen == {("fused_smooth", shape), ("fused_smooth", (36,) * 3),
                    ("fused_smooth", (18,) * 3)}
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * scale


def test_sizes_the_reference_runs_in_xla_go_through_the_wrappers(monkeypatch):
    """At 71³ (odd, and its lumped fine level past the whole-array gate) the
    reference names no apply kernel and no fine-level sweep kernel, and runs
    XLA; the port's solve
    still goes through its apply and sweep wrappers at that size, which on
    a CUDA tensor launch the kernels (the card test holds 129³)."""
    shape = (71, 71, 71)
    assert _policy.apply_plan(shape, 2) is None
    assert tmg.smoother_plan([shape], [True], 2, 3) == [None]
    tp, _ = _sphere_problem(shape, 1300)
    seen = set()
    _spy(monkeypatch, seen, tsolver, ["fused_normal_apply"])
    _spy(monkeypatch, seen, tmg, ["fused_smooth"])
    tsolver.solve(tp, ft.SolverConfig(tol=1e-4, maxiter=2))
    assert {("fused_normal_apply", shape), ("fused_smooth", shape)} <= seen
