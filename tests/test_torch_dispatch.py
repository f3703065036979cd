"""Which reference kernel the port stands in for, call by call.

* The port's copies of the reference's tiling rules (`ops._policy`) equal
  the reference's own on large, small and odd shapes.
* The apply: `_policy.apply_plan` names the kernel the reference's
  `_make_apply` picks (solver.py:213-249).
* The smoothing: the reference's multigrid cycle is built with
  ``pallas_smooth=True`` and run once with its kernels replaced by recorders;
  the port's `multigrid.kernel_plan` must name, level by level, the kernels
  the reference called (multigrid.py:934-1042). The 128³ plan (BASELINE
  config 4) and the 4096², 2048² and 440² plans (config 5's grid, its
  nested-iteration grid, and a grid whose whole cycle is still one reference
  kernel) are checked from their shapes. Under Chebyshev smoothing and
  Galerkin coarse data the plans match the reference's calls at 64², and
  the whole-cycle band shrinks as the reference's operand budget says.
* The port's cycle at 72³, the smallest cube whose lumped fine level is past
  the reference's whole-array gate, smooths every level through
  `fused_smooth` and equals the plain cycle; at 64² with ν_pre ≠ ν_post the
  9-channel fine level goes through `fused_smooth_2d` and the coarse levels
  through `fused_smooth`, equal to the plain cycle; at 64² under the lumped
  fine operator the whole cycle is one `ops.cycle` wrapper call, as the
  reference's is one whole-cycle kernel.
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
from field_interpolation_tpu_torch.ops import cycle as tcycle
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


@pytest.mark.parametrize("shape,change", [
    ((64, 64), dict(mg_smoother="chebyshev4", mg_pre_smooth=2)),
    ((64, 64), dict(mg_coarse_data="galerkin", mg_pre_smooth=2)),  # 9-channel coarse
    ((64, 64), dict(mg_smoother="chebyshev", mg_coarse_data="galerkin",
                    mg_fine_operator="lumped")),                     # whole V-cycle
], ids=str)
def test_chebyshev_galerkin_plans_match_reference_calls(monkeypatch, shape, change):
    """Galerkin coarse levels carry the full stencil, so the plan takes
    each level's own diagonal-or-full flag; Chebyshev picks the same
    kernels as Jacobi."""
    _check_plan(monkeypatch, shape, change)


CHEB4, GALERKIN = dict(mg_smoother="chebyshev4"), dict(mg_coarse_data="galerkin")


@pytest.mark.parametrize("change,side,whole", [
    (CHEB4, 440, "fused_wcycle_2d"), (CHEB4, 480, "fused_wcycle_2d"),
    (CHEB4, 488, None), (CHEB4, 496, None),
    (GALERKIN, 448, "fused_wcycle_2d"), (GALERKIN, 456, None),
    ({**CHEB4, **GALERKIN}, 440, "fused_wcycle_2d"), ({**CHEB4, **GALERKIN}, 448, None),
    ({**CHEB4, **GALERKIN}, 256, "fused_vcycle_2d"),
], ids=str)
def test_whole_cycle_band_under_chebyshev_and_galerkin(change, side, whole):
    """The reference's 12 MB fused-operand budget counts every level's data
    term (9 channels on a Galerkin level) and one more fine array of
    scratch under Chebyshev (multigrid.py:635-639), so the whole-cycle band
    (440²-496² under Jacobi with lumped coarse data) shrinks to 440²-480²
    under Chebyshev, 440²-448² under Galerkin and 440² under both. The
    expected names are the kernels the reference's cycle calls at these
    sides (recorded with `_reference_calls`: its whole-cycle kernel, or
    fused_smooth_striped and fused_smooth level by level); at 256² both
    options still take the fused segment."""
    shape = (side, side)
    _, tp = _pair(shape)
    cfg = ft.SolverConfig(**change)
    levels = tmg.build_levels(tp, cfg)
    assert tmg.kernel_plan(tp, cfg, levels, False)[1] == whole
    fused = tmg.build_fused_solver_operands(tp, cfg)
    assert (fused is not None) == ps.fits_vmem(shape)
    if fused is not None:
        cfs = fused[5]
        assert len(cfs) == len(levels) + 1 and all(tuple(c.shape) == (3, 2) for c in cfs)


def _reference_chain(shapes, radius, nu_max):
    """The reference's per-level smoother for a 2-D hierarchy with a 9-channel
    fine level and diagonal coarse levels, from its own pickers
    (multigrid.py:959-1004)."""
    chain = []
    for li, shape in enumerate(shapes):
        diag = li > 0
        if ps.fits_vmem(shape, diag_data=diag):
            chain.append("fused_smooth")
        elif diag:
            chain.append("fused_sweep_striped_diag"
                         if ps.pick_stripe_sweep_diag(shape) is not None else None)
        elif ps.pick_stripe_smooth(shape, radius, nu_max) is not None:
            chain.append("fused_smooth_striped")
        elif ps.pick_tile_smooth(shape, radius, nu_max) is not None:
            chain.append("fused_smooth_tiled")
        else:
            chain.append(None)
    return chain


@pytest.mark.parametrize("shape,head", [
    ((4096, 4096), ["fused_smooth_tiled", "fused_sweep_striped_diag",
                    "fused_sweep_striped_diag"]),   # BASELINE config 5's grid
    ((2048, 2048), ["fused_smooth_striped", "fused_sweep_striped_diag"]),  # its fmg grid
    ((440, 440), ["fused_smooth_striped"]),
], ids=str)
def test_large_2d_plans_match_reference_pickers(shape, head):
    """Pure shape arithmetic: the port's plan for config 5's hierarchy and
    the others equals the reference pickers' chain; every level has a
    kernel smoother there, each one the port's kernels stand in for."""
    cfg = ft.SolverConfig(tol=1e-4)
    shapes = [shape] + list(tmg.level_shapes(shape, cfg.mg_min_size,
                                             cfg.mg_coarse_solver))
    assert shapes == [shape] + list(jmg.level_shapes(shape, 16, "dense"))
    radius = max(max_stencil_radius(ft.Weights(model_2=0.3)), 1)
    plan = tmg.smoother_plan(shapes, [False] + [True] * (len(shapes) - 1), radius, 3)
    assert plan == _reference_chain(shapes, radius, 3)
    assert plan == head + ["fused_smooth"] * (len(shapes) - len(head))


def test_whole_cycle_kernel_still_planned_just_past_the_gate():
    """440² is past the whole-array gate, but its fused-cycle operands fit
    the reference's 12 MB budget, so the reference runs the whole W-cycle
    kernel there (the port: `ops.cycle.fused_wcycle_2d`); 1024² is past
    both."""
    cfg = ft.SolverConfig(tol=1e-4)
    theta = np.random.default_rng(0).uniform(0, 2 * np.pi, 60)
    nrm = torch.as_tensor(np.stack([np.cos(theta), np.sin(theta)], 1),
                          dtype=torch.float32)
    for shape, whole in [((440, 440), "fused_wcycle_2d"), ((1024, 1024), None)]:
        tp = ft.assemble_sdf(ft.Grid(shape), ft.Weights(model_2=0.3),
                             (shape[0] - 1) / 2.0 + 0.3 * shape[0] * nrm, nrm)
        levels = tmg.build_levels(tp, cfg)
        assert not ps.fits_vmem(shape)
        assert tmg.kernel_plan(tp, cfg, levels, False)[1] == whole


@pytest.mark.parametrize("shape,guess_whole", [((880, 880), "fused_wcycle_2d"),
                                               ((1000, 1000), None)], ids=str)
def test_fmg_guess_grid_plan(shape, guess_whole):
    """``fmg_start`` first solves on the (n+1)//2 grid. From 880² that is
    440², where the reference plans the whole W-cycle kernel, so the guess
    runs through the port's whole-cycle kernel while the fine solve smooths
    level by level; from 1000² it is 500², past the whole-cycle budget."""
    cfg = ft.SolverConfig(tol=1e-4)
    theta = np.random.default_rng(0).uniform(0, 2 * np.pi, 60)
    nrm = torch.as_tensor(np.stack([np.cos(theta), np.sin(theta)], 1),
                          dtype=torch.float32)
    wholes = []
    for grid_shape in (shape, tuple((n + 1) // 2 for n in shape)):
        tp = ft.assemble_sdf(ft.Grid(grid_shape), ft.Weights(model_2=0.3),
                             (grid_shape[0] - 1) / 2.0 + 0.3 * grid_shape[0] * nrm, nrm)
        wholes.append(tmg.kernel_plan(tp, cfg, tmg.build_levels(tp, cfg), False)[1])
    assert wholes == [None, guess_whole]


def test_2d_cycle_goes_through_the_multisweep_wrapper(monkeypatch):
    """A 2-D cycle off the fused PCG path that the reference smooths level by
    level (ν_pre ≠ ν_post rules its whole-cycle kernels out): the 9-channel
    fine level smooths through fused_smooth_2d, the diagonal coarse levels
    through fused_smooth (the 16² coarsest is solved densely); on CPU
    tensors the wrappers run their plain versions, so the kernel route
    equals the plain route."""
    shape = (64, 64)
    _, tp = _pair(shape, n=100)
    seen = set()
    _spy(monkeypatch, seen, tmg, ["fused_smooth", "fused_smooth_2d"])
    cfg = ft.SolverConfig(mg_pre_smooth=2)
    assert tmg.kernel_plan(tp, cfg, tmg.build_levels(tp, cfg), False)[1] is None
    r = torch.as_tensor(np.random.default_rng(5).standard_normal(shape),
                        dtype=torch.float32)
    got = tmg.make_vcycle_preconditioner(tp, cfg, kernels=True)(r)
    want = tmg.make_vcycle_preconditioner(tp, cfg, kernels=False)(r)
    assert seen == {("fused_smooth_2d", shape), ("fused_smooth", (32, 32))}
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("change,whole", [
    (dict(mg_fine_operator="lumped"), "fused_vcycle_2d"),
    (dict(mg_fine_operator="lumped", mg_cycle="w"), "fused_wcycle_2d"),
], ids=str)
def test_whole_cycle_goes_through_the_cycle_wrappers(monkeypatch, change, whole):
    """64² under the lumped fine operator: the reference's cycle is one call
    of its whole-cycle kernel; the port's is one call of the wrapper of the
    same name (`ops.cycle`, the CUDA kernel on a CUDA tensor, its plain
    version here), and no level-by-level smoothing."""
    shape = (64, 64)
    jp, tp = _pair(shape, n=100)
    assert _reference_calls(monkeypatch, jp, fi.SolverConfig(**change)) == {(whole, shape)}
    seen = set()
    _spy(monkeypatch, seen, tcycle, ["fused_vcycle_2d", "fused_wcycle_2d"])
    _spy(monkeypatch, seen, tmg, ["fused_smooth", "fused_smooth_2d"])
    r = torch.as_tensor(np.random.default_rng(5).standard_normal(shape),
                        dtype=torch.float32)
    z = tmg.make_vcycle_preconditioner(tp, ft.SolverConfig(**change), kernels=True)(r)
    assert seen == {(whole, shape)}
    assert tuple(z.shape) == shape and bool(torch.isfinite(z).all())
    assert float(torch.sum(r * z)) > 0  # a positive definite preconditioner


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


# ---- the sharded slice ------------------------------------------------------
# Blocks of BASELINE config 5's sharded runs: 4096² on 2 x 2 and 1 x 8 (the
# reference's own case, pallas_stencil.py:1249-1257), 256³ on 2 x 2 over dims
# 0 and 1, and the sharded coarse levels of the 4096² hierarchy on 2 x 2.
EXT_BLOCKS = [(2048, 2048), (4096, 512), (128, 128, 256), (1024, 1024), (512, 512),
              (256, 256), (128, 128), (64, 64, 128), (32, 32, 64), (24, 20), (12, 20, 8)]


@pytest.mark.parametrize("local", EXT_BLOCKS, ids=str)
def test_ext_policy_matches_reference(local):
    for radius in (1, 2, 3, 8, 9):
        for diag in (False, True):
            assert (_policy.ext_fits_vmem(local, radius, diag_data=diag)
                    == ps.ext_fits_vmem(local, radius, diag_data=diag))
        assert _policy.pick_stripe_ext(local, radius) == ps.pick_stripe_ext(local, radius)


@pytest.mark.parametrize("grid,mesh,backend,want", [
    ((4096, 4096), (2, 2), "auto", ("ext_striped", 32)),
    ((4096, 4096), (1, 8), "auto", ("ext_striped", 128)),
    ((4096, 4096), (8, 1), "auto", ("ext_striped", 16)),
    ((256, 256, 256), (2, 2), "auto", ("ext", None)),
    ((2048, 2048), (2, 2), "auto", ("ext_striped", 64)),
    ((64, 64), (2, 2), "auto", ("ext", None)),
    ((4096, 4096), (2, 2), "xla", ("sequential", None)),
    ((48, 40), (1, 4), "xla", ("sequential", None)),
    ((48, 40), (1, 8), "xla", ("sequential", None)),
    ((256, 256, 256), (2, 2), "xla", ("sequential", None)),
], ids=str)
def test_sharded_apply_route(grid, mesh, backend, want):
    """The striped kernel where the reference picks a stripe, the whole-form
    ext kernel everywhere else (where the reference runs XLA past its gate,
    too); the plain routes under backend="xla"."""
    from field_interpolation_tpu_torch.parallel.mesh import Mesh
    from field_interpolation_tpu_torch.parallel.sharded import apply_route
    assert apply_route(grid, ft.Weights(model_2=0.3), Mesh(mesh), backend) == want


@pytest.mark.parametrize("grid,shards,n_sh", [((4096, 4096), (2, 2), 5),
                                              ((256, 256, 256), (2, 2, 1), 3),
                                              ((160, 128), (2, 2), 1)], ids=str)
def test_distributed_levels_of_the_sharded_runs(grid, shards, n_sh):
    """S2's and S4's hierarchies: which levels stay sharded, each
    transition's halos equal the reference's, and each level's route: the
    ext kernel's diagonal form on every sharded level (the lumped 3-D fine
    level too), the exact apply on the 2-D fine level, plain torch where the
    level is replicated."""
    from field_interpolation_tpu.parallel import sharded as jsh
    from field_interpolation_tpu_torch.parallel import sharded as tsh
    cfg = ft.SolverConfig(tol=1e-4, maxiter=500)
    shapes = (grid,) + tmg.level_shapes(grid, cfg.mg_min_size, cfg.mg_coarse_solver)
    assert shapes[1:] == tuple(jmg.level_shapes(grid, cfg.mg_min_size,
                                                cfg.mg_coarse_solver))
    radii = (2,) * (len(shapes) - 1)
    got_n_sh, trans = tsh._sharded_prefix(shapes, shards, radii)
    assert got_n_sh == n_sh
    assert [t[0] for t in trans] == ["ss"] * n_sh + ["boundary"] + ["rr"] * (
        len(trans) - n_sh - 1)
    for (kind, changing, halos), S_f, S_c in zip(trans, shapes, shapes[1:]):
        for d, h in zip(changing, halos):
            assert h == jsh._transfer_band_halos(S_f[d], S_c[d], shards[d])
    lump = tmg.fine_lumped(cfg, grid)
    plan = tsh._MGPlan(shapes=shapes, fweights=ft.Weights(model_2=0.3), lweights=(),
                       radii=radii, n_sh=got_n_sh, lump=lump, has_dense=True, trans=trans)
    routes = tsh.level_routes(plan, "auto")
    assert routes == (("ext",) if lump else ("apply",)) + ("ext",) * n_sh + (
        "replicated",) * (len(shapes) - n_sh - 1)
    assert set(tsh.level_routes(plan, "xla")[1:n_sh + 1]) == {"plain"}


def test_pcg_without_dot_fn_is_unchanged():
    """An existing caller: pcg with no dot_fn is the plain full sum, bit for
    bit, and the solve keeps its iterations (the reference's own count)."""
    jp, tp = _pair((32, 40))
    apply_fn = tp.apply
    x1, i1 = tsolver.pcg(apply_fn, tp.b, tol=1e-5, maxiter=500)
    x2, i2 = tsolver.pcg(apply_fn, tp.b, tol=1e-5, maxiter=500,
                         dot_fn=lambda a, b: torch.sum(a * b))
    assert torch.equal(x1, x2) and int(i1.iterations) == int(i2.iterations)
    from field_interpolation_tpu.solver import pcg as jpcg
    _, ij = jpcg(jp.apply, jp.b, tol=1e-5, maxiter=500)
    assert abs(int(i1.iterations) - int(ij.iterations)) <= 2
