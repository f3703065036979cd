#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one GPU and check them.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card and the CUDA
toolkit (``nvcc``). Phases, each fatal on failure:

1. the card: ``nvidia-smi`` name and power limit, torch's CUDA, nvcc's release;
2. the build of ``field_interpolation_tpu_torch/csrc`` for sm_90a (one nvcc
   per source, side by side), with ptxas' register counts;
3. the apply kernel against its plain version on the headline problem
   (256², 1000 points, full 9-channel data) and on a 128² coarse level
   (diagonal data, that level's weights), within 1e-5·max|plain|;
4. the PCG segment kernel against its plain version on the headline
   operands at tol 1e-4 from x = 0: iterations within ±2, x within
   2e-3·max|x|;
5. the 2-D main path: ``sdf_from_points_precise`` at 256², 1000 points,
   tol 1e-6, seeds 0..7: every field converged, its true float64 residual
   (the port's plain float64 operator) ≤ 1e-6, the reported residual within
   2% of it, and both kernels launched by this phase;
6. the apply kernel on 3-D grids against its plain version, within
   1e-5·max|plain|: BASELINE config 4's problem (128³, 4000 points,
   27-channel data; the reference's striped apply), the same cloud with
   radius-3 weights (the reference's two-axis apply), a 32³ problem (its
   whole-array apply) and the 64³ multigrid level (diagonal data);
7. the Jacobi sweep kernel against its plain version, within
   2e-5·max|plain|: one sweep on the lumped 128³ fine level, ν = 3 from
   zero and from z on the 64³ level, ν = 3 on the 32³ problem's full
   27-channel data;
8. the 3-D main path, BASELINE config 4 (bench.py:217-227):
   ``sdf_from_points`` at 128³, 4000 points, tol 1e-4, seeds 0..3, each
   field converged, finite, of shape 128³ and within ±2 iterations and
   2e-3·max|x| of the same solve under ``backend="xla"``; then
   ``sdf_from_points_precise`` at tol 1e-6, seeds 0..1, true float64
   residual ≤ 1e-6 and reported within 2%. The apply and sweep kernels
   must be launched in this phase, the PCG segment kernel not;
9. where the time of a config-4 field goes: synchronized host clocks of its
   stages (assembly, preconditioner setup, one cycle, one apply, the solve)
   over seeds 0..2, then ``torch.profiler`` over two fields: the device's
   busy and idle share, kernel launches, host→device copies and stream
   synchronizations per field, and device time per kind of work. The
   profiler must see the apply and sweep kernels on the card.

The lines before the last are the kernel record (JSON) and the card; the
last line is ``{"ok": true, "device": {...}}``. Without a CUDA card it exits
non-zero before printing any result.
"""

import dataclasses
import json
import re
import statistics
import subprocess
import time

import numpy as np
import torch

SHAPE = (256, 256)
N_POINTS = 1000
TOL = 1e-6
SEEDS = range(8)
REPS = 20
SHAPE3 = (128, 128, 128)  # BASELINE config 4
N_POINTS3 = 4000
SEEDS3 = range(4)
SEEDS3_PRECISE = range(2)
RADIUS3_WEIGHTS = dict(model_2=0.5, model_3=0.8)
PROFILE_SEEDS = range(3)
# Device work by kind, matched on the kernel's name in the profile; the
# rest is plain elementwise and reduction ops.
DEVICE_KINDS = [
    ("sweep kernel", r"jacobi_sweep"),
    ("apply kernel", r"normal_apply"),
    ("host->device copies", r"HtoD"),
    ("device->host copies", r"DtoH"),
    ("GEMM/GEMV (transfers, dense coarsest)", r"gemm|gemv|cutlass|xmma|splitK|dot_kernel"),
    ("f64 factorization", r"potrf|getrf|trsm|trsv|getrs"),
]


def require(ok, what):
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def make_circle_cloud(n, grid_shape, radius_frac=0.35, noise=0.2, seed=0):
    """The headline cloud of bench.py:30-37: noisy oriented points on a circle."""
    rng = np.random.default_rng(seed)
    center = (np.asarray(grid_shape, np.float64) - 1.0) / 2.0
    radius = radius_frac * min(grid_shape)
    theta = rng.uniform(0, 2 * np.pi, n)
    normals = np.stack([np.cos(theta), np.sin(theta)], axis=1)
    pts = center + radius * normals + noise * rng.standard_normal((n, 2))
    return pts.astype(np.float32), normals.astype(np.float32)


def make_sphere_cloud(n, grid_shape, seed=0):
    """bench.py config 4 (217-227), scaled to the grid: n oriented points
    on a sphere of radius 40/128 of the width around the center."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    center = (np.asarray(grid_shape, np.float64) - 1.0) / 2.0
    pts = center + (40.0 / 128.0) * grid_shape[0] * u
    return pts.astype(np.float32), u.astype(np.float32)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def nvcc_release(nvcc):
    out = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         check=True, timeout=60)
    return [l for l in out.stdout.splitlines() if "release" in l][0].strip()


def cuda_ms(fn, reps=REPS):
    """Median of ``reps`` single-call times from CUDA events, after a warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def shape_str(shape):
    return "x".join(map(str, shape))


def compare(name, kernel, plain, bar):
    """Run ``kernel`` and ``plain`` once each, check max|kernel - plain| ≤
    bar·max|plain|, time both; returns the record."""
    got = kernel()
    want = plain()
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    ms = cuda_ms(kernel)
    plain_ms = cuda_ms(plain)
    print(f"{name}: max|kernel-plain| {err:.3e} (bar {bar * scale:.3e}); "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    require(bool(torch.isfinite(got).all()), f"{name}: kernel output not finite")
    require(err <= bar * scale, f"{name}: {err} > {bar}·{scale}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


def headline_inputs(seed, device):
    pts, nrm = make_circle_cloud(N_POINTS, SHAPE, seed=seed)
    return (torch.as_tensor(pts, device=device),
            torch.as_tensor(nrm, device=device))


def phase_apply(ft, device):
    from field_interpolation_tpu_torch.multigrid import build_fused_solver_operands
    from field_interpolation_tpu_torch.ops.stencil import (
        fused_normal_apply, fused_normal_apply_plain)
    grid, weights = ft.Grid(SHAPE), ft.Weights(model_2=0.3)
    problem = ft.assemble_sdf(grid, weights, *headline_inputs(0, device))
    ops = build_fused_solver_operands(problem, ft.SolverConfig(tol=TOL))
    require(ops is not None, "the headline problem takes the fused path")
    coeffs, _, _, _, lw, _ = ops
    rng = np.random.default_rng(1)
    rec = None
    for form, coeff, w in [("9-channel", coeffs[0], lw[0]),
                           ("diag", coeffs[1], lw[1])]:
        shape = tuple(coeff.shape[-2:])
        x = torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                            device=device)
        r = compare(f"apply {form} {shape_str(shape)}",
                    lambda: fused_normal_apply(x, coeff, w, 2),
                    lambda: fused_normal_apply_plain(x, coeff, w, 2), 1e-5)
        rec = rec or r
    return problem, ops, rec


def phase_segment(problem, ops, device):
    from field_interpolation_tpu_torch.ops.pcg import (fused_pcg_solve,
                                                       fused_pcg_solve_plain)
    coeffs, sids, Rs, inv32, lw, _ = ops
    b = problem.b
    x0 = torch.zeros_like(b)
    tol2 = (1e-4 ** 2 * torch.sum(b * b)).reshape(1, 1)
    budget = torch.full((1, 1), 2000, dtype=torch.int32, device=device)
    args = (x0, b, tol2, budget, coeffs, sids, Rs, inv32, lw, 3)
    xk, ik, rrk = fused_pcg_solve(*args)
    xp, ip, rrp = fused_pcg_solve_plain(*args)
    torch.cuda.synchronize()
    ik, ip = int(ik.item()), int(ip.item())
    err = float((xk - xp).abs().max())
    scale = float(xp.abs().max())
    ms = cuda_ms(lambda: fused_pcg_solve(*args))
    plain_ms = cuda_ms(lambda: fused_pcg_solve_plain(*args))
    print(f"segment tol 1e-4: iterations kernel {ik} plain {ip}; "
          f"max|x_kernel-x_plain| {err:.3e} (bar {2e-3 * scale:.3e}); "
          f"rr kernel {float(rrk.item()):.4e} plain {float(rrp.item()):.4e}; "
          f"kernel {ms:.3f} ms ({1e3 * ms / max(ik, 1):.1f} us/iter), "
          f"plain {plain_ms:.3f} ms ({1e3 * plain_ms / max(ip, 1):.1f} us/iter)")
    require(abs(ik - ip) <= 2, f"segment iterations {ik} vs {ip}")
    require(err <= 2e-3 * scale, f"segment x: {err} > 2e-3·{scale}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


def phase_main(ft, device):
    from field_interpolation_tpu_torch.ops.pcg import fused_pcg_solve
    from field_interpolation_tpu_torch.ops.stencil import fused_normal_apply
    grid, weights = ft.Grid(SHAPE), ft.Weights(model_2=0.3)
    cfg = ft.SolverConfig(tol=TOL, preconditioner="multigrid", maxiter=2000)
    inputs = [headline_inputs(s, device) for s in SEEDS]
    ft.sdf_from_points_precise(grid, weights, *inputs[0], config=cfg)  # warm-up
    torch.cuda.synchronize()

    fused_normal_apply.launches = 0
    fused_pcg_solve.launches = 0
    results = []
    for pts, nrm in inputs:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        x, info = ft.sdf_from_points_precise(grid, weights, pts, nrm, config=cfg)
        end.record()
        end.synchronize()
        results.append((x, info, start.elapsed_time(end)))
    launches = {"fused_normal_apply": fused_normal_apply.launches,
                "fused_pcg_solve": fused_pcg_solve.launches}

    for seed, (pts, nrm), (x, info, ms) in zip(SEEDS, inputs, results):
        # The true residual, from the port's plain float64 operator.
        zeros = torch.zeros(N_POINTS, dtype=torch.float32, device=device)
        pp = ft.assemble_precise(grid, weights, pts, zeros, gradients=nrm)
        true = float(torch.linalg.norm(pp.residual64(x)) / torch.linalg.norm(pp.b64))
        rep = float(info.rel_residual)
        print(f"field seed {seed}: iterations {int(info.iterations)}, reported "
              f"rel {rep:.6e}, true rel {true:.6e}, {ms:.3f} ms, "
              f"finite {bool(torch.isfinite(x).all())}, shape {tuple(x.shape)}")
        require(bool(info.converged), f"seed {seed} did not converge")
        require(tuple(x.shape) == SHAPE and bool(torch.isfinite(x).all()),
                f"seed {seed}: field not finite or wrong shape")
        require(true <= TOL, f"seed {seed}: true residual {true} > {TOL}")
        require(abs(true - rep) <= 0.02 * true,
                f"seed {seed}: reported {rep} vs true {true}")
    ms_all = [ms for _, _, ms in results]
    print(f"main path: {len(ms_all)} fields, ms/field mean "
          f"{statistics.mean(ms_all):.3f}, median {statistics.median(ms_all):.3f}, "
          f"min {min(ms_all):.3f}, max {max(ms_all):.3f}; launches {launches}")
    for name, n in launches.items():
        require(n > 0, f"{name} was not launched on the main path")
    return launches


def sphere_inputs(seed, device, shape=None, n=None):
    shape, n = shape or SHAPE3, n or N_POINTS3
    pts, nrm = make_sphere_cloud(n, shape, seed=seed)
    return (torch.as_tensor(pts, device=device),
            torch.as_tensor(nrm, device=device))


def phase_apply3d(ft, device):
    from field_interpolation_tpu_torch import multigrid as tmg
    from field_interpolation_tpu_torch.ops._policy import apply_plan
    from field_interpolation_tpu_torch.ops.stencil import (
        fused_normal_apply, fused_normal_apply_plain)
    from field_interpolation_tpu_torch.stencils import max_stencil_radius
    rng = np.random.default_rng(2)
    w = ft.Weights(model_2=0.3)
    p128 = ft.assemble_sdf(ft.Grid(SHAPE3), w, *sphere_inputs(0, device))
    require(tuple(p128.coeff.shape) == (27,) + SHAPE3,
            f"config 4 coeff {tuple(p128.coeff.shape)}")
    require(not (torch.backends.cuda.matmul.allow_tf32
                 or torch.backends.cudnn.allow_tf32), "TF32 is on after assembly")
    w3 = ft.Weights(**RADIUS3_WEIGHTS)
    p128r3 = ft.assemble_sdf(ft.Grid(SHAPE3), w3, *sphere_inputs(0, device))
    p32 = ft.assemble_sdf(ft.Grid((32,) * 3), w,
                          *sphere_inputs(0, device, (32,) * 3, 1000))
    lvl1 = tmg.build_levels(p128, ft.SolverConfig(tol=1e-4))[0]
    require(lvl1.shape == tuple(n // 2 for n in SHAPE3), f"first level {lvl1.shape}")
    lvl1 = dataclasses.replace(lvl1, data_diag=lvl1.data_diag.contiguous())
    rec = None
    for label, coeff, wl in [("config 4, 27-channel", p128.coeff, w),
                             ("radius-3 weights, 27-channel", p128r3.coeff, w3),
                             ("27-channel", p32.coeff, w),
                             ("first multigrid level, diag", lvl1.data_diag, lvl1.weights)]:
        shape = tuple(coeff.shape[-3:])
        ref = (apply_plan(shape, max(max_stencil_radius(wl), 1)) if coeff.ndim == 4
               else "diagonal data")
        x = torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                            device=device)
        r = compare(f"apply {shape_str(shape)} {label} (reference: {ref})",
                    lambda: fused_normal_apply(x, coeff, wl, 3),
                    lambda: fused_normal_apply_plain(x, coeff, wl, 3), 1e-5)
        rec = rec or r
    return p128, p32, lvl1, rec


def phase_sweep3d(ft, device, p128, p32, lvl1):
    from field_interpolation_tpu_torch import multigrid as tmg
    from field_interpolation_tpu_torch.ops.smooth import (
        fused_smooth, fused_smooth_plain, fused_sweep)
    rng = np.random.default_rng(3)
    cfg = ft.SolverConfig(tol=1e-4)

    def rand(shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                               device=device)

    levels = tmg.build_levels(p128, cfg)
    lump, fine_ddiag, taus, _ = tmg.build_smoothing_setup(p128, levels, cfg)
    require(lump, "config 4 lumps the fine operator")
    sid0 = (taus[0] * tmg._inv_diag(p128.diag)).contiguous()
    sid1 = (taus[1] * tmg._inv_diag(lvl1.diag)).contiguous()
    fd = fine_ddiag.contiguous()
    r0, z0 = rand(SHAPE3), rand(SHAPE3)
    rec = compare(f"sweep {shape_str(SHAPE3)} lumped fine level, 1 sweep",
                  lambda: fused_sweep(r0, z0, fd, sid0, p128.weights),
                  lambda: fused_smooth_plain(r0, z0, fd, sid0, p128.weights, 3, 1),
                  2e-5)
    r1, z1 = rand(lvl1.shape), rand(lvl1.shape)
    for from_zero in (True, False):
        compare(f"smooth {shape_str(lvl1.shape)} level diag, 3 sweeps, "
                f"from_zero={from_zero}",
                lambda: fused_smooth(r1, z1, lvl1.data_diag, sid1, lvl1.weights,
                                     3, 3, from_zero),
                lambda: fused_smooth_plain(r1, z1, lvl1.data_diag, sid1,
                                           lvl1.weights, 3, 3, from_zero), 2e-5)
    l32 = tmg.build_levels(p32, cfg)
    lump32, _, taus32, _ = tmg.build_smoothing_setup(p32, l32, cfg)
    require(not lump32, "32^3 smooths with the full data stencil")
    sid32 = (taus32[0] * tmg._inv_diag(p32.diag)).contiguous()
    r2, z2 = rand(p32.grid.shape), rand(p32.grid.shape)
    compare(f"smooth {shape_str(p32.grid.shape)} 27-channel, 3 sweeps",
            lambda: fused_smooth(r2, z2, p32.coeff, sid32, p32.weights, 3, 3),
            lambda: fused_smooth_plain(r2, z2, p32.coeff, sid32, p32.weights, 3, 3),
            2e-5)
    return rec


def phase_main3d(ft, device):
    from field_interpolation_tpu_torch.ops.pcg import fused_pcg_solve
    from field_interpolation_tpu_torch.ops.smooth import fused_smooth
    from field_interpolation_tpu_torch.ops.stencil import fused_normal_apply
    grid, weights = ft.Grid(SHAPE3), ft.Weights(model_2=0.3)
    cfg = ft.SolverConfig(tol=1e-4, preconditioner="multigrid", backend="auto")
    cfg_xla = ft.SolverConfig(tol=1e-4, preconditioner="multigrid", backend="xla")
    cfg_precise = ft.SolverConfig(tol=1e-6, preconditioner="multigrid")
    inputs = {s: sphere_inputs(s, device) for s in SEEDS3}
    ft.sdf_from_points(grid, weights, *inputs[0], config=cfg)  # warm-up
    torch.cuda.synchronize()

    counters = (fused_normal_apply, fused_smooth, fused_pcg_solve)
    for c in counters:
        c.launches = 0
    fields = []
    for seed in SEEDS3:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        x, info = ft.sdf_from_points(grid, weights, *inputs[seed], config=cfg)
        end.record()
        end.synchronize()
        fields.append((seed, x, info, start.elapsed_time(end)))
    precise = []
    for seed in SEEDS3_PRECISE:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        x, info = ft.sdf_from_points_precise(grid, weights, *inputs[seed],
                                             config=cfg_precise)
        end.record()
        end.synchronize()
        precise.append((seed, x, info, start.elapsed_time(end)))
    launches = {c.__name__: c.launches for c in counters}

    for seed, x, info, ms in fields:
        xr, ir = ft.sdf_from_points(grid, weights, *inputs[seed], config=cfg_xla)
        it, itr = int(info.iterations), int(ir.iterations)
        err = float((x - xr).abs().max())
        scale = float(xr.abs().max())
        print(f"3-D field seed {seed}: iterations {it} (xla {itr}), rel "
              f"{float(info.rel_residual):.3e}, max|x-x_xla| {err:.3e} (bar "
              f"{2e-3 * scale:.3e}), {ms:.3f} ms, finite "
              f"{bool(torch.isfinite(x).all())}, shape {tuple(x.shape)}")
        require(bool(info.converged), f"3-D seed {seed} did not converge")
        require(tuple(x.shape) == SHAPE3 and bool(torch.isfinite(x).all()),
                f"3-D seed {seed}: field not finite or wrong shape")
        require(bool(ir.converged), f"3-D seed {seed}: the xla solve did not converge")
        require(abs(it - itr) <= 2, f"3-D seed {seed}: iterations {it} vs xla {itr}")
        require(err <= 2e-3 * scale, f"3-D seed {seed}: {err} > 2e-3·{scale}")
    for seed, x, info, ms in precise:
        pts, nrm = inputs[seed]
        zeros = torch.zeros(N_POINTS3, dtype=torch.float32, device=device)
        pp = ft.assemble_precise(grid, weights, pts, zeros, gradients=nrm)
        true = float(torch.linalg.norm(pp.residual64(x)) / torch.linalg.norm(pp.b64))
        rep = float(info.rel_residual)
        print(f"3-D precise field seed {seed}: iterations {int(info.iterations)}, "
              f"reported rel {rep:.6e}, true rel {true:.6e}, {ms:.3f} ms")
        require(bool(info.converged), f"3-D precise seed {seed} did not converge")
        require(tuple(x.shape) == SHAPE3 and bool(torch.isfinite(x).all()),
                f"3-D precise seed {seed}: field not finite or wrong shape")
        require(true <= TOL, f"3-D precise seed {seed}: true residual {true} > {TOL}")
        require(abs(true - rep) <= 0.02 * true,
                f"3-D precise seed {seed}: reported {rep} vs true {true}")
    ms_all = [ms for *_, ms in fields]
    print(f"3-D main path: {len(ms_all)} fields at tol 1e-4, ms/field mean "
          f"{statistics.mean(ms_all):.3f}, median {statistics.median(ms_all):.3f}, "
          f"min {min(ms_all):.3f}, max {max(ms_all):.3f}; precise fields "
          f"{', '.join(f'{ms:.3f}' for *_, ms in precise)} ms; launches {launches}")
    for name in ("fused_normal_apply", "fused_smooth"):
        require(launches[name] > 0, f"{name} was not launched on the 3-D path")
    require(launches["fused_pcg_solve"] == 0, "the 3-D path launched fused_pcg_solve")
    return launches


def busy_ms(intervals):
    """Length of the union of [start, end] intervals in µs, in ms."""
    total, lo, hi = 0.0, None, None
    for a, b in sorted(intervals):
        if hi is None or a > hi:
            total += 0.0 if hi is None else hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    return (total + (0.0 if hi is None else hi - lo)) / 1e3


def phase_profile3d(ft, device):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from field_interpolation_tpu_torch import solver
    grid, weights = ft.Grid(SHAPE3), ft.Weights(model_2=0.3)
    cfg = ft.SolverConfig(tol=1e-4, preconditioner="multigrid")
    stages = {}

    def clock(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages.setdefault(name, []).append(1e3 * (time.perf_counter() - t0))
        return out

    for seed in PROFILE_SEEDS:
        pts, nrm = sphere_inputs(seed, device)
        p = clock("assemble_sdf", lambda: ft.assemble_sdf(grid, weights, pts, nrm))
        apply_fn = solver._make_apply(p, cfg)
        pc = clock("preconditioner setup",
                   lambda: solver._make_precond(p, cfg, apply_fn))
        clock("one cycle", lambda: pc(p.b))
        clock("one apply", lambda: apply_fn(p.b))
        clock("solve", lambda: ft.solve(p, cfg))
    print(f"profile, host clocks after synchronize, seeds "
          f"{PROFILE_SEEDS.start}..{PROFILE_SEEDS.stop - 1}: " + "; ".join(
              f"{k} {', '.join(f'{t:.3f}' for t in v)} ms" for k, v in stages.items()))

    inputs = [sphere_inputs(s, device) for s in range(2)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for pts, nrm in inputs:
            ft.sdf_from_points(grid, weights, pts, nrm, config=cfg)
        torch.cuda.synchronize()
        span = 1e3 * (time.perf_counter() - t0)
    events = list(prof.events())
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    host = [e for e in events if e.device_type == DeviceType.CPU]
    busy = busy_ms((e.time_range.start, e.time_range.end) for e in dev)
    n = len(inputs)
    launch = [e for e in host if e.name.startswith("cudaLaunchKernel")]
    syncs = sum(e.name in ("cudaStreamSynchronize", "cudaDeviceSynchronize")
                for e in host)
    kernels = [e for e in dev if not re.search(r"Memcpy|Memset", e.name)]
    print(f"profile, torch.profiler over {n} fields: span {span:.3f} ms, device "
          f"busy {busy:.3f} ms, device idle share {1 - busy / span:.3f}; per field: "
          f"{len(kernels) / n:.0f} kernels on the device, {len(launch) / n:.0f} "
          f"cudaLaunchKernel calls ({sum(e.self_cpu_time_total for e in launch) / n / 1e3:.3f}"
          f" ms host), {sum('HtoD' in e.name for e in dev) / n:.0f} host->device "
          f"copies, {syncs / n:.0f} stream synchronizations")
    totals, counts = {}, {}
    for e in dev:
        kind = next((k for k, pat in DEVICE_KINDS if re.search(pat, e.name)),
                    "plain elementwise and reduction ops")
        totals[kind] = totals.get(kind, 0.0) + (e.time_range.end - e.time_range.start)
        counts[kind] = counts.get(kind, 0) + 1
    for kind, us in sorted(totals.items(), key=lambda kv: -kv[1]):
        print(f"  device {kind}: {us / n / 1e3:.3f} ms/field, "
              f"{counts[kind] / n:.0f} per field")
    for kind in ("sweep kernel", "apply kernel"):
        require(counts.get(kind, 0) > 0, f"the profile shows no {kind} on the card")


def main():
    require(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    import field_interpolation_tpu_torch as ft
    from field_interpolation_tpu_torch.ops import _build

    device = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}; torch {torch.__version__} CUDA {torch.version.cuda}; "
          f"nvcc {nvcc_release(_build._nvcc())}")

    t0 = time.perf_counter()
    path, build_s, log = _build.build()
    _build.library()
    print(f"build: {path.name} in {build_s:.1f} s (load {time.perf_counter() - t0:.1f} s)")
    for line in log.splitlines():
        if "Used" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())

    problem, ops, apply_rec = phase_apply(ft, device)
    seg_rec = phase_segment(problem, ops, device)
    launches = phase_main(ft, device)
    p128, p32, lvl1, apply3_rec = phase_apply3d(ft, device)
    sweep_rec = phase_sweep3d(ft, device, p128, p32, lvl1)
    del p128, p32, lvl1
    launches3 = phase_main3d(ft, device)
    phase_profile3d(ft, device)

    src = "field_interpolation_tpu_torch/csrc/"
    ref = "field_interpolation_tpu/ops/pallas_stencil.py:"
    kernels = [
        dict(name="fused_normal_apply", route="cuda", source=src + "normal_apply.cu",
             replaces=ref + "170", launches=launches["fused_normal_apply"], **apply_rec),
        dict(name="fused_pcg_solve", route="cuda", source=src + "pcg_segment.cu",
             replaces=ref + "1484", launches=launches["fused_pcg_solve"], **seg_rec),
        dict(name="fused_normal_apply_3d", route="cuda", source=src + "normal_apply.cu",
             replaces=ref + "170,300,1662",
             launches=launches3["fused_normal_apply"], **apply3_rec),
        dict(name="jacobi_sweep", route="cuda", source=src + "jacobi_sweep.cu",
             replaces=ref + "513,1813",
             launches=launches3["fused_smooth"], **sweep_rec),
    ]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
