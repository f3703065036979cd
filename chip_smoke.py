#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card and the CUDA
toolkit (``nvcc``). Phases, each fatal on failure:

1. the card: ``nvidia-smi`` name and power limit, torch's CUDA, nvcc's release;
2. the build of ``field_interpolation_tpu_torch/csrc`` for sm_90a;
3. the apply kernel against its plain version on the headline problem
   (256², 1000 points, full 9-channel data) and on a 128² coarse level
   (diagonal data, that level's weights), within 1e-5·max|plain|;
4. the PCG segment kernel against its plain version on the headline
   operands at tol 1e-4 from x = 0: iterations within ±2, x within
   2e-3·max|x|;
5. the main path: ``sdf_from_points_precise`` at 256², 1000 points,
   tol 1e-6, seeds 0..7: every field converged, its true float64 residual
   (the port's plain float64 operator) ≤ 1e-6, the reported residual within
   2% of it, and both kernels launched by this phase.

The lines before the last are the kernel record (JSON) and the card; the
last line is ``{"ok": true, "device": {...}}``. Without a CUDA card it exits
non-zero before printing any result.
"""

import json
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
        name = f"{form} {shape[0]}x{shape[1]}"
        x = torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                            device=device)
        got = fused_normal_apply(x, coeff, w, 2)
        want = fused_normal_apply_plain(x, coeff, w, 2)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        ms = cuda_ms(lambda: fused_normal_apply(x, coeff, w, 2))
        plain_ms = cuda_ms(lambda: fused_normal_apply_plain(x, coeff, w, 2))
        print(f"apply {name}: max|kernel-plain| {err:.3e} (bar {1e-5 * scale:.3e}); "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        require(err <= 1e-5 * scale, f"apply {name}: {err} > 1e-5·{scale}")
        if rec is None:
            rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
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

    src = "field_interpolation_tpu_torch/csrc/"
    ref = "field_interpolation_tpu/ops/pallas_stencil.py:"
    kernels = [
        dict(name="fused_normal_apply", route="cuda", source=src + "normal_apply.cu",
             replaces=ref + "170", launches=launches["fused_normal_apply"], **apply_rec),
        dict(name="fused_pcg_solve", route="cuda", source=src + "pcg_segment.cu",
             replaces=ref + "1484", launches=launches["fused_pcg_solve"], **seg_rec),
    ]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
