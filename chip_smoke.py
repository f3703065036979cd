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
   tol 1e-6, seeds 0..3: every field converged, its true float64 residual
   (the port's plain float64 operator) ≤ 1e-6, the reported residual within
   2% of it, and both kernels launched by this phase;
6. the apply kernel on 3-D grids against its plain version, within
   1e-5·max|plain|: BASELINE config 4's problem (128³, 4000 points,
   27-channel data; the reference's striped apply), the same cloud with
   radius-3 weights (the reference's two-axis apply), a 32³ problem (its
   whole-array apply) and the 64³ multigrid level (diagonal data);
7. the smoothing-phase kernel against its plain version, within
   2e-5·max|plain| for z and 2e-5·max|r − A z| for the residual the call
   writes, each call timed single and back to back: one sweep on the
   lumped 128³ fine level, and the cycle's calls there (ν = 3 from zero
   with the residual, ν = 3 from z), ν = 3 from zero and from z with the
   residual on the 64³ level, ν = 3 with the residual on the 32³ problem's
   full 27-channel data;
8. the 3-D main path, BASELINE config 4 (bench.py:217-227):
   ``sdf_from_points`` at 128³, 4000 points, tol 1e-4, seeds 0..1, each
   field converged, finite, of shape 128³ and within ±2 iterations and
   2e-3·max|x| of the same solve under ``backend="xla"``; then
   ``sdf_from_points_precise`` at tol 1e-6, seed 0, true float64
   residual ≤ 1e-6 and reported within 2%. The apply and sweep kernels
   must be launched in this phase, the PCG segment kernel not;
9. where the time of a config-4 field goes: synchronized host clocks of its
   stages (assembly, preconditioner setup, one cycle, one apply, the solve)
   of seed 0, then ``torch.profiler`` over one field: the device's
   busy and idle share, kernel launches, host→device copies and stream
   synchronizations per field, and device time per kind of work. The
   profiler must see the apply and sweep kernels on the card;
10. the apply kernel against its plain version, within 1e-5·max|plain|,
    on BASELINE config 5's 4096² problem (100 000 points, 9-channel data)
    and on its 2048² nested-iteration problem (the reference's striped
    apply on both); then the multi-sweep kernel's phases as the cycle runs
    them against their plain versions, within 2e-5·max|plain|: ν = 3 from
    zero with the residual (the pre-smoothing, one launch) and from z (the
    post-smoothing) on the 4096² fine level (the reference's tiled
    smoother) and the 2048² fine level (the striped smoother), and ν = 3
    from z with the residual at 1000×1030 with radius-3 weights (two
    launches in one call); each timed single and back to back beside its
    bytes bound, GB/s, and the same phase through the per-sweep kernel;
11. the smoothing-phase kernel against its plain version, as phase 7, on
    config 5's diagonal levels: one sweep and the cycle's pre-smoothing
    call (ν = 3 from zero with the residual) at 2048² and 1024² (the
    reference's fused_sweep_striped_diag), the latter at 512² (its
    whole-level fused_smooth);
12. BASELINE config 5's single-chip proxy (bench.py:272-315):
    ``sdf_from_points`` at 4096², 100 000 points, tol 1e-4, maxiter 500,
    ``fmg_start=1``, seed 0, converged, finite, of shape 4096²,
    seed 0 within ±2 iterations and 2e-3·max|x| of the same call under
    ``backend="xla"``; ``sdf_from_points_precise`` at tol 1e-6, seed 0, true
    float64 residual ≤ 1e-6 and reported within 2%. The apply, per-sweep
    and multi-sweep kernels must launch in this phase, the segment kernel
    not;
13. where the time of a config-5 field goes, as phase 9: host clocks of its
    stages and ``torch.profiler`` over one field;
14. the whole-cycle kernel against ``mg_cycle_plain``, within
    3e-5·max|plain|, on the operands ``multigrid.whole_cycle_operands``
    hands it for field A (496², the W-cycle, the V-cycle, the V-cycle with
    ν_pre = 2, ν_post = 3) and for a 256² lumped problem (V), each on a
    standard-normal residual and on r = A·x (which the fine level's
    smoothing shapes): each timed beside one plain-torch cycle (the
    ``backend="xla"`` preconditioner), with its grid-barrier phases and µs
    per phase;
15. the PCG segment kernel with the W-cycle (``wdepth=99``) against its
    plain version, as phase 4;
16. field A, the whole-cycle band's main path: the apply kernel against its
    plain version on the field's 9-channel 496² problem, within
    1e-5·max|plain|; ``sdf_from_points`` at 496²,
    2000 circle points, the default config (tol 1e-4), seed 0,
    converged, finite, of shape 496², seed 0 within ±2 iterations and
    2e-3·max|x| of ``backend="xla"``; ``sdf_from_points_precise`` at tol
    1e-6, seed 0, true float64 residual ≤ 1e-6 and reported within 2%. The
    whole W-cycle kernel and the apply kernel must launch, the segment
    kernel not; then ``torch.profiler`` over one field;
17. field B: ``sdf_from_points_precise`` at 256², 1000 points, tol 1e-6,
    ``mg_cycle="w"`` (the segment kernel with the W-cycle), seed 0,
    true residual ≤ 1e-6, reported within 2%, beside phase 5's V-cycle
    iterations and times;
18. field C: the apply kernel (1e-5·max|plain|), the multi-sweep kernel
    at 992² (ν = 3 from zero with the residual, and from z) and the
    per-sweep kernel on its 496² diagonal level (ν = 3 from zero and from
    z), 2e-5·max|plain|, against their plain versions on the
    field's own problem; then ``sdf_from_points`` at 992², 4000 points, tol
    1e-4, ``fmg_start=1``, seed 0: converged, finite, of shape 992²; its
    496² guess launches the whole-cycle kernel, its fine level the apply,
    multi-sweep and per-sweep kernels;
19. the smoothing-phase kernel's Chebyshev mode (kind 4, ν = 3, from zero
    and from z, each with the residual) against its plain version as phase
    7 on config 4's cloud: the lumped 128³ fine level, the 64³ level with
    lumped data and the 64³ Galerkin level (27 channels), each beside the
    kernel's damped-Jacobi mode on the same level;
20. the multi-sweep kernel's Chebyshev mode at 4096² (from zero with the
    residual, and from z) and at 1000×1030 with radius-3 weights (ν = 3
    from z, with and without the residual: two launches in one call, the
    second from the first's z and z_prev), and the smoothing-phase
    kernel's on config 5's 512² diagonal level, as phase 19;
21. the whole-cycle kernel's Chebyshev mode against ``mg_cycle_plain`` on
    field A′'s operands (480², W and V), as phase 14, beside the
    damped-Jacobi cycle kernel on the same problem;
22. the segment kernel's Chebyshev mode against its plain version on the
    headline's operands, with lumped and with Galerkin coarse levels, as
    phase 4;
23. H-cheb and H-gal: ``sdf_from_points_precise`` at 256², 1000 points, tol
    1e-6, kind-4 Chebyshev (seed 0) and with Galerkin coarse data too
    (seed 0): true residual ≤ 1e-6, the reported within 2%, within ±2
    iterations and 2e-3·max|x| of ``backend="xla"``, beside phase 5; the
    segment kernel must launch in Chebyshev mode;
24. field A′, the Chebyshev whole-cycle band: the apply kernel against its
    plain version at 480²; ``sdf_from_points`` at 480², 2000 points, tol
    1e-4, kind-4 Chebyshev, seed 0, against ``backend="xla"`` and beside
    damped Jacobi; precise at 1e-6; the whole-cycle kernel must launch in
    Chebyshev mode, the segment kernel not; a profile of one field;
25. config 4-cg: config 4 with kind-4 Chebyshev and Galerkin coarse data,
    seed 0, against ``backend="xla"``; the per-sweep kernel must
    launch in Chebyshev mode; host clocks of a field's stages and a profile
    of one field, as phase 9;
26. config 5-cheb: config 5's proxy with kind-4 Chebyshev, seed 0, against
    ``backend="xla"``; the multi-sweep and per-sweep kernels must launch in
    Chebyshev mode;
27. S1, the sharded apply's kernels block by block in one process
    (``phase_ext``): config 5's 9-channel 4096² field cut 2 x 2 and 1 x 8
    through the striped form, a 27-channel 256³ field cut 2 x 2 through the
    whole form, the diagonal form on the 512² and 64³ multigrid levels; each
    stitched within 1e-5·max|plain| of the plain version and of the
    whole-grid apply kernel, one block timed beside its bound; then the
    same blocks through ``ExtLevel`` (the block and its halo slabs, as the
    sharded solve launches it) in every mode (apply, residual, Jacobi,
    Chebyshev; the updates within 2e-5·max|plain|), each timed;
28-30. S2-S4 (``phase_sharded``): four ranks sharing the card, halos via
    gloo through host memory: config 5 sharded on a 2 x 2 mesh (4096²,
    ``solve_sharded``), S3 ``solve_refined_sharded`` to a TRUE 1e-6, S4 the
    3-D half at 192³ (then S2 and S4 as one rank: the sharded code without
    the sharing); each against the port's unsharded solve (±2 iterations,
    2e-3·max|x|), both ext kernels launched on every rank, each rank's
    launches per CG iteration printed by form and mode;
31. BASELINE config 1 through ``interpolate`` (bench.py:125-135: 64², 100
    values, plain CG at tol 5e-4): converged, within ±2 iterations and
    2e-3·max|x| of ``backend="xla"``, ms/solve; the apply kernel against
    its plain version on the config's problem and launched;
32. ``interpolate_precise`` at 256² on the headline's points with values
    sin(x/9), tol 1e-6: true float64 residual ≤ 1e-6, reported within 2%;
    the segment kernel launched;
33. ``interpolate`` at 1024², 51 200 points (the density of the
    reference's fmg check), sin(x/9), tol 1e-4, cold and with
    ``fmg_start=1``: both converged, fmg with fewer fine iterations, the
    fields within 5e-2; the apply, multi-sweep and per-sweep kernels
    against their plain versions on its problem and launched; then the
    same with 4000 points, reported (it stalls, in the reference too);
34. the ``Solver`` session on the headline (precise, tol 1e-6): frame 1
    with the iterations of ``sdf_from_points_precise``, frames 2-9 with the
    normals turned by a seeded angle of at most 2° per frame and warm
    started, each true residual ≤ 1e-6; construction, frame and cold-field
    times and kernels per frame;
35. ``prepare`` + ``solve(prep=)`` on config 4: the cold solve's
    iterations and field; solve and field times, cold against prepared;
36. ``solve_implicit`` on the headline at tol 1e-5 with the loss ⟨w, x*⟩:
    the whole-cycle kernel on its preconditioner's operands against
    ``mg_cycle_plain``; b̄ = λ with ‖A λ − w‖ ≤ 1e-5·‖w‖ (plain float64
    operator), coeff̄ = −λ·shift(x, o) within 1e-5·max; the apply and
    whole-cycle V kernels launched forward and backward; their times;
37. the apply kernel's device time from ``torch.profiler`` at 256², 480²,
    992², 4096² and 128³ beside its single-call and back-to-back times
    and its bound;
38. the batched kernels against their plain versions, each lane to the
    single-field bars (segment: iterations within ±2, x within
    2e-3·max|x|; apply: 1e-5·max|plain|), timed single and back to back
    beside their bounds: the batched segment on config 3's operands at
    B = 8 (V, damped Jacobi, one lane with b = 0 and one with budget 0:
    both 0 iterations and x untouched) and B = 1024 (the whole batch), W
    and Chebyshev at B = 4, 128²,
    and B = 3 at 256²; the batched apply at B = 16 and 1024 (128²) and
    B = 4 at 32³. Each segment record carries its lane geometry (threads a
    lane, lanes an SM, `ops.pcg.lane_geometry`) and its shared-memory
    plan; its printed line adds the bytes this design moves a
    lane-iteration (`lane_iteration_bytes`, a model of the kernel's loads,
    kept out of the record); the kernel record carries ptxas' registers
    and spills of the batched kernel;
39. BASELINE config 3 (bench.py:166-187): ``sdf_from_points_batch`` on
    1024 fields of 128², 256 oriented points each, tol 1e-4: every lane
    converged and finite, 8 lanes within ±2 iterations and 2e-3·max|x| of
    their single-field ``sdf_from_points``; the batched segment launched
    once per outer round for the whole batch; ms per batch (CUDA events),
    µs/field, fields/s, and from ``torch.profiler`` device-busy ms, kernels
    and launch calls per batch, at B = 64 and 1024;
40. config 3 at a TRUE 1e-6 (bench.py:189-210): B = 256 through
    ``sdf_from_points_precise_batch``, every lane ≤ 1e-6 against the plain
    float64 operator with the reported residual within 2%;
41. 32 of config 3's lanes one after another through the single-field
    ``sdf_from_points``: ms per field, as context for the batch;
42-45. the lane forms of the smoothing-phase, multi-sweep and whole-cycle
    kernels against their plain versions and bit for bit against one
    single-field call a lane (phase 42, ``phase_lane_kernels``; also the
    Chebyshev lane form on config 4 × 16's 64³ Galerkin level, ν = 3 from
    zero with the residual), then the "cycle" route's batches (config 4 ×
    16, config 3's inputs × 4096, field A × 8, field C's grid × 4);
46. contouring config 4's 128³ field (phase 8, seed 0):
    ``marching_tetrahedra_device_compact`` with its defaults against
    ``marching_tetrahedra_device`` (the same count, the same rows in order
    within 2e-6), ``weld_triangles`` and ``write_obj``, the host
    ``marching_tetrahedra`` on a 33³ crop against the device extraction of
    the crop (as sets within 1e-5);
47. the same for config 5's 4096² field (phase 12) in 2-D, with
    ``contour_polylines`` on the compact rows and a 256² crop;
48. config 3's 1024 fields (phase 39) through the compact extractor in one
    call, lanes 0, 341, 682 and 1023 the bits of one-lane calls;
49. in the ranks of phases 28-30, each rank contours its own solved block
    of S2 and S4 (``parallel.contour``): the union equals the device
    extraction of the stitched field within 3e-5, and a cap of 2 overflows
    on every rank;
50. debug mode on the headline (256², tol 1e-4, ``SolverConfig(debug=True)``):
    within ±2 iterations and 2e-3·max|x| of ``backend="xla"``, no kernel
    launched, a NaN position raises the reference's message;
51. (after phase 11) a ``record_solve`` JSON line for config 4's solve and
    ``measure_marginal`` of the 4096² apply;
52. ``explicit`` at the headline (256², 1000 points): the rows assembled
    (host ms; rows and entries against their closed form), AᵀA·x and Aᵀb
    against the port's float64 operator within 1e-10·max,
    ``solve_sparse_linear`` (a dense float64 LU) to a true relative residual
    ≤ 1e-10, the residual of ``sdf_from_points_precise``'s field measured
    with the explicit AᵀA within 2% of the reported one, and
    ``solve_sparse_linear_with_guess`` from that field;
53. ``native`` on the port's engine: ``sdf_from_points_native`` at the
    headline (iterations, ms, true residual ≤ 1e-10),
    ``solve_approximate_lattice_native`` against ``explicit``'s within
    1e-8·max, and at config 4's 128³ the rows built and exported (ms,
    counts against their closed form), AᵀA·x against the operator within
    1e-10·max and ``solve(tol=1e-4)`` with its iterations and true residual.

Each phase's wall time follows it in brackets. The lines before the last
are the contour record (JSON: each extractor's ms a call, the median of 5
CUDA-event times after a warm-up, its spread and its segments or
triangles; the host extractors and the sharded ranks once; with the debug,
observe, explicit and native results and the card), the kernel record (JSON: per kernel its
launches on its path, its error and time against its plain version, and
its bound: the bytes it must move over 3.35 TB/s or its float32 operations
over 67 TFLOP/s, whichever is longer) and the card; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA card it exits non-zero
before printing any result.
"""

import dataclasses
import json
import math
import re
import statistics
import subprocess
import time

import numpy as np
import torch

SHAPE = (256, 256)
N_POINTS = 1000
TOL = 1e-6
SEEDS = range(4)
REPS = 20
PLAIN_REPS = 3  # plain versions and plain-torch cycles: hundreds of ms a call
SHAPE3 = (128, 128, 128)  # BASELINE config 4
N_POINTS3 = 4000
SEEDS3 = range(2)
SEEDS3_PRECISE = range(1)
RADIUS3_WEIGHTS = dict(model_2=0.5, model_3=0.8)
PROFILE_SEEDS = range(1)
SHAPE5 = (4096, 4096)  # BASELINE config 5's single-chip proxy
N_POINTS5 = 100_000
SEEDS5 = range(1)
CFG5 = dict(tol=1e-4, preconditioner="multigrid", backend="auto", maxiter=500)
FMG5 = 1  # bench.py's default depth for 2-D grids (bench.py:259-271)
SHAPE_A = (496, 496)  # field A: the largest side of the whole-cycle band
N_POINTS_A = 2000     # the headline's density, ~1.8 points per unit of arc
SEEDS_A = range(1)
SEEDS_B = range(1)    # field B: the headline with SolverConfig(mg_cycle="w")
SHAPE_C = (992, 992)  # field C: fmg_start=1 guesses on 496², in the band
N_POINTS_C = 4000
# The Chebyshev / Galerkin slice: the reference's kind-4 Chebyshev smoother
# (its "strongest default candidate", weights.py:73-76), alone and with
# Galerkin coarse data.
CHEB = dict(mg_smoother="chebyshev4")
GALERKIN = dict(mg_coarse_data="galerkin")
SEEDS_HCHEB = range(1)
SHAPE_A2 = (480, 480)  # field A′: the largest side of the Chebyshev whole-cycle band
SEEDS4_CG = range(1)
# Kernels per field that the previous smoothing design (one host call per
# sweep, every residual of the cycle in plain torch) launched, counted by
# torch.profiler in `cycle_ab.py --ab` on an NVIDIA H100 80GB HBM3 at 700 W;
# the profiles of phases 9, 13 and 25 print them beside their own counts.
PREVIOUS_KERNELS = {"config 4": 17367, "config 5": 199462, "config 4-cg": 52481}
# The least time the card could take (bound_ms): bytes over HBM's rate, or
# float32 operations over the peak outside the tensor cores (H100 SXM data
# sheet, 700 W).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
# Device work by kind, matched on the kernel's name in the profile; the
# rest is plain elementwise and reduction ops.
DEVICE_KINDS = [
    ("cycle kernel", r"mg_cycle2d"),
    ("segment kernel", r"pcg_segment"),
    ("multi-sweep kernel", r"multisweep2d"),
    ("sweep kernel", r"smooth_phase_kernel"),
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


def batch_ms(fn, reps=REPS):
    """Time per call of ``reps`` calls launched back to back, from CUDA
    events around the batch: the card's time when the host enqueues faster
    than the card runs, which single-call events (`cuda_ms`) do not give for
    a kernel whose wrapper takes longer than its work."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def timed(fn):
    """(fn(), its time in ms from CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def shape_str(shape):
    return "x".join(map(str, shape))


def bound(nbytes, flops):
    """bound_ms and bound_by of the kernel record: the larger of the bytes
    the call must move (each input read once, each output written once)
    over HBM's rate and its float32 operations over the peak rate."""
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * flops / FP32_FLOPS_PER_S
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def apply_flops(weights, ndim, diag):
    """Operations per node of one operator apply, as the kernels do them:
    per active order of stencil length L and per axis, L windows of an
    L-tap correlation and one accumulate (L·(2L + 2)), one scale; the data
    term's multiply-adds (one channel when diagonal, 3^D otherwise)."""
    active = weights.active_orders()
    ops = 2 if 0 in active else 0
    for k in active:
        if k:
            ops += ndim * (k + 1) * (2 * k + 4) + 2
    return ops + 2 * (1 if diag else 3 ** ndim)


def apply_work(x, coeff, weights, ndim):
    """(bytes, operations) of one apply: x and the coefficients read, the
    result written."""
    return (4 * (2 * x.numel() + coeff.numel()),
            apply_flops(weights, ndim, coeff.ndim == ndim) * x.numel())


def sweep_work(r, coeff, weights, ndim, sweeps, from_zero, cheb=False, residual=False):
    """(bytes, operations) of ``sweeps`` damped-Jacobi sweeps (Chebyshev
    sweeps with ``cheb``: four more operations per node) in one call: r,
    sid, the coefficients (and z) read once, z written once (z_prev and the
    [ν, 2] schedule are the kernels' own); with ``residual`` also r − A z
    written, one more apply and subtraction per node."""
    n = r.numel()
    reads = 2 * n + coeff.numel() + (0 if from_zero else n)
    a = apply_flops(weights, ndim, coeff.ndim == ndim)
    per = a + (8 if cheb else 4)
    flops = n * (per * sweeps - (per - 1 if from_zero else 0))
    if residual:
        return 4 * (reads + 2 * n), flops + n * (a + 1)
    return 4 * (reads + n), flops


def cycle_work(ops, nu_pre, nu_post, wdepth, cheb=False):
    """(bytes, operations, grid-barrier phases) of one whole cycle on
    ``ops`` = (coeffs, sids, Rs, inv_c, level weights): r read and z
    written, every operand read once (the Rs over their nonzeros); the
    operations and phases of csrc/mg_cycle2d.cuh's schedule (per visit of
    a level above the coarsest: max(ν_pre, 1) pre-sweep phases, the
    residual's apply, the restriction, one prolongation per child visit,
    ν_post post-sweeps; one dense matvec per coarsest visit). A Chebyshev
    sweep (``cheb``) does four more operations per node."""
    from field_interpolation_tpu_torch.ops.cycle import level_shapes
    coeffs, sids, Rs, inv_c, lw = ops[:5]
    sizes = [math.prod(sh) for sh in level_shapes(coeffs)]
    L = len(sizes)
    nbytes = 4 * (2 * sizes[0] + sum(c.numel() for c in coeffs)
                  + sum(t.numel() for t in sids) + inv_c.numel()
                  + sum(int(torch.count_nonzero(R)) for R in Rs))
    visits, flops, phases = 1, 0, 0
    for l in range(L - 1):
        a = apply_flops(lw[l], 2, coeffs[l].ndim == 2)
        twice = l < wdepth and l + 1 < L - 1
        work = sizes[l] * ((nu_pre + nu_post) * (a + (8 if cheb else 4)) + a
                          + 2 * 6 * (1 + twice))
        if twice:  # the W step's residual update on level l + 1
            work += sizes[l + 1] * (apply_flops(lw[l + 1], 2, True) + 1)
        flops += visits * work
        phases += visits * (max(nu_pre, 1) + 2 + (1 + twice) + nu_post)
        visits *= 2 if twice else 1
    flops += visits * 2 * sizes[-1] ** 2
    return nbytes, flops, phases + visits


def check_close(name, got, want, bar):
    """max|got - want| ≤ bar·max|want| and got finite; returns the error."""
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    print(f"{name}: max|kernel-plain| {err:.3e} (bar {bar * scale:.3e})")
    require(bool(torch.isfinite(got).all()), f"{name}: kernel output not finite")
    require(err <= bar * scale, f"{name}: {err} > {bar}·{scale}")
    return err


def compare(name, kernel, plain, bar, work=None, residual=False):
    """Run ``kernel`` and ``plain`` once each, check max|kernel - plain| ≤
    bar·max|plain|, time both (the kernel single and back to back);
    returns the record, with `bound` of ``work`` = (bytes, operations) when
    given. With ``residual`` both return (z, r − A z), each held to the bar
    on its own scale; the record's error is the larger of the two."""
    got, want = kernel(), plain()
    if residual:
        err_z = check_close(f"{name}, z", got[0], want[0], bar)
        err_r = check_close(f"{name}, r - A z", got[1], want[1], bar)
        errs = dict(max_abs_err=max(err_z, err_r), z_max_abs_err=err_z,
                    residual_max_abs_err=err_r)
    else:
        errs = dict(max_abs_err=check_close(name, got, want, bar))
    del got, want
    ms, b2b = cuda_ms(kernel), batch_ms(kernel)
    plain_ms = cuda_ms(plain, PLAIN_REPS)
    print(f"  kernel {ms:.4f} ms (back to back {b2b:.4f}), plain {plain_ms:.4f} ms")
    rec = dict(**errs, ms=ms, batch_ms=b2b, plain_ms=plain_ms)
    if work is not None:
        rec.update(bound(*work))
        print(f"  bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}: "
              f"{work[0] / 1e6:.3f} MB, {work[1] / 1e6:.3f} MFLOP)")
    return rec


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
                    lambda: fused_normal_apply_plain(x, coeff, w, 2), 1e-5,
                    apply_work(x, coeff, w, 2))
        rec = rec or r
    return problem, ops, rec


def phase_segment(problem, ops, device, wdepth=0, label=""):
    """The segment kernel against its plain version at tol 1e-4 from x = 0
    on ``ops`` (`build_fused_solver_operands`; their Chebyshev schedules,
    if any, go to both)."""
    from field_interpolation_tpu_torch.ops.pcg import (fused_pcg_solve,
                                                       fused_pcg_solve_plain)
    coeffs, sids, Rs, inv32, lw, cfs = ops
    b = problem.b
    x0 = torch.zeros_like(b)
    tol2 = (1e-4 ** 2 * torch.sum(b * b)).reshape(1, 1)
    budget = torch.full((1, 1), 2000, dtype=torch.int32, device=device)
    args = (x0, b, tol2, budget, coeffs, sids, Rs, inv32, lw, 3, cfs)
    xk, ik, rrk = fused_pcg_solve(*args, wdepth=wdepth)
    xp, ip, rrp = fused_pcg_solve_plain(*args, wdepth=wdepth)
    torch.cuda.synchronize()
    ik, ip = int(ik.item()), int(ip.item())
    err = float((xk - xp).abs().max())
    scale = float(xp.abs().max())
    ms = cuda_ms(lambda: fused_pcg_solve(*args, wdepth=wdepth))
    dev_ms = batch_ms(lambda: fused_pcg_solve(*args, wdepth=wdepth))
    plain_ms = cuda_ms(lambda: fused_pcg_solve_plain(*args, wdepth=wdepth), PLAIN_REPS)
    # The segment's work: the cycle's operands and x, r read once, x
    # written; ik cycles, applies and CG updates (the kernel runs no cycle
    # it does not use); per iteration the cycle's phases and 3 more, and
    # one for the start.
    n = b.numel()
    cb, cf, cp = cycle_work(ops, 3, 3, wdepth, cheb=cfs is not None)
    work = (cb + 4 * n, ik * cf + ik * n * (apply_flops(lw[0], 2, False) + 12))
    phases = 1 + ik * (cp + 3)
    print(f"segment{label} tol 1e-4, wdepth {wdepth}: iterations kernel {ik} plain {ip}; "
          f"max|x_kernel-x_plain| {err:.3e} (bar {2e-3 * scale:.3e}); "
          f"rr kernel {float(rrk.item()):.4e} plain {float(rrp.item()):.4e}; "
          f"kernel {ms:.3f} ms, back to back {dev_ms:.3f} ms ({1e3 * dev_ms / max(ik, 1):.1f} "
          f"us/iter, {phases} grid-barrier phases, {1e3 * dev_ms / phases:.2f} us/phase), "
          f"plain {plain_ms:.3f} ms ({1e3 * plain_ms / max(ip, 1):.1f} us/iter)")
    require(abs(ik - ip) <= 2, f"segment iterations {ik} vs {ip}")
    require(err <= 2e-3 * scale, f"segment x: {err} > 2e-3·{scale}")
    rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **bound(*work), batch_ms=dev_ms)
    print(f"  bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})")
    return rec, ik


def check_precise(label, ft, grid, weights, pts, nrm, x, info, device):
    """Converged, finite, of the grid's shape; the true float64 residual
    (the port's plain float64 operator) ≤ TOL and the reported one within
    2% of it. Returns the true residual."""
    zeros = torch.zeros(len(pts), dtype=torch.float32, device=device)
    pp = ft.assemble_precise(grid, weights, pts, zeros, gradients=nrm)
    true = float(torch.linalg.norm(pp.residual64(x)) / torch.linalg.norm(pp.b64))
    rep = float(info.rel_residual)
    require(bool(info.converged), f"{label} did not converge")
    require(tuple(x.shape) == grid.shape and bool(torch.isfinite(x).all()),
            f"{label}: field not finite or wrong shape")
    require(true <= TOL, f"{label}: true residual {true} > {TOL}")
    require(abs(true - rep) <= 0.02 * true, f"{label}: reported {rep} vs true {true}")
    return true


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
        (x, info), ms = timed(lambda: ft.sdf_from_points_precise(
            grid, weights, pts, nrm, config=cfg))
        results.append((x, info, ms))
    launches = {"fused_normal_apply": fused_normal_apply.launches,
                "fused_pcg_solve": fused_pcg_solve.launches}

    for seed, (pts, nrm), (x, info, ms) in zip(SEEDS, inputs, results):
        true = check_precise(f"seed {seed}", ft, grid, weights, pts, nrm, x, info, device)
        print(f"field seed {seed}: iterations {int(info.iterations)}, reported "
              f"rel {float(info.rel_residual):.6e}, true rel {true:.6e}, {ms:.3f} ms, "
              f"finite {bool(torch.isfinite(x).all())}, shape {tuple(x.shape)}")
    ms_all = [ms for _, _, ms in results]
    print(f"main path: {len(ms_all)} fields, ms/field mean "
          f"{statistics.mean(ms_all):.3f}, median {statistics.median(ms_all):.3f}, "
          f"min {min(ms_all):.3f}, max {max(ms_all):.3f}; launches {launches}")
    for name, n in launches.items():
        require(n > 0, f"{name} was not launched on the main path")
    return launches, ms_all, [int(info.iterations) for _, info, _ in results]


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
                    lambda: fused_normal_apply_plain(x, coeff, wl, 3), 1e-5,
                    apply_work(x, coeff, wl, 3))
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
    compare(f"sweep {shape_str(SHAPE3)} lumped fine level, 1 sweep from z",
            lambda: fused_sweep(r0, z0, fd, sid0, p128.weights),
            lambda: fused_smooth_plain(r0, z0, fd, sid0, p128.weights, 3, 1),
            2e-5, sweep_work(r0, fd, p128.weights, 3, 1, False))
    # The cycle's calls on the fine level: the pre-smoothing phase with the
    # residual it restricts, and the post-smoothing phase from z.
    rec = None
    for from_zero, residual in ((True, True), (False, False)):
        got = compare(f"smooth {shape_str(SHAPE3)} lumped fine level, 3 sweeps, "
                      f"from_zero={from_zero}, residual={residual}",
                      lambda: fused_smooth(r0, z0, fd, sid0, p128.weights, 3, 3, from_zero,
                                           residual=residual),
                      lambda: fused_smooth_plain(r0, z0, fd, sid0, p128.weights, 3, 3,
                                                 from_zero, residual=residual),
                      2e-5, sweep_work(r0, fd, p128.weights, 3, 3, from_zero,
                                       residual=residual), residual)
        rec = rec or got
    r1, z1 = rand(lvl1.shape), rand(lvl1.shape)
    for from_zero in (True, False):
        compare(f"smooth {shape_str(lvl1.shape)} level diag, 3 sweeps, "
                f"from_zero={from_zero}, residual=True",
                lambda: fused_smooth(r1, z1, lvl1.data_diag, sid1, lvl1.weights,
                                     3, 3, from_zero, residual=True),
                lambda: fused_smooth_plain(r1, z1, lvl1.data_diag, sid1,
                                           lvl1.weights, 3, 3, from_zero, residual=True),
                2e-5, sweep_work(r1, lvl1.data_diag, lvl1.weights, 3, 3, from_zero,
                                 residual=True), True)
    l32 = tmg.build_levels(p32, cfg)
    lump32, _, taus32, _ = tmg.build_smoothing_setup(p32, l32, cfg)
    require(not lump32, "32^3 smooths with the full data stencil")
    sid32 = (taus32[0] * tmg._inv_diag(p32.diag)).contiguous()
    r2, z2 = rand(p32.grid.shape), rand(p32.grid.shape)
    compare(f"smooth {shape_str(p32.grid.shape)} 27-channel, 3 sweeps, residual=True",
            lambda: fused_smooth(r2, z2, p32.coeff, sid32, p32.weights, 3, 3,
                                 residual=True),
            lambda: fused_smooth_plain(r2, z2, p32.coeff, sid32, p32.weights, 3, 3,
                                       residual=True),
            2e-5, sweep_work(r2, p32.coeff, p32.weights, 3, 3, False, residual=True), True)
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
        (x, info), ms = timed(lambda: ft.sdf_from_points(grid, weights, *inputs[seed],
                                                         config=cfg))
        fields.append((seed, x, info, ms))
    precise = []
    for seed in SEEDS3_PRECISE:
        (x, info), ms = timed(lambda: ft.sdf_from_points_precise(
            grid, weights, *inputs[seed], config=cfg_precise))
        precise.append((seed, x, info, ms))
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
        true = check_precise(f"3-D precise seed {seed}", ft, grid, weights,
                             *inputs[seed], x, info, device)
        print(f"3-D precise field seed {seed}: iterations {int(info.iterations)}, "
              f"reported rel {float(info.rel_residual):.6e}, true rel {true:.6e}, "
              f"{ms:.3f} ms")
    ms_all = [ms for *_, ms in fields]
    print(f"3-D main path: {len(ms_all)} fields at tol 1e-4, ms/field mean "
          f"{statistics.mean(ms_all):.3f}, median {statistics.median(ms_all):.3f}, "
          f"min {min(ms_all):.3f}, max {max(ms_all):.3f}; precise fields "
          f"{', '.join(f'{ms:.3f}' for *_, ms in precise)} ms; launches {launches}")
    for name in ("fused_normal_apply", "fused_smooth"):
        require(launches[name] > 0, f"{name} was not launched on the 3-D path")
    require(launches["fused_pcg_solve"] == 0, "the 3-D path launched fused_pcg_solve")
    return launches, {seed: int(info.iterations) for seed, _, info, _ in fields}, fields[0]


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


class StageClock:
    """Synchronized host clocks of named stages, in ms."""

    def __init__(self):
        self.stages = {}

    def __call__(self, name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        self.stages.setdefault(name, []).append(1e3 * (time.perf_counter() - t0))
        return out

    def line(self):
        return "; ".join(f"{k} {', '.join(f'{t:.3f}' for t in v)} ms"
                         for k, v in self.stages.items())


def trace_events(prof):
    """(device type, name, start µs, end µs) of each of the profile's trace
    events. Reads the raw events of the private ``prof.profiler.kineto_results``
    (building prof.events()' annotated event tree takes ~100 s for a config-5
    field's ~600k events) and falls back to prof.events() on a torch release
    without that field."""
    kineto = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if kineto is not None:
        return [(e.device_type(), e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3)
                for e in kineto.events()]
    return [(e.device_type, e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()]


def profile_fields(label, fields, must_see):
    """``torch.profiler`` over ``fields`` (callables, one field each): the
    device's busy and idle share, kernels, launches, host->device copies and
    synchronizations per field, and device time per kind of work; fails if
    a kind in ``must_see`` did not run on the card. Returns per field the
    kernels on the device, the launch calls, the idle share and the busy ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for field in fields:
            field()
        torch.cuda.synchronize()
        span = 1e3 * (time.perf_counter() - t0)
    events = trace_events(prof)
    dev = [e for e in events if e[0] == DeviceType.CUDA]
    host = [e for e in events if e[0] == DeviceType.CPU]
    busy = busy_ms((e[2], e[3]) for e in dev)
    n = len(fields)
    # The segment and cycle kernels go through cudaLaunchCooperativeKernel.
    launch = [e for e in host if re.match(r"cudaLaunch(Cooperative)?Kernel", e[1])]
    syncs = sum(e[1] in ("cudaStreamSynchronize", "cudaDeviceSynchronize") for e in host)
    kernels = [e for e in dev if not re.search(r"Memcpy|Memset", e[1])]
    launch_ms = sum(e[3] - e[2] for e in launch) / n / 1e3
    previous = (f" (the previous smoothing design: {PREVIOUS_KERNELS[label]})"
                if label in PREVIOUS_KERNELS else "")
    print(f"profile {label}, torch.profiler over {n} field(s): span {span:.3f} ms, "
          f"device busy {busy:.3f} ms, device idle share {1 - busy / span:.3f}; per "
          f"field: {len(kernels) / n:.0f} kernels on the device{previous}, {len(launch) / n:.0f} "
          f"cudaLaunch(Cooperative)Kernel calls ({launch_ms:.3f}"
          f" ms host), {sum('HtoD' in e[1] for e in dev) / n:.0f} host->device "
          f"copies, {syncs / n:.0f} stream synchronizations")
    totals, counts = {}, {}
    for _, name, t0, t1 in dev:
        kind = next((k for k, pat in DEVICE_KINDS if re.search(pat, name)),
                    "plain elementwise and reduction ops")
        totals[kind] = totals.get(kind, 0.0) + t1 - t0
        counts[kind] = counts.get(kind, 0) + 1
    for kind, us in sorted(totals.items(), key=lambda kv: -kv[1]):
        print(f"  device {kind}: {us / n / 1e3:.3f} ms/field, "
              f"{counts[kind] / n:.0f} per field")
    for kind in must_see:
        require(counts.get(kind, 0) > 0, f"the profile shows no {kind} on the card")
    return dict(kernels=len(kernels) / n, launch_calls=len(launch) / n,
                idle=1 - busy / span, busy_ms=busy / n)


def phase_profile3d(ft, device):
    from field_interpolation_tpu_torch import solver
    grid, weights = ft.Grid(SHAPE3), ft.Weights(model_2=0.3)
    cfg = ft.SolverConfig(tol=1e-4, preconditioner="multigrid")
    clock = StageClock()
    for seed in PROFILE_SEEDS:
        pts, nrm = sphere_inputs(seed, device)
        p = clock("assemble_sdf", lambda: ft.assemble_sdf(grid, weights, pts, nrm))
        apply_fn = solver._make_apply(p, cfg)
        pc = clock("preconditioner setup",
                   lambda: solver._make_precond(p, cfg, apply_fn))
        clock("one cycle", lambda: pc(p.b))
        clock("one apply", lambda: apply_fn(p.b))
        clock("solve", lambda: ft.solve(p, cfg))
    print(f"profile config 4, host clocks after synchronize, seeds "
          f"{PROFILE_SEEDS.start}..{PROFILE_SEEDS.stop - 1}: {clock.line()}")
    inputs = [sphere_inputs(s, device) for s in range(1)]
    profile_fields("config 4", [
        lambda pts=pts, nrm=nrm: ft.sdf_from_points(grid, weights, pts, nrm, config=cfg)
        for pts, nrm in inputs], ("sweep kernel", "apply kernel"))


def circle5_inputs(seed, device, shape=None, n=None):
    """BASELINE config 5's proxy cloud (bench.py:272-276), θ from ``seed``:
    n oriented points on a circle of radius 0.35·width around the center
    (2047.5 + 1433.6·n̂ at 4096²)."""
    shape, n = shape or SHAPE5, n or N_POINTS5
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0, 2 * np.pi, n)
    nrm = np.stack([np.cos(theta), np.sin(theta)], -1).astype(np.float32)
    center = (np.asarray(shape, np.float64) - 1.0) / 2.0
    pts = (center + (1433.6 / 4096.0) * shape[0] * nrm).astype(np.float32)
    return (torch.as_tensor(pts, device=device),
            torch.as_tensor(nrm, device=device))


def fine_smoothing_operands(p, cfg):
    """(levels, τ·D⁻¹ per level incl. the fine one) of a problem's cycle."""
    from field_interpolation_tpu_torch import multigrid as tmg
    levels = tmg.build_levels(p, cfg)
    lump, _, taus, _ = tmg.build_smoothing_setup(p, levels, cfg)
    require(not lump, f"{shape_str(p.grid.shape)} smooths with the full data stencil")
    inv = [tmg._inv_diag(p.diag)] + [tmg._inv_diag(l.diag) for l in levels]
    return levels, [(t * d).contiguous() for t, d in zip(taus, inv)]


def phase_smooth2d(ft, device):
    """The 2-D apply on config 5's 9-channel problems, then the multi-sweep
    kernel's phases (2e-5·max|plain|): as the cycle runs them (ν = 3), from
    zero with the residual (the pre-smoothing) and from z (the
    post-smoothing), on config 5's 4096² fine level and the fmg grid's
    2048²; at 1000×1030 with radius-3 weights ν = 2 from z (one launch) and
    ν = 3 from z with the residual, a phase of 12 halo nodes that takes two
    launches; each beside the same phase through the per-sweep kernel.
    Returns (p5, {form: record}, apply record)."""
    from field_interpolation_tpu_torch.ops.smooth import (fused_smooth, fused_smooth_2d,
                                                          fused_smooth_plain)
    from field_interpolation_tpu_torch.ops.stencil import (
        fused_normal_apply, fused_normal_apply_plain)
    rng = np.random.default_rng(5)
    cfg = ft.SolverConfig(**CFG5)
    w = ft.Weights(model_2=0.3)
    pts, nrm = circle5_inputs(0, device)
    p5 = ft.assemble_sdf(ft.Grid(SHAPE5), w, pts, nrm)
    # The fmg guess's problem: the same cloud on the (n+1)//2 grid.
    cshape = tuple((n + 1) // 2 for n in SHAPE5)
    scale = (np.asarray(cshape) - 1.0) / (np.asarray(SHAPE5) - 1.0)
    p2 = ft.assemble_sdf(ft.Grid(cshape), w, pts * torch.as_tensor(
        scale, dtype=torch.float32, device=device), nrm)
    odd = (1000, 1030)
    podd = ft.assemble_sdf(ft.Grid(odd), ft.Weights(**RADIUS3_WEIGHTS),
                           *circle5_inputs(0, device, odd, 20_000))
    apply_rec = None
    for label, p in [("config 5 (reference: fused_normal_apply_striped)", p5),
                     ("fmg grid (reference: fused_normal_apply_striped)", p2)]:
        x = torch.as_tensor(rng.standard_normal(p.grid.shape).astype(np.float32),
                            device=device)
        got = compare(f"apply {shape_str(p.grid.shape)} {label}, 9-channel",
                      lambda: fused_normal_apply(x, p.coeff, p.weights, 2),
                      lambda: fused_normal_apply_plain(x, p.coeff, p.weights, 2), 1e-5,
                      apply_work(x, p.coeff, p.weights, 2))
        apply_rec = apply_rec or got
    recs = {}
    for key, label, p, nu, fz, res, launches in [
            ("4096_from_zero_residual", "config 5 fine level (reference: fused_smooth_tiled)",
             p5, 3, True, True, 1),
            ("4096_from_z", "config 5 fine level", p5, 3, False, False, 1),
            ("2048_from_zero_residual", "fmg grid's fine level (reference: "
             "fused_smooth_striped)", p2, 3, True, True, 1),
            ("2048_from_z", "fmg grid's fine level", p2, 3, False, False, 1),
            ("1000x1030_radius3", "radius-3 weights", podd, 2, False, False, 1),
            ("1000x1030_radius3_split", "radius-3 weights", podd, 3, False, True, 2)]:
        shape = p.grid.shape
        sid = fine_smoothing_operands(p, cfg)[1][0]
        r, z = (torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                                device=device) for _ in range(2))
        before = fused_smooth_2d.launches
        fused_smooth_2d(r, z, p.coeff, sid, p.weights, nu, fz, residual=res)
        made = fused_smooth_2d.launches - before
        require(made == launches, f"multi-sweep {shape_str(shape)}: {made} launches, "
                                  f"not {launches}")
        recs[key] = got = compare(
            f"multi-sweep {shape_str(shape)} {label}, {nu} sweeps, from_zero={fz}, "
            f"residual={res}, {made} launch(es) in one call",
            lambda: fused_smooth_2d(r, z, p.coeff, sid, p.weights, nu, fz, residual=res),
            lambda: fused_smooth_plain(r, z, p.coeff, sid, p.weights, 2, nu, fz,
                                       residual=res),
            2e-5, sweep_work(r, p.coeff, p.weights, 2, nu, fz, residual=res), res)
        # The same phase through the per-sweep kernel (one launch per sweep
        # that reads neighbours, one for the residual), as a yardstick.
        per_ms = batch_ms(lambda: fused_smooth(r, z, p.coeff, sid, p.weights, 2, nu, fz,
                                               residual=res))
        nbytes = sweep_work(r, p.coeff, p.weights, 2, nu, fz, residual=res)[0]
        print(f"  multi-sweep {got['batch_ms']:.4f} ms back to back, "
              f"{nbytes / got['batch_ms'] / 1e6:.0f} GB/s of the {nbytes / 1e9:.3f} GB the "
              f"phase must move; per-sweep kernel {per_ms:.4f} ms back to back")
    del p2, podd
    return p5, recs, apply_rec


def phase_sweep2d(ft, device, p5):
    from field_interpolation_tpu_torch.ops.smooth import (fused_smooth, fused_smooth_plain,
                                                          fused_sweep)
    rng = np.random.default_rng(6)
    levels, sids = fine_smoothing_operands(p5, ft.SolverConfig(**CFG5))

    def operands(li):
        lvl = levels[li - 1]
        r, z = (torch.as_tensor(rng.standard_normal(lvl.shape).astype(np.float32),
                                device=device) for _ in range(2))
        return lvl, lvl.data_diag.contiguous(), sids[li], r, z

    rec = None
    for li in (1, 2):
        lvl, dd, sid, r, z = operands(li)
        compare(f"sweep {shape_str(lvl.shape)} config 5 diagonal level "
                f"(reference: fused_sweep_striped_diag), 1 sweep",
                lambda: fused_sweep(r, z, dd, sid, lvl.weights),
                lambda: fused_smooth_plain(r, z, dd, sid, lvl.weights, 2, 1),
                2e-5, sweep_work(r, dd, lvl.weights, 2, 1, False))
        # The cycle's pre-smoothing call on the level: ν = 3 from zero and
        # the residual it restricts.
        got = compare(f"smooth {shape_str(lvl.shape)} config 5 diagonal level, 3 sweeps, "
                      f"from_zero=True, residual=True",
                      lambda: fused_smooth(r, z, dd, sid, lvl.weights, 2, 3, True,
                                           residual=True),
                      lambda: fused_smooth_plain(r, z, dd, sid, lvl.weights, 2, 3, True,
                                                 residual=True),
                      2e-5, sweep_work(r, dd, lvl.weights, 2, 3, True, residual=True), True)
        rec = rec or got
    # The whole-level diagonal form (the reference's fused_smooth) on the
    # first level that fits VMEM, from zero.
    lvl, dd, sid, r, z = operands(3)
    compare(f"smooth {shape_str(lvl.shape)} config 5 diagonal level "
            f"(reference: fused_smooth), 3 sweeps, from_zero=True, residual=True",
            lambda: fused_smooth(r, z, dd, sid, lvl.weights, 2, 3, True, residual=True),
            lambda: fused_smooth_plain(r, z, dd, sid, lvl.weights, 2, 3, True,
                                       residual=True), 2e-5,
            sweep_work(r, dd, lvl.weights, 2, 3, True, residual=True), True)
    return rec


def record_solves(sdf_module):
    """Record the SolveInfo of every `solve` the sdf module makes (the fmg
    guess's coarse solves, then the fine one); returns (infos, restore)."""
    inner = sdf_module.solve
    infos = []

    def solve(*args, **kwargs):
        x, info = inner(*args, **kwargs)
        infos.append(info)
        return x, info
    sdf_module.solve = solve
    return infos, lambda: setattr(sdf_module, "solve", inner)


def phase_main5(ft, device):
    from field_interpolation_tpu_torch import sdf as tsdf
    from field_interpolation_tpu_torch.ops.pcg import fused_pcg_solve
    from field_interpolation_tpu_torch.ops.smooth import fused_smooth, fused_smooth_2d
    from field_interpolation_tpu_torch.ops.stencil import fused_normal_apply
    grid, weights = ft.Grid(SHAPE5), ft.Weights(model_2=0.3)
    cfg = ft.SolverConfig(**CFG5)
    cfg_xla = ft.SolverConfig(**{**CFG5, "backend": "xla"})
    cfg_precise = ft.SolverConfig(**{**CFG5, "tol": 1e-6})
    inputs = {s: circle5_inputs(s, device) for s in SEEDS5}
    torch.cuda.synchronize()

    counters = (fused_normal_apply, fused_smooth, fused_smooth_2d, fused_pcg_solve)
    coarse, restore = record_solves(tsdf)
    try:
        for c in counters:
            c.launches = 0
        fields = []
        for seed in SEEDS5:
            coarse.clear()
            (x, info), ms = timed(lambda: ft.sdf_from_points(
                grid, weights, *inputs[seed], config=cfg, fmg_start=FMG5))
            fields.append((seed, x, info, ms, [int(i.iterations) for i in coarse[:-1]]))
        coarse.clear()
        (xp, infop), msp = timed(lambda: ft.sdf_from_points_precise(
            grid, weights, *inputs[0], config=cfg_precise, fmg_start=FMG5))
        coarse_p = [int(i.iterations) for i in coarse]
        launches = {c.__name__: c.launches for c in counters}
    finally:
        restore()

    for seed, x, info, ms, its_c in fields:
        print(f"config 5 field seed {seed}: fine iterations {int(info.iterations)}, "
              f"coarse (fmg) iterations {its_c}, rel {float(info.rel_residual):.3e}, "
              f"{ms:.3f} ms, finite {bool(torch.isfinite(x).all())}, shape {tuple(x.shape)}")
        require(bool(info.converged), f"config 5 seed {seed} did not converge")
        require(tuple(x.shape) == SHAPE5 and bool(torch.isfinite(x).all()),
                f"config 5 seed {seed}: field not finite or wrong shape")
    seed, x, info, _, _ = fields[0]
    xr, ir = ft.sdf_from_points(grid, weights, *inputs[seed], config=cfg_xla,
                                fmg_start=FMG5)
    it, itr = int(info.iterations), int(ir.iterations)
    err, scale = float((x - xr).abs().max()), float(xr.abs().max())
    print(f"config 5 seed {seed} against backend='xla': iterations {it} (xla {itr}), "
          f"max|x-x_xla| {err:.3e} (bar {2e-3 * scale:.3e})")
    require(bool(ir.converged), "config 5: the xla solve did not converge")
    require(abs(it - itr) <= 2, f"config 5: iterations {it} vs xla {itr}")
    require(err <= 2e-3 * scale, f"config 5: {err} > 2e-3·{scale}")
    true = check_precise("config 5 precise", ft, grid, weights, *inputs[0], xp, infop,
                         device)
    print(f"config 5 precise field seed 0: iterations {int(infop.iterations)}, coarse "
          f"(fmg) iterations {coarse_p}, reported rel {float(infop.rel_residual):.6e}, "
          f"true rel {true:.6e}, {msp:.3f} ms")
    ms_all = [ms for *_, ms, _ in fields]
    print(f"config 5 main path: {len(ms_all)} fields at tol 1e-4, ms/field "
          f"{', '.join(f'{ms:.3f}' for ms in ms_all)}; precise {msp:.3f} ms; "
          f"launches {launches}")
    for name in ("fused_normal_apply", "fused_smooth", "fused_smooth_2d"):
        require(launches[name] > 0, f"{name} was not launched on the config 5 path")
    require(launches["fused_pcg_solve"] == 0, "the config 5 path launched fused_pcg_solve")
    return launches, fields[0][1]


def phase_profile5(ft, device):
    from field_interpolation_tpu_torch import sdf as tsdf
    from field_interpolation_tpu_torch import solver
    grid, weights = ft.Grid(SHAPE5), ft.Weights(model_2=0.3)
    cfg = ft.SolverConfig(**CFG5)
    pts, nrm = circle5_inputs(0, device)
    clock = StageClock()
    cshape = shape_str(tuple((n + 1) // 2 for n in SHAPE5))
    guess = clock(f"fmg guess ({cshape} solve, prolong)", lambda: tsdf._fmg_guess(
        grid, weights, pts, nrm, None, cfg, FMG5))
    p = clock("assemble_sdf", lambda: ft.assemble_sdf(grid, weights, pts, nrm))
    apply_fn = solver._make_apply(p, cfg)
    pc = clock("preconditioner setup", lambda: solver._make_precond(p, cfg, apply_fn))
    clock("one cycle", lambda: pc(p.b))
    clock("one apply", lambda: apply_fn(p.b))
    clock("solve from the guess", lambda: ft.solve(p, cfg, x0=guess))
    print(f"profile config 5, host clocks after synchronize, seed 0: {clock.line()}")
    del p, pc, guess
    profile_fields("config 5", [lambda: ft.sdf_from_points(
        grid, weights, pts, nrm, config=cfg, fmg_start=FMG5)],
        ("multi-sweep kernel", "sweep kernel", "apply kernel"))


def field_a_inputs(seed, device, shape=SHAPE_A, n=N_POINTS_A):
    pts, nrm = make_circle_cloud(n, shape, seed=seed)
    return (torch.as_tensor(pts, device=device),
            torch.as_tensor(nrm, device=device))


def phase_cycle(ft, device, shape=SHAPE_A, change=None):
    """The whole-cycle kernel against mg_cycle_plain on the operands of
    field A (``shape``, the default config; W, V, V with ν_pre ≠ ν_post)
    and of a 256² lumped problem (V), each timed beside one plain-torch
    cycle (the backend="xla" preconditioner). With ``change`` (the
    Chebyshev options: field A′) the W and V cycles under it, each also
    beside the damped-Jacobi cycle kernel on the same problem.

    Each case is checked twice at the reference's bar 3e-5·max|plain|: z on
    a standard-normal r, whose z is dominated by the coarse-grid correction
    of the near-null space (max|z| ~ 1e7 at 496²), so that an error of the
    fine level's sweeps or prolongation hides under the bar; and the fine
    residual r - A·z in float64 on r = A·x for a standard-normal x, which
    such an error moves by a quarter of its size. z itself on r = A·x is no
    check: float32 rounding through the near-singular coarsest solve moves
    it by ~1% of max|z| (plain float32 against float64), while A maps that
    smooth error to ~1e-5 of the residual."""
    from field_interpolation_tpu_torch import multigrid as tmg
    from field_interpolation_tpu_torch.ops.cycle import (fused_vcycle_2d, fused_wcycle_2d,
                                                         mg_cycle_plain)
    from field_interpolation_tpu_torch.ops.stencil import fused_normal_apply_plain
    rng = np.random.default_rng(9)
    w = ft.Weights(model_2=0.3)
    pa = ft.assemble_sdf(ft.Grid(shape), w, *field_a_inputs(0, device, shape))
    name_a = "field A′" if change else "field A"
    v = dict(mg_cycle="v")
    cases = [(f"{name_a}, W", pa, {}, 3, 3, 99), (f"{name_a}, V", pa, v, 3, 3, 0)]
    if not change:
        p256 = ft.assemble_sdf(ft.Grid(SHAPE), w, *headline_inputs(0, device))
        cases += [("field A, V", pa, v, 2, 3, 0),
                  ("256² lumped, V", p256, dict(mg_fine_operator="lumped"), 3, 3, 0)]
    rec, runs = None, []
    # The operands do not depend on ν: the ν_pre ≠ ν_post case (which the
    # route never plans) runs on the V-cycle's.
    for label, p, cfg_kw, nu_pre, nu_post, wdepth in cases:
        cfg = ft.SolverConfig(tol=1e-4, **(change or {}), **cfg_kw)
        whole = tmg.whole_cycle_operands(p, cfg)
        require(whole is not None and (whole[1] > 0) == (wdepth > 0),
                f"{label}: the route hands {whole and whole[1]} as wdepth")
        ops, _, cfs = whole
        require((cfs is not None) == bool(change), f"{label}: schedules {cfs}")
        x = torch.as_tensor(rng.standard_normal(p.grid.shape).astype(np.float32),
                            device=device)
        c64 = ops[0][0].double()

        def fine_residual(r, z):
            return r.double() - fused_normal_apply_plain(z.double(), c64, ops[4][0], 2)

        r_ax = fused_normal_apply_plain(x, ops[0][0], ops[4][0], 2)
        r = torch.as_tensor(rng.standard_normal(p.grid.shape).astype(np.float32),
                            device=device)

        def kernel(r=r, ops=ops, cfs=cfs):
            if wdepth:
                return fused_wcycle_2d(r, *ops, nu_pre, cheb_coefs=cfs, wdepth=wdepth)
            return fused_vcycle_2d(r, *ops, nu_pre, nu_post, cheb_coefs=cfs)

        def plain(r=r):
            return mg_cycle_plain(r, *ops, nu_pre, nu_post, wdepth, cheb_coefs=cfs)

        name = (f"cycle {shape_str(p.grid.shape)} {label}, nu {nu_pre}/{nu_post}, "
                f"wdepth {wdepth}, {len(ops[0])} levels"
                + (f", {cfg.mg_smoother}" if change else ""))
        check_close(f"{name}, r = A·x, fine residual r - A·z",
                    fine_residual(r_ax, kernel(r_ax)), fine_residual(r_ax, plain(r_ax)),
                    3e-5)
        nbytes, flops, phases = cycle_work(ops, nu_pre, nu_post, wdepth,
                                           cheb=cfs is not None)
        got = compare(f"{name}, standard-normal r", kernel, plain, 3e-5, (nbytes, flops))
        dev_ms = batch_ms(kernel)
        xla = tmg.make_vcycle_preconditioner(p, ft.SolverConfig(
            tol=1e-4, **(change or {}), **cfg_kw, mg_pre_smooth=nu_pre,
            mg_post_smooth=nu_post))
        xla_ms = cuda_ms(lambda: xla(r), PLAIN_REPS)
        print(f"  back to back {dev_ms:.4f} ms per launch; {phases} "
              f"grid-barrier phases, {1e3 * dev_ms / phases:.2f} us/phase; one plain-torch "
              f"cycle (backend='xla') {xla_ms:.3f} ms, {xla_ms / got['ms']:.1f}x the kernel")
        if change:
            jops = tmg.whole_cycle_operands(p, ft.SolverConfig(tol=1e-4, **cfg_kw))[0]
            jac = (lambda: fused_wcycle_2d(r, *jops, nu_pre, wdepth=wdepth)) if wdepth \
                else (lambda: fused_vcycle_2d(r, *jops, nu_pre, nu_post))
            got["jacobi_ms"], got["jacobi_batch_ms"] = cuda_ms(jac), batch_ms(jac)
            print(f"  the damped-Jacobi cycle kernel on the same problem: "
                  f"{got['jacobi_ms']:.4f} ms, back to back {got['jacobi_batch_ms']:.4f} ms")
        rec = rec or dict(got, batch_ms=dev_ms, xla_cycle_ms=xla_ms, phases=phases)
        runs.append((dev_ms, phases))
    # The W-cycle's extra phases over the V-cycle's on the same operands all
    # run on the coarse levels (≤ 248², little work): their cost per phase
    # is the grid barrier's.
    (w_ms, w_phases), (v_ms, v_phases) = runs[:2]
    barrier_us = 1e3 * (w_ms - v_ms) / (w_phases - v_phases)
    print(f"cycle: measured cost of a coarse-level phase (W minus V at "
          f"{shape_str(shape)}, back to back) {barrier_us:.2f} us; W {w_phases} phases x "
          f"{barrier_us:.2f} us = {w_phases * barrier_us / 1e3:.4f} ms, V {v_phases} x "
          f"{barrier_us:.2f} us = {v_phases * barrier_us / 1e3:.4f} ms")
    return dict(rec, barrier_us=barrier_us)


def counters_zero():
    """Set every kernel's launch counts to 0; returns a function that reads
    them: {name: launches, name_cheb: launches in Chebyshev mode}."""
    from field_interpolation_tpu_torch.ops.cycle import fused_vcycle_2d, fused_wcycle_2d
    from field_interpolation_tpu_torch.ops.pcg import fused_pcg_solve, fused_pcg_solve_batch
    from field_interpolation_tpu_torch.ops.smooth import fused_smooth, fused_smooth_2d
    from field_interpolation_tpu_torch.ops.stencil import (fused_normal_apply,
                                                           fused_normal_apply_batch)
    counters = (fused_normal_apply, fused_normal_apply_batch, fused_smooth, fused_smooth_2d,
                fused_pcg_solve, fused_pcg_solve_batch, fused_vcycle_2d, fused_wcycle_2d)
    moded = counters[2:]  # every kernel but the applies has a Chebyshev mode
    laned = (fused_smooth, fused_smooth_2d, fused_vcycle_2d, fused_wcycle_2d)  # lane forms
    for c in counters:
        c.launches = 0
    for c in moded:
        c.cheb_launches = 0
    for c in laned:
        c.lane_launches = 0
    return lambda: {**{c.__name__: c.launches for c in counters},
                    **{c.__name__ + "_cheb": c.cheb_launches for c in moded},
                    **{c.__name__ + "_lanes": c.lane_launches for c in laned}}


def phase_field_a(ft, device):
    """Field A, the slice's main path: 496², 2000 points, the default
    config, where the reference runs fused_wcycle_2d. First the apply
    kernel against its plain version on the field's 9-channel problem
    (the cycle kernel on its operands is phase 14's)."""
    from field_interpolation_tpu_torch.ops.stencil import (
        fused_normal_apply, fused_normal_apply_plain)
    grid, weights = ft.Grid(SHAPE_A), ft.Weights(model_2=0.3)
    cfg = ft.SolverConfig(tol=1e-4)
    cfg_xla = ft.SolverConfig(tol=1e-4, backend="xla")
    inputs = {s: field_a_inputs(s, device) for s in SEEDS_A}
    p = ft.assemble_sdf(grid, weights, *inputs[0])
    x = torch.as_tensor(np.random.default_rng(10).standard_normal(SHAPE_A)
                        .astype(np.float32), device=device)
    apply_rec = compare(f"apply {shape_str(SHAPE_A)} field A, 9-channel (reference: "
                        f"fused_normal_apply_striped)",
                        lambda: fused_normal_apply(x, p.coeff, weights, 2),
                        lambda: fused_normal_apply_plain(x, p.coeff, weights, 2), 1e-5,
                        apply_work(x, p.coeff, weights, 2))
    del p
    ft.sdf_from_points(grid, weights, *inputs[0], config=cfg)  # warm-up
    torch.cuda.synchronize()

    read = counters_zero()
    fields = []
    for seed in SEEDS_A:
        (x, info), ms = timed(lambda: ft.sdf_from_points(grid, weights, *inputs[seed],
                                                         config=cfg))
        fields.append((seed, x, info, ms))
    (xp, infop), msp = timed(lambda: ft.sdf_from_points_precise(
        grid, weights, *inputs[0], config=ft.SolverConfig(tol=TOL)))
    launches = read()

    for seed, x, info, ms in fields:
        print(f"field A seed {seed}: iterations {int(info.iterations)}, rel "
              f"{float(info.rel_residual):.3e}, {ms:.3f} ms, finite "
              f"{bool(torch.isfinite(x).all())}, shape {tuple(x.shape)}")
        require(bool(info.converged), f"field A seed {seed} did not converge")
        require(tuple(x.shape) == SHAPE_A and bool(torch.isfinite(x).all()),
                f"field A seed {seed}: field not finite or wrong shape")
    _, x, info, _ = fields[0]
    (xr, ir), ms_xla = timed(lambda: ft.sdf_from_points(grid, weights, *inputs[0],
                                                        config=cfg_xla))
    it, itr = int(info.iterations), int(ir.iterations)
    err, scale = float((x - xr).abs().max()), float(xr.abs().max())
    print(f"field A seed 0 against backend='xla': iterations {it} (xla {itr}), "
          f"max|x-x_xla| {err:.3e} (bar {2e-3 * scale:.3e}); xla {ms_xla:.3f} ms")
    require(bool(ir.converged), "field A: the xla solve did not converge")
    require(abs(it - itr) <= 2, f"field A: iterations {it} vs xla {itr}")
    require(err <= 2e-3 * scale, f"field A: {err} > 2e-3·{scale}")
    true = check_precise("field A precise", ft, grid, weights, *inputs[0], xp, infop,
                         device)
    print(f"field A precise seed 0: iterations {int(infop.iterations)}, reported rel "
          f"{float(infop.rel_residual):.6e}, true rel {true:.6e}, {msp:.3f} ms")
    n = len(SEEDS_A) + 1
    print(f"field A main path: ms/field {', '.join(f'{ms:.3f}' for *_, ms in fields)}; "
          f"precise {msp:.3f} ms; launches {launches} over {n} fields "
          f"({launches['fused_wcycle_2d'] / n:.1f} cycle launches per field)")
    require(launches["fused_wcycle_2d"] > 0, "fused_wcycle_2d was not launched on field A")
    require(launches["fused_normal_apply"] > 0, "the apply kernel was not launched on field A")
    require(launches["fused_pcg_solve"] == 0, "field A launched fused_pcg_solve")
    profile_fields("field A", [lambda: ft.sdf_from_points(
        grid, weights, *inputs[0], config=cfg)], ("cycle kernel", "apply kernel"))
    return launches, apply_rec


def phase_field_b(ft, device, v_ms, v_iters):
    """Field B: the headline (256², 1000 points, tol 1e-6) with the
    reference's W option: the segment kernel with wdepth 99."""
    grid, weights = ft.Grid(SHAPE), ft.Weights(model_2=0.3)
    cfg = ft.SolverConfig(tol=TOL, mg_cycle="w", maxiter=2000)
    inputs = {s: headline_inputs(s, device) for s in SEEDS_B}
    ft.sdf_from_points_precise(grid, weights, *inputs[0], config=cfg)  # warm-up
    torch.cuda.synchronize()
    read = counters_zero()
    fields = []
    for seed in SEEDS_B:
        (x, info), ms = timed(lambda: ft.sdf_from_points_precise(
            grid, weights, *inputs[seed], config=cfg))
        fields.append((seed, x, info, ms))
    launches = read()
    for seed, x, info, ms in fields:
        true = check_precise(f"field B seed {seed}", ft, grid, weights, *inputs[seed],
                             x, info, device)
        print(f"field B seed {seed}: iterations {int(info.iterations)} (V, phase 5: "
              f"{v_iters[seed]}), reported rel {float(info.rel_residual):.6e}, true rel "
              f"{true:.6e}, {ms:.3f} ms (V, phase 5: {v_ms[seed]:.3f} ms)")
    print(f"field B: launches {launches}")
    require(launches["fused_pcg_solve"] > 0, "field B did not launch fused_pcg_solve")


def phase_field_c(ft, device):
    """Field C: 992², 4000 points, tol 1e-4, fmg_start=1: the 496² guess
    runs the whole W-cycle kernel, the fine level the multi-sweep kernel.
    First the kernels of its fine solve against their plain versions on
    its own problem: the apply (1e-5·max|plain|), the multi-sweep kernel
    at 992² (ν = 3 from zero with the residual, and from z) and the
    per-sweep kernel on the 496² diagonal level, ν = 3 from zero and from z
    (2e-5·max|plain|). Returns the launches and the
    records of the apply, multi-sweep and per-sweep checks."""
    from field_interpolation_tpu_torch.ops.smooth import (fused_smooth, fused_smooth_2d,
                                                          fused_smooth_plain)
    from field_interpolation_tpu_torch.ops.stencil import (
        fused_normal_apply, fused_normal_apply_plain)
    grid, weights = ft.Grid(SHAPE_C), ft.Weights(model_2=0.3)
    pts, nrm = field_a_inputs(0, device, SHAPE_C, N_POINTS_C)
    rng = np.random.default_rng(11)

    def rand(shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                               device=device)

    p = ft.assemble_sdf(grid, weights, pts, nrm)
    levels, sids = fine_smoothing_operands(p, ft.SolverConfig(tol=1e-4))
    x, r, z = rand(SHAPE_C), rand(SHAPE_C), rand(SHAPE_C)
    recs = dict(apply=compare(
        f"apply {shape_str(SHAPE_C)} field C, 9-channel (reference: "
        f"fused_normal_apply_striped)",
        lambda: fused_normal_apply(x, p.coeff, weights, 2),
        lambda: fused_normal_apply_plain(x, p.coeff, weights, 2), 1e-5,
        apply_work(x, p.coeff, weights, 2)))
    for key, fz in (("multi", True), ("multi_from_z", False)):
        recs[key] = compare(
            f"multi-sweep {shape_str(SHAPE_C)} field C fine level (reference: "
            f"fused_smooth_striped), 3 sweeps, from_zero={fz}, residual={fz}",
            lambda: fused_smooth_2d(r, z, p.coeff, sids[0], weights, 3, fz, residual=fz),
            lambda: fused_smooth_plain(r, z, p.coeff, sids[0], weights, 2, 3, fz,
                                       residual=fz),
            2e-5, sweep_work(r, p.coeff, weights, 2, 3, fz, residual=fz), fz)
    lvl = levels[0]
    dd, r1, z1 = lvl.data_diag.contiguous(), rand(lvl.shape), rand(lvl.shape)
    for fz in (True, False):
        recs["sweep"] = compare(
            f"smooth {shape_str(lvl.shape)} field C diagonal level (reference: "
            f"fused_smooth), 3 sweeps, from_zero={fz}",
            lambda: fused_smooth(r1, z1, dd, sids[1], lvl.weights, 2, 3, fz),
            lambda: fused_smooth_plain(r1, z1, dd, sids[1], lvl.weights, 2, 3, fz),
            2e-5, sweep_work(r1, dd, lvl.weights, 2, 3, fz))
    del p, levels, sids
    read = counters_zero()
    (x, info), ms = timed(lambda: ft.sdf_from_points(
        grid, weights, pts, nrm, config=ft.SolverConfig(tol=1e-4), fmg_start=1))
    launches = read()
    print(f"field C seed 0: fine iterations {int(info.iterations)}, rel "
          f"{float(info.rel_residual):.3e}, {ms:.3f} ms, finite "
          f"{bool(torch.isfinite(x).all())}, shape {tuple(x.shape)}; launches {launches}")
    require(bool(info.converged), "field C did not converge")
    require(tuple(x.shape) == SHAPE_C and bool(torch.isfinite(x).all()),
            "field C: field not finite or wrong shape")
    for name in ("fused_wcycle_2d", "fused_smooth_2d", "fused_smooth", "fused_normal_apply"):
        require(launches[name] > 0, f"{name} was not launched on field C")
    return launches, recs


def smoothing_levels(p, cfg, nu):
    """Per level li of p's cycle under cfg (0: the fine level): (the data
    term the cycle smooths with, D⁻¹, τ·D⁻¹, the [ν, 2] Chebyshev schedule
    for ρ̂_li, the level's weights)."""
    from field_interpolation_tpu_torch import multigrid as tmg
    levels = tmg.build_levels(p, cfg)
    lump, fine_ddiag, taus, rhos = tmg.build_smoothing_setup(p, levels, cfg)
    out = [((fine_ddiag if lump else p.coeff), p.diag, p.weights)]
    out += [(l.data_diag if l.data_coeff is None else l.data_coeff, l.diag, l.weights)
            for l in levels]
    res = []
    for li, (coeff, diag, w) in enumerate(out):
        inv = tmg._inv_diag(diag)
        res.append((coeff.contiguous(), inv.contiguous(), (taus[li] * inv).contiguous(),
                    tmg.chebyshev_coefs(rhos[li], nu, cfg), w))
    return res


def compare_cheb(label, kernel, plain, lv, r, z, ndim, nu, fz, residual=False):
    """A smoothing kernel's Chebyshev mode against its plain version on
    level operands ``lv`` (`smoothing_levels`), at the reference's bar
    2e-5·max|plain| (tests/test_mg_options.py:346), beside the kernel's
    damped-Jacobi mode on the same level. ``kernel(r, z, coeff, sid, w, nu,
    fz, cf)``; with ``residual`` it and ``plain`` take residual=True and
    return (z, r − A z)."""
    coeff, inv, sid_j, cf, w = lv
    kw = dict(residual=True) if residual else {}
    rec = compare(f"{label}, {nu} Chebyshev sweeps, from_zero={fz}, residual={residual}",
                  lambda: kernel(r, z, coeff, inv, w, nu, fz, cf, **kw),
                  lambda: plain(r, z, coeff, inv, w, ndim, nu, fz, cf, **kw), 2e-5,
                  sweep_work(r, coeff, w, ndim, nu, fz, cheb=True, residual=residual),
                  residual)

    def jacobi():
        return kernel(r, z, coeff, sid_j, w, nu, fz, None, **kw)

    rec.update(jacobi_ms=cuda_ms(jacobi), jacobi_batch_ms=batch_ms(jacobi))
    print(f"  the damped-Jacobi mode on the same level: {rec['jacobi_ms']:.4f} ms, "
          f"back to back {rec['jacobi_batch_ms']:.4f} ms")
    return rec


def phase_cheb_sweep(ft, device):
    """The per-sweep kernel's Chebyshev mode on config 4's cloud: the
    lumped 128³ fine level, the 64³ level with lumped (diagonal) data and
    the 64³ Galerkin level (27 channels), each from zero and from z."""
    from field_interpolation_tpu_torch.ops.smooth import fused_smooth, fused_smooth_plain
    rng = np.random.default_rng(12)
    p128 = ft.assemble_sdf(ft.Grid(SHAPE3), ft.Weights(model_2=0.3),
                           *sphere_inputs(0, device))
    lv_c = smoothing_levels(p128, ft.SolverConfig(tol=1e-4, **CHEB), 3)
    lv_cg = smoothing_levels(p128, ft.SolverConfig(tol=1e-4, **CHEB, **GALERKIN), 3)
    del p128

    def kernel(r, z, coeff, sid, w, nu, fz, cf, residual=False):
        return fused_smooth(r, z, coeff, sid, w, 3, nu, fz, cheb_coefs=cf, residual=residual)

    recs = {}
    for key, label, lv in [("fine", "lumped fine level, diag", lv_cg[0]),
                           ("diag", "level, diag", lv_c[1]),
                           ("galerkin", "Galerkin level, 27-channel", lv_cg[1])]:
        shape = tuple(lv[1].shape)
        require(lv[0].ndim == (4 if key == "galerkin" else 3), f"{label}: {lv[0].shape}")
        r, z = (torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                                device=device) for _ in range(2))
        for fz in (True, False):
            recs[key] = compare_cheb(f"smooth {shape_str(shape)} config 4 {label}",
                                     kernel, fused_smooth_plain, lv, r, z, 3, 3, fz,
                                     residual=True)
    return recs


def phase_cheb5(ft, device):
    """The multi-sweep kernel's Chebyshev mode on config 5's 4096² fine
    level (the reference's fused_smooth_tiled) from zero with the residual
    and from z, and at 1000×1030 with radius-3 weights, ν = 3 from z with
    and without the residual (a 9- or 12-node halo: the phase takes two
    launches in one call, the second from the first's z, z_prev and
    schedule row); the per-sweep kernel's on config 5's 512² diagonal
    level, from zero and from z."""
    from field_interpolation_tpu_torch.ops.smooth import (fused_smooth, fused_smooth_2d,
                                                          fused_smooth_plain)
    rng = np.random.default_rng(13)
    cfg = ft.SolverConfig(**CFG5, **CHEB)

    def rand(shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                               device=device)

    def multi(r, z, coeff, sid, w, nu, fz, cf, residual=False):
        return fused_smooth_2d(r, z, coeff, sid, w, nu, fz, cheb_coefs=cf, residual=residual)

    def per_sweep(r, z, coeff, sid, w, nu, fz, cf, residual=False):
        return fused_smooth(r, z, coeff, sid, w, 2, nu, fz, cheb_coefs=cf, residual=residual)

    p5 = ft.assemble_sdf(ft.Grid(SHAPE5), ft.Weights(model_2=0.3), *circle5_inputs(0, device))
    lv5 = smoothing_levels(p5, cfg, 3)
    del p5
    recs = {}
    r, z = rand(SHAPE5), rand(SHAPE5)
    # The cycle's two phases: from zero with the residual, from z.
    recs["multi"] = compare_cheb(f"multi-sweep {shape_str(SHAPE5)} config 5 fine level",
                                 multi, fused_smooth_plain, lv5[0], r, z, 2, 3, True,
                                 residual=True)
    recs["multi_from_z"] = compare_cheb(f"multi-sweep {shape_str(SHAPE5)} config 5 fine level",
                                        multi, fused_smooth_plain, lv5[0], r, z, 2, 3, False)
    odd = (1000, 1030)
    podd = ft.assemble_sdf(ft.Grid(odd), ft.Weights(**RADIUS3_WEIGHTS),
                           *circle5_inputs(0, device, odd, 20_000))
    lvo = smoothing_levels(podd, cfg, 3)[0]
    del podd
    r, z = rand(odd), rand(odd)
    for res in (False, True):
        before = fused_smooth_2d.launches
        multi(r, z, lvo[0], lvo[1], lvo[4], 3, False, lvo[3], residual=res)
        split = fused_smooth_2d.launches - before
        print(f"multi-sweep {shape_str(odd)}, radius 3, 3 Chebyshev sweeps from z, "
              f"residual={res}: {split} launches in one call")
        require(split == 2, f"the {9 + 3 * res}-node halo phase took {split} launches, not 2")
        recs["multi_split" + ("_residual" if res else "")] = compare_cheb(
            f"multi-sweep {shape_str(odd)} radius-3 weights", multi, fused_smooth_plain,
            lvo, r, z, 2, 3, False, residual=res)
    lv = lv5[3]
    shape = tuple(lv[1].shape)
    r, z = rand(shape), rand(shape)
    for fz in (True, False):
        recs["diag"] = compare_cheb(f"smooth {shape_str(shape)} config 5 diagonal level",
                                    per_sweep, fused_smooth_plain, lv, r, z, 2, 3, fz,
                                    residual=True)
    return recs


def compare_path(label, x, info, xr, ir):
    """A field against the same call under backend="xla": converged,
    finite, within ±2 iterations and 2e-3·max|x|."""
    it, itr = int(info.iterations), int(ir.iterations)
    err, scale = float((x - xr).abs().max()), float(xr.abs().max())
    print(f"{label} against backend='xla': iterations {it} (xla {itr}), rel "
          f"{float(info.rel_residual):.3e}, max|x-x_xla| {err:.3e} (bar "
          f"{2e-3 * scale:.3e}), finite {bool(torch.isfinite(x).all())}, shape "
          f"{tuple(x.shape)}")
    require(bool(info.converged), f"{label} did not converge")
    require(bool(torch.isfinite(x).all()), f"{label}: field not finite")
    require(bool(ir.converged), f"{label}: the xla solve did not converge")
    require(abs(it - itr) <= 2, f"{label}: iterations {it} vs xla {itr}")
    require(err <= 2e-3 * scale, f"{label}: {err} > 2e-3·{scale}")


def require_launched(label, launches, names, absent=()):
    for name in names:
        require(launches[name] > 0, f"{name} was not launched on {label}")
    for name in absent:
        require(launches[name] == 0, f"{label} launched {name}")


def phase_h_cheb(ft, device, v_ms, v_iters):
    """H-cheb and H-gal: the headline (256², 1000 points, tol 1e-6) with
    the kind-4 Chebyshev smoother, seed 0, and with Galerkin coarse
    data besides, seed 0: the segment kernel in Chebyshev mode (lumped,
    then 9-channel coarse levels) and the apply kernel. Each field's true
    residual ≤ 1e-6 with the reported within 2%, and within ±2 iterations
    and 2e-3·max|x| of backend="xla"; beside phase 5's Jacobi fields."""
    grid, weights = ft.Grid(SHAPE), ft.Weights(model_2=0.3)
    out = {}
    for name, change, seeds in [("H-cheb", CHEB, SEEDS_HCHEB),
                                ("H-gal", {**CHEB, **GALERKIN}, range(1))]:
        cfg = ft.SolverConfig(tol=TOL, maxiter=2000, **change)
        inputs = {s: headline_inputs(s, device) for s in seeds}
        ft.sdf_from_points_precise(grid, weights, *inputs[0], config=cfg)  # warm-up
        torch.cuda.synchronize()
        read = counters_zero()
        fields = []
        for seed in seeds:
            (x, info), ms = timed(lambda: ft.sdf_from_points_precise(
                grid, weights, *inputs[seed], config=cfg))
            fields.append((seed, x, info, ms))
        launches = read()
        for seed, x, info, ms in fields:
            true = check_precise(f"{name} seed {seed}", ft, grid, weights, *inputs[seed],
                                 x, info, device)
            xr, ir = ft.sdf_from_points_precise(grid, weights, *inputs[seed], config=ft.
                                                SolverConfig(tol=TOL, maxiter=2000,
                                                             backend="xla", **change))
            compare_path(f"{name} seed {seed}", x, info, xr, ir)
            print(f"{name} seed {seed}: iterations {int(info.iterations)} (Jacobi, phase 5: "
                  f"{v_iters[seed]}), reported rel {float(info.rel_residual):.6e}, true rel "
                  f"{true:.6e}, {ms:.3f} ms (Jacobi, phase 5: {v_ms[seed]:.3f} ms)")
        print(f"{name}: launches {launches}")
        require_launched(name, launches, ("fused_pcg_solve_cheb", "fused_normal_apply"),
                         ("fused_wcycle_2d", "fused_vcycle_2d", "fused_smooth"))
        out[name] = launches
    return out


def phase_field_a2(ft, device):
    """Field A′, the Chebyshev whole-cycle band's main path: 480², 2000
    points, tol 1e-4, kind-4 Chebyshev, seed 0, against backend="xla" and
    beside the same field under damped Jacobi; precise at 1e-6. The apply
    kernel against its plain version at 480² first; then the whole W-cycle
    kernel in Chebyshev mode and the apply must launch, the segment not;
    then torch.profiler over one field."""
    from field_interpolation_tpu_torch.ops.stencil import (
        fused_normal_apply, fused_normal_apply_plain)
    grid, weights = ft.Grid(SHAPE_A2), ft.Weights(model_2=0.3)
    cfg = ft.SolverConfig(tol=1e-4, **CHEB)
    pts, nrm = field_a_inputs(0, device, SHAPE_A2)
    p = ft.assemble_sdf(grid, weights, pts, nrm)
    x = torch.as_tensor(np.random.default_rng(14).standard_normal(SHAPE_A2)
                        .astype(np.float32), device=device)
    apply_rec = compare(f"apply {shape_str(SHAPE_A2)} field A′, 9-channel (reference: "
                        f"fused_normal_apply_striped)",
                        lambda: fused_normal_apply(x, p.coeff, weights, 2),
                        lambda: fused_normal_apply_plain(x, p.coeff, weights, 2), 1e-5,
                        apply_work(x, p.coeff, weights, 2))
    del p
    ft.sdf_from_points(grid, weights, pts, nrm, config=cfg)  # warm-up
    (xj, ij), ms_j = timed(lambda: ft.sdf_from_points(grid, weights, pts, nrm,
                                                      config=ft.SolverConfig(tol=1e-4)))
    read = counters_zero()
    (x, info), ms = timed(lambda: ft.sdf_from_points(grid, weights, pts, nrm, config=cfg))
    (xp, infop), msp = timed(lambda: ft.sdf_from_points_precise(
        grid, weights, pts, nrm, config=ft.SolverConfig(tol=TOL, **CHEB)))
    launches = read()
    (xr, ir), ms_xla = timed(lambda: ft.sdf_from_points(
        grid, weights, pts, nrm, config=ft.SolverConfig(tol=1e-4, backend="xla", **CHEB)))
    compare_path("field A′ seed 0", x, info, xr, ir)
    true = check_precise("field A′ precise", ft, grid, weights, pts, nrm, xp, infop, device)
    print(f"field A′ seed 0: {ms:.3f} ms ({int(info.iterations)} iterations) against "
          f"damped Jacobi {ms_j:.3f} ms ({int(ij.iterations)} iterations, rel "
          f"{float(ij.rel_residual):.3e}) and backend='xla' {ms_xla:.3f} ms; precise: "
          f"iterations {int(infop.iterations)}, reported rel {float(infop.rel_residual):.6e}, "
          f"true rel {true:.6e}, {msp:.3f} ms; launches {launches}")
    require_launched("field A′", launches, ("fused_wcycle_2d_cheb", "fused_normal_apply"),
                     ("fused_pcg_solve", "fused_smooth", "fused_smooth_2d"))
    profile_fields("field A′", [lambda: ft.sdf_from_points(
        grid, weights, pts, nrm, config=cfg)], ("cycle kernel", "apply kernel"))
    return launches, apply_rec


def phase_main4cg(ft, device, iters_jacobi):
    """Config 4-cg: BASELINE config 4 (128³, 4000 sphere points, tol 1e-4)
    with kind-4 Chebyshev smoothing and Galerkin coarse data, seed 0,
    each against backend="xla": the per-sweep kernel in Chebyshev mode on
    the lumped fine level and the 27-channel coarse levels, and the apply."""
    grid, weights = ft.Grid(SHAPE3), ft.Weights(model_2=0.3)
    change = {**CHEB, **GALERKIN}
    cfg = ft.SolverConfig(tol=1e-4, **change)
    inputs = {s: sphere_inputs(s, device) for s in SEEDS4_CG}
    ft.sdf_from_points(grid, weights, *inputs[0], config=cfg)  # warm-up
    torch.cuda.synchronize()
    read = counters_zero()
    fields = []
    for seed in SEEDS4_CG:
        (x, info), ms = timed(lambda: ft.sdf_from_points(grid, weights, *inputs[seed],
                                                         config=cfg))
        fields.append((seed, x, info, ms))
    launches = read()
    for seed, x, info, ms in fields:
        xr, ir = ft.sdf_from_points(grid, weights, *inputs[seed], config=ft.SolverConfig(
            tol=1e-4, backend="xla", **change))
        compare_path(f"config 4-cg seed {seed}", x, info, xr, ir)
        print(f"config 4-cg seed {seed}: {ms:.3f} ms, {int(info.iterations)} iterations "
              f"(damped Jacobi, phase 8: {iters_jacobi.get(seed)})")
        require(tuple(x.shape) == SHAPE3, f"config 4-cg: shape {tuple(x.shape)}")
    print(f"config 4-cg: launches {launches} over {len(fields)} fields")
    require_launched("config 4-cg", launches, ("fused_smooth_cheb", "fused_normal_apply"),
                     ("fused_pcg_solve",))
    from field_interpolation_tpu_torch import solver
    clock = StageClock()
    p = clock("assemble_sdf", lambda: ft.assemble_sdf(grid, weights, *inputs[0]))
    apply_fn = solver._make_apply(p, cfg)
    pc = clock("preconditioner setup (Galerkin levels)",
               lambda: solver._make_precond(p, cfg, apply_fn))
    clock("one cycle", lambda: pc(p.b))
    clock("solve", lambda: ft.solve(p, cfg))
    print(f"profile config 4-cg, host clocks after synchronize, seed 0: {clock.line()}")
    del p, pc
    profile_fields("config 4-cg", [lambda: ft.sdf_from_points(
        grid, weights, *inputs[0], config=cfg)], ("sweep kernel", "apply kernel"))
    return launches


def phase_main5cheb(ft, device):
    """Config 5-cheb: BASELINE config 5's proxy (4096², 100 000 points,
    tol 1e-4, fmg_start=1) with kind-4 Chebyshev smoothing, seed 0, against
    backend="xla": the multi-sweep kernel in Chebyshev mode on the 4096² and
    2048² fine levels, the per-sweep one on the diagonal levels, the apply."""
    from field_interpolation_tpu_torch import sdf as tsdf
    grid, weights = ft.Grid(SHAPE5), ft.Weights(model_2=0.3)
    cfg = ft.SolverConfig(**CFG5, **CHEB)
    pts, nrm = circle5_inputs(0, device)
    coarse, restore = record_solves(tsdf)
    try:
        read = counters_zero()
        (x, info), ms = timed(lambda: ft.sdf_from_points(grid, weights, pts, nrm,
                                                         config=cfg, fmg_start=FMG5))
        launches = read()
        its_c = [int(i.iterations) for i in coarse[:-1]]
    finally:
        restore()
    (xr, ir), ms_xla = timed(lambda: ft.sdf_from_points(
        grid, weights, pts, nrm, config=ft.SolverConfig(**{**CFG5, "backend": "xla"}, **CHEB),
        fmg_start=FMG5))
    compare_path("config 5-cheb seed 0", x, info, xr, ir)
    print(f"config 5-cheb seed 0: {ms:.3f} ms (backend='xla' {ms_xla:.3f} ms), fine "
          f"iterations {int(info.iterations)}, coarse (fmg) iterations {its_c}; launches "
          f"{launches}")
    require(tuple(x.shape) == SHAPE5, f"config 5-cheb: shape {tuple(x.shape)}")
    require_launched("config 5-cheb", launches,
                     ("fused_smooth_2d_cheb", "fused_smooth_cheb", "fused_normal_apply"),
                     ("fused_pcg_solve",))
    return launches

# ---- the sharded slice: phases 27-30 (S1-S4) --------------------------------
# BASELINE config 5's sharded solve ("Sharded 2D 4096² / 3D 256³ across v5p-8
# with halo exchange over ICI", BASELINE.json:11) as four ranks, one process
# per shard, on a mesh of 2 x 2 (the reference's _spatial_mesh_shape(4)). The
# tool gives one card, so the ranks share it and their halos go through host
# memory under gloo: the times are the port's sharded path on one card, not
# times for four cards.
# S4 runs config 5's 3-D half (256³, 100 000 points, bench.py:317-326) cut
# to 192³ with 56 250 points (the same density): with S2-S4 past 180 s at
# 256³, the whole script would pass its time limit. S1 cuts the same field.
SHAPE_S4 = (192, 192, 192)
N_POINTS_S4 = 56_250
MESH_S = (2, 2)
RANKS = 4
SHARDED = "4 ranks sharing one H100, halos via gloo through host memory"


def sphere5_inputs(shape, n, seed=0):
    """bench.py:320-326 at ``shape``: n oriented points on a sphere of radius
    0.35·width around the center (127.5 + 89.6·u at 256³), as numpy."""
    u = np.random.default_rng(seed).standard_normal((n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    center = (np.asarray(shape, np.float64) - 1.0) / 2.0
    return ((center + 0.35 * shape[0] * u).astype(np.float32), u.astype(np.float32))


def ext_blocks(shape, shards, r):
    """Per block of the layout: (its slices, the slices of its extended block
    in the field padded by r on every axis, its global start)."""
    import itertools
    loc = [n // s for n, s in zip(shape, shards)]
    for idx in itertools.product(*[range(s) for s in shards]):
        gs = [i * n for i, n in zip(idx, loc)]
        yield (tuple(slice(g, g + n) for g, n in zip(gs, loc)),
               tuple(slice(g, g + n + 2 * r) for g, n in zip(gs, loc)), gs)


def compare_blocks(label, shape, shards, r, whole, operands, kernel, plain, work):
    """Each block's ``operands(blk, ext, gs)`` through ``kernel`` and its
    ``plain`` version, stitched: the kernel within 1e-5·max|plain| of the
    plain version and of the whole-grid apply kernel's output ``whole``;
    then the last block's call alone timed (single, back to back, plain),
    with GB/s of the bytes ``work`` = (bytes, operations) says it moves."""
    got = torch.empty_like(whole)
    want = torch.empty_like(whole)
    for blk, ext, gs in ext_blocks(shape, shards, r):
        args = operands(blk, ext, gs)
        got[blk] = kernel(*args)
        want[blk] = plain(*args)
    loc = tuple(sl.stop - sl.start for sl in blk)
    name = f"{label}: {shape_str(shape)} as {shape_str(shards)} blocks of {shape_str(loc)}"
    err = check_close(f"{name}, stitched against the plain version", got, want, 1e-5)
    check_close(f"{name}, stitched against the whole-grid apply kernel", got, whole, 1e-5)
    ms, b2b = cuda_ms(lambda: kernel(*args)), batch_ms(lambda: kernel(*args))
    plain_ms = cuda_ms(lambda: plain(*args), PLAIN_REPS)
    nbytes, flops = work
    rec = dict(max_abs_err=err, ms=ms, batch_ms=b2b, plain_ms=plain_ms, shape=shape_str(loc),
               **bound(nbytes, flops))
    print(f"  one block: kernel {ms:.4f} ms ({nbytes / ms / 1e6:.0f} GB/s), back to back "
          f"{b2b:.4f} ms ({nbytes / b2b / 1e6:.0f} GB/s), plain {plain_ms:.4f} ms; bound "
          f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}: {nbytes / 1e6:.1f} MB)")
    return rec


def block_slabs(x, blk, r, order, shape):
    """(z, slabs) of block ``blk`` of the field ``x``: the halo slabs in
    exchange ``order`` as `parallel.sharded._level_slabs` delivers them (the
    corners filled by the later axes), None past the global grid."""
    xp = torch.nn.functional.pad(x, (r,) * (2 * x.ndim))
    slabs = []
    for k, axis in enumerate(order):
        pair = []
        for low in (True, False):
            sl = [slice(b.start, b.stop + 2 * r) if d in order[:k]
                  else slice(b.start + r, b.stop + r) for d, b in enumerate(blk)]
            b = blk[axis]
            sl[axis] = slice(b.start, b.start + r) if low else slice(b.stop + r, b.stop + 2 * r)
            past = b.start == 0 if low else b.stop == shape[axis]
            pair.append(None if past else xp[tuple(sl)].contiguous())
        slabs.append(tuple(pair))
    return x[blk].contiguous(), slabs


def compare_modes(label, shape, shards, r, x, coeff, w, whole_az, striped=False):
    """`ExtLevel` (the slab form the sharded solve launches) in every mode
    on each block of the layout, its slabs cut from the zero-padded field:
    stitched within 1e-5 (the apply) or 2e-5 (the updates) ·max|plain| of
    the plain version and of the mode's update of the whole-grid apply
    kernel's output ``whole_az``; then the last block's call timed (single,
    back to back, plain) per mode. Returns {mode: record}."""
    from field_interpolation_tpu_torch.ops.stencil_ext import (
        MODES, ExtLevel, fused_normal_apply_ext_slabs_plain, level_update)
    nd = len(shape)
    diag = coeff.ndim == nd
    order = (1, 0) if striped else tuple(range(nd))
    rng = np.random.default_rng(31)
    rr, zp = (torch.as_tensor(rng.standard_normal(shape).astype(np.float32), device=x.device)
              for _ in range(2))
    inv_d = torch.as_tensor(rng.uniform(0.05, 0.5, shape).astype(np.float32), device=x.device)
    s0, s1 = 0.7, 0.4
    recs = {}
    for mode in MODES:
        got, want = torch.empty_like(x), torch.empty_like(x)
        for blk, _, gs in ext_blocks(shape, shards, r):
            c = coeff[blk if diag else (slice(None),) + blk].contiguous()
            level = ExtLevel(c, gs, w, r, shape, striped=striped)
            z, slabs = block_slabs(x, blk, r, order, shape)
            ops = dict(r=rr[blk].contiguous(), inv_d=inv_d[blk].contiguous(),
                       z_prev=zp[blk].contiguous(), s0=s0, s1=s1)
            got[blk] = level(z, slabs, mode, **ops)
            want[blk] = fused_normal_apply_ext_slabs_plain(z, slabs, c, gs, w, r, shape, order,
                                                           mode, **ops)
        loc = z.shape
        bar = 1e-5 if mode == "apply" else 2e-5
        name = (f"{label}, slab form, {mode}: {shape_str(shape)} as {shape_str(shards)} blocks "
                f"of {shape_str(loc)}")
        err = check_close(f"{name}, stitched against the plain version", got, want, bar)
        check_close(f"{name}, stitched against the whole-grid apply kernel's update", got,
                    level_update(mode, whole_az, x, rr, inv_d, zp, s0, s1), bar)
        n = math.prod(loc)
        planes = (1 if diag else 3 ** nd) + 1 + {"apply": 0, "residual": 1, "jacobi": 2,
                                                 "chebyshev": 3}[mode]
        nbytes = 4 * (n * planes + sum(t.numel() for pair in slabs for t in pair
                                       if t is not None))

        def call(level=level, z=z, slabs=slabs, ops=ops, mode=mode):
            return level(z, slabs, mode, **ops)

        ms, b2b = cuda_ms(call), batch_ms(call)
        plain_ms = cuda_ms(lambda: fused_normal_apply_ext_slabs_plain(
            z, slabs, c, gs, w, r, shape, order, mode, **ops), PLAIN_REPS)
        recs[mode] = dict(max_abs_err=err, ms=ms, batch_ms=b2b, plain_ms=plain_ms,
                          shape=shape_str(loc), **bound(nbytes, apply_flops(w, nd, diag) * n))
        print(f"  one block, {mode}: kernel {ms:.4f} ms, back to back {b2b:.4f} ms "
              f"({nbytes / b2b / 1e6:.0f} GB/s, {recs[mode]['bound_ms'] / b2b:.2f} of the bound "
              f"{recs[mode]['bound_ms']:.4f} ms), plain {plain_ms:.4f} ms")
    return recs


def phase_ext(ft, device):
    """S1, one process: the two sharded-apply kernels block by block, at the
    blocks S2 and S4 give them. A 9-channel 4096² field (config 5's problem)
    cut 2 x 2 into 2048² blocks (S2's fine apply) and 1 x 8 into 4096 x 512
    blocks (the reference's own case), both through the striped form at the
    stripe the reference picks; S4's 27-channel 192³ field cut 2 x 2 into
    96 x 96 x 192 blocks through the whole form; the diagonal form on S4's
    lumped fine level and on every sharded level of S2's and S4's
    hierarchies, cut 2 x 2. Each stitched against the plain version and the
    whole-grid apply."""
    from field_interpolation_tpu_torch import constraints as cons
    from field_interpolation_tpu_torch.ops._policy import ext_fits_vmem, pick_stripe_ext
    from field_interpolation_tpu_torch.ops.stencil import fused_normal_apply
    from field_interpolation_tpu_torch.ops.stencil_ext import (
        fused_normal_apply_ext, fused_normal_apply_ext_plain, fused_normal_apply_ext_striped,
        fused_normal_apply_ext_striped_plain)
    F = torch.nn.functional
    rng = np.random.default_rng(30)
    w, r = ft.Weights(model_2=0.3), 2
    cfg = ft.SolverConfig(**CFG5)
    recs = {}

    def randn(shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32), device=device)

    p5 = ft.assemble_sdf(ft.Grid(SHAPE5), w, *circle5_inputs(0, device))
    x = randn(SHAPE5)
    xp = F.pad(x, (r,) * 4)
    whole = fused_normal_apply(x, p5.coeff, w, 2)
    for shards in [(2, 2), (1, 8)]:
        loc = tuple(n // s for n, s in zip(SHAPE5, shards))
        stripe = pick_stripe_ext(loc, r)
        require(stripe is not None and not ext_fits_vmem(loc, r),
                f"{shape_str(loc)} blocks take the striped form")

        def striped(blk, ext, gs):
            # x extended along axis 1 and the corner-filled axis-0 slabs.
            rows, cols = ext
            return (xp[rows.start + r:rows.stop - r, cols].contiguous(),
                    xp[rows.start:rows.start + r, cols].contiguous(),
                    xp[rows.stop - r:rows.stop, cols].contiguous(),
                    p5.coeff[(slice(None),) + blk].contiguous(), gs, w, r, SHAPE5)

        n = math.prod(loc)
        recs[shards] = compare_blocks(
            f"striped ext apply (stripe {stripe} on the reference)", SHAPE5, shards, r,
            whole, striped, fused_normal_apply_ext_striped,
            fused_normal_apply_ext_striped_plain,
            (4 * ((loc[0] + 2 * r) * (loc[1] + 2 * r) + 10 * n), apply_flops(w, 2, False) * n))
        recs[shards]["modes"] = compare_modes("striped ext", SHAPE5, shards, r, x, p5.coeff, w,
                                              whole, striped=True)
    del x, xp, whole
    recs["diag2d"] = sharded_level_blocks(ft, p5, cfg, randn)
    del p5

    p3 = ft.assemble_sdf(ft.Grid(SHAPE_S4), w, *(torch.as_tensor(a, device=device)
                                                 for a in sphere5_inputs(SHAPE_S4,
                                                                         N_POINTS_S4)))
    x3 = randn(SHAPE_S4)
    xp3 = F.pad(x3, (r,) * 6)
    whole3 = fused_normal_apply(x3, p3.coeff, w, 3)

    def ext3(blk, ext, gs):
        return (xp3[ext].contiguous(), p3.coeff[(slice(None),) + blk].contiguous(), gs, w, 3,
                r, SHAPE_S4)

    loc3 = tuple(n // s for n, s in zip(SHAPE_S4, MESH_S + (1,)))
    n3 = math.prod(loc3)
    recs["ext3d"] = compare_blocks(
        "whole-form ext apply, 27 channels", SHAPE_S4, MESH_S + (1,), r, whole3, ext3,
        fused_normal_apply_ext, fused_normal_apply_ext_plain,
        (4 * (math.prod(n + 2 * r for n in loc3) + 28 * n3), apply_flops(w, 3, False) * n3))
    recs["ext3d"]["modes"] = compare_modes("whole-form ext, 27 channels", SHAPE_S4,
                                           MESH_S + (1,), r, x3, p3.coeff, w, whole3)
    del x3, xp3, whole3
    recs["diag3d_fine"] = diag_blocks("lumped fine level", SHAPE_S4, w,
                                      cons.data_diag(p3.coeff, 3).contiguous(), randn)
    recs["diag3d"] = sharded_level_blocks(ft, p3, cfg, randn)
    del p3
    torch.cuda.empty_cache()
    return recs


def sharded_level_blocks(ft, p, cfg, randn):
    """`diag_blocks` on every level of ``p``'s hierarchy that the distributed
    multigrid keeps sharded on MESH_S (its own `_sharded_prefix`)."""
    from field_interpolation_tpu_torch import multigrid as tmg
    from field_interpolation_tpu_torch.parallel import sharded as tsh
    levels = tmg.build_levels(p, cfg)
    radii = tuple(max([k for k in l.weights.active_orders() if k > 0], default=0)
                  for l in levels)
    nd = p.grid.ndim
    n_sh, _ = tsh._sharded_prefix((p.grid.shape,) + tuple(l.shape for l in levels),
                                  MESH_S + (1,) * (nd - 2), radii)
    require(n_sh > 0, f"{shape_str(p.grid.shape)}: no coarse level stays sharded")
    return [diag_blocks(f"multigrid level {li + 1}", lv.shape, lv.weights,
                        lv.data_diag.contiguous(), randn)
            for li, lv in enumerate(levels[:n_sh])]


def diag_blocks(label, shape, lw, dd, randn):
    """The ext kernel's diagonal form (weights ``lw``, data diagonal ``dd``)
    on a level of ``shape`` cut 2 x 2, against the whole-level apply
    kernel's diagonal form."""
    from field_interpolation_tpu_torch.ops.stencil import fused_normal_apply
    from field_interpolation_tpu_torch.ops.stencil_ext import (
        fused_normal_apply_ext, fused_normal_apply_ext_plain)
    nd = len(shape)
    r = max(k for k in lw.active_orders() if k > 0)
    x = randn(shape)
    xp = torch.nn.functional.pad(x, (r,) * (2 * nd))
    shards = MESH_S + (1,) * (nd - 2)
    loc = tuple(n // s for n, s in zip(shape, shards))

    def call(blk, ext, gs):
        return xp[ext].contiguous(), dd[blk].contiguous(), gs, lw, nd, r, shape

    n = math.prod(loc)
    whole = fused_normal_apply(x, dd, lw, nd)
    rec = compare_blocks(f"diagonal-form ext apply, {label}", shape, shards, r, whole, call,
                         fused_normal_apply_ext, fused_normal_apply_ext_plain,
                         (4 * (math.prod(m + 2 * r for m in loc) + 2 * n),
                          apply_flops(lw, nd, True) * n))
    rec["modes"] = compare_modes(f"diagonal-form ext, {label}", shape, shards, r, x, dd, lw,
                                 whole)
    return rec


def unsharded_solve(ft, cloud, cfg, device):
    """The port's unsharded solve of ``cloud`` on the card: (x on the host,
    SolveInfo, ms)."""
    p = cloud.problem(device)
    torch.cuda.synchronize()
    (x, info), ms = timed(lambda: ft.solve(p, cfg))
    out = (x.cpu(), info, ms)
    del p, x
    torch.cuda.empty_cache()
    return out


def rank_launches(parts):
    """{kernel: [launches on rank 0, 1, ...]} of the kernels a rank launched."""
    names = [k for k in parts[0]["launches"] if any(p["launches"][k] for p in parts)]
    return {k: [p["launches"][k] for p in parts] for k in names}


def launches_per_iteration(parts):
    """Per rank, {kind: wrapper launches per CG iteration} of its solve (the
    ext kernel by form and mode, "name.mode"; the other counted kernels)."""
    return [{k: round(v / max(p["iterations"], 1), 2) for k, v in p["launches"].items() if v}
            for p in parts]


def check_sharded(label, parts, ref, note=SHARDED):
    """The stitched sharded field against the unsharded one: converged,
    finite, ±2 iterations, max|x - x_unsharded| ≤ 2e-3·max|x|. Prints the
    slowest rank's ms per solve and each rank's launches."""
    from field_interpolation_tpu_torch.parallel.cases import stitch
    x = stitch(parts, "x")
    xr, ir, ms_r = ref
    it, itr = parts[0]["iterations"], int(ir.iterations)
    err, scale = float((x - xr).abs().max()), float(xr.abs().max())
    slowest = max(p["ms"] for p in parts)
    print(f"{label} ({note}): iterations {it} (unsharded {itr}), rel "
          f"{parts[0]['rel_residual']:.3e}, max|x-x_unsharded| {err:.3e} (bar "
          f"{2e-3 * scale:.3e}); ms/field, slowest rank: {slowest:.1f} (assembly and blocks "
          f"{max(p['setup_ms'] for p in parts):.1f}); unsharded solve {ms_r:.1f} ms on the "
          f"card alone; launches per rank {rank_launches(parts)}; per rank per CG iteration "
          f"{launches_per_iteration(parts)}")
    require(all(p["converged"] for p in parts), f"{label} did not converge")
    require(bool(torch.isfinite(x).all()), f"{label}: field not finite")
    require(bool(ir.converged), f"{label}: the unsharded solve did not converge")
    require(abs(it - itr) <= 2, f"{label}: iterations {it} vs unsharded {itr}")
    require(err <= 2e-3 * scale, f"{label}: {err} > 2e-3·{scale}")
    return slowest


def phase_sharded(ft, device, shape3=SHAPE_S4, n3=N_POINTS_S4, rank_device="cuda"):
    """S2-S4: four ranks on the one card (`parallel.launch.run_ranks`, gloo),
    one start for all three. S2: config 5 sharded, 2-D: 4096², the config-5
    cloud, tol 1e-4, maxiter 500, multigrid; `assemble_sdf` → `shard_problem`
    → `solve_sharded`, against the port's unsharded solve; both ext
    kernels must launch on every rank. S3: `solve_refined_sharded` on the
    same cloud's `assemble_precise` at tol 1e-6: the TRUE relative residual
    of the stitched field (the plain float64 operator) ≤ 1e-6 and the
    reported within 2%. S4: 3-D, 192³ (config 5's 256³ cut, `SHAPE_S4`),
    56 250 sphere points, tol 1e-4, the mesh over dims 0 and 1 (96 x 96 x
    192 blocks), against the unsharded solve; the whole-form ext kernel must
    launch on every rank; then S2 and S4 as one rank (mesh 1 x 1), the same
    bars. Each prints its ranks' wrapper launches per CG iteration, the ext
    kernel by form and mode."""
    from field_interpolation_tpu_torch.parallel.cases import Cloud, run_cases, stitch
    from field_interpolation_tpu_torch.parallel.launch import run_ranks
    w = ft.Weights(model_2=0.3)
    cfg2 = ft.SolverConfig(**CFG5)
    cfg3 = ft.SolverConfig(tol=1e-4, preconditioner="multigrid", maxiter=500)
    pts5, nrm5 = (t.cpu().numpy() for t in circle5_inputs(0, device))
    c2 = Cloud(SHAPE5, w, pts5, None, nrm5)
    pts3, nrm3 = sphere5_inputs(shape3, n3)
    c3 = Cloud(shape3, w, pts3, None, nrm3)
    ref2 = unsharded_solve(ft, c2, cfg2, device)
    ref3 = unsharded_solve(ft, c3, cfg3, device)
    cases = [("sharded_solve", dict(cloud=c2, mesh_shape=MESH_S, config=cfg2)),
             ("sharded_refined", dict(cloud=c2, mesh_shape=MESH_S,
                                      config=ft.SolverConfig(**{**CFG5, "tol": TOL}))),
             ("sharded_solve", dict(cloud=c3, mesh_shape=MESH_S, config=cfg3)),
             # Phase 49: each rank contours its own solved block of S2 and S4.
             ("sharded_contour", dict(field=0, mesh_shape=MESH_S, caps=(None, 2))),
             ("sharded_contour", dict(field=2, mesh_shape=MESH_S, caps=(None, 2)))]
    t0 = time.perf_counter()
    res = run_ranks(run_cases, RANKS, cases, device=rank_device)
    print(f"sharded phases: {RANKS} ranks, {len(cases)} runs, "
          f"{time.perf_counter() - t0:.1f} s from spawn to join")
    s2, s3, s4, s2c, s4c = ([r[k] for r in res] for k in range(5))
    out = {"S2": check_sharded(f"S2 config 5 sharded 2-D {shape_str(SHAPE5)} on "
                               f"{shape_str(MESH_S)}", s2, ref2)}
    for name in ("fused_normal_apply_ext", "fused_normal_apply_ext_striped"):
        require(all(p["launches"][name] > 0 for p in s2), f"S2: a rank did not launch {name}")
    x64 = stitch(s3, "x")
    pp = c2.precise(device)
    true = float(torch.linalg.norm(pp.residual64(x64.to(device)))
                 / torch.linalg.norm(pp.b64))
    rep = s3[0]["rel_residual"]
    print(f"S3 refined sharded {shape_str(SHAPE5)} ({SHARDED}): iterations "
          f"{s3[0]['iterations']}, reported rel {rep:.6e}, true rel {true:.6e}, ms/field, "
          f"slowest rank {max(p['ms'] for p in s3):.1f}; launches per rank "
          f"{rank_launches(s3)}")
    require(all(p["converged"] for p in s3), "S3 did not converge")
    require(true <= TOL, f"S3: true residual {true} > {TOL}")
    require(abs(true - rep) <= 0.02 * true, f"S3: reported {rep} vs true {true}")
    del pp
    out["S4"] = check_sharded(f"S4 sharded 3-D {shape_str(shape3)} on {shape_str(MESH_S)}",
                              s4, ref3)
    require(all(p["launches"]["fused_normal_apply_ext"] > 0 for p in s4),
            "S4: a rank did not launch fused_normal_apply_ext")
    from field_interpolation_tpu_torch import contour as tc
    for label, parts, blocks, extract in [
            (f"S2 sharded contour {shape_str(SHAPE5)}", s2c, s2,
             lambda x, n: tc.marching_squares_device_compact(x, max_segments=n)),
            (f"S4 sharded contour {shape_str(shape3)}", s4c, s4,
             lambda x, n: tc.marching_tetrahedra_device_compact(x, max_triangles=n))]:
        n = 2 * sum(p["runs"][0]["count"] for p in parts) + 16
        check_sharded_contour(label, parts, stitch(blocks, "x").to(device),
                              lambda x: extract(x, n))
        torch.cuda.empty_cache()
    # S2 and S4 as one rank (mesh 1 x 1): the sharded code's own cost,
    # without four processes sharing the card or halo messages.
    s2one, s4one = ([r[k] for r in run_ranks(run_cases, 1, [
        ("sharded_solve", dict(cloud=c2, mesh_shape=(1, 1), config=cfg2)),
        ("sharded_solve", dict(cloud=c3, mesh_shape=(1, 1), config=cfg3))],
        device=rank_device)] for k in range(2))
    one = "1 rank on the H100, no halo messages"
    out["S2_one_rank"] = check_sharded(f"S2 as one rank {shape_str(SHAPE5)}", s2one, ref2, one)
    out["S4_one_rank"] = check_sharded(f"S4 as one rank {shape_str(shape3)}", s4one, ref3, one)
    for label, parts in (("S2 as one rank", s2one), ("S4 as one rank", s4one)):
        require(parts[0]["launches"]["fused_normal_apply_ext"]
                + parts[0]["launches"]["fused_normal_apply_ext_striped"] > 0,
                f"{label}: no ext launch")
    out["launches"] = {k: [p["launches"] for p in parts]
                       for k, parts in (("S2", s2), ("S3", s3), ("S4", s4), ("S2_one_rank", s2one),
                                        ("S4_one_rank", s4one))}
    torch.cuda.empty_cache()
    return out

# ---- the public-API slice: phases 31-37 -------------------------------------
# Config 1 through `interpolate` (bench.py:125-135: 64², 100 values uniform in
# [0, 63]², standard-normal values, plain CG at tol 5e-4); value
# interpolation at the headline size (precise) and at 1024² (cold and
# fmg_start=1, the reference's own fmg check of tests/test_solver.py:721-739
# at full width); the Solver session on the headline; prepare on config 4;
# solve_implicit on the headline; the apply kernel's device time at five
# shapes of the main paths.
SHAPE1 = (64, 64)
N_POINTS1 = 100
W1 = dict(model_1=0.1, model_2=1.0)
CFG1 = dict(tol=5e-4, preconditioner="none", maxiter=20000)
SHAPE_I = (1024, 1024)
N_POINTS_I = 51_200       # 200 points per 64², the density of tests/test_solver.py:727
N_POINTS_I_SPARSE = 4000  # 13x sparser: the float32 solve stalls, in the reference too
FRAMES = 9
MAX_TURN_DEG = 2.0
TIMED_REPS = 16  # CUDA-event medians of the new paths
LARGE_REPS = 5   # ms/field medians at 1024² (in turns, cold and fmg)
# The sparse 1024² cloud's solves stall (ROADMAP §3): 200 iterations show
# it; the 2000 of the default budget took ~2 min of the script's time.
SPARSE_MAXITER = 200
PREPARE_REPS = 8  # config 4 cold and prepared, in turns (a run spreads ±40%)


def host_ms(fn):
    """(fn(), its time in ms on the host clock, synchronized before and after)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def sine_values(pts, device):
    """The values of tests/test_solver.py:727, sin(x/9) of each point's
    first coordinate, on the device."""
    return torch.as_tensor(np.sin(pts[:, 0] / 9.0).astype(np.float32), device=device)


def phase_config1(ft, device, reps=TIMED_REPS):
    """Config 1 through `interpolate`: converged, within ±2 iterations and
    2e-3·max|x| of backend="xla"; the apply kernel against its plain version
    on the config's problem (1e-5·max|plain|) and launched on the path."""
    from field_interpolation_tpu_torch.ops.stencil import (fused_normal_apply,
                                                           fused_normal_apply_plain)
    rng = np.random.default_rng(0)
    pos = torch.as_tensor(rng.uniform(0, 63, (N_POINTS1, 2)).astype(np.float32),
                          device=device)
    vals = torch.as_tensor(rng.standard_normal(N_POINTS1).astype(np.float32), device=device)
    grid, w = ft.Grid(SHAPE1), ft.Weights(**W1)
    cfg = ft.SolverConfig(**CFG1)
    p = ft.assemble_interpolation(grid, w, pos, vals)
    xa = torch.as_tensor(rng.standard_normal(SHAPE1).astype(np.float32), device=device)
    rec = compare("apply 64x64 config 1, value rows (reference: fused_normal_apply)",
                  lambda: fused_normal_apply(xa, p.coeff, w, 2),
                  lambda: fused_normal_apply_plain(xa, p.coeff, w, 2), 1e-5,
                  apply_work(xa, p.coeff, w, 2))

    def field():
        return ft.interpolate(grid, w, pos, vals, config=cfg)
    field()  # warm-up
    torch.cuda.synchronize()
    read = counters_zero()
    (x, info), ms1 = timed(field)
    launches = read()
    xr, ir = ft.interpolate(grid, w, pos, vals, config=ft.SolverConfig(**CFG1, backend="xla"))
    compare_path("config 1 (64², 100 values, plain CG, tol 5e-4)", x, info, xr, ir)
    require(tuple(x.shape) == SHAPE1, f"config 1: shape {tuple(x.shape)}")
    ms = cuda_ms(field, reps)
    print(f"config 1: {ms:.3f} ms/solve (median of {reps}, CUDA events; the checked call "
          f"{ms1:.3f}), {int(info.iterations)} iterations, "
          f"{1e3 * ms / max(int(info.iterations), 1):.1f} us/iteration; launches {launches}")
    require_launched("config 1", launches, ("fused_normal_apply",), ("fused_pcg_solve",))
    return launches, rec, ms


def phase_interp_precise(ft, device, shape=SHAPE, n=N_POINTS, reps=TIMED_REPS):
    """`interpolate_precise` on the headline's points with sin(x/9) values,
    Weights(model_2=0.3), tol 1e-6: TRUE ≤ 1e-6 from the plain float64
    operator, reported within 2%; the segment and apply kernels launch."""
    pts, _ = make_circle_cloud(n, shape, seed=0)
    vals = sine_values(pts, device)
    pts = torch.as_tensor(pts, device=device)
    grid, w = ft.Grid(shape), ft.Weights(model_2=0.3)
    cfg = ft.SolverConfig(tol=TOL)

    def field():
        return ft.interpolate_precise(grid, w, pts, vals, config=cfg)
    field()  # warm-up
    torch.cuda.synchronize()
    read = counters_zero()
    (x, info), ms1 = timed(field)
    launches = read()
    pp = ft.assemble_precise(grid, w, pts, vals)
    true = float(torch.linalg.norm(pp.residual64(x)) / torch.linalg.norm(pp.b64))
    rep = float(info.rel_residual)
    require(bool(info.converged), "interpolate_precise did not converge")
    require(tuple(x.shape) == shape and bool(torch.isfinite(x).all()),
            "interpolate_precise: field not finite or wrong shape")
    require(true <= TOL, f"interpolate_precise: true residual {true} > {TOL}")
    require(abs(true - rep) <= 0.02 * true, f"interpolate_precise: reported {rep} vs {true}")
    ms = cuda_ms(field, reps)
    print(f"interpolate_precise {shape_str(shape)}, {n} points, sin(x/9): iterations "
          f"{int(info.iterations)}, reported rel {rep:.6e}, true rel {true:.6e}; "
          f"{ms:.3f} ms/field (median of {reps}; the checked call {ms1:.3f}); "
          f"launches {launches}")
    require_launched("interpolate_precise", launches,
                     ("fused_pcg_solve", "fused_normal_apply"))
    return launches, ms


def phase_interp_large(ft, device, shape=SHAPE_I, n=N_POINTS_I, n_sparse=N_POINTS_I_SPARSE,
                       reps=LARGE_REPS):
    """`interpolate` at 1024², sin(x/9) values, Weights(model_2=0.3), tol
    1e-4, cold and with fmg_start=1, on points uniform in [1, 1022]².

    At the density of the reference's own fmg check (tests/test_solver.py:
    721-739: 200 points on 64², so 51 200 on 1024²): both converged, fmg
    with fewer fine iterations, the fields within 5e-2 of each other; the
    multi-sweep, per-sweep and apply kernels launch; both timed in turns.
    First those kernels against their plain versions on this problem: the
    apply (1e-5·max|plain|), the multi-sweep kernel's pre-smoothing with
    its residual on the fine level and the per-sweep kernel's on the first
    diagonal level (2e-5·max|plain|).

    With 4000 points (a 13x sparser cloud) the float32 solve stalls above
    tol 1e-4 in the reference too (on the CPU at 512² with the same
    density, both packages stop at maxiter with a residual of 8.2e-4):
    that case runs once cold and once with fmg_start=1 for SPARSE_MAXITER
    iterations and is reported, finite and of the grid's shape, its
    convergence not required."""
    from field_interpolation_tpu_torch import sdf as tsdf
    from field_interpolation_tpu_torch.ops.smooth import (fused_smooth, fused_smooth_2d,
                                                          fused_smooth_plain)
    from field_interpolation_tpu_torch.ops.stencil import (fused_normal_apply,
                                                           fused_normal_apply_plain)
    rng = np.random.default_rng(5)
    grid, w = ft.Grid(shape), ft.Weights(model_2=0.3)
    cfg = ft.SolverConfig(tol=1e-4)
    name = shape_str(shape)

    def cloud(count):
        pts = rng.uniform(1, shape[0] - 2, (count, 2)).astype(np.float32)
        return torch.as_tensor(pts, device=device), sine_values(pts, device)

    def rand(sh):
        return torch.as_tensor(rng.standard_normal(sh).astype(np.float32), device=device)
    pts, vals = cloud(n)
    p = ft.assemble_interpolation(grid, w, pts, vals)
    levels, sids = fine_smoothing_operands(p, cfg)
    x, r, z = rand(shape), rand(shape), rand(shape)
    recs = dict(apply=compare(
        f"apply {name} values (reference: fused_normal_apply_striped)",
        lambda: fused_normal_apply(x, p.coeff, w, 2),
        lambda: fused_normal_apply_plain(x, p.coeff, w, 2), 1e-5,
        apply_work(x, p.coeff, w, 2)))
    recs["multi"] = compare(
        f"multi-sweep {name} values fine level, 3 sweeps from zero, residual",
        lambda: fused_smooth_2d(r, z, p.coeff, sids[0], w, 3, True, residual=True),
        lambda: fused_smooth_plain(r, z, p.coeff, sids[0], w, 2, 3, True, residual=True),
        2e-5, sweep_work(r, p.coeff, w, 2, 3, True, residual=True), True)
    lvl = levels[0]
    dd, r1, z1 = lvl.data_diag.contiguous(), rand(lvl.shape), rand(lvl.shape)
    recs["sweep"] = compare(
        f"smooth {shape_str(lvl.shape)} values diagonal level, 3 sweeps from zero, residual",
        lambda: fused_smooth(r1, z1, dd, sids[1], lvl.weights, 2, 3, True, residual=True),
        lambda: fused_smooth_plain(r1, z1, dd, sids[1], lvl.weights, 2, 3, True,
                                   residual=True),
        2e-5, sweep_work(r1, dd, lvl.weights, 2, 3, True, residual=True), True)
    del p, levels, sids, x, r, z

    def runs(pts, vals, config=cfg):
        return (lambda: ft.interpolate(grid, w, pts, vals, config=config),
                lambda: ft.interpolate(grid, w, pts, vals, config=config, fmg_start=1))
    cold, fmg = runs(pts, vals)
    cold(), fmg()  # warm-up
    torch.cuda.synchronize()
    coarse, restore = record_solves(tsdf)
    try:
        read = counters_zero()
        (xc, ic), _ = timed(cold)
        coarse.clear()
        (xf, inf), _ = timed(fmg)
        launches = read()
        its_c = [int(i.iterations) for i in coarse[:-1]]
    finally:
        restore()
    err = float((xf - xc).abs().max())
    for label, xx, info in (("cold", xc, ic), ("fmg_start=1", xf, inf)):
        require(bool(info.converged), f"interpolate {name} {label} did not converge "
                                      f"({int(info.iterations)} iterations, rel "
                                      f"{float(info.rel_residual):.3e})")
        require(tuple(xx.shape) == shape and bool(torch.isfinite(xx).all()),
                f"interpolate {name} {label}: field not finite or wrong shape")
    require(int(inf.iterations) < int(ic.iterations),
            f"fmg fine iterations {int(inf.iterations)} not below cold {int(ic.iterations)}")
    require(err <= 5e-2, f"interpolate {name}: fmg vs cold {err} > 5e-2")
    ms = {}
    for _ in range(reps):  # in turns
        for label, fn in (("cold", cold), ("fmg", fmg)):
            ms.setdefault(label, []).append(timed(fn)[1])
    med = {k: statistics.median(v) for k, v in ms.items()}
    print(f"interpolate {name}, {n} points, tol 1e-4: cold {int(ic.iterations)} iterations, "
          f"{med['cold']:.3f} ms/field; fmg_start=1 {int(inf.iterations)} fine iterations "
          f"(coarse {its_c}), {med['fmg']:.3f} ms/field (medians of {reps}, in turns; all "
          f"{ms}); max|x_fmg - x_cold| {err:.3e}; launches over both {launches}")
    require_launched(f"interpolate {name}", launches,
                     ("fused_smooth_2d", "fused_smooth", "fused_normal_apply"),
                     ("fused_pcg_solve",))
    del xc, xf
    cold, fmg = runs(*cloud(n_sparse), ft.SolverConfig(tol=1e-4, maxiter=SPARSE_MAXITER))
    for label, fn in (("cold", cold), ("fmg_start=1", fmg)):
        (xx, info), t = timed(fn)
        require(tuple(xx.shape) == shape and bool(torch.isfinite(xx).all()),
                f"interpolate {name}, {n_sparse} points, {label}: not finite or wrong shape")
        print(f"interpolate {name}, {n_sparse} points, tol 1e-4, maxiter {SPARSE_MAXITER}, "
              f"{label}: converged "
              f"{bool(info.converged)}, {int(info.iterations)} iterations, rel "
              f"{float(info.rel_residual):.3e}, {t:.3f} ms")
        med[f"sparse_{label}"] = dict(ms=t, iterations=int(info.iterations),
                                      rel=float(info.rel_residual),
                                      converged=bool(info.converged))
    return launches, med, recs


def rotate(nrm, degrees):
    """2-D normals turned by ``degrees``."""
    t = math.radians(degrees)
    rot = torch.tensor([[math.cos(t), -math.sin(t)], [math.sin(t), math.cos(t)]],
                       dtype=nrm.dtype, device=nrm.device)
    return nrm @ rot.T


def phase_session(ft, device, shape=SHAPE, n=N_POINTS, frames=FRAMES):
    """The Solver session on the headline (256², 1000 points, tol 1e-6,
    precise): frame 1 with the iterations of sdf_from_points_precise and
    TRUE ≤ 1e-6; frames 2..9 with the normals turned by a seeded angle of
    at most 2° per frame, each warm-started from the frame before, each
    TRUE ≤ 1e-6. Host clocks after synchronize: construction, frames, a
    frame from zero, the cold field; kernels per frame and per cold field
    from torch.profiler."""
    pts, nrm = make_circle_cloud(n, shape, seed=0)
    pts, nrm = torch.as_tensor(pts, device=device), torch.as_tensor(nrm, device=device)
    grid, w = ft.Grid(shape), ft.Weights(model_2=0.3)
    cfg = ft.SolverConfig(tol=TOL)
    zeros = torch.zeros(n, device=device)

    def cold(normals=nrm):
        return ft.sdf_from_points_precise(grid, w, pts, normals, config=cfg)
    cold()  # warm-up
    ft.Solver(grid, w, pts, config=cfg, precise=True).solve(zeros, gradients=nrm)
    s, build_ms = host_ms(lambda: ft.Solver(grid, w, pts, config=cfg, precise=True))
    read = counters_zero()
    (x, info), first_ms = host_ms(lambda: s.solve(zeros, gradients=nrm))
    launches1 = read()
    (xc, ic), cold_first_ms = host_ms(cold)
    true = check_precise("session frame 1", ft, grid, w, pts, nrm, x, info, device)
    err = float((x - xc).abs().max())
    print(f"session frame 1: iterations {int(info.iterations)} (sdf_from_points_precise "
          f"{int(ic.iterations)}), true rel {true:.6e}, max|x - x_cold| {err:.3e}, "
          f"{first_ms:.3f} ms; launches {launches1}")
    require(int(info.iterations) == int(ic.iterations),
            f"session frame 1: {int(info.iterations)} iterations, cold {int(ic.iterations)}")
    require(err <= 2e-4 * float(xc.abs().max()), f"session frame 1: {err} from the cold field")
    turns = np.random.default_rng(12).uniform(-MAX_TURN_DEG, MAX_TURN_DEG, frames - 1)
    normals, frame_ms, its = nrm, [], []
    read = counters_zero()
    for k, deg in enumerate(turns, start=2):
        normals = rotate(normals, float(deg))
        (x, info), ms = host_ms(lambda: s.solve(zeros, gradients=normals, x0=x))
        true = check_precise(f"session frame {k}", ft, grid, w, pts, normals, x, info, device)
        frame_ms.append(ms)
        its.append(int(info.iterations))
        print(f"session frame {k}: turned {deg:+.3f} deg, warm start, iterations "
              f"{its[-1]}, true rel {true:.6e}, {ms:.3f} ms")
    launches = read()
    # The same clock over cold fields and frames from zero, in turns.
    cold_ms, zero_ms = [], []
    for _ in range(frames - 1):
        cold_ms.append(host_ms(lambda: cold(normals))[1])
        zero_ms.append(host_ms(lambda: s.solve(zeros, gradients=normals))[1])
    med = dict(frame=statistics.median(frame_ms), frame_from_zero=statistics.median(zero_ms),
               cold=statistics.median(cold_ms), construction=build_ms)
    print(f"session: construction {build_ms:.3f} ms; frames 2-{frames} warm-started: median "
          f"{med['frame']:.3f} ms/frame, {statistics.mean(its):.1f} iterations on average; a "
          f"frame from zero {med['frame_from_zero']:.3f} ms; cold sdf_from_points_precise "
          f"{med['cold']:.3f} ms/field (first {cold_first_ms:.3f}); host clock after "
          f"synchronize, medians of {frames - 1}; launches over frames 2-{frames} {launches} "
          f"({launches['fused_pcg_solve'] / (frames - 1):.1f} segment, "
          f"{launches['fused_normal_apply'] / (frames - 1):.1f} apply per frame)")
    require_launched("the session's frames", launches, ("fused_pcg_solve", "fused_normal_apply"))
    prof = {
        "session frame": profile_fields("session frame", [
            lambda: s.solve(zeros, gradients=normals, x0=x)], ("segment kernel",)),
        "session frame from zero": profile_fields("session frame from zero", [
            lambda: s.solve(zeros, gradients=normals)], ("segment kernel",)),
        "cold field": profile_fields("headline cold field", [lambda: cold(normals)],
                                     ("segment kernel",))}
    return launches, med, prof


def phase_prepare4(ft, device, shape=SHAPE3, n=N_POINTS3, reps=PREPARE_REPS):
    """`prepare` + ``solve(prep=)`` on config 4 (128³, 4000 sphere points,
    tol 1e-4): the iterations of the cold solve and its field within
    1e-5·max|x|; the apply and per-sweep kernels launch; the solve and the
    whole field (assembly + prepared solve against sdf_from_points) timed
    in turns; the preconditioner's construction cold and from the prep
    (host clock after synchronize) and the device-busy ms of one solve
    each way (torch.profiler), which a field's ±40% spread hides."""
    from field_interpolation_tpu_torch import solver
    grid, w = ft.Grid(shape), ft.Weights(model_2=0.3)
    cfg = ft.SolverConfig(tol=1e-4, preconditioner="multigrid", backend="auto")
    pts, nrm = sphere_inputs(0, device, shape, n)
    p = ft.assemble_sdf(grid, w, pts, nrm)
    ft.solve(p, cfg)  # warm-up
    solver.prepare(p, cfg)
    prep, prep_ms = host_ms(lambda: solver.prepare(p, cfg))
    ft.solve(p, cfg, prep=prep)
    read = counters_zero()
    (x, info), _ = timed(lambda: ft.solve(p, cfg, prep=prep))
    launches = read()
    xc, ic = ft.solve(p, cfg)
    err = float((x - xc).abs().max())
    require(bool(info.converged), "config 4 prepared solve did not converge")
    require(int(info.iterations) == int(ic.iterations),
            f"config 4 prepared {int(info.iterations)} iterations, cold {int(ic.iterations)}")
    require(err <= 1e-5 * float(xc.abs().max()), f"config 4 prepared: {err} from cold")
    runs = dict(solve_cold=lambda: ft.solve(p, cfg),
                solve_prepared=lambda: ft.solve(p, cfg, prep=prep),
                field_cold=lambda: ft.sdf_from_points(grid, w, pts, nrm, config=cfg),
                field_prepared=lambda: ft.solve(ft.assemble_sdf(grid, w, pts, nrm), cfg,
                                                prep=prep))
    ms = {}
    for _ in range(reps):
        for k, fn in runs.items():
            ms.setdefault(k, []).append(timed(fn)[1])
    med = {k: statistics.median(v) for k, v in ms.items()}
    apply_fn = solver._make_apply(p, cfg)
    setup = {}
    for _ in range(reps):
        setup.setdefault("cold", []).append(host_ms(
            lambda: solver._make_precond(p, cfg, apply_fn))[1])
        setup.setdefault("prepared", []).append(host_ms(
            lambda: solver._make_precond(p, cfg, apply_fn, prep))[1])
    med.update({f"precond_setup_{k}": statistics.median(v) for k, v in setup.items()})
    busy = {k: profile_fields(f"config 4 solve, {k}", [runs[f"solve_{k}"]],
                              ("sweep kernel", "apply kernel"))
            for k in ("cold", "prepared")}
    print(f"config 4 preconditioner setup (host clock after synchronize, medians of "
          f"{reps}): cold {med['precond_setup_cold']:.3f} ms, from the prep "
          f"{med['precond_setup_prepared']:.3f} ms; one solve, device busy cold "
          f"{busy['cold']['busy_ms']:.3f} ms ({busy['cold']['kernels']:.0f} kernels), "
          f"prepared {busy['prepared']['busy_ms']:.3f} ms "
          f"({busy['prepared']['kernels']:.0f} kernels)")
    print(f"config 4 prepare: {prep_ms:.3f} ms (host clock); prepared solve "
          f"{int(info.iterations)} iterations (cold {int(ic.iterations)}), "
          f"max|x - x_cold| {err:.3e}; medians of {reps} in turns (CUDA events): solve "
          f"cold {med['solve_cold']:.3f}, prepared {med['solve_prepared']:.3f} ms; field "
          f"(assembly + solve) cold {med['field_cold']:.3f}, prepared "
          f"{med['field_prepared']:.3f} ms; all {ms}; launches {launches}")
    require_launched("config 4 prepared", launches, ("fused_normal_apply", "fused_smooth"),
                     ("fused_pcg_solve",))
    return launches, dict(med, prepare=prep_ms)


def phase_implicit(ft, device, shape=SHAPE, n=N_POINTS, reps=5):
    """`solve_implicit` on the headline problem, tol 1e-5, with the loss
    ⟨w, x*⟩: b̄ = λ with ‖A λ − w‖ ≤ 1e-5·‖w‖ and the forward x with
    ‖A x − b‖ ≤ 1e-5·‖b‖ (the plain float64 operator), coeff̄ = −λ·shift(x, o)
    from plain ops within 1e-5·max, diaḡ = 0; the apply and whole-cycle V
    kernels launch in the forward and in the backward pass.

    w = A·v for a standard-normal v: a white-noise w puts λ on the
    operator's smallest eigenvalues, where a float32 PCG (the reference's
    algorithm too) stalls near κ·2⁻²⁴ relative (2.3e-2 at 256² in a CPU
    run), far above 1e-5."""
    from field_interpolation_tpu_torch import constraints as cons
    from field_interpolation_tpu_torch import multigrid as tmg
    from field_interpolation_tpu_torch.ops.cycle import fused_vcycle_2d, mg_cycle_plain
    pts, nrm = headline_inputs(0, device)
    p = ft.assemble_sdf(ft.Grid(shape), ft.Weights(model_2=0.3), pts, nrm)
    cfg = ft.SolverConfig(tol=1e-5)
    # The whole-cycle kernel its preconditioner runs, against mg_cycle_plain
    # on the same operands at phase 14's bar.
    whole = tmg.whole_cycle_operands(p, cfg)
    require(whole is not None and whole[1] == 0, "solve_implicit: no whole V-cycle route")
    ops = whole[0]
    r = torch.as_tensor(np.random.default_rng(15).standard_normal(shape).astype(np.float32),
                        device=device)
    nbytes, flops, _ = cycle_work(ops, 3, 3, 0)
    cycle_rec = compare(f"cycle {shape_str(shape)} headline, V, nu 3/3, {len(ops[0])} levels "
                        f"(solve_implicit's preconditioner), standard-normal r",
                        lambda: fused_vcycle_2d(r, *ops, 3, 3),
                        lambda: mg_cycle_plain(r, *ops, 3, 3, 0), 3e-5, (nbytes, flops))
    p64 = ft.Problem(coeff=p.coeff.double(), b=p.b.double(), diag=p.diag.double(),
                     grid=p.grid, weights=p.weights)
    v = torch.as_tensor(np.random.default_rng(13).standard_normal(shape), device=device)
    wv = p64.apply(v).float()
    coeff, b, diag = (t.clone().requires_grad_(True) for t in (p.coeff, p.b, p.diag))

    def forward():
        return ft.solve_implicit(ft.Problem(coeff=coeff, b=b, diag=diag, grid=p.grid,
                                            weights=p.weights), cfg)

    def backward(x):
        return torch.autograd.grad(torch.sum(wv * x), (coeff, b, diag))
    backward(forward())  # warm-up
    torch.cuda.synchronize()
    read = counters_zero()
    x, fwd_ms = timed(forward)
    fwd = read()
    read = counters_zero()
    (c_bar, lam, d_bar), bwd_ms = timed(lambda: backward(x))
    bwd = read()
    xd = x.detach()
    res_x = float(torch.linalg.norm(p64.apply(xd.double()) - p64.b) / torch.linalg.norm(p64.b))
    res_l = float(torch.linalg.norm(p64.apply(lam.double()) - wv.double())
                  / torch.linalg.norm(wv.double()))
    want = torch.stack([-lam * cons._shift(xd, o, 2) for o in cons.offset_list(2)])
    err = float((c_bar - want).abs().max())
    scale = float(want.abs().max())
    require(bool(torch.isfinite(xd).all()) and tuple(xd.shape) == shape,
            "solve_implicit: x not finite or wrong shape")
    require(res_x <= 1e-5, f"solve_implicit forward: relative residual {res_x} > 1e-5")
    require(res_l <= 1e-5, f"solve_implicit backward: |A lam - w| / |w| = {res_l} > 1e-5")
    require(err <= 1e-5 * scale, f"solve_implicit: coeff_bar {err} > 1e-5·{scale}")
    require(bool((d_bar == 0).all()), "solve_implicit: diag_bar is not zero")
    f_ms, b_ms = [], []
    for _ in range(reps):
        xr, ms = timed(forward)
        f_ms.append(ms)
        b_ms.append(timed(lambda: backward(xr))[1])
    print(f"solve_implicit {shape_str(shape)} tol 1e-5: forward relative residual "
          f"{res_x:.3e}, backward |A lam - w|/|w| {res_l:.3e} (float64 operator), "
          f"max|coeff_bar + lam·shift(x)| {err:.3e} (bar {1e-5 * scale:.3e}); forward "
          f"{statistics.median(f_ms):.3f} ms, backward {statistics.median(b_ms):.3f} ms "
          f"(medians of {reps}, CUDA events; the checked calls {fwd_ms:.3f} / {bwd_ms:.3f}); "
          f"launches forward {fwd}, backward {bwd}")
    for label, launches in (("forward", fwd), ("backward", bwd)):
        require_launched(f"solve_implicit {label}", launches,
                         ("fused_normal_apply", "fused_vcycle_2d"), ("fused_pcg_solve",))
    return (dict(forward=fwd, backward=bwd), dict(forward_ms=statistics.median(f_ms),
                                                  backward_ms=statistics.median(b_ms)),
            cycle_rec)


def profiled_device_ms(call, calls, pattern):
    """Device ms per call of the kernels whose name matches ``pattern``,
    from torch.profiler over ``calls`` calls, or None where the profile
    shows fewer than ``calls`` of them (then the event kinds it shows are
    printed). The second try synchronizes after every call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for sync_each in (False, True):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                call()
                if sync_each:
                    torch.cuda.synchronize()
            torch.cuda.synchronize()
        events = trace_events(prof)
        dev = [e for e in events if e[0] == DeviceType.CUDA and re.search(pattern, e[1])]
        if len(dev) == calls:
            return sum(e[3] - e[2] for e in dev) / calls / 1e3
        kinds = sorted({(str(e[0]), e[1][:48]) for e in events})[:12]
        print(f"  the profile shows {len(dev)} of {calls} kernels matching {pattern!r} "
              f"(sync after each call: {sync_each}); event kinds {kinds}")
    return None


def phase_apply_profile(ft, device, cases=None, calls=20):
    """The apply kernel at five shapes of the main paths (256² headline,
    480² field A′, 992² field C, 4096² config 5, 128³ config 4): its device
    time per call from torch.profiler beside its single-call and
    back-to-back times (CUDA events) and its bound, to tell a host floor
    from device time. A measurement, not a check: where the profile does
    not show the kernels, the device time is reported as not measured."""
    from field_interpolation_tpu_torch.ops.stencil import fused_normal_apply
    cases = cases or [
        ("256² headline", SHAPE, lambda: headline_inputs(0, device)),
        ("480² field A′", SHAPE_A2, lambda: field_a_inputs(0, device, SHAPE_A2)),
        ("992² field C", SHAPE_C, lambda: field_a_inputs(0, device, SHAPE_C, N_POINTS_C)),
        ("4096² config 5", SHAPE5, lambda: circle5_inputs(0, device)),
        ("128³ config 4", SHAPE3, lambda: sphere_inputs(0, device))]
    rng = np.random.default_rng(14)
    out = {}
    for label, shape, inputs in cases:
        p = ft.assemble_sdf(ft.Grid(shape), ft.Weights(model_2=0.3), *inputs())
        x = torch.as_tensor(rng.standard_normal(shape).astype(np.float32), device=device)
        nd = len(shape)

        def call():
            return fused_normal_apply(x, p.coeff, p.weights, nd)
        single, b2b = cuda_ms(call), batch_ms(call)
        dev_ms = profiled_device_ms(call, calls, r"normal_apply")
        rec = dict(ms=single, batch_ms=b2b, device_ms=dev_ms,
                   **bound(*apply_work(x, p.coeff, p.weights, nd)))
        dev_txt = ("not measured" if dev_ms is None else
                   f"{dev_ms:.4f} ms per call (torch.profiler, {calls} calls); bound / device "
                   f"{rec['bound_ms'] / dev_ms:.2f}; back to back - device "
                   f"{b2b - dev_ms:.4f} ms")
        print(f"apply {label} ({shape_str(shape)}): single {single:.4f} ms, back to back "
              f"{b2b:.4f}, bound {rec['bound_ms']:.4f} ({rec['bound_by']}); device {dev_txt}")
        out[label] = rec
        del p, x
    torch.cuda.empty_cache()
    return out

SHAPE3B = (128, 128)   # BASELINE config 3: 1024 independent fields of 128²
B3 = 1024
N_POINTS3B = 256
B3_PRECISE = 256       # its TRUE-1e-6 form (bench.py:189-210)
B3_CHECK = 8           # lanes held against their single-field solves
B3_PROFILE_SMALL = 64  # the batch size whose launches config 3's must not pass
B3_LANE_BY_LANE = 32   # lanes timed through the single-field path, as context
BATCH_REPS = 3         # timed config-3 batches, after a warm-up


def config3_inputs(device, B=None, shape=None, n=None):
    """bench.py:166-171 with numpy default_rng(1): per lane n oriented
    points on a circle about the center, radius 0.25-0.4 of the width
    (B3 lanes of N_POINTS3B points in SHAPE3B unless given)."""
    B, shape, n = B or B3, shape or SHAPE3B, n or N_POINTS3B
    rng = np.random.default_rng(1)
    theta = rng.uniform(0, 2 * np.pi, (B, n))
    nrm = np.stack([np.cos(theta), np.sin(theta)], -1).astype(np.float32)
    radii = rng.uniform(0.25, 0.4, (B, 1, 1)) * shape[0]
    pts = ((np.asarray(shape) - 1.0) / 2.0 + radii * nrm).astype(np.float32)
    return torch.as_tensor(pts, device=device), torch.as_tensor(nrm, device=device)


def batch_segment_work(ops, x, iters, nu, wdepth, cheb):
    """(bytes, operations) of one batched segment: every lane's x and r read
    and x written, its cycle operands read once (the shared Rs once over
    their nonzeros); a lane of k iterations runs k cycles, k applies and
    the CG updates (csrc/pcg_segment.cu runs no cycle it does not use)."""
    coeffs, sids, Rs, inv_c, lw = ops[:5]
    lane0 = ([c[0] for c in coeffs], [t[0] for t in sids], Rs, inv_c[0], lw)
    cb, cf, _ = cycle_work(lane0, nu, nu, wdepth, cheb)
    rs_bytes = 4 * sum(int(torch.count_nonzero(R)) for R in Rs)
    B, n = x.shape[0], x[0].numel()
    per_lane = cb - rs_bytes - 8 * n + 12 * n
    k = int(iters.sum())
    return (B * per_lane + rs_bytes,
            k * (cf + n * (apply_flops(lw[0], 2, False) + 12)))


def segment_ptxas(log):
    """{kernel: [registers, spill store bytes, spill load bytes]} of the
    segment kernels from ptxas' output of a build (the spills of the kernel
    and of the functions it calls, summed), the batched kernel's
    instantiations as pcg_segment_batch_kernel<threads, lanes an SM>."""
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"pcg_segment_batch_kernelILi(\d+)ELi(\d+)E", line)
            name = (f"pcg_segment_batch_kernel<{m[1]},{m[2]}>" if m else
                    "pcg_segment_kernel" if "pcg_segment_kernel" in line else None)
            if name:
                out[name] = [0, 0, 0]
        elif name and "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
            out[name][1] += nums[1]
            out[name][2] += nums[2]
        elif name and "Used" in line and "registers" in line:
            out[name][0] = int(line.split("Used")[1].split()[0])
    return out


def lane_iteration_bytes(shapes, diags, nu, wdepth, cheb, plan):
    """The bytes one CG iteration of one lane of the batched segment moves
    to and from global memory, counted from csrc/lane2d.cuh's loads and
    stores: each array a phase touches once a phase (the windows' re-reads
    from cache not counted), nothing of what ``plan`` (`ops.pcg.lane_plan`:
    threads, lanes an SM holds, bitmask of coarse levels in shared memory,
    level 0's residual) keeps in shared memory. A figure from the code, not
    a reading."""
    mask, az0 = plan[2:4]
    L = len(shapes)
    n = [a * b for a, b in shapes]
    planes = [1 if d else 9 for d in diags]
    glob = [l == 0 or not (mask >> l) & 1 for l in range(L)]
    gaz = [not az0 if l == 0 else glob[l] for l in range(L)]

    def sweeps(l, ks, cheb_prev):
        # a sweep reads r, sid, z_in, the data planes (and z_prev) and writes z
        return sum((4 + planes[l] + (cheb and cheb_prev(k))) * n[l] * glob[l] for k in ks)

    def visit(l):
        if l == L - 1:  # the dense solve: the lane's inverse, r_c, z_c
            return n[l] ** 2 + 2 * n[l] * glob[l]
        # pre-smoothing: sweep 0 from zero reads r and sid and writes z (on
        # level 0 the CG update does it), the others are whole sweeps
        out = sweeps(l, range(1, nu), lambda k: k >= 2)
        out += (3 * n[l] * glob[l] if l > 0 else 0) if nu > 0 else n[l] * glob[l]
        out += (2 + planes[l]) * n[l] * glob[l] + n[l] * gaz[l]          # residual
        out += n[l] * gaz[l] + n[l + 1] * glob[l + 1]                    # restriction
        twice = l < wdepth and l + 1 < L - 1
        for _ in range(2 if twice else 1):
            out += visit(l + 1)
            out += 2 * n[l] * glob[l] + n[l + 1] * glob[l + 1]           # prolongation
        if twice:  # the W step's r −= A z on level l + 1
            out += (3 + planes[l + 1]) * n[l + 1] * glob[l + 1]
        return out + sweeps(l, range(nu), lambda k: k >= 1)

    cg = 3 * n[0] + (10 * n[0] + n[0] * gaz[0]) + (4 * n[0] + n[0] * gaz[0] + 3 * n[0])
    return 4 * (visit(0) + cg)


def compare_segment_batch(label, probs, cfg, device, budget=None, plain_reps=PLAIN_REPS):
    """The batched segment kernel against its plain version at tol 1e-4 from
    x = 0 on ``probs``' fused operands, lane by lane to the single-field
    bars; lanes with budget 0 or b = 0 must run 0 iterations and keep x.
    Timed single and back to back; returns the record."""
    from field_interpolation_tpu_torch.multigrid import (build_fused_solver_operands,
                                                         resolve_wdepth)
    from field_interpolation_tpu_torch.ops.cycle import level_shapes
    from field_interpolation_tpu_torch.ops.pcg import (_sms, fused_pcg_solve_batch,
                                                       fused_pcg_solve_batch_plain,
                                                       lane_geometry, lane_plan)
    ops = build_fused_solver_operands(probs, cfg)
    coeffs, sids, Rs, inv32, lw, cfs = ops
    b = probs.b
    B = b.shape[0]
    x0 = torch.zeros_like(b)
    tol2 = (1e-4 ** 2 * torch.sum(b * b, dim=(1, 2))).contiguous()
    if budget is None:
        budget = torch.full((B,), 2000, dtype=torch.int32, device=device)
    wdepth = resolve_wdepth(cfg, tuple(b.shape[1:]))
    nu = cfg.mg_pre_smooth
    args = (x0, b, tol2, budget, coeffs, sids, Rs, inv32, lw, nu)
    kw = dict(cheb_coefs=cfs, wdepth=wdepth)
    xk, ik, rrk = fused_pcg_solve_batch(*args, **kw)
    xp, ip, rrp = fused_pcg_solve_batch_plain(*args, **kw)
    torch.cuda.synchronize()
    d_it = int((ik - ip).abs().max())
    scale = xp.abs().amax(dim=(1, 2)).clamp_min(1e-30)
    rel = float(((xk - xp).abs().amax(dim=(1, 2)) / scale).max())
    err = float((xk - xp).abs().max())
    frozen = (budget == 0) | (torch.sum(b * b, dim=(1, 2)) == 0)
    kept = bool(torch.equal(xk[frozen], x0[frozen])) and int(ik[frozen].abs().sum()) == 0
    ms = cuda_ms(lambda: fused_pcg_solve_batch(*args, **kw))
    b2b = batch_ms(lambda: fused_pcg_solve_batch(*args, **kw))
    plain_ms = cuda_ms(lambda: fused_pcg_solve_batch_plain(*args, **kw), plain_reps)
    shapes = level_shapes([c[0] for c in coeffs])
    diags = [c.ndim == 3 for c in coeffs]
    plan = lane_plan(shapes, diags, nu, wdepth, lane_geometry(B, _sms(device)))
    lane_bytes = lane_iteration_bytes(shapes, diags, nu, wdepth, cfs is not None, plan)
    rec = dict(max_abs_err=err, max_rel_lane_err=rel, ms=ms, batch_ms=b2b, plain_ms=plain_ms,
               lanes=B, iterations_sum=int(ik.sum()), iterations_max=int(ik.max()),
               frozen_lanes=int(frozen.sum()), threads_per_lane=plan[0], blocks_per_lane=1,
               lanes_per_sm=plan[1], shared_levels_mask=plan[2], shared_residual=plan[3],
               shared_bytes=plan[4],
               **bound(*batch_segment_work(ops, b, ik, nu, wdepth, cfs is not None)))
    print(f"batched segment {label} (B={B}, {shape_str(tuple(b.shape[1:]))}, wdepth {wdepth}, "
          f"{'Chebyshev' if cfs is not None else 'Jacobi'}): iterations kernel "
          f"{ik.tolist()} plain {ip.tolist()}; max lane |x_k - x_p|/max|x_p| {rel:.3e} "
          f"(bar 2e-3); frozen lanes {int(frozen.sum())} kept {kept}; kernel {ms:.4f} ms, "
          f"back to back {b2b:.4f} ms ({1e3 * b2b / max(int(ik.sum()), 1):.2f} us per lane "
          f"iteration), plain {plain_ms:.4f} ms; bound {rec['bound_ms']:.4f} ms "
          f"({rec['bound_by']}); {plan[0]} threads a lane, {plan[1]} lanes an SM, shared levels "
          f"{plan[2]:#b}, residual shared {plan[3]}, {plan[4]} B; bytes this design moves "
          f"(model): {lane_bytes / 1e6:.3f} MB a lane-iteration")
    require(d_it <= 2, f"batched segment {label}: iterations {ik.tolist()} vs {ip.tolist()}")
    require(bool(torch.isfinite(xk).all()), f"batched segment {label}: x not finite")
    require(rel <= 2e-3, f"batched segment {label}: lane error {rel} > 2e-3·max|x|")
    require(kept, f"batched segment {label}: a frozen lane ran or moved")
    return rec


def phase_batch_kernels(ft, device):
    """Phase 38: each batched kernel against its plain version (the
    segment also on config 3's whole batch, its shapes on the main path)."""
    from field_interpolation_tpu_torch import batch as tb
    from field_interpolation_tpu_torch.ops.stencil import (fused_normal_apply_batch,
                                                           fused_normal_apply_plain)
    w = ft.Weights(model_2=0.3)
    recs = {}
    pts, nrm = config3_inputs(device, B=8)
    pts[0] += 1e4  # lane 0: every point out of bounds, b = 0
    zeros = torch.zeros(pts.shape[:2], device=device)
    p8 = tb.assemble_batch(ft.Grid(SHAPE3B), w, pts, zeros, gradients=nrm)
    budget = torch.full((8,), 2000, dtype=torch.int32, device=device)
    budget[1] = 0
    cfg = ft.SolverConfig(tol=1e-4)
    recs["seg"] = compare_segment_batch("config 3 V", p8, cfg, device, budget)
    pts3, nrm3 = config3_inputs(device)
    p3 = tb.assemble_batch(ft.Grid(SHAPE3B), w, pts3, torch.zeros(pts3.shape[:2], device=device),
                           gradients=nrm3)
    recs["seg_config3"] = compare_segment_batch("config 3, every lane", p3, cfg, device,
                                                plain_reps=1)
    del p3
    p4 = tb.assemble_batch(ft.Grid(SHAPE3B), w, pts[4:], zeros[4:], gradients=nrm[4:])
    recs["seg_w"] = compare_segment_batch("config 3 W", p4, ft.SolverConfig(
        tol=1e-4, mg_cycle="w"), device)
    recs["seg_cheb"] = compare_segment_batch("config 3 Chebyshev", p4, ft.SolverConfig(
        tol=1e-4, **CHEB), device)
    clouds = [headline_inputs(s, device) for s in range(3)]
    p256 = tb.assemble_batch(ft.Grid(SHAPE), w, torch.stack([c[0] for c in clouds]),
                             torch.zeros(3, N_POINTS, device=device),
                             gradients=torch.stack([c[1] for c in clouds]))
    recs["seg_256"] = compare_segment_batch("headline clouds", p256, cfg, device)
    del p8, p4, p256
    rng = np.random.default_rng(15)
    for label, shape, B in [("apply_16", SHAPE3B, 16), ("apply_1024", SHAPE3B, B3),
                            ("apply_32_3d", (32, 32, 32), 4)]:
        if len(shape) == 2:
            bp, bn = config3_inputs(device, B=B)
        else:
            cl = [sphere_inputs(s, device, shape, 1000) for s in range(B)]
            bp, bn = torch.stack([c[0] for c in cl]), torch.stack([c[1] for c in cl])
        probs = tb.assemble_batch(ft.Grid(shape), w, bp, torch.zeros(bp.shape[:2],
                                                                     device=device),
                                  gradients=bn)
        x = torch.as_tensor(rng.standard_normal((B,) + shape).astype(np.float32),
                            device=device)
        nd = len(shape)
        print(f"batched apply {label}: B={B}, {shape_str(shape)}")
        recs[label] = compare(f"batched apply {label}",
                              lambda: fused_normal_apply_batch(x, probs.coeff, w, nd),
                              lambda: fused_normal_apply_plain(x, probs.coeff, w, nd), 1e-5,
                              apply_work(x, probs.coeff, w, nd))
        del probs, x
    torch.cuda.empty_cache()
    return recs


def batch_check_lanes(ft, label, grid, w, pts, nrm, cfg, x, info, lanes):
    """``lanes`` of a float32 batch against their single-field solves:
    iterations within ±2, x within 2e-3·max|x|."""
    worst = 0.0
    for i in lanes:
        xi, ii = ft.sdf_from_points(grid, w, pts[i], nrm[i], config=cfg)
        d = abs(int(info.iterations[i]) - int(ii.iterations))
        e = float((x[i] - xi).abs().max()) / max(float(xi.abs().max()), 1e-30)
        worst = max(worst, e)
        require(d <= 2 and e <= 2e-3,
                f"{label} lane {i}: iterations {int(info.iterations[i])} vs single "
                f"{int(ii.iterations)}, error {e} of max|x|")
    print(f"{label}: lanes {list(lanes)} within ±2 iterations and {worst:.3e}·max|x| of "
          f"their single-field solves")


def phase_config3(ft, device):
    """Phase 39: BASELINE config 3 on the card, through sdf_from_points_batch."""
    from field_interpolation_tpu_torch import batch as tb
    grid, w = ft.Grid(SHAPE3B), ft.Weights(model_2=0.3)
    cfg = ft.SolverConfig(tol=1e-4, preconditioner="multigrid")
    pts, nrm = config3_inputs(device)
    probe = tb.assemble_batch(grid, w, pts, torch.zeros(B3, N_POINTS3B, device=device),
                              gradients=nrm)
    require(tb.solve_route(probe, tb._batch_config(grid, cfg, B3)) == "fused",
            "config 3 does not take the batched fused route")
    del probe

    def run(B=B3):
        return tb.sdf_from_points_batch(grid, w, pts[:B], nrm[:B], config=cfg)
    run()  # warm-up
    torch.cuda.synchronize()
    read = counters_zero()
    (x, info), first_ms = timed(run)
    launches = read()
    ms = [first_ms] + [timed(run)[1] for _ in range(BATCH_REPS - 1)]
    its = info.iterations
    require(bool(info.converged.all()), f"config 3: {int((~info.converged).sum())} lanes "
            "did not converge")
    require(tuple(x.shape) == (B3,) + SHAPE3B and bool(torch.isfinite(x).all()),
            "config 3: fields not finite or of the wrong shape")
    med = statistics.median(ms)
    rounds = launches["fused_pcg_solve_batch"]
    print(f"config 3: {B3} fields of {shape_str(SHAPE3B)}, {N_POINTS3B} points each, tol 1e-4: "
          f"all converged; iterations max {int(its.max())}, mean {float(its.float().mean()):.2f}, "
          f"sum {int(its.sum())}; {statistics.median(ms):.3f} ms per batch (CUDA events, "
          f"median of {len(ms)}: {', '.join(f'{t:.3f}' for t in ms)}), {1e3 * med / B3:.2f} "
          f"us/field, {B3 / (med / 1e3):.0f} fields/s; launches per batch {launches}")
    require(rounds >= 1 and launches["fused_pcg_solve"] == 0,
            f"config 3: batched segment launched {rounds} times, single segment "
            f"{launches['fused_pcg_solve']}")
    require(launches["fused_normal_apply_batch"] >= rounds,
            "config 3: the batched apply did not verify every round")
    batch_check_lanes(ft, "config 3", grid, w, pts, nrm, cfg, x, info,
                      range(0, B3, B3 // B3_CHECK))
    prof = {B: profile_fields(f"config 3 batch of {B}", [lambda: run(B)], ("segment kernel",))
            for B in (B3_PROFILE_SMALL, B3)}
    # Setup and rounds, not lanes, set the launches: 16x the lanes may add
    # an outer round, not 16x the calls.
    require(prof[B3]["launch_calls"] <= 1.25 * prof[B3_PROFILE_SMALL]["launch_calls"],
            f"config 3: launch calls grow with B: {prof[B3_PROFILE_SMALL]['launch_calls']} at "
            f"{B3_PROFILE_SMALL}, {prof[B3]['launch_calls']} at {B3}")
    p = prof[B3]
    print(f"config 3: device busy {p['busy_ms']:.3f} ms per batch ({1 - p['idle']:.3f} of the "
          f"span), {p['kernels']:.0f} kernels, {p['launch_calls']:.0f} launch calls per batch "
          f"(B={B3_PROFILE_SMALL}: {prof[B3_PROFILE_SMALL]['kernels']:.0f} kernels, "
          f"{prof[B3_PROFILE_SMALL]['launch_calls']:.0f} launch calls)")
    return launches, dict(ms=med, us_per_field=1e3 * med / B3, fields_per_s=B3 / (med / 1e3),
                          iterations_max=int(its.max()),
                          iterations_mean=float(its.float().mean()), profile=prof), x


def phase_config3_precise(ft, device):
    """Phase 40: config 3 at a TRUE 1e-6, B = 256."""
    from field_interpolation_tpu_torch import batch as tb
    grid, w = ft.Grid(SHAPE3B), ft.Weights(model_2=0.3)
    cfg = ft.SolverConfig(tol=1e-6, preconditioner="multigrid")
    pts, nrm = config3_inputs(device)
    pts, nrm = pts[:B3_PRECISE], nrm[:B3_PRECISE]

    def run():
        return tb.sdf_from_points_precise_batch(grid, w, pts, nrm, config=cfg)
    run()
    read = counters_zero()
    (x, info), first_ms = timed(run)
    launches = read()
    ms = [first_ms] + [timed(run)[1] for _ in range(BATCH_REPS - 1)]
    pp = tb.assemble_precise_batch(grid, w, pts, torch.zeros(pts.shape[:2], device=device),
                                   gradients=nrm)
    true = (torch.linalg.vector_norm(pp.residual64(x), dim=(1, 2))
            / torch.linalg.vector_norm(pp.b64, dim=(1, 2)))
    rep = info.rel_residual.double()
    gap = float(((true - rep).abs() / true).max())
    med = statistics.median(ms)
    print(f"config 3 at TRUE 1e-6: {B3_PRECISE} fields, true rel max {float(true.max()):.4e}, "
          f"reported within {gap:.4f} of true; iterations max {int(info.iterations.max())}, "
          f"mean {float(info.iterations.float().mean()):.2f}; {med:.3f} ms per batch (median "
          f"of {len(ms)}), {1e3 * med / B3_PRECISE:.2f} us/field, "
          f"{B3_PRECISE / (med / 1e3):.0f} fields/s; launches {launches}")
    require(bool(info.converged.all()), "config 3 at 1e-6: a lane did not converge")
    require(bool(torch.isfinite(x).all()), "config 3 at 1e-6: fields not finite")
    require(float(true.max()) <= TOL, f"config 3 at 1e-6: true residual {float(true.max())}")
    require(gap <= 0.02, f"config 3 at 1e-6: reported residual {gap} from the true one")
    require(launches["fused_pcg_solve_batch"] >= 1, "config 3 at 1e-6: no batched segment")
    return launches, dict(ms=med, us_per_field=1e3 * med / B3_PRECISE,
                          true_max=float(true.max()))


def phase_batch_lanes(ft, device):
    """Phase 41: config 3's first lanes one after another through the
    single-field path (context for the batch, not a target)."""
    grid, w = ft.Grid(SHAPE3B), ft.Weights(model_2=0.3)
    cfg = ft.SolverConfig(tol=1e-4, preconditioner="multigrid")
    pts, nrm = config3_inputs(device, B=B3_LANE_BY_LANE)
    ft.sdf_from_points(grid, w, pts[0], nrm[0], config=cfg)

    def run():
        return [ft.sdf_from_points(grid, w, pts[i], nrm[i], config=cfg)
                for i in range(B3_LANE_BY_LANE)]
    _, ms = timed(run)
    print(f"config 3 lane by lane: {B3_LANE_BY_LANE} fields through sdf_from_points, "
          f"{ms:.3f} ms, {ms / B3_LANE_BY_LANE:.3f} ms/field "
          f"({ms / B3_LANE_BY_LANE * B3 / 1e3:.2f} s for {B3} at that rate)")
    return dict(ms_per_field=ms / B3_LANE_BY_LANE)


# The batched-cycle slice (phases 42-45): the lane forms of the smoothing-
# phase, multi-sweep and whole-cycle kernels, then the batches that take the
# "cycle" route (batch.solve_route), each with the counts set to 0 just
# before it and read just after.
B4 = 16                     # BASELINE config 4 in lanes (bench.py:212-254): 128³, 4000 points
B4_CHECK = (0, 5, 10, 15)   # lanes held against their single-field solves
B3_JACOBI = 4096            # config 3's inputs where the reference's rule picks the Jacobi coarsest
B3_JACOBI_CHECK = (0, 1365, 2730, 4095)
B_A, B_C = 8, 4             # field A (496²) and field C's grid (992²) in lanes
B_A_CHECK, B_C_CHECK = (0, 3, 5, 7), (0, 3)
SHAPE_D8 = (1024, 1024)     # 8 lanes whose level 1 is the 512² diagonal level
LANE_REPS = 5               # timed calls of a lane kernel, single and back to back
CYCLE_REPS = 5              # timed batches of a "cycle"-route path, after a warm-up


def compare_lanes(label, batched, single, plain, B, bar, work, residual=False, check=None):
    """A lane kernel on B lanes: its output within ``bar``·max|plain| of the
    plain version on all B lanes, and the output of each lane of ``check``
    (every lane when None) the bits of the single-field call on that lane
    (``single(i)``); timed single and back to back beside those lanes'
    single-field calls back to back and the plain version. Returns the
    record."""
    check = range(B) if check is None else check
    got, want = batched(), plain()
    outs, wants = (got, want) if residual else ((got,), (want,))
    parts = (", z", ", r - A z") if residual else ("",)
    errs = [check_close(label + part, g, w, bar) for part, g, w in zip(parts, outs, wants)]
    for i in check:
        one = single(i)
        for part, g, o in zip(parts, outs, one if residual else (one,)):
            require(torch.equal(g[i], o), f"{label}{part}: lane {i} is not the single-field "
                    f"call's bits (max diff {float((g[i] - o).abs().max())})")
    del got, want, outs, wants
    ms, b2b = cuda_ms(batched, LANE_REPS), batch_ms(batched, LANE_REPS)
    single_ms = batch_ms(lambda: [single(i) for i in check], LANE_REPS)
    plain_ms = cuda_ms(plain, 1)
    rec = dict(max_abs_err=max(errs), ms=ms, batch_ms=b2b, plain_ms=plain_ms,
               single_calls_ms=single_ms, single_calls=len(check), lanes=B,
               lanes_bitwise_equal=list(check) if len(check) < B else True, **bound(*work))
    which = "every lane" if len(check) == B else f"lanes {list(check)}"
    print(f"  all {B} lanes within {bar}·max|plain|; {which} the single-field call's bits; "
          f"lane kernel {ms:.4f} ms (back to back {b2b:.4f}), {len(check)} single-field "
          f"calls back to back {single_ms:.4f} ms, plain {plain_ms:.4f} ms; bound "
          f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})")
    return rec


def stacked(inputs, seeds):
    """(positions [B, n, D], normals [B, n, D]) of the clouds ``inputs(seed)``."""
    clouds = [inputs(s) for s in seeds]
    return torch.stack([c[0] for c in clouds]), torch.stack([c[1] for c in clouds])


def lane_problems(ft, device, shape, inputs, seeds):
    """Lanes of ``inputs(seed, device)`` clouds, assembled in one pass."""
    from field_interpolation_tpu_torch import batch as tb
    pts, nrm = stacked(lambda s: inputs(s, device), seeds)
    return tb.assemble_batch(ft.Grid(shape), ft.Weights(model_2=0.3), pts,
                             torch.zeros(pts.shape[:2], device=device), gradients=nrm)


def phase_lane_kernels(ft, device):
    """Phase 42: the lane forms against their plain versions on the same
    lanes and against one single-field call a lane (bit for bit), on the
    operands the "cycle" route gives them: the smoothing-phase kernel on
    config 4's lumped 128³ fine level × 16 and its 64³ diagonal level × 16,
    and on a 512² diagonal level × 8 (config 5's proxy cloud at 1024²); the
    multi-sweep kernel on field C's 992² fine level × 4; at config 3's
    inputs × 4096 with the Jacobi coarsest (phase 44's batch), the
    multi-sweep kernel on the 128² fine level and the smoothing-phase
    kernel on the 64² level and on the 16² coarsest's mg_coarse_iters
    sweeps from zero, there the lanes B3_JACOBI_CHECK bit for bit; the
    whole-cycle kernel, W on field A × 8 (496²) and V on the headline's
    256² lumped hierarchy × 8. Smoothing phases ν = 3 (2e-5·max|plain|),
    cycles on a standard-normal r (3e-5·max|plain|)."""
    from field_interpolation_tpu_torch import multigrid as tmg
    from field_interpolation_tpu_torch.ops.cycle import (fused_vcycle_2d, fused_wcycle_2d,
                                                         mg_cycle_plain)
    from field_interpolation_tpu_torch.ops.smooth import (fused_smooth, fused_smooth_2d,
                                                          fused_smooth_plain)
    # Drawn on the device: 4096 lanes of 128² are 67 M normals a tensor.
    gen = torch.Generator(device=device).manual_seed(42)
    cfg = ft.SolverConfig(tol=1e-4)
    recs = {}

    def rand(shape):
        return torch.randn(shape, generator=gen, device=device)

    def phase(key, label, coeff, sid, w, nd, fz, residual, nu=3, check=None, cf=None):
        # cf: the lanes' [B, ν, 2] Chebyshev schedules (sid = D⁻¹), or None
        # for damped Jacobi.
        B, multi = sid.shape[0], coeff.ndim == sid.ndim + 1 and nd == 2
        r, z = rand(tuple(sid.shape)), rand(tuple(sid.shape))

        def call(rr, zz, c, si, cfs=cf):
            if multi:
                return fused_smooth_2d(rr, zz, c, si, w, nu, fz, cheb_coefs=cfs,
                                       residual=residual)
            return fused_smooth(rr, zz, c, si, w, nd, nu, fz, cheb_coefs=cfs,
                                residual=residual)
        print(f"lane {'multi-sweep' if multi else 'smoothing-phase'} kernel, {label}: B={B}, "
              f"{shape_str(tuple(sid.shape[1:]))}, ν = {nu}"
              f"{' Chebyshev' if cf is not None else ''} from {'zero' if fz else 'z'}"
              f"{' with the residual' if residual else ''}")
        work = tuple(B * v for v in sweep_work(r[0], coeff[0], w, nd, nu, fz,
                                               cheb=cf is not None, residual=residual))
        recs[key] = compare_lanes(
            f"lane phase {key}", lambda: call(r, z, coeff, sid),
            lambda i: call(r[i], z[i], coeff[i], sid[i], None if cf is None else cf[i]),
            lambda: fused_smooth_plain(r, z, coeff, sid, w, nd, nu, fz, cheb_coefs=cf,
                                       residual=residual),
            B, 2e-5, work, residual, check)
        recs[key]["multi_sweep"] = multi

    def smooth_ops(probs, config=cfg):
        prep = tmg.prepare_mg(probs, config, fused=False, kernels=True)
        return (prep.smooth_ops, [probs.weights] + [l.weights for l in prep.levels],
                prep.schedules)

    p4 = lane_problems(ft, device, SHAPE3, sphere_inputs, range(B4))
    ops, lw, _ = smooth_ops(p4)
    phase("sweep_128_lumped_x16", "config 4's lumped fine level", *ops[0], lw[0], 3, True, True)
    phase("sweep_64_diag_x16", "config 4's 64³ diagonal level", *ops[1], lw[1], 3, False, False)
    del ops
    # The Chebyshev lane form on the 27-channel Galerkin level (the 537 row).
    ops, lw, sched = smooth_ops(p4, ft.SolverConfig(tol=1e-4, **CHEB, **GALERKIN))
    del p4
    require(ops[1][0].ndim == 5, f"config 4 x 16 Galerkin: level 1 data {tuple(ops[1][0].shape)}")
    phase("sweep_64_galerkin_cheb_x16", "config 4's 64³ Galerkin level (27 channels), "
          "Chebyshev", *ops[1], lw[1], 3, True, True, cf=sched[1, 3])
    del ops, sched
    p5 = lane_problems(ft, device, SHAPE_D8, lambda s, d: circle5_inputs(
        s, d, SHAPE_D8, N_POINTS5 // 16), range(8))
    ops, lw, _ = smooth_ops(p5)
    del p5
    phase("sweep_512_diag_x8", "512² diagonal level (config 5's cloud at 1024²)", *ops[1],
          lw[1], 2, True, False)
    del ops
    pc = lane_problems(ft, device, SHAPE_C, lambda s, d: field_a_inputs(
        s, d, SHAPE_C, N_POINTS_C), range(B_C))
    ops, lw, _ = smooth_ops(pc)
    del pc
    phase("multi_992_x4", "field C's 992² fine level", *ops[0], lw[0], 2, True, True)
    del ops
    from field_interpolation_tpu_torch import batch as tb
    pts, nrm = config3_inputs(device, B=B3_JACOBI)
    grid = ft.Grid(SHAPE3B)
    jcfg = tb._batch_config(grid, cfg, B3_JACOBI)
    require(jcfg.mg_coarse_solver == "jacobi", "config 3 x 4096: not the Jacobi coarsest")
    p3 = tb.assemble_batch(grid, ft.Weights(model_2=0.3), pts,
                           torch.zeros(pts.shape[:2], device=device), gradients=nrm)
    del pts, nrm
    ops, lw, _ = smooth_ops(p3, jcfg)
    del p3
    phase("multi_128_x4096", "config 3's 128² fine level", *ops[0], lw[0], 2, True, True,
          check=B3_JACOBI_CHECK)
    phase("sweep_64_x4096", "config 3's 64² level", *ops[1], lw[1], 2, True, True,
          check=B3_JACOBI_CHECK)
    phase("coarsest_jacobi_x4096", "config 3's Jacobi coarsest", *ops[-1], lw[-1], 2, True,
          False, nu=jcfg.mg_coarse_iters, check=B3_JACOBI_CHECK)
    require(recs["multi_128_x4096"]["multi_sweep"]
            and not recs["sweep_64_x4096"]["multi_sweep"]
            and not recs["coarsest_jacobi_x4096"]["multi_sweep"],
            "config 3 x 4096: a level in another kernel than its path's")
    del ops
    torch.cuda.empty_cache()
    for key, shape, inputs, change in [
            ("cycle_w_496_x8", SHAPE_A, field_a_inputs, {}),
            ("cycle_v_256_lumped_x8", SHAPE, headline_inputs,
             dict(mg_fine_operator="lumped"))]:
        probs = lane_problems(ft, device, shape, inputs, range(8))
        (cops, wdepth, cfs) = tmg.whole_cycle_operands(probs, ft.SolverConfig(tol=1e-4,
                                                                              **change))
        del probs
        coeffs, sids, Rs, inv32, lw = cops
        r = rand((8,) + shape)
        kernel = fused_wcycle_2d if wdepth else fused_vcycle_2d

        def call(rr, cs, ss, inv, kernel=kernel, wdepth=wdepth):
            if wdepth:
                return kernel(rr, cs, ss, Rs, inv, lw, 3, wdepth=wdepth)
            return kernel(rr, cs, ss, Rs, inv, lw, 3, 3)
        nbytes, flops, phases = cycle_work(([c[0] for c in coeffs], [t[0] for t in sids], Rs,
                                            inv32[0], lw), 3, 3, wdepth)
        print(f"lane whole-cycle kernel {key}: B=8, {shape_str(shape)}, "
              f"{'W' if wdepth else 'V'}, {len(coeffs)} levels, {phases} grid-barrier phases "
              "for the batch (one field's)")
        recs[key] = compare_lanes(
            f"lane cycle {key}", lambda: call(r, coeffs, sids, inv32),
            lambda i: call(r[i], [c[i] for c in coeffs], [t[i] for t in sids], inv32[i]),
            lambda: mg_cycle_plain(r, coeffs, sids, Rs, inv32, lw, 3, 3, wdepth), 8, 3e-5,
            (8 * nbytes, 8 * flops))
        recs[key]["phases"] = phases
        del cops, coeffs, sids, inv32, r
    torch.cuda.empty_cache()
    return recs


def route_stub(ft, shape, B, device):
    """A problem of B lanes that only the route reads (grid, dtype, lanes)."""
    z = torch.zeros(shape, device=device)
    c = torch.zeros((3 ** len(shape),) + shape, device=device)
    return ft.Problem(coeff=c.expand((B,) + c.shape), b=z.expand((B,) + shape),
                      diag=(z + 1.0).expand((B,) + shape), grid=ft.Grid(shape),
                      weights=ft.Weights(model_2=0.3))


def cycle_batch_path(ft, device, label, shape, pts, nrm, cfg, check, by_lane, must_see):
    """A batch through sdf_from_points_batch on the "cycle" route: every lane
    converged and finite; the lanes ``check`` within ±2 iterations and
    2e-3·max|x| of their single-field solves with the batch's config; ms
    per batch (CUDA events, median and spread of CYCLE_REPS after a
    warm-up) and the launches per batch (counts set to 0 just before the
    first timed batch, read just after); one field's launches (the lane of
    the most iterations, which the batch runs to: a lane stops on its own,
    the cycle runs on for the slowest); a profile of a batch (device busy,
    kernels, launch calls); the lanes ``by_lane`` one after another
    through the single-field path (warm: those of ``check`` have run).
    Returns (launches, the single field's launches, the record)."""
    from field_interpolation_tpu_torch import batch as tb
    grid, w = ft.Grid(shape), ft.Weights(model_2=0.3)
    B = pts.shape[0]
    bcfg = tb._batch_config(grid, cfg, B)
    require(tb.solve_route(route_stub(ft, shape, B, device), bcfg) == "cycle",
            f"{label}: the batch does not take the cycle route")

    def run():
        return tb.sdf_from_points_batch(grid, w, pts, nrm, config=cfg)
    run()
    torch.cuda.synchronize()
    read = counters_zero()
    (x, info), first = timed(run)
    launches = read()
    ms = [first] + [timed(run)[1] for _ in range(CYCLE_REPS - 1)]
    its = info.iterations
    require(bool(info.converged.all()), f"{label}: {int((~info.converged).sum())} lanes did "
            "not converge")
    require(tuple(x.shape) == (B,) + shape and bool(torch.isfinite(x).all()),
            f"{label}: fields not finite or of the wrong shape")
    batch_check_lanes(ft, label, grid, w, pts, nrm, bcfg, x, info, check)
    del x
    slowest = int(torch.argmax(its))
    read = counters_zero()
    ft.sdf_from_points(grid, w, pts[slowest], nrm[slowest], config=bcfg)
    one = read()
    prof = profile_fields(f"{label} batch of {B}", [run], must_see)
    _, lane_ms = timed(lambda: [ft.sdf_from_points(grid, w, pts[i], nrm[i], config=bcfg)
                                for i in by_lane])
    med, spread = statistics.median(ms), (max(ms) - min(ms)) / statistics.median(ms)
    per_lane = lane_ms / len(by_lane)
    print(f"{label}: {B} fields of {shape_str(shape)}, tol {cfg.tol}, coarsest "
          f"{bcfg.mg_coarse_solver}: all converged; iterations max {int(its.max())}, mean "
          f"{float(its.float().mean()):.2f}; {med:.3f} ms per batch (CUDA events, median of "
          f"{len(ms)}: {', '.join(f'{t:.3f}' for t in ms)}; spread {spread:.3f} of the "
          f"median), {med / B:.3f} ms/field; lane by "
          f"lane {per_lane:.3f} ms/field over {len(by_lane)} lanes ({per_lane * B:.1f} ms for "
          f"the batch at that rate); device busy {prof['busy_ms']:.3f} ms per batch, "
          f"{prof['kernels']:.0f} kernels, {prof['launch_calls']:.0f} launch calls; launches "
          f"per batch {launches}; one field's (lane {slowest}) {one}")
    require(launches["fused_pcg_solve"] == 0 and launches["fused_pcg_solve_batch"] == 0,
            f"{label}: a segment kernel ran on the cycle route")
    return launches, one, dict(ms=med, ms_runs=ms, ms_spread=spread, ms_per_field=med / B,
                               lane_by_lane_ms_per_field=per_lane,
                               lane_by_lane_lanes=len(by_lane), lanes=B,
                               iterations_max=int(its.max()),
                               iterations_mean=float(its.float().mean()), profile=prof,
                               coarse_solver=bcfg.mg_coarse_solver)


def phase_config4_batch(ft, device):
    """Phase 43: BASELINE config 4 × 16 (128³, 4000 sphere points a lane,
    seeds 0-15, tol 1e-4) through the batched cycle: each smoothing phase
    one lane-form launch for the batch, so its launches stay within 1.5×
    one field's (the lane the batch runs to, its slowest)."""
    pts, nrm = stacked(lambda s: sphere_inputs(s, device), range(B4))
    launches, one, rec = cycle_batch_path(
        ft, device, "config 4 x 16", SHAPE3, pts, nrm, ft.SolverConfig(tol=1e-4), B4_CHECK,
        B4_CHECK, ("sweep kernel", "apply kernel"))
    require(launches["fused_smooth_lanes"] == launches["fused_smooth"] > 0,
            "config 4 x 16: smoothing phases outside the lane form")
    require(launches["fused_smooth"] <= 1.5 * one["fused_smooth"],
            f"config 4 x 16: {launches['fused_smooth']} smoothing launches per batch, one "
            f"field {one['fused_smooth']}")
    return launches, rec


def phase_config3_jacobi(ft, device):
    """Phase 44: config 3's inputs at B = 4096, where the reference's memory
    rule (batch._dense_coarsest_ok) picks the Jacobi coarsest: the batched
    cycle (the 128² fine level through the multi-sweep lane form, the
    coarse levels and the coarsest's sweeps through the smoothing-phase
    lane form), beside 32 lanes through the single-field path."""
    pts, nrm = config3_inputs(device, B=B3_JACOBI)
    launches, one, rec = cycle_batch_path(
        ft, device, "config 3 x 4096", SHAPE3B, pts, nrm, ft.SolverConfig(tol=1e-4),
        B3_JACOBI_CHECK, range(B3_LANE_BY_LANE),
        ("multi-sweep kernel", "sweep kernel", "apply kernel"))
    require(rec["coarse_solver"] == "jacobi", "config 3 x 4096: not the Jacobi coarsest")
    require(launches["fused_smooth_2d_lanes"] == launches["fused_smooth_2d"] > 0
            and launches["fused_smooth_lanes"] == launches["fused_smooth"] > 0,
            "config 3 x 4096: smoothing phases outside the lane forms")
    torch.cuda.empty_cache()
    return launches, rec


def phase_fields_lanes(ft, device):
    """Phase 45: field A × 8 (496², 2000 points a lane, seeds 0-7): the
    whole W-cycle kernel's lane form, one launch per cycle for the batch;
    field C's grid × 4 (992², 4000 points, seeds 0-3; the batch API takes
    no fmg_start): the multi-sweep and smoothing-phase lane forms."""
    pts, nrm = stacked(lambda s: field_a_inputs(s, device), range(B_A))
    launches_a, _, rec_a = cycle_batch_path(
        ft, device, "field A x 8", SHAPE_A, pts, nrm, ft.SolverConfig(tol=1e-4), B_A_CHECK,
        B_A_CHECK, ("cycle kernel", "apply kernel"))
    require(launches_a["fused_wcycle_2d_lanes"] == launches_a["fused_wcycle_2d"] > 0,
            "field A x 8: cycles outside the whole-cycle kernel's lane form")
    pts, nrm = stacked(lambda s: field_a_inputs(s, device, SHAPE_C, N_POINTS_C), range(B_C))
    launches_c, _, rec_c = cycle_batch_path(
        ft, device, "field C x 4", SHAPE_C, pts, nrm, ft.SolverConfig(tol=1e-4), B_C_CHECK,
        B_C_CHECK, ("multi-sweep kernel", "sweep kernel", "apply kernel"))
    require(launches_c["fused_smooth_2d_lanes"] == launches_c["fused_smooth_2d"] > 0
            and launches_c["fused_smooth_lanes"] == launches_c["fused_smooth"] > 0,
            "field C x 4: smoothing phases outside the lane forms")
    torch.cuda.empty_cache()
    return (launches_a, rec_a), (launches_c, rec_c)


# ---- the contouring and tooling slice: phases 46-51 -------------------------
# The extractors on fields the main paths solve (config 4's 128³, config 5's
# 4096², config 3's 1024 lanes of 128², S2's and S4's sharded blocks), the
# debug pipeline on the headline and the observe tools. Crops: a 33³ box and
# a 256² window that the surface crosses (config 4's sphere of radius 40
# around 63.5; config 5's circle of radius 1433.6 around 2047.5).
CROP3 = (slice(48, 81), slice(48, 81), slice(88, 121))
CROP5 = (slice(1920, 2176), slice(3352, 3608))
CONTOUR_REPS = 5
CONTOUR_LANES = (0, 341, 682, 1023)
CONTOURS = []  # the `contour` line's records, filled by the phases


def extractor_ms(name, fn, shape, items):
    """Median of CONTOUR_REPS single calls of an extractor (CUDA events,
    after a warm-up) and their spread, (max − min) / median, as a record
    of the `contour` line."""
    fn()
    times = []
    for _ in range(CONTOUR_REPS):
        times.append(timed(fn)[1])
    med = statistics.median(times)
    rec = dict(name=name, shape=list(shape), ms=med, spread=(max(times) - min(times)) / med,
               items=int(items))
    print(f"  {name} {shape_str(shape)}: {med:.3f} ms a call (median of {CONTOUR_REPS}, "
          f"spread {rec['spread']:.3f}), {int(items)} items")
    CONTOURS.append(rec)
    return rec


def canonical_rows(rows):
    """[n, k, D] float64 items with each item's points in lexicographic
    order, as [n, k·D] rows."""
    rows = np.asarray(rows, np.float64)
    keys = np.lexsort(rows.transpose(2, 0, 1)[::-1], axis=-1)           # [n, k]
    return np.take_along_axis(rows, keys[..., None], axis=1).reshape(len(rows), -1)


def same_sets(label, got, want, tol):
    """The item sets ``got`` and ``want`` ([n, k, D]) are equal within
    ``tol`` (max norm), matched one to one by nearest neighbour (the
    float32 and float64 extractors place a vertex shared by two items a
    few ulps apart, so a sorted comparison could pair the wrong items)."""
    from scipy.spatial import cKDTree
    require(len(got) == len(want), f"{label}: {len(got)} items against {len(want)}")
    a, b = canonical_rows(got), canonical_rows(want)
    dist, idx = cKDTree(b).query(a, p=np.inf)
    worst = float(dist.max()) if len(a) else 0.0
    require(worst <= tol and len(np.unique(idx)) == len(idx),
            f"{label}: max distance {worst} (bar {tol}), {len(np.unique(idx))} of {len(idx)} "
            "matched")
    print(f"{label}: {len(got)} items, the same set within {worst:.2e} (bar {tol})")


def phase_contour3d(ft, device, x3):
    """Phase 46: config 4's 128³ field (phase 8, seed 0):
    `marching_tetrahedra_device_compact` with its defaults against
    `marching_tetrahedra_device` (24.6 M slots), the same count and the
    same rows in order (2e-6); `weld_triangles` + `write_obj` into a temp
    dir; the host `marching_tetrahedra` on a 33³ crop against the device
    extraction of the same crop, as sets within 1e-5."""
    import tempfile
    from field_interpolation_tpu_torch import contour as tc
    tris, count, ovf = tc.marching_tetrahedra_device_compact(x3)
    full, valid = tc.marching_tetrahedra_device(x3)
    want = full[valid]
    n = int(count)
    require(tris.is_cuda and not bool(ovf), f"config 4 contour: on {tris.device}, "
            f"overflowed {bool(ovf)}")
    require(n == want.shape[0] and n > 0, f"config 4 contour: compact {n}, full {want.shape[0]}")
    err = float((tris[:n] - want).abs().max())
    require(err <= 2e-6 and bool((tris[n:] == 0).all()),
            f"config 4 contour: compact rows {err} from the full form's")
    print(f"config 4 contour {shape_str(SHAPE3)}: compact {n} triangles (buffer "
          f"{tris.shape[0]}), the full form's {full.shape[0]} slots give the same rows in "
          f"order (max diff {err:.1e}, bitwise {torch.equal(tris[:n], want)})")
    del full, valid, want
    torch.cuda.empty_cache()
    extractor_ms("marching_tetrahedra_device_compact",
                 lambda: tc.marching_tetrahedra_device_compact(x3), SHAPE3, n)
    extractor_ms("marching_tetrahedra_device", lambda: tc.marching_tetrahedra_device(x3),
                 SHAPE3, n)
    torch.cuda.empty_cache()
    host_tris = tris[:n].cpu().numpy()
    (verts, faces), weld_ms = host_ms(lambda: tc.weld_triangles(host_tris))
    with tempfile.TemporaryDirectory() as tmp:
        (nv, nf), obj_ms = host_ms(lambda: tc.write_obj(f"{tmp}/config4.obj", host_tris))
    require((nv, nf) == (len(verts), n) and nv < 3 * n, f"config 4 OBJ: {nv} vertices, "
            f"{nf} faces of {n} triangles")
    print(f"config 4 mesh: {nv} welded vertices, {nf} faces; weld {weld_ms:.1f} ms, OBJ "
          f"{obj_ms:.1f} ms (host clock)")
    crop = x3[CROP3].contiguous()
    host, ms_h = host_ms(lambda: tc.marching_tetrahedra(crop))
    dev, dvalid = tc.marching_tetrahedra_device(crop)
    require(len(host) > 100, f"config 4 crop: {len(host)} triangles")
    same_sets(f"config 4 33³ crop, host (float64, {ms_h:.0f} ms host clock) against device",
              dev[dvalid].cpu().numpy(), host, 1e-5)
    CONTOURS.append(dict(name="marching_tetrahedra (host)", shape=[33, 33, 33], ms=ms_h,
                         spread=None, items=len(host), clock="host"))


def phase_contour5(ft, device, x5):
    """Phase 47: config 5's 4096² field (phase 12, seed 0):
    `marching_squares_device_compact` against `marching_squares_device`
    (33.5 M slots), as phase 46; `contour_polylines` on the compact rows
    (every segment in one polyline); the host `marching_squares` on a 256²
    crop against the device extraction of the crop, as sets within 1e-5."""
    from field_interpolation_tpu_torch import contour as tc
    segs, count, ovf = tc.marching_squares_device_compact(x5)
    full, valid = tc.marching_squares_device(x5)
    want = full[valid]
    n = int(count)
    require(segs.is_cuda and not bool(ovf), f"config 5 contour: overflowed {bool(ovf)}")
    require(n == want.shape[0] and n > 0, f"config 5 contour: compact {n}, full {want.shape[0]}")
    err = float((segs[:n] - want).abs().max())
    require(err <= 2e-6 and bool((segs[n:] == 0).all()),
            f"config 5 contour: compact rows {err} from the full form's")
    print(f"config 5 contour {shape_str(SHAPE5)}: compact {n} segments (buffer "
          f"{segs.shape[0]}), the full form's {full.shape[0]} slots give the same rows in "
          f"order (max diff {err:.1e}, bitwise {torch.equal(segs[:n], want)})")
    del full, valid, want
    torch.cuda.empty_cache()
    extractor_ms("marching_squares_device_compact",
                 lambda: tc.marching_squares_device_compact(x5), SHAPE5, n)
    extractor_ms("marching_squares_device", lambda: tc.marching_squares_device(x5), SHAPE5, n)
    torch.cuda.empty_cache()
    lines, ms_l = host_ms(lambda: tc.contour_polylines(segs[:n]))
    used = sum(len(line) - 1 for line in lines)
    closed = sum(bool(np.allclose(line[0], line[-1])) for line in lines)
    require(used == n, f"config 5 polylines hold {used} of {n} segments")
    print(f"config 5 polylines: {len(lines)} ({closed} closed), longest "
          f"{max(len(line) for line in lines)} points; {ms_l:.1f} ms (host clock)")
    crop = x5[CROP5].contiguous()
    host, ms_h = host_ms(lambda: tc.marching_squares(crop))
    dev, dvalid = tc.marching_squares_device(crop)
    require(len(host) > 100, f"config 5 crop: {len(host)} segments")
    same_sets(f"config 5 256² crop, host (float64, {ms_h:.0f} ms host clock) against device",
              dev[dvalid].cpu().numpy(), host, 1e-5)
    CONTOURS.append(dict(name="marching_squares (host)", shape=[256, 256], ms=ms_h,
                         spread=None, items=len(host), clock="host"))


def phase_contour_lanes(ft, device, x3b):
    """Phase 48: config 3's 1024 fields of 128² (phase 39) through
    `marching_squares_device_compact` in one call; lanes CONTOUR_LANES
    against one-lane calls (bit for bit)."""
    from field_interpolation_tpu_torch import contour as tc
    segs, count, ovf = tc.marching_squares_device_compact(x3b)
    require(tuple(segs.shape[:1]) == (x3b.shape[0],) and not bool(ovf.any()),
            f"config 3 contour: {tuple(segs.shape)}, {int(ovf.sum())} lanes overflowed")
    require(bool((count > 0).all()), "config 3 contour: a lane without segments")
    for i in CONTOUR_LANES:
        one = tc.marching_squares_device_compact(x3b[i])
        require(torch.equal(segs[i], one[0]) and int(count[i]) == int(one[1])
                and bool(ovf[i]) == bool(one[2]),
                f"config 3 contour: lane {i} is not its one-lane call's")
    print(f"config 3 contour: {x3b.shape[0]} lanes of {shape_str(tuple(x3b.shape[1:]))} in one "
          f"call, {int(count.sum())} segments (min {int(count.min())}, max "
          f"{int(count.max())} a lane); lanes {list(CONTOUR_LANES)} their one-lane calls' bits")
    extractor_ms(f"marching_squares_device_compact x{x3b.shape[0]}",
                 lambda: tc.marching_squares_device_compact(x3b), tuple(x3b.shape),
                 int(count.sum()))
    extractor_ms("marching_squares_device_compact x1",
                 lambda: tc.marching_squares_device_compact(x3b[0]), tuple(x3b.shape[1:]),
                 int(count[0]))


def check_sharded_contour(label, parts, x, extract):
    """Phase 49 (in the ranks of phases 28-30): the union of the ranks' live
    rows equals the device extraction of the stitched field (rows sorted,
    3e-5, the reference's bar); the tiny cap overflows on every rank."""
    runs = [p["runs"][0] for p in parts]
    require(not any(r["overflowed"] for r in runs) and all(r["zeros_past_count"] for r in runs),
            f"{label}: overflowed or nonzero rows past count")
    got = torch.cat([r["items"] for r in runs]).numpy()
    items, count, ovf = extract(x)
    want = items[:int(count)].cpu().numpy()
    require(not bool(ovf) and len(got) == len(want),
            f"{label}: {len(got)} rows over the ranks, {len(want)} unsharded")
    a, b = (r.reshape(len(r), -1) for r in (got, want))
    a, b = a[np.lexsort(a.T[::-1])], b[np.lexsort(b.T[::-1])]
    err = float(np.abs(a - b).max()) if len(a) else 0.0
    require(err <= 3e-5, f"{label}: union {err} from the unsharded extraction")
    require(all(p["runs"][1]["overflowed"] for p in parts), f"{label}: tiny cap not reported")
    slowest = max(r["ms"] for r in runs)
    print(f"{label} ({SHARDED}): {len(got)} items over the ranks {[r['count'] for r in runs]}, "
          f"the stitched field's device extraction (max diff {err:.1e}); a cap of 2 "
          f"overflows on every rank; {slowest:.1f} ms, slowest rank")
    CONTOURS.append(dict(name=label, shape=list(x.shape), ms=slowest, spread=None,
                         items=len(got), clock="CUDA events on each rank after a barrier"))


def phase_debug(ft, device):
    """Phase 50: debug mode on the headline (256², seed 0, tol 1e-4):
    `sdf_from_points(..., SolverConfig(debug=True))` converged within ±2
    iterations and 2e-3·max|x| of the `backend="xla"` solve, no port kernel
    launched; a NaN position raises the reference's message."""
    grid, w = ft.Grid(SHAPE), ft.Weights(model_2=0.3)
    pts, nrm = headline_inputs(0, device)
    cfg = ft.SolverConfig(tol=1e-4, debug=True)
    xr, ir = ft.sdf_from_points(grid, w, pts, nrm, config=ft.SolverConfig(tol=1e-4,
                                                                          backend="xla"))
    read = counters_zero()
    (x, info), ms = timed(lambda: ft.sdf_from_points(grid, w, pts, nrm, config=cfg))
    launches = read()
    it, itr = int(info.iterations), int(ir.iterations)
    err, scale = float((x - xr).abs().max()), float(xr.abs().max())
    print(f"debug headline: iterations {it} (xla {itr}), max|x-x_xla| {err:.3e} (bar "
          f"{2e-3 * scale:.3e}), {ms:.3f} ms, kernel launches {sum(launches.values())}")
    require(x.is_cuda and bool(info.converged) and bool(ir.converged),
            "debug headline: not converged on the card")
    require(abs(it - itr) <= 2 and err <= 2e-3 * scale,
            f"debug headline: iterations {it} vs {itr}, error {err}")
    require(not any(launches.values()), f"debug headline launched kernels: {launches}")
    bad = pts.clone()
    bad[3, 0] = float("nan")
    try:
        ft.sdf_from_points(grid, w, bad, nrm, config=cfg)
    except ValueError as e:
        require("debug: non-finite sample position" in str(e), f"debug NaN: {e}")
        print(f"debug NaN position raises: {e}")
    else:
        require(False, "debug mode accepted a NaN position")
    return dict(ms=ms, iterations=it)


def phase_observe(ft, device, p5, field3):
    """Phase 51: a `record_solve` JSON line for config 4's solve (phase 8,
    seed 0, its CUDA-event ms), and `measure_marginal` of the 4096² apply
    (each step the apply kernel on config 5's problem and one x: a chain x →
    A x would leave float32's range within ~30 steps)."""
    import io
    from field_interpolation_tpu_torch.ops.stencil import fused_normal_apply
    from field_interpolation_tpu_torch.utils import (measure_marginal, record_solve,
                                                      vcycle_applies_per_iteration)
    _, x3, info3, ms3 = field3
    buf = io.StringIO()
    rec = record_solve(ft.Grid(SHAPE3), info3, ms3, preconditioner="multigrid",
                       applies_per_iteration=vcycle_applies_per_iteration(3, 3), stream=buf,
                       config="config 4", card=card_line())
    print("record_solve:", buf.getvalue().strip())
    require(rec.converged and rec.achieved_gbps and rec.achieved_gbps > 0,
            f"record_solve: {rec}")
    x = torch.randn(SHAPE5, generator=torch.Generator(device=device).manual_seed(51),
                    device=device)
    per, details = measure_marginal(lambda c: fused_normal_apply(x, p5.coeff, p5.weights, 2),
                                    x, counts=(32, 160))
    print(f"measure_marginal, the 4096² apply: {1e3 * per:.4f} ms a step (chains of "
          f"{details['counts']}: {', '.join(f'{1e3 * t:.2f}' for t in details['times_s'].values())}"
          " ms, host clock after synchronize)")
    require(per > 0 and bool(torch.isfinite(details["final_carry"]).all()),
            f"measure_marginal: {per}")
    return dict(record=json.loads(buf.getvalue()), marginal_apply_ms=1e3 * per)


# The reference's row-level API (phases 52-53): the headline's system in
# explicit rows and BASELINE config 4's (128³, 4000 sphere points).
ROWS_TOL3 = 1e-4


def explicit_counts(shape, weights, pts):
    """Rows and stored entries of `explicit.assemble_explicit` (values and
    gradients, nonzero data weights) in closed form: per active order k and
    axis of n ≥ k + 1 nodes, (N/n)·(n − k) rows of k + 1 entries (order 0:
    N rows of one); per sample inside the grid one value row of Π_d c_d
    entries and D gradient rows of 2·Π_{d≠a} c_d, c_d = 1 where the sample
    lies on a node plane across axis d (a corner weight is 0), else 2."""
    p = pts.double().cpu().numpy()
    top = np.asarray(shape, np.float64) - 1.0
    p = p[np.all((p >= 0.0) & (p <= top), axis=1)]
    frac = p - np.clip(np.floor(p), 0.0, top - 1.0)
    c = np.where((frac == 0.0) | (frac == 1.0), 1, 2)
    n_nodes = math.prod(shape)
    rows = nnz = 0
    for k in weights.active_orders():
        if k == 0:
            rows, nnz = rows + n_nodes, nnz + n_nodes
            continue
        for n in shape:
            if n >= k + 1:
                r = n_nodes // n * (n - k)
                rows, nnz = rows + r, nnz + r * (k + 1)
    D = len(shape)
    rows += len(p) * (1 + D)
    nnz += int(c.prod(1).sum()) + sum(int(2 * np.delete(c, a, 1).prod(1).sum())
                                      for a in range(D))
    return rows, nnz


def rel_residual(ata, atb, x):
    """‖Aᵀb − AᵀA x‖ / ‖Aᵀb‖ in float64 with the explicit matrix."""
    x = x.reshape(-1).double()
    return float(torch.linalg.norm(atb - ata @ x) / torch.linalg.norm(atb))


def check_ata(label, ata, atb, pp, device, seed):
    """AᵀA·x of the explicit rows against the port's matrix-free float64
    operator (`PreciseProblem.apply64_delta`: the f64 rows of
    `sdf.assemble_precise` and the smoothness stencils) on a standard-normal
    x, and Aᵀb against its b64, each within 1e-10·max."""
    x = torch.randn(pp.grid.shape, dtype=torch.float64, device=device,
                    generator=torch.Generator(device=device).manual_seed(seed))
    want = pp.apply64_delta(x).reshape(-1)
    err = float((ata @ x.reshape(-1) - want).abs().max())
    scale = float(want.abs().max())
    err_b = float((atb - pp.b64.reshape(-1)).abs().max())
    scale_b = float(pp.b64.abs().max())
    print(f"{label}: max|AᵀA·x - operator| {err:.3e} (bar {1e-10 * scale:.3e}), "
          f"max|Aᵀb - b64| {err_b:.3e} (bar {1e-10 * scale_b:.3e}), AᵀA stores "
          f"{ata.values().numel()} entries")
    require(err <= 1e-10 * scale, f"{label}: AᵀA·x {err} > 1e-10·{scale}")
    require(err_b <= 1e-10 * scale_b, f"{label}: Aᵀb {err_b} > 1e-10·{scale_b}")
    return max(err / scale, err_b / scale_b)


def phase_explicit(ft, device):
    """Phase 52: `explicit` at the headline (256², 1000 circle points,
    Weights(model_2=0.3), seed 0): the host ms to assemble the rows, the
    row and entry counts against `explicit_counts`; AᵀA and Aᵀb against
    the port's float64 operator; `solve_sparse_linear` (a dense float64 LU
    on the card) to a true relative residual ≤ 1e-10; the residual of
    `sdf_from_points_precise`'s field (tol 1e-6) measured with the explicit
    AᵀA within 2% of the one the port reports; `_with_guess` from that
    field, its iterations and ms."""
    from field_interpolation_tpu_torch import explicit, rows
    grid, w = ft.Grid(SHAPE), ft.Weights(model_2=0.3)
    n = grid.num_nodes
    pts, nrm = headline_inputs(0, device)
    zeros = torch.zeros(len(pts), device=device)
    explicit.assemble_explicit(grid, w, pts, zeros, nrm)          # warm-up
    eq, asm_ms = host_ms(lambda: explicit.assemble_explicit(grid, w, pts, zeros, nrm))
    want = explicit_counts(SHAPE, w, pts)
    got = (eq.num_rows, eq.export_rows()[0].numel())
    print(f"explicit headline: {got[0]} rows, {got[1]} entries (closed form {want}), "
          f"assembled in {asm_ms:.3f} ms")
    require(got == want, f"explicit rows/entries {got} vs closed form {want}")
    explicit.normal_equations(eq, n)                             # warm-up
    (ata, atb), ne_ms = host_ms(lambda: explicit.normal_equations(eq, n))
    print(f"normal equations: {ne_ms:.3f} ms")
    pp = ft.assemble_precise(grid, w, pts, zeros, gradients=nrm)
    ata_err = check_ata("explicit headline", ata, atb, pp, device, 52)

    # Why the direct solve is a dense LU: PyTorch's sparse direct solve on
    # this card (a record of the build, not a route of the library).
    small = torch.eye(4, dtype=torch.float64, device=device)
    try:
        with rows.quiet_sparse():
            torch.sparse.spsolve(small.to_sparse_csr(), small[0])
        spsolve = "runs"
    except RuntimeError as e:
        spsolve = f"raises RuntimeError: {e}"[:160]
    print(f"torch.sparse.spsolve on a CUDA tensor: {spsolve}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    x_d, direct_ms = host_ms(lambda: explicit.solve_sparse_linear(n, eq))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    direct_rel = rel_residual(ata, atb, x_d)
    print(f"solve_sparse_linear (dense float64 LU, torch.linalg.solve, {n} unknowns): "
          f"{direct_ms:.1f} ms, true rel {direct_rel:.3e}, peak {peak_gb:.1f} GB")
    require(bool(torch.isfinite(x_d).all()) and direct_rel <= 1e-10,
            f"direct solve: true rel {direct_rel} > 1e-10")
    del x_d
    torch.cuda.empty_cache()

    (x_p, info), precise_ms = host_ms(lambda: ft.sdf_from_points_precise(
        grid, w, pts, nrm, config=ft.SolverConfig(tol=TOL)))
    rel_e, rep = rel_residual(ata, atb, x_p), float(info.rel_residual)
    true = check_precise("explicit headline precise", ft, grid, w, pts, nrm, x_p, info, device)
    print(f"sdf_from_points_precise: {int(info.iterations)} iterations, {precise_ms:.1f} ms; "
          f"rel residual with the explicit AᵀA {rel_e:.6e}, reported {rep:.6e}, the "
          f"operator's true {true:.6e}")
    require(abs(rel_e - rep) <= 0.02 * rel_e,
            f"precise field: explicit residual {rel_e} vs reported {rep}")

    guess = x_p.double().reshape(-1)
    x_g, guess_ms = host_ms(lambda: explicit.solve_sparse_linear_with_guess(n, eq, guess))
    x_c, it_g, status = rows.conjugate_gradient(ata, atb, guess, tol=1e-10, maxiter=10000,
                                                jacobi=False)
    rel_g = rel_residual(ata, atb, x_g)
    print(f"solve_sparse_linear_with_guess from the precise field (tol 1e-10, maxiter "
          f"10000, no preconditioner): {it_g} iterations ({status}), {guess_ms:.1f} ms "
          f"({1e3 * guess_ms / max(it_g, 1):.1f} us/iteration), true rel {rel_g:.3e}")
    require(torch.equal(x_c, x_g) and bool(torch.isfinite(x_g).all()),
            "with_guess: not the shared CG's x, or not finite")
    require(status == "maxiter" or rel_g <= 2e-10,
            f"with_guess: converged by its own residual, true rel {rel_g}")
    return dict(rows=got[0], entries=got[1], assemble_ms=asm_ms, normal_equations_ms=ne_ms,
                ata_rel_err=ata_err, direct_route="dense float64 LU (torch.linalg.solve)",
                sparse_spsolve_on_card=spsolve,
                direct_ms=direct_ms, direct_true_rel=direct_rel, direct_peak_gb=peak_gb,
                precise_iterations=int(info.iterations), precise_rel_explicit=rel_e,
                precise_rel_reported=rep, with_guess_iterations=it_g,
                with_guess_status=status, with_guess_ms=guess_ms, with_guess_true_rel=rel_g)


def phase_native(ft, device):
    """Phase 53: `native` on the port's engine. `sdf_from_points_native` at
    the headline (seed 0, tol 1e-10): iterations, ms, true residual with the
    explicit AᵀA; `solve_approximate_lattice_native` (tol 1e-12) against
    `explicit`'s approximate lattice (a direct solve) within 1e-8·max; at
    BASELINE config 4's 128³ (4000 sphere points, seed 0) the ms to build
    and export the rows, AᵀA·x against the operator at 1e-10·max and
    `solve(tol=1e-4)` with its iterations and true residual."""
    from field_interpolation_tpu_torch import explicit, native, rows
    grid, w = ft.Grid(SHAPE), ft.Weights(model_2=0.3)
    pts, nrm = headline_inputs(0, device)
    zeros = torch.zeros(len(pts), device=device)
    native.sdf_from_points_native(ft.Grid((32, 32)), w, pts / 8, nrm)   # warm-up
    (x, it), sdf_ms = host_ms(lambda: native.sdf_from_points_native(grid, w, pts, nrm))
    ata, atb = explicit.normal_equations(explicit.assemble_explicit(grid, w, pts, zeros, nrm),
                                         grid.num_nodes)
    sdf_rel = rel_residual(ata, atb, x)
    print(f"sdf_from_points_native headline (Jacobi-PCG, tol 1e-10): {it} iterations, "
          f"{sdf_ms:.1f} ms ({1e3 * sdf_ms / it:.1f} us/iteration), true rel {sdf_rel:.3e}")
    require(tuple(x.shape) == SHAPE and bool(torch.isfinite(x).all()),
            "sdf_from_points_native: field not finite or wrong shape")
    require(sdf_rel <= 1.01e-10, f"sdf_from_points_native: true rel {sdf_rel} > 1e-10")
    del ata, atb

    (xa, it_a), approx_ms = host_ms(lambda: native.solve_approximate_lattice_native(
        grid, w, pts, zeros, nrm, tol=1e-12))
    xe, approx_e_ms = host_ms(lambda: explicit.solve_sparse_linear_approximate_lattice(
        grid, w, pts, zeros, nrm))
    err_a = float((xa.reshape(-1) - xe).abs().max())
    scale_a = float(xe.abs().max())
    print(f"approximate lattice (downscale 2, 128² coarse): native {it_a} iterations "
          f"{approx_ms:.1f} ms, explicit (dense LU) {approx_e_ms:.1f} ms, "
          f"max|native - explicit| {err_a:.3e} (bar {1e-8 * scale_a:.3e})")
    require(err_a <= 1e-8 * scale_a, f"approximate lattice: {err_a} > 1e-8·{scale_a}")
    torch.cuda.empty_cache()

    grid3, w3 = ft.Grid(SHAPE3), ft.Weights(model_2=0.3)
    p3, n3 = sphere_inputs(0, device)
    ones = torch.ones(len(p3), device=device)

    def build():
        eq = native.NativeEquation(grid3, device=device)
        eq.add_field_constraints(w3)
        eq.add_value_constraints(p3, torch.zeros_like(ones), w3.data_pos * ones)
        eq.add_gradient_constraints(p3, n3, w3.data_gradient * ones)
        return eq, eq.export_rows()

    build()                                                     # warm-up
    (eq3, exported), build_ms = host_ms(build)
    want = explicit_counts(SHAPE3, w3, p3)
    got = (eq3.num_rows, exported[0].numel())
    print(f"native config 4: {got[0]} rows, {got[1]} entries (closed form {want}), built "
          f"and exported in {build_ms:.1f} ms")
    require(got == want, f"native config 4 rows/entries {got} vs closed form {want}")
    (ata3, atb3), ne3_ms = host_ms(lambda: rows.normal_equations(rows.Rows(*exported),
                                                                 grid3.num_nodes))
    pp3 = ft.assemble_precise(grid3, w3, p3, torch.zeros_like(ones), gradients=n3)
    ata3_err = check_ata("native config 4", ata3, atb3, pp3, device, 53)
    del pp3, exported
    (x3, it3), solve3_ms = host_ms(lambda: eq3.solve(tol=ROWS_TOL3))
    rel3 = rel_residual(ata3, atb3, x3)
    print(f"NativeEquation.solve config 4 (tol {ROWS_TOL3}): {it3} iterations, "
          f"{solve3_ms:.1f} ms (normal equations {ne3_ms:.1f} ms of it by themselves), "
          f"true rel {rel3:.3e}")
    require(tuple(x3.shape) == SHAPE3 and bool(torch.isfinite(x3).all()),
            "native config 4: field not finite or wrong shape")
    require(rel3 <= 1.01 * ROWS_TOL3, f"native config 4: true rel {rel3} > {ROWS_TOL3}")
    del eq3, ata3, atb3, x3
    torch.cuda.empty_cache()
    return dict(sdf_iterations=it, sdf_ms=sdf_ms, sdf_true_rel=sdf_rel,
                approx_iterations=it_a, approx_ms=approx_ms, approx_explicit_ms=approx_e_ms,
                approx_max_abs_err=err_a, config4_rows=got[0], config4_entries=got[1],
                config4_build_export_ms=build_ms, config4_normal_equations_ms=ne3_ms,
                config4_ata_rel_err=ata3_err, config4_iterations=it3,
                config4_solve_ms=solve3_ms, config4_true_rel=rel3)


def run_phase(fn, *args, **kwargs):
    """fn(*args, **kwargs), then its wall time on a line of its own."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    print(f"[{fn.__name__}: {time.perf_counter() - t0:.1f} s]")
    return out


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
        if any(key in line for key in ("Used", "Compiling entry", "stack frame")):
            print("  ptxas:", line.strip())

    problem, ops, apply_rec = run_phase(phase_apply, ft, device)
    seg_rec, _ = run_phase(phase_segment, problem, ops, device)
    launches, v_ms, v_iters = run_phase(phase_main, ft, device)
    p128, p32, lvl1, apply3_rec = run_phase(phase_apply3d, ft, device)
    sweep_rec = run_phase(phase_sweep3d, ft, device, p128, p32, lvl1)
    del p128, p32, lvl1
    launches3, iters3, field3 = run_phase(phase_main3d, ft, device)
    run_phase(phase_contour3d, ft, device, field3[1])
    run_phase(phase_profile3d, ft, device)
    p5, multi_recs, apply5_rec = run_phase(phase_smooth2d, ft, device)
    sweep5_rec = run_phase(phase_sweep2d, ft, device, p5)
    observe = run_phase(phase_observe, ft, device, p5, field3)
    del p5, field3
    launches5, x5 = run_phase(phase_main5, ft, device)
    run_phase(phase_contour5, ft, device, x5)
    del x5
    run_phase(phase_profile5, ft, device)
    cycle_rec = run_phase(phase_cycle, ft, device)
    seg_w_rec, _ = run_phase(phase_segment, problem, ops, device, wdepth=99)
    launches_a, apply_a_rec = run_phase(phase_field_a, ft, device)
    run_phase(phase_field_b, ft, device, v_ms, v_iters)
    launches_c, recs_c = run_phase(phase_field_c, ft, device)
    # The Chebyshev / Galerkin slice: each kernel's Chebyshev mode against
    # its plain version, then its five paths.
    from field_interpolation_tpu_torch.multigrid import build_fused_solver_operands
    recs_cs = run_phase(phase_cheb_sweep, ft, device)
    recs_c5 = run_phase(phase_cheb5, ft, device)
    cycle_cheb_rec = run_phase(phase_cycle, ft, device, SHAPE_A2, CHEB)
    seg_recs = {name: phase_segment(problem, build_fused_solver_operands(
        problem, ft.SolverConfig(tol=TOL, **change)), device, label=f" {name}")[0]
        for name, change in [("H-cheb", CHEB), ("H-gal", {**CHEB, **GALERKIN})]}
    launches_h = run_phase(phase_h_cheb, ft, device, v_ms, v_iters)
    launches_a2, apply_a2_rec = run_phase(phase_field_a2, ft, device)
    launches_4cg = run_phase(phase_main4cg, ft, device, iters3)
    launches_5c = run_phase(phase_main5cheb, ft, device)
    # The sharded slice: the two ext kernels block by block, then four ranks.
    ext_recs = run_phase(phase_ext, ft, device)
    sharded = run_phase(phase_sharded, ft, device)
    # The public-API slice: its paths, each with the counts set to 0 just
    # before it and read just after.
    launches_1, apply1_rec, _ = run_phase(phase_config1, ft, device)
    launches_ip, _ = run_phase(phase_interp_precise, ft, device)
    launches_il, _, recs_il = run_phase(phase_interp_large, ft, device)
    launches_s, _, _ = run_phase(phase_session, ft, device)
    launches_p4, _ = run_phase(phase_prepare4, ft, device)
    launches_imp, _, cycle_imp_rec = run_phase(phase_implicit, ft, device)
    apply_prof = run_phase(phase_apply_profile, ft, device)
    # The batch slice: the batched kernels, then config 3 and its 1e-6 form,
    # each with the counts set to 0 just before it and read just after.
    batch_recs = run_phase(phase_batch_kernels, ft, device)
    launches_b3, config3, x3b = run_phase(phase_config3, ft, device)
    run_phase(phase_contour_lanes, ft, device, x3b)
    del x3b
    launches_b3p, config3p = run_phase(phase_config3_precise, ft, device)
    lanes3 = run_phase(phase_batch_lanes, ft, device)
    # The batched-cycle slice: the three lane forms, then the cycle route's
    # batches, each with the counts set to 0 just before it and read after.
    lane_recs = run_phase(phase_lane_kernels, ft, device)
    launches_b4, config4b = run_phase(phase_config4_batch, ft, device)
    launches_b3j, config3j = run_phase(phase_config3_jacobi, ft, device)
    (launches_ba, field_ab), (launches_bc, field_cb) = run_phase(phase_fields_lanes, ft, device)
    # The contouring and tooling slice (phases 46-48 ran beside the fields
    # they contour, 49 in the sharded ranks, 51 after phase 11).
    debug = run_phase(phase_debug, ft, device)
    # The reference's row-level API on the card: no kernel of this repo
    # runs on it (plain torch ops, cuBLAS/cuSOLVER/cuSPARSE).
    explicit_rec = run_phase(phase_explicit, ft, device)
    native_rec = run_phase(phase_native, ft, device)

    src = "field_interpolation_tpu_torch/csrc/"
    ref = "field_interpolation_tpu/ops/pallas_stencil.py:"

    def ext_launches(key, runs=("S2", "S4")):
        return sum(rank[key] for k in runs for rank in sharded["launches"][k])

    def mode_recs(mode):
        """The slab form's records of ``mode`` at every block S1 holds."""
        return ([ext_recs[sh]["modes"][mode] for sh in ((2, 2), (1, 8))]
                + [ext_recs["ext3d"]["modes"][mode], ext_recs["diag3d_fine"]["modes"][mode]]
                + [rec["modes"][mode] for rec in ext_recs["diag2d"] + ext_recs["diag3d"]])

    kernels = [
        dict(name="fused_normal_apply", route="cuda", source=src + "normal_apply.cu",
             replaces=ref + "170", launches=launches["fused_normal_apply"], **apply_rec,
             device_profile=apply_prof),
        dict(name="fused_pcg_solve", route="cuda", source=src + "pcg_segment.cu",
             replaces=ref + "1484", launches=launches["fused_pcg_solve"], **seg_rec,
             wcycle=seg_w_rec),
        dict(name="fused_normal_apply_3d", route="cuda", source=src + "normal_apply.cu",
             replaces=ref + "170,300,1662",
             launches=launches3["fused_normal_apply"], **apply3_rec),
        dict(name="jacobi_sweep", route="cuda", source=src + "jacobi_sweep.cu",
             replaces=ref + "513,1813",
             launches=launches3["fused_smooth"], **sweep_rec),
        dict(name="fused_normal_apply_2d_large", route="cuda",
             source=src + "normal_apply.cu", replaces=ref + "300",
             launches=launches5["fused_normal_apply"], **apply5_rec),
        dict(name="jacobi_sweep_2d_diag", route="cuda", source=src + "jacobi_sweep.cu",
             replaces=ref + "513,1959",
             launches=launches5["fused_smooth"], **sweep5_rec),
        dict(name="jacobi_multisweep_2d", route="cuda",
             source=src + "jacobi_multisweep2d.cu", replaces=ref + "653,876",
             launches=launches5["fused_smooth_2d"],
             **{**multi_recs["4096_from_zero_residual"],
                "max_abs_err": max(r["max_abs_err"] for r in multi_recs.values())},
             forms={k: v for k, v in multi_recs.items() if k != "4096_from_zero_residual"}),
        dict(name="mg_cycle2d", route="cuda", source=src + "mg_cycle2d.cu",
             replaces=ref + "1052,1114,1192",
             launches=launches_a["fused_wcycle_2d"] + launches_a["fused_vcycle_2d"],
             field_c_launches=launches_c["fused_wcycle_2d"], **cycle_rec),
        dict(name="fused_normal_apply_2d_field_a", route="cuda",
             source=src + "normal_apply.cu", replaces=ref + "300",
             launches=launches_a["fused_normal_apply"], **apply_a_rec),
        dict(name="fused_normal_apply_2d_field_c", route="cuda",
             source=src + "normal_apply.cu", replaces=ref + "300",
             launches=launches_c["fused_normal_apply"], **recs_c["apply"]),
        dict(name="jacobi_multisweep_2d_field_c", route="cuda",
             source=src + "jacobi_multisweep2d.cu", replaces=ref + "653",
             launches=launches_c["fused_smooth_2d"],
             **{**recs_c["multi"], "max_abs_err": max(recs_c["multi"]["max_abs_err"],
                                                      recs_c["multi_from_z"]["max_abs_err"])},
             from_z=recs_c["multi_from_z"]),
        dict(name="jacobi_sweep_2d_field_c", route="cuda", source=src + "jacobi_sweep.cu",
             replaces=ref + "513", launches=launches_c["fused_smooth"], **recs_c["sweep"]),
        # Chebyshev modes; launches in that mode on their path.
        dict(name="jacobi_sweep_cheb", route="cuda", source=src + "jacobi_sweep.cu",
             replaces=ref + "537,1813", launches=launches_4cg["fused_smooth_cheb"],
             **recs_cs["diag"], lumped_fine=recs_cs["fine"], galerkin=recs_cs["galerkin"]),
        dict(name="jacobi_sweep_cheb_2d_diag", route="cuda", source=src + "jacobi_sweep.cu",
             replaces=ref + "537,1959", launches=launches_5c["fused_smooth_cheb"],
             **recs_c5["diag"]),
        dict(name="jacobi_multisweep_2d_cheb", route="cuda",
             source=src + "jacobi_multisweep2d.cu", replaces=ref + "653,876",
             launches=launches_5c["fused_smooth_2d_cheb"],
             **{**recs_c5["multi"], "max_abs_err": max(
                 recs_c5[k]["max_abs_err"] for k in ("multi", "multi_from_z", "multi_split",
                                                      "multi_split_residual"))},
             from_z=recs_c5["multi_from_z"], split=recs_c5["multi_split"],
             split_residual=recs_c5["multi_split_residual"]),
        dict(name="mg_cycle2d_cheb", route="cuda", source=src + "mg_cycle2d.cu",
             replaces=ref + "1052,1114,1192",
             launches=launches_a2["fused_wcycle_2d_cheb"], **cycle_cheb_rec),
        dict(name="fused_pcg_solve_cheb", route="cuda", source=src + "pcg_segment.cu",
             replaces=ref + "1484", launches=launches_h["H-cheb"]["fused_pcg_solve_cheb"],
             **seg_recs["H-cheb"]),
        dict(name="fused_pcg_solve_cheb_galerkin", route="cuda",
             source=src + "pcg_segment.cu", replaces=ref + "1484",
             launches=launches_h["H-gal"]["fused_pcg_solve_cheb"], **seg_recs["H-gal"]),
        dict(name="fused_normal_apply_2d_field_a2", route="cuda",
             source=src + "normal_apply.cu", replaces=ref + "300",
             launches=launches_a2["fused_normal_apply"], **apply_a2_rec),
        # The sharded slice: launches summed over the ranks of S2 and S4
        # (the whole and diagonal forms) and of S2 (the striped form), per
        # mode: the apply (CG's), the residual the cycle restricts and the
        # Jacobi sweep (the Chebyshev step, on no S2-S4 path, beside it).
        dict(name="fused_normal_apply_ext", route="cuda", source=src + "normal_apply_ext.cu",
             replaces=ref + "378,462", launches=ext_launches("fused_normal_apply_ext.apply"),
             **{**ext_recs["ext3d"], "max_abs_err": max(
                 rec["max_abs_err"] for rec in [ext_recs["ext3d"], ext_recs["diag3d_fine"]]
                 + ext_recs["diag2d"] + ext_recs["diag3d"] + mode_recs("apply"))},
             diag_2d_levels=ext_recs["diag2d"], diag_3d_fine=ext_recs["diag3d_fine"],
             diag_3d_levels=ext_recs["diag3d"]),
        *[dict(name=f"fused_normal_apply_ext_{mode}", route="cuda",
               source=src + "normal_apply_ext.cu", replaces=ref + "378,462",
               launches=ext_launches(f"fused_normal_apply_ext.{mode}"),
               **{**ext_recs["diag2d"][0]["modes"][mode], "max_abs_err": max(
                   rec["max_abs_err"] for rec in mode_recs(mode))},
               diag_2d_levels=[rec["modes"][mode] for rec in ext_recs["diag2d"]],
               diag_3d_fine=ext_recs["diag3d_fine"]["modes"][mode],
               diag_3d_levels=[rec["modes"][mode] for rec in ext_recs["diag3d"]],
               whole_27_channels=ext_recs["ext3d"]["modes"][mode],
               **({"chebyshev": ext_recs["diag2d"][0]["modes"]["chebyshev"],
                   "chebyshev_max_abs_err": max(rec["max_abs_err"]
                                                for rec in mode_recs("chebyshev"))}
                  if mode == "jacobi" else {}))
          for mode in ("residual", "jacobi")],
        dict(name="fused_normal_apply_ext_striped", route="cuda",
             source=src + "normal_apply_ext.cu", replaces=ref + "1282,1387",
             launches=ext_launches("fused_normal_apply_ext_striped.apply", ("S2",)),
             **ext_recs[(2, 2)], blocks_4096x512=ext_recs[(1, 8)]),
        *[dict(name=f"fused_normal_apply_ext_striped_{mode}", route="cuda",
               source=src + "normal_apply_ext.cu", replaces=ref + "1282,1387",
               launches=ext_launches(f"fused_normal_apply_ext_striped.{mode}", ("S2",)),
               **ext_recs[(2, 2)]["modes"][mode],
               blocks_4096x512=ext_recs[(1, 8)]["modes"][mode])
          for mode in ("residual", "jacobi")],
        # The public-API slice: the kernels on its paths' own inputs, or at
        # the shapes they give them (the session: the headline's operands,
        # phase 4's record; config 4 prepared: phases 6-7's).
        dict(name="fused_normal_apply_config1", route="cuda", source=src + "normal_apply.cu",
             replaces=ref + "170", launches=launches_1["fused_normal_apply"], **apply1_rec),
        dict(name="fused_normal_apply_interpolate_1024", route="cuda",
             source=src + "normal_apply.cu", replaces=ref + "300",
             launches=launches_il["fused_normal_apply"], **recs_il["apply"]),
        dict(name="jacobi_multisweep_2d_interpolate_1024", route="cuda",
             source=src + "jacobi_multisweep2d.cu", replaces=ref + "653",
             launches=launches_il["fused_smooth_2d"], **recs_il["multi"]),
        dict(name="jacobi_sweep_2d_interpolate_1024", route="cuda",
             source=src + "jacobi_sweep.cu", replaces=ref + "513,1959",
             launches=launches_il["fused_smooth"], **recs_il["sweep"]),
        dict(name="fused_pcg_solve_session", route="cuda", source=src + "pcg_segment.cu",
             replaces=ref + "1484", launches=launches_s["fused_pcg_solve"], **seg_rec,
             interpolate_precise_launches=launches_ip["fused_pcg_solve"]),
        dict(name="fused_normal_apply_3d_prepared", route="cuda",
             source=src + "normal_apply.cu", replaces=ref + "300",
             launches=launches_p4["fused_normal_apply"], **apply3_rec),
        dict(name="jacobi_sweep_prepared", route="cuda", source=src + "jacobi_sweep.cu",
             replaces=ref + "513,1813", launches=launches_p4["fused_smooth"], **sweep_rec),
        dict(name="mg_cycle2d_solve_implicit", route="cuda", source=src + "mg_cycle2d.cu",
             replaces=ref + "1052,1114",
             launches=sum(l["fused_vcycle_2d"] for l in launches_imp.values()),
             **cycle_imp_rec),
        # The batch slice: launches on config 3's run (tol 1e-4, B = 1024).
        dict(name="fused_pcg_solve_batch", route="cuda", source=src + "pcg_segment.cu",
             replaces=ref + "1484", launches=launches_b3["fused_pcg_solve_batch"],
             ptxas={k: v for k, v in segment_ptxas(log).items() if "batch" in k},
             **{**batch_recs["seg_config3"], "max_abs_err": max(
                 batch_recs[k]["max_abs_err"] for k in ("seg_config3", "seg", "seg_w",
                                                        "seg_cheb", "seg_256"))},
             ragged_b8=batch_recs["seg"], wcycle=batch_recs["seg_w"],
             chebyshev=batch_recs["seg_cheb"],
             headline_256=batch_recs["seg_256"],
             precise_launches=launches_b3p["fused_pcg_solve_batch"], config3=config3,
             config3_precise=config3p, lane_by_lane=lanes3),
        dict(name="fused_normal_apply_batch", route="cuda", source=src + "normal_apply.cu",
             replaces=ref + "170", launches=launches_b3["fused_normal_apply_batch"],
             **{**batch_recs["apply_1024"], "max_abs_err": max(
                 batch_recs[k]["max_abs_err"] for k in ("apply_16", "apply_1024",
                                                        "apply_32_3d"))},
             b16=batch_recs["apply_16"], b4_32cubed=batch_recs["apply_32_3d"],
             precise_launches=launches_b3p["fused_normal_apply_batch"]),
        # The batched-cycle slice: launches on its paths (config 4 x 16 and
        # field C x 4 for the smoothing-phase form, field C x 4 and config 3
        # x 4096 for the multi-sweep form, field A x 8 for the cycle).
        dict(name="jacobi_sweep_lanes", route="cuda", source=src + "jacobi_sweep.cu",
             replaces=ref + "513,1813,1959", launches=launches_b4["fused_smooth_lanes"],
             **{**lane_recs["sweep_128_lumped_x16"], "max_abs_err": max(
                 lane_recs[k]["max_abs_err"] for k in ("sweep_128_lumped_x16",
                                                        "sweep_64_diag_x16",
                                                        "sweep_512_diag_x8",
                                                        "sweep_64_x4096",
                                                        "coarsest_jacobi_x4096",
                                                        "sweep_64_galerkin_cheb_x16"))},
             diag_64_x16=lane_recs["sweep_64_diag_x16"],
             galerkin_cheb_64_x16=lane_recs["sweep_64_galerkin_cheb_x16"],
             diag_512_x8=lane_recs["sweep_512_diag_x8"],
             config3_64_x4096=lane_recs["sweep_64_x4096"],
             config3_coarsest_x4096=lane_recs["coarsest_jacobi_x4096"],
             field_c_launches=launches_bc["fused_smooth_lanes"],
             config3_4096_launches=launches_b3j["fused_smooth_lanes"], config4_x16=config4b),
        dict(name="jacobi_multisweep_2d_lanes", route="cuda",
             source=src + "jacobi_multisweep2d.cu", replaces=ref + "653,876",
             launches=launches_bc["fused_smooth_2d_lanes"],
             **{**lane_recs["multi_992_x4"], "max_abs_err": max(
                 lane_recs[k]["max_abs_err"] for k in ("multi_992_x4", "multi_128_x4096"))},
             config3_128_x4096=lane_recs["multi_128_x4096"],
             config3_4096_launches=launches_b3j["fused_smooth_2d_lanes"], field_c_x4=field_cb,
             config3_x4096=config3j),
        dict(name="mg_cycle2d_lanes", route="cuda", source=src + "mg_cycle2d.cu",
             replaces=ref + "1052,1114,1192", launches=launches_ba["fused_wcycle_2d_lanes"],
             **{**lane_recs["cycle_w_496_x8"], "max_abs_err": max(
                 lane_recs[k]["max_abs_err"] for k in ("cycle_w_496_x8",
                                                        "cycle_v_256_lumped_x8"))},
             v_256_lumped_x8=lane_recs["cycle_v_256_lumped_x8"], field_a_x8=field_ab),
    ]
    for k in kernels:
        k["library_ms"] = None  # no one PyTorch call computes any of these functions
    print(json.dumps({"contour": CONTOURS, "debug": debug, "observe": observe,
                      "explicit": explicit_rec, "native": native_rec, "card": card}))
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
