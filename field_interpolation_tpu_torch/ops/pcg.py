"""Kernel 2: one safeguarded multigrid-PCG segment in one launch.

Replaces ``field_interpolation_tpu/ops/pallas_stencil.py:fused_pcg_solve``
(lines 1484-1629, with ``_vcycle_refs`` 1439-1481 and ``_smooth_inplace``
1016-1027 or ``_cheb_inplace`` 483-507). The CUDA kernel is
``csrc/pcg_segment.cu``: a persistent cooperative kernel whose CG loop runs
on the device, phases separated by grid barriers. Its preconditioner is the
V- or W-cycle of ``csrc/mg_cycle2d.cuh``, the device code of the
whole-cycle kernel (`ops.cycle`), with damped-Jacobi or Chebyshev smoothing
and lumped or Galerkin coarse levels. On the H100 the barriers bound it,
not memory: a V-cycle is ~40 dependent phases, most on coarse levels of a
few hundred nodes. Its design keeps the whole segment in one launch, takes
every loop decision from dot products summed in a fixed order (same exit in
every block, same iteration count on every run), ping-pongs the sweeps and
reads the transfers only over their bands.

``fused_pcg_solve`` launches the kernel for CUDA tensors and runs
``fused_pcg_solve_plain`` (the same segment in torch ops on the same
operands, its cycle `ops.cycle.mg_cycle_plain`) for CPU tensors, and
counts its launches in ``fused_pcg_solve.launches``, those in Chebyshev mode
also in ``.cheb_launches``.

``fused_pcg_solve_batch`` is ``fused_pcg_solve`` under ``vmap`` (BASELINE
config 3): B independent segments in one launch of the same source's
``pcg_segment_batch_kernel``, one block per lane running the lane body of
``csrc/lane2d.cuh`` in `lane_geometry`'s geometry with `lane_plan`'s
shared memory, each lane doing only its own iterations; ``fused_pcg_solve_batch_plain`` is its plain version, with
per-lane masks. Same counters on the batched wrapper; each call also adds
its lanes' level-0 runs that hold data (the kernel's run mask,
`lane_data_runs`) and the runs it offered to the open batch record.
"""

from __future__ import annotations

import torch

from ..utils import observe
from ..weights import Weights
from . import _build
from .cycle import (_band_table, _ok, call_tables, check_cycle_operands, check_schedules,
                    cycle_tables, level_shapes, mg_cycle_plain, schedule_strides)
from .stencil import check_lanes, fused_normal_apply_plain

# Upper bound on the kernel's grid; the C entry point never launches more
# blocks than this (nor more than can be co-resident on the card).
_MAX_BLOCKS = 4096


def fused_pcg_solve_plain(x, r, tol2, iter_budget, coeffs, sids, Rs, inv_c,
                          level_weights: list[Weights], nu: int,
                          cheb_coefs=None, wdepth: int = 0):
    """The segment in plain torch ops; same contract as `fused_pcg_solve`:
    `fused_pcg_solve_batch_plain` on one lane."""
    cfs = None if cheb_coefs is None else [None if cf is None else cf[None]
                                           for cf in cheb_coefs]
    xo, iters, rr = fused_pcg_solve_batch_plain(
        x[None], r[None], tol2.reshape(1), iter_budget.reshape(1),
        [c[None] for c in coeffs], [s[None] for s in sids], Rs, inv_c[None],
        level_weights, nu, cfs, wdepth)
    return xo[0], iters.reshape(1, 1), rr.reshape(1, 1)


def _check_operands(x, r, tol2, iter_budget, coeffs, sids, Rs, inv_c) -> None:
    dev = x.device
    shape0 = tuple(coeffs[0].shape[-2:])
    bad = [f"{name} {tuple(t.shape)} {t.dtype}"
           for name, t, shape, dtype in [("x", x, shape0, torch.float32),
                                         ("r", r, shape0, torch.float32),
                                         ("tol2", tol2, (1, 1), torch.float32),
                                         ("iter_budget", iter_budget, (1, 1),
                                          torch.int32)]
           if not _ok(t, dev, shape, dtype)]
    check_cycle_operands("fused_pcg_solve", dev, coeffs, sids, Rs, inv_c, bad)


def _launch_tables(x, r, tol2, iter_budget, coeffs, sids, Rs, inv_c,
                   level_weights, nu, wdepth, cheb_coefs=None):
    """Outputs, scratch and the host tables of csrc/pcg_segment.cu's
    ``fi_pcg_segment`` (layout documented there): pointers, ints, w_k².
    Returns (outputs, ptrs, ints, w2s, scratch); the caller keeps
    ``scratch`` alive until the launch is queued."""
    dev = x.device
    x_out = torch.empty_like(x)
    iters = torch.empty((1, 1), dtype=torch.int32, device=dev)
    rr = torch.empty((1, 1), dtype=torch.float32, device=dev)
    rw = torch.empty_like(x)
    p = torch.empty_like(x)
    partials = torch.empty(3 * _MAX_BLOCKS, dtype=torch.float32, device=dev)
    lp, li, w2s, bufs = cycle_tables(coeffs, sids, Rs, level_weights, nu, nu,
                                     wdepth, dev, cheb_coefs)
    ptrs = [t.data_ptr() for t in (x, r, tol2, iter_budget, x_out, iters, rr,
                                   rw, p, partials, inv_c)] + lp
    return ((x_out, iters, rr), ptrs, [_MAX_BLOCKS] + li, w2s,
            (rw, p, partials, bufs))


def fused_pcg_solve(x, r, tol2, iter_budget, coeffs, sids, Rs, inv_c,
                    level_weights: list[Weights], nu: int, cheb_coefs=None,
                    wdepth: int = 0):
    """One safeguard SEGMENT of 2-D multigrid PCG (pallas_stencil.py:1484).

    x, r: current iterate and its TRUE residual [n0, n1] float32. tol2,
    iter_budget: (1,1) float32 / int32. coeffs[l]: the [9, n0, n1] data
    stencil (fine level; Galerkin coarse levels) or the [*shape_l] diagonal;
    sids[l] = τ_l·D_l⁻¹ (Jacobi) or D_l⁻¹ (Chebyshev, with ``cheb_coefs``
    the per-level [≥ ν, 2] float32 schedules on x's device, as
    `ops.cycle.fused_vcycle_2d`); Rs: per transition the two per-axis
    restriction matrices [n_c, n_f] (the transposes of
    ``multigrid._resize_matrix``, which the kernel reads only over their
    bands); inv_c: dense inverse of the coarsest operator; wdepth: the
    transitions whose coarser level the cycle visits twice (0: a V-cycle,
    99: the textbook W-cycle). Returns (x_out, iters (1,1) int32, rr (1,1)
    float32)."""
    if int(nu) < 0 or int(wdepth) < 0:
        raise ValueError(f"fused_pcg_solve: nu and wdepth must be >= 0, got {nu}, "
                         f"{wdepth}")
    if cheb_coefs is not None:
        check_schedules("fused_pcg_solve", cheb_coefs, len(coeffs), nu, x.device)
    if x.device.type == "cpu":
        return fused_pcg_solve_plain(x, r, tol2, iter_budget, coeffs, sids, Rs,
                                     inv_c, level_weights, nu, cheb_coefs,
                                     wdepth)
    if x.device.type != "cuda":
        raise ValueError(f"fused_pcg_solve: no kernel for device {x.device}")
    _check_operands(x, r, tol2, iter_budget, coeffs, sids, Rs, inv_c)
    lib = _build.library()
    outs, ptrs, ints, w2s, _scratch = _launch_tables(
        x, r, tol2, iter_budget, coeffs, sids, Rs, inv_c, level_weights, nu, wdepth,
        cheb_coefs)
    rc = call_tables(lib.fi_pcg_segment, ptrs, ints, w2s, x.device)
    _build.check(rc, "fused_pcg_solve")
    fused_pcg_solve.launches += 1
    fused_pcg_solve.cheb_launches += cheb_coefs is not None
    return outs


fused_pcg_solve.launches = fused_pcg_solve.cheb_launches = 0


def _lane_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-lane Σ a·b over the grid axes of [B, n0, n1]."""
    return torch.sum(a * b, dim=(-2, -1))


def lane_data_runs(coeff: torch.Tensor, iters: torch.Tensor) -> torch.Tensor:
    """Per lane of ``coeff`` [B, 9, n0, n1], the runs of `lane_runs` whose
    nine data coefficients are not all zero, and 0 for a lane that ran no
    iteration (``iters`` [B]): the bits csrc/lane2d.cuh:mark_runs sets, [B]
    int32."""
    B, _, n0, n1 = coeff.shape
    nz = (coeff != 0).any(dim=1).to(torch.int8)
    nz = torch.nn.functional.pad(nz, (0, -n1 % _RUN)).reshape(B, n0, -1, _RUN)
    runs = nz.amax(dim=-1).sum(dim=(1, 2), dtype=torch.int32)
    return torch.where(iters > 0, runs, 0)


def lane_runs(shape) -> int:
    """The runs of 4 nodes along axis 1 (csrc/lane2d.cuh: kRun, the last one
    ragged) of a 2-D lane of ``shape``."""
    return shape[0] * -(-shape[1] // _RUN)


def fused_pcg_solve_batch_plain(x, r, tol2, iter_budget, coeffs, sids, Rs, inv_c,
                                level_weights: list[Weights], nu: int, cheb_coefs=None,
                                wdepth: int = 0):
    """The batched segment in plain torch ops; same contract as
    `fused_pcg_solve_batch`, and on one lane `fused_pcg_solve_plain`. The
    lanes step together, and a lane whose exit test holds (‖r‖² ≤ tol2 or
    its budget spent) is frozen by masks from then on."""
    def precond(v):
        return mg_cycle_plain(v, coeffs, sids, Rs, inv_c, level_weights, nu, nu,
                              wdepth, cheb_coefs)

    B = x.shape[0]
    tol2 = tol2.reshape(B)
    budget = iter_budget.reshape(B)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    xo, rw = x.clone(), r.clone()
    rr = _lane_dot(rw, rw)
    k = torch.zeros(B, dtype=torch.int32, device=x.device)
    active = (rr > tol2) & (k < budget)
    if not bool(active.any()):
        return xo, k, rr
    z = precond(rw)
    p, rz = z, _lane_dot(rw, z)
    while True:
        grid = active[:, None, None]
        Ap = fused_normal_apply_plain(p, coeffs[0], level_weights[0], 2)
        pAp = _lane_dot(p, Ap)
        alpha = torch.where(pAp > 0, rz / pAp, zero)[:, None, None]
        xo = torch.where(grid, xo + alpha * p, xo)
        rw = torch.where(grid, rw - alpha * Ap, rw)
        rr = torch.where(active, _lane_dot(rw, rw), rr)
        k = k + active.to(torch.int32)
        active = active & (rr > tol2) & (k < budget)
        if not bool(active.any()):
            break
        z = precond(rw)
        rz_new = _lane_dot(rw, z)
        beta = torch.where(rz > 0, rz_new / rz, zero)[:, None, None]
        p = torch.where(active[:, None, None], z + beta * p, p)
        rz = torch.where(active, rz_new, rz)
    return xo, k, rr


# The batched segment's lane geometry (csrc/lane2d.cuh): threads a lane
# and the lanes an SM holds at once (which caps a thread's registers: 64 at
# one lane of 1024 threads, 128 at two of 256), each one of
# csrc/pcg_segment.cu's instantiations; per lanes an SM, the shared memory
# one lane may fill (its transfer bands, then the coarse levels and level
# 0's residual that save the most traffic), beside the L1 the fine level's
# windows use. `lane_geometry` picks one from the number of lanes;
# LANE_GEOMETRY, when set, overrides it (batch_probe.py --lane). A lane's
# result does not depend on the geometry: its dot products sum in one order
# at every width (lane2d.cuh: Dot).
LANE_GEOMETRIES = ((1024, 1), (256, 2))
LANE_GEOMETRY = None
LANE_SMEM_BYTES = {1: 160 * 1024, 2: 100 * 1024}
_SPAN_R, _SPAN_P = 4, 2  # lane2d.cuh: kSpanR, kSpanP
_RUN = 4  # lane2d.cuh: kRun, the nodes of a work item along axis 1


def _round4(w: int) -> int:
    return (w + 3) & ~3


def _mask_words(shape) -> int:
    """The words of level 0's run mask, one bit a run (lane2d.cuh:mask_words)."""
    return _round4(-(-lane_runs(shape) // 32))


def _lane_candidates(shapes, diags, nu, wdepth):
    """The words every lane holds (the transfer bands, then level 0's run
    mask), and (words, traffic saved a cycle) of each candidate for shared
    memory: coarse levels 1..L-1 (a level's arrays are read and written
    ~4ν + 6 times a visit), then level 0's residual (4 times an iteration)."""
    fixed = 0
    for (f0, f1), (c0, c1) in zip(shapes, shapes[1:]):
        for nf, nc in ((f0, c0), (f1, c1)):
            fixed += 2 * _round4(nc) + nc * _SPAN_R + 2 * _round4(nf) + nf * _SPAN_P
    fixed += _mask_words(shapes[0])
    L = len(shapes)
    nodes = [a * b for a, b in shapes]
    visits = [1] * L
    for l in range(L - 1):
        visits[l + 1] = visits[l] * (2 if l < wdepth and l + 1 < L - 1 else 1)
    items = [(5 * _round4(nodes[l]) + _round4(nodes[l] if diags[l] else 9 * nodes[l]),
              visits[l] * nodes[l] * (4 * nu + 6)) for l in range(1, L)]
    return fixed, items + [(_round4(nodes[0]), 4 * nodes[0])]


def lane_geometry(B: int, sms: int) -> tuple[int, int]:
    """(threads a lane, lanes an SM) for B lanes on a card of ``sms`` SMs:
    the geometry with the fewest waves of lanes (B over the lanes the card
    holds at once, rounded up), the fewest lanes an SM on a tie; so one
    lane of 1024 threads an SM up to one wave of them (it finishes
    soonest), else two of 256 (more lanes a second). On the H100 this is
    the faster geometry on the main paths (config 3's 1024 lanes, its
    1e-6 form's 256; PERF.md §6); at 265-396 lanes one lane an SM is 3-17%
    faster and the rule does not take it."""
    if LANE_GEOMETRY:
        return LANE_GEOMETRY
    return min(LANE_GEOMETRIES, key=lambda g: (-(-B // (sms * g[1])), g[1]))


def _sms(device) -> int:
    """The SMs of ``device``'s card; 132 (an H100's) for a host device, where
    only the tables are built, never launched."""
    if torch.device(device).type != "cuda":
        return 132
    return torch.cuda.get_device_properties(device).multi_processor_count


def lane_plan(shapes, diags, nu: int = 3, wdepth: int = 0, geometry=(1024, 1)):
    """Where a lane of the batched segment keeps its arrays: (threads, lanes
    an SM holds, bitmask of the coarse levels held in shared memory, 1 if
    level 0's residual is too, the dynamic shared-memory bytes).
    ``shapes``/``diags``: per level its (n0, n1) and whether its data is the
    diagonal; ``nu``/``wdepth`` the cycle's. The transfer bands and level 0's
    run mask first, then of the sets of `_lane_candidates` that fit the
    lane's share, the one that saves the most traffic. The sizes are
    csrc/lane2d.cuh:plan_layout's: the kernel refuses a launch whose bytes
    differ from the plan's."""
    threads, per_sm = geometry
    if (threads, per_sm) not in LANE_GEOMETRIES:
        raise ValueError(f"lane_plan: the lane geometry (threads, lanes an SM holds) must "
                         f"be one of {LANE_GEOMETRIES}, got {(threads, per_sm)}")
    budget = LANE_SMEM_BYTES[per_sm] // 4
    fixed, items = _lane_candidates(shapes, diags, nu, wdepth)
    best = (0, 0, 0)  # (saved, -words, set)
    for chosen in range(1 << len(items)):
        words = fixed + sum(items[i][0] for i in range(len(items)) if chosen >> i & 1)
        saved = sum(items[i][1] for i in range(len(items)) if chosen >> i & 1)
        if words <= budget and (saved, -words) > best[:2]:
            best = (saved, -words, chosen)
    chosen, L = best[2], len(shapes)
    mask = sum(1 << (i + 1) for i in range(L - 1) if chosen >> i & 1)
    az0 = chosen >> (L - 1) & 1
    return threads, per_sm, mask, az0, -4 * best[1]


def _check_lane_bands(shapes) -> None:
    """The lane body keeps ≤ 4 fine indices per restriction row and ≤ 2
    coarse per prolongation row of each axis (csrc/lane2d.cuh: kSpanR,
    kSpanP); the hierarchy's halving keeps them there."""
    for (f0, f1), (c0, c1) in zip(shapes, shapes[1:]):
        for nf, nc in ((f0, c0), (f1, c1)):
            spans = _band_table(nf, nc).reshape(-1, 2)[:, 1]
            if spans[:nc].max() > _SPAN_R or spans[nc:].max() > _SPAN_P:
                raise ValueError(f"fused_pcg_solve_batch: the transfer {nf} -> {nc} has "
                                 f"bands wider than {_SPAN_R} / {_SPAN_P}")


def _check_batch_operands(x, r, tol2, iter_budget, coeffs, sids, Rs, inv_c) -> int:
    """The batched segment's operands: every per-lane operand [B, ...]
    contiguous, each lane's as `_check_operands` wants one field's; Rs
    shared. Returns B."""
    B, _ = check_lanes("fused_pcg_solve_batch", x, coeffs[0], 2, r)
    lanes = [("tol2", tol2, torch.float32), ("iter_budget", iter_budget, torch.int32)]
    bad = [f"{name} {tuple(t.shape)} {t.dtype}" for name, t, dtype in lanes
           if not _ok(t, x.device, (B,), dtype)]
    per_lane = list(coeffs) + list(sids) + [inv_c]
    bad += [f"lane axis of {tuple(t.shape)}" for t in per_lane
            if t.ndim < 1 or t.shape[0] != B or not t.is_contiguous()]
    check_cycle_operands("fused_pcg_solve_batch", x.device, [c[0] for c in coeffs],
                         [s[0] for s in sids], Rs, inv_c[0], bad)
    return B


def _batch_tables(x, r, tol2, iter_budget, coeffs, sids, Rs, inv_c, level_weights, nu,
                  wdepth, cheb_coefs):
    """Outputs, scratch and the host tables of csrc/pcg_segment.cu's
    ``fi_pcg_segment_batch`` (layout documented there), with
    `lane_geometry`'s geometry and its `lane_plan`. Returns (outputs: x,
    iters, rr and the data runs, ptrs, ints, w2s, scratch); the caller keeps
    ``scratch`` alive until the launch is queued."""
    B, dev = x.shape[0], x.device
    shapes = level_shapes([c[0] for c in coeffs])
    _check_lane_bands(shapes)
    threads, per_sm, mask, az0, nbytes = lane_plan(shapes, [c.ndim == 3 for c in coeffs], nu,
                                                   wdepth, lane_geometry(B, _sms(dev)))
    x_out = torch.empty_like(x)
    iters = torch.empty(B, dtype=torch.int32, device=dev)
    rr = torch.empty(B, dtype=torch.float32, device=dev)
    runs = torch.empty(B, dtype=torch.int32, device=dev)
    rw, p = torch.empty_like(x), torch.empty_like(x)
    lane0_cfs = None if cheb_coefs is None else [cf[0] for cf in cheb_coefs]
    lp, li, w2s, scratch = cycle_tables([c[0] for c in coeffs], [s[0] for s in sids], Rs,
                                        level_weights, nu, nu, wdepth, dev, lane0_cfs,
                                        lanes=B)
    cf_strides = schedule_strides(cheb_coefs, len(coeffs))
    ptrs = [t.data_ptr() for t in (x, r, tol2, iter_budget, x_out, iters, rr, rw, p,
                                   inv_c, runs)] + lp
    ints = [B, scratch.numel() // B] + cf_strides + [threads, mask, az0, per_sm, nbytes] + li
    return (x_out, iters, rr, runs), ptrs, ints, w2s, (rw, p, scratch)


def fused_pcg_solve_batch(x, r, tol2, iter_budget, coeffs, sids, Rs, inv_c,
                          level_weights: list[Weights], nu: int, cheb_coefs=None,
                          wdepth: int = 0):
    """B independent safeguard SEGMENTS of 2-D multigrid PCG in one launch
    (pallas_stencil.py:1484 under vmap, BASELINE config 3).

    x, r: [B, n0, n1] float32, each lane's iterate and TRUE residual.
    tol2, iter_budget: [B] float32 / int32; a lane with budget 0 (or
    already ‖r‖² ≤ tol2) runs no cycle and keeps its x. coeffs, sids: per
    level [B, ...] as `fused_pcg_solve`'s per field; inv_c [B, Nc, Nc];
    cheb_coefs: per level [B, ≥ ν, 2] (each lane's schedule) or None; Rs
    and level_weights shared. Returns (x_out [B, n0, n1], iters [B] int32,
    rr [B] float32). Adds the lanes' level-0 runs that hold data
    (`lane_data_runs`; the kernel counts its run mask's bits) and the runs
    offered, B · `lane_runs`, to the counters ``data_runs`` and
    ``runs_offered`` of the open batch record (`utils.observe.count`)."""
    if int(nu) < 0 or int(wdepth) < 0:
        raise ValueError(f"fused_pcg_solve_batch: nu and wdepth must be >= 0, got {nu}, "
                         f"{wdepth}")
    if cheb_coefs is not None:
        if any(not isinstance(cf, torch.Tensor) or cf.ndim != 3 or cf.shape[0] != x.shape[0]
               or not cf.is_contiguous() for cf in cheb_coefs[:len(coeffs) - 1]):
            raise ValueError("fused_pcg_solve_batch: Chebyshev schedules must be "
                             "contiguous [B, >= nu, 2] per level")
        check_schedules("fused_pcg_solve_batch", [cf[0] for cf in cheb_coefs],
                        len(coeffs), nu, x.device)
    if x.device.type == "cpu":
        outs = fused_pcg_solve_batch_plain(x, r, tol2, iter_budget, coeffs, sids, Rs,
                                           inv_c, level_weights, nu, cheb_coefs, wdepth)
        runs = lane_data_runs(coeffs[0], outs[1])
    elif x.device.type != "cuda":
        raise ValueError(f"fused_pcg_solve_batch: no kernel for device {x.device}")
    else:
        _check_batch_operands(x, r, tol2, iter_budget, coeffs, sids, Rs, inv_c)
        lib = _build.library()
        (*outs, runs), ptrs, ints, w2s, _scratch = _batch_tables(
            x, r, tol2, iter_budget, coeffs, sids, Rs, inv_c, level_weights, nu, wdepth,
            cheb_coefs)
        rc = call_tables(lib.fi_pcg_segment_batch, ptrs, ints, w2s, x.device)
        _build.check(rc, "fused_pcg_solve_batch")
        fused_pcg_solve_batch.launches += 1
        fused_pcg_solve_batch.cheb_launches += cheb_coefs is not None
    observe.count("runs_offered", x.shape[0] * lane_runs(x.shape[1:]))
    observe.count("data_runs", runs)
    return tuple(outs)


fused_pcg_solve_batch.launches = fused_pcg_solve_batch.cheb_launches = 0
