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
``pcg_segment_batch_kernel``, one block per lane, each lane doing only its
own iterations; ``fused_pcg_solve_batch_plain`` is its plain version, with
per-lane masks. Same counters on the batched wrapper.
"""

from __future__ import annotations

import torch

from ..weights import Weights
from . import _build
from .cycle import (MAX_LEVELS, _ok, call_tables, check_cycle_operands,
                    check_schedules, cycle_tables, mg_cycle_plain)
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
    rr [B] float32)."""
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
        return fused_pcg_solve_batch_plain(x, r, tol2, iter_budget, coeffs, sids, Rs,
                                           inv_c, level_weights, nu, cheb_coefs, wdepth)
    if x.device.type != "cuda":
        raise ValueError(f"fused_pcg_solve_batch: no kernel for device {x.device}")
    B = _check_batch_operands(x, r, tol2, iter_budget, coeffs, sids, Rs, inv_c)
    lib = _build.library()
    dev = x.device
    x_out = torch.empty_like(x)
    iters = torch.empty(B, dtype=torch.int32, device=dev)
    rr = torch.empty(B, dtype=torch.float32, device=dev)
    rw, p = torch.empty_like(x), torch.empty_like(x)
    lane0_cfs = None if cheb_coefs is None else [cf[0] for cf in cheb_coefs]
    lp, li, w2s, scratch = cycle_tables([c[0] for c in coeffs], [s[0] for s in sids], Rs,
                                        level_weights, nu, nu, wdepth, dev, lane0_cfs,
                                        lanes=B)
    cf_strides = [0] * MAX_LEVELS
    if cheb_coefs is not None:
        for l in range(len(coeffs) - 1):
            cf_strides[l] = cheb_coefs[l][0].numel()
    ptrs = [t.data_ptr() for t in (x, r, tol2, iter_budget, x_out, iters, rr, rw, p,
                                   inv_c)] + lp
    ints = [B, scratch.numel() // B] + cf_strides + li
    rc = call_tables(lib.fi_pcg_segment_batch, ptrs, ints, w2s, dev)
    _build.check(rc, "fused_pcg_solve_batch")
    fused_pcg_solve_batch.launches += 1
    fused_pcg_solve_batch.cheb_launches += cheb_coefs is not None
    return x_out, iters, rr


fused_pcg_solve_batch.launches = fused_pcg_solve_batch.cheb_launches = 0
