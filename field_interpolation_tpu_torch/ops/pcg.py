"""Kernel 2: one safeguarded multigrid-PCG segment in one launch.

Replaces ``field_interpolation_tpu/ops/pallas_stencil.py:fused_pcg_solve``
(lines 1484-1629, with ``_vcycle_refs`` 1439-1481 and ``_smooth_inplace``
1016-1027). The CUDA kernel is ``csrc/pcg_segment.cu``: a persistent
cooperative kernel whose CG loop runs on the device, phases separated by
grid barriers. On the H100 the barriers bound it, not memory: a V-cycle is
~40 dependent phases, most on coarse levels of a few hundred nodes. Its
design keeps the whole segment in one launch, takes every loop decision from
dot products summed in a fixed order (same exit in every block, same
iteration count on every run), ping-pongs the Jacobi sweeps and reads the
transfers only over their bands.

``fused_pcg_solve`` launches the kernel for CUDA tensors and runs
``fused_pcg_solve_plain`` (the same segment in torch ops on the same
operands: plain apply, dense ``Rs`` products, dense coarse inverse) for CPU
tensors.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..multigrid import _resize_matrix
from ..weights import Weights
from . import _build
from .stencil import fused_normal_apply_plain, order_w2

_MAX_LEVELS = 8
# Upper bound on the kernel's grid; the C entry point never launches more
# blocks than this (nor more than can be co-resident on the card).
_MAX_BLOCKS = 4096


def _level_shapes(coeffs: list[torch.Tensor]) -> list[tuple[int, int]]:
    """Per-level grid shapes off the operand ranks: [9, n0, n1] full stencils
    vs bare [n0, n1] diagonals (pallas_stencil.py:_lvl_shapes)."""
    return [tuple(c.shape[1:]) if c.ndim == 3 else tuple(c.shape) for c in coeffs]


def fused_pcg_solve_plain(x, r, tol2, iter_budget, coeffs, sids, Rs, inv_c,
                          level_weights: list[Weights], nu: int,
                          cheb_coefs=None, wdepth: int = 0):
    """The segment in plain torch ops; same contract as `fused_pcg_solve`."""
    if cheb_coefs is not None:
        raise NotImplementedError(
            "fused_pcg_solve: Chebyshev smoothing is not ported "
            "(ROADMAP queue 2, fused_smooth / fused_pcg_solve Chebyshev)")
    L = len(coeffs)

    def A(l, v):
        return fused_normal_apply_plain(v, coeffs[l], level_weights[l], 2)

    def smooth(l, r_l, z, sweeps):
        # z None = from zero: the first sweep is z = sid·r.
        for _ in range(sweeps):
            z = sids[l] * r_l if z is None else z + sids[l] * (r_l - A(l, z))
        return torch.zeros_like(r_l) if z is None else z

    def vcycle(r_l, l=0):
        if l == L - 1:
            return (inv_c @ r_l.reshape(-1)).reshape(r_l.shape)
        R0, R1 = Rs[2 * l], Rs[2 * l + 1]
        z = smooth(l, r_l, None, nu)
        rc = R0 @ (r_l - A(l, z)) @ R1.T
        zc = vcycle(rc, l + 1)
        z = z + R0.T @ zc @ R1
        if l < wdepth and l + 1 < L - 1:
            # W-cycle: a second visit on the residual the first leaves.
            z = z + R0.T @ vcycle(rc - A(l + 1, zc), l + 1) @ R1
        return smooth(l, r_l, z, nu)

    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    xo, rw = x.clone(), r.clone()
    z = vcycle(rw)
    p = z
    rz = torch.sum(rw * z)
    rr = torch.sum(rw * rw)
    tol2_s = tol2.reshape(())
    budget = int(iter_budget.reshape(()).item())
    k = 0
    while bool(rr > tol2_s) and k < budget:
        Ap = A(0, p)
        pAp = torch.sum(p * Ap)
        alpha = torch.where(pAp > 0, rz / pAp, zero)
        xo = xo + alpha * p
        rw = rw - alpha * Ap
        rr = torch.sum(rw * rw)
        z = vcycle(rw)
        rz_new = torch.sum(rw * z)
        beta = torch.where(rz > 0, rz_new / rz, zero)
        p = z + beta * p
        rz = rz_new
        k += 1
    iters = torch.full((1, 1), k, dtype=torch.int32, device=x.device)
    return xo, iters, rr.reshape(1, 1)


@functools.lru_cache(maxsize=None)
def _band_table(n_f: int, n_c: int) -> np.ndarray:
    """Nonzero bands of the transfer between axes of n_f and n_c nodes, as
    int32 (first, span) pairs: first the n_c rows of R = Pᵀ (restriction,
    over fine indices), then the n_f rows of P (prolongation, over coarse
    indices). P is the same `_resize_matrix` the dense Rs come from."""
    nz = _resize_matrix(n_f, n_c) != 0                   # [n_f, n_c]

    def bands(mask):
        out = np.zeros((mask.shape[0], 2), np.int32)
        for i, row in enumerate(mask):
            idx = np.flatnonzero(row)
            if idx.size:
                out[i] = (idx[0], idx[-1] - idx[0] + 1)
        return out

    return np.concatenate([bands(nz.T).ravel(), bands(nz).ravel()])


@functools.lru_cache(maxsize=64)
def _band_tensor(n_f: int, n_c: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_band_table(n_f, n_c), device=device)


def _check_operands(x, r, tol2, iter_budget, coeffs, sids, Rs, inv_c,
                    shapes) -> None:
    dev = x.device
    f32 = torch.float32

    def ok(t, shape, dtype=f32):
        return (t.device == dev and t.dtype == dtype and t.is_contiguous()
                and tuple(t.shape) == tuple(shape))

    L = len(coeffs)
    if not 2 <= L <= _MAX_LEVELS or len(sids) != L or len(Rs) != 2 * (L - 1):
        raise ValueError(f"fused_pcg_solve: needs 2..{_MAX_LEVELS} levels with "
                         f"one sid per level and two Rs per transition; got "
                         f"{L} levels, {len(sids)} sids, {len(Rs)} Rs")
    bad = []
    if coeffs[0].ndim != 3:
        bad.append("the fine level needs the full [9, n0, n1] data stencil")
    for name, t, shape in [("x", x, shapes[0]), ("r", r, shapes[0])]:
        if not ok(t, shape):
            bad.append(f"{name} {tuple(t.shape)} {t.dtype}")
    if not ok(tol2, (1, 1)):
        bad.append(f"tol2 {tuple(tol2.shape)} {tol2.dtype}")
    if not ok(iter_budget, (1, 1), torch.int32):
        bad.append(f"iter_budget {tuple(iter_budget.shape)} {iter_budget.dtype}")
    for l, (c, s) in enumerate(zip(coeffs, sids)):
        cshape = ((9,) + shapes[l]) if c.ndim == 3 else shapes[l]
        if not ok(c, cshape) or not ok(s, shapes[l]):
            bad.append(f"level {l} coeff {tuple(c.shape)} / sid {tuple(s.shape)}")
    for l in range(L - 1):
        for d in range(2):
            R = Rs[2 * l + d]
            if not ok(R, (shapes[l + 1][d], shapes[l][d])):
                bad.append(f"Rs[{2 * l + d}] {tuple(R.shape)}")
    nc = shapes[-1][0] * shapes[-1][1]
    if not ok(inv_c, (nc, nc)):
        bad.append(f"inv_c {tuple(inv_c.shape)}")
    if bad:
        raise ValueError("fused_pcg_solve: needs contiguous float32 operands "
                         f"on {dev}: " + "; ".join(bad))


def _launch_tables(x, r, tol2, iter_budget, coeffs, sids, Rs, inv_c,
                   level_weights, nu):
    """Outputs, scratch and the host tables of csrc/pcg_segment.cu's
    ``fi_pcg_segment`` (layout documented there): pointers, ints, w_k².
    Returns (outputs, ptrs, ints, w2s, scratch); the caller keeps
    ``scratch`` alive until the launch is queued."""
    shapes = _level_shapes(coeffs)
    L = len(coeffs)
    dev = x.device
    x_out = torch.empty_like(x)
    iters = torch.empty((1, 1), dtype=torch.int32, device=dev)
    rr = torch.empty((1, 1), dtype=torch.float32, device=dev)
    rw = torch.empty_like(x)
    p = torch.empty_like(x)
    partials = torch.empty(3 * _MAX_BLOCKS, dtype=torch.float32, device=dev)
    bufs = [[torch.empty(s, dtype=torch.float32, device=dev) for _ in range(4)]
            for s in shapes]                               # r, za, zb, az
    ptrs = [t.data_ptr() for t in (x, r, tol2, iter_budget, x_out, iters, rr,
                                   rw, p, partials, inv_c)]
    for l in range(L):
        ptrs += [coeffs[l].data_ptr(), sids[l].data_ptr()]
        ptrs += [b.data_ptr() for b in bufs[l]]
    for l in range(L - 1):
        ptrs += [Rs[2 * l].data_ptr(), Rs[2 * l + 1].data_ptr()]
        tabs = [_band_tensor(shapes[l][d], shapes[l + 1][d], dev) for d in range(2)]
        ptrs += [t.data_ptr() for t in tabs]                        # restriction
        ptrs += [t.data_ptr() + 4 * 2 * shapes[l + 1][d]            # prolongation
                 for d, t in enumerate(tabs)]
    ints = [L, int(nu), _MAX_BLOCKS]
    for l, s in enumerate(shapes):
        ints += [s[0], s[1], int(coeffs[l].ndim == 2)]
    w2s = [w for lw in level_weights for w in order_w2(lw)]
    return (x_out, iters, rr), ptrs, ints, w2s, (rw, p, partials, bufs)


def fused_pcg_solve(x, r, tol2, iter_budget, coeffs, sids, Rs, inv_c,
                    level_weights: list[Weights], nu: int, cheb_coefs=None,
                    wdepth: int = 0):
    """One safeguard SEGMENT of 2-D multigrid PCG (pallas_stencil.py:1484).

    x, r: current iterate and its TRUE residual [n0, n1] float32. tol2,
    iter_budget: (1,1) float32 / int32. coeffs[l]: the [9, n0, n1] data
    stencil (fine level) or the [*shape_l] diagonal; sids[l] = τ_l·D_l⁻¹;
    Rs: per transition the two per-axis restriction matrices [n_c, n_f]
    (the transposes of ``multigrid._resize_matrix``, which the kernel reads
    only over their bands); inv_c: dense inverse of the coarsest operator.
    Returns (x_out, iters (1,1) int32, rr (1,1) float32)."""
    if x.device.type == "cpu":
        return fused_pcg_solve_plain(x, r, tol2, iter_budget, coeffs, sids, Rs,
                                     inv_c, level_weights, nu, cheb_coefs,
                                     wdepth)
    if x.device.type != "cuda":
        raise ValueError(f"fused_pcg_solve: no kernel for device {x.device}")
    if cheb_coefs is not None or wdepth != 0:
        raise NotImplementedError(
            "fused_pcg_solve: the CUDA kernel runs the damped-Jacobi V-cycle; "
            "Chebyshev smoothing and the W-cycle are ROADMAP queue 2 items "
            "(fused_smooth, fused_wcycle_2d)")
    if int(nu) < 0:
        raise ValueError(f"fused_pcg_solve: nu must be >= 0, got {nu}")
    shapes = _level_shapes(coeffs)
    _check_operands(x, r, tol2, iter_budget, coeffs, sids, Rs, inv_c, shapes)
    lib = _build.library()
    outs, ptrs, ints, w2s, _scratch = _launch_tables(
        x, r, tol2, iter_budget, coeffs, sids, Rs, inv_c, level_weights, nu)
    ptr_arr = (ctypes.c_longlong * len(ptrs))(*ptrs)
    int_arr = (ctypes.c_int * len(ints))(*ints)
    w2_arr = (ctypes.c_float * len(w2s))(*w2s)
    with torch.cuda.device(x.device):
        rc = lib.fi_pcg_segment(ctypes.addressof(ptr_arr),
                                ctypes.addressof(int_arr),
                                ctypes.addressof(w2_arr),
                                _build.stream_handle(x.device))
    _build.check(rc, "fused_pcg_solve")
    fused_pcg_solve.launches += 1
    return outs


fused_pcg_solve.launches = 0
