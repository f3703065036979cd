"""Kernel 5: one whole 2-D multigrid cycle, z = M⁻¹ r, in one launch.

One CUDA kernel (``csrc/mg_cycle2d.cu``) stands in for three TPU kernels of
``field_interpolation_tpu/ops/pallas_stencil.py`` that compute the same
symmetric cycle on a 2-D hierarchy, with damped-Jacobi smoothing or, given
per-level [ν, 2] schedules (``cheb_coefs``), Chebyshev smoothing, and with
lumped (diagonal) or Galerkin (9-channel) coarse levels:

* `fused_vcycle_2d` — ``_vc_down_call`` (1052 → 1100) and ``_vc_up_call``
  (1114 → 1161), the two halves of the reference's ``fused_vcycle_2d``
  (1172), with the XLA coarsest matvec between them: a V-cycle with ν_pre
  and ν_post apart (``wdepth = 0``);
* `fused_wcycle_2d` — ``fused_wcycle_2d`` (1192 → 1238): the W-cycle of
  ``_vcycle_refs`` (1439-1481) with ν sweeps each way.

The reference splits its V-cycle only because Mosaic cannot reshape the
coarsest level in a kernel (pallas_stencil.py:1008-1013). Here the whole
cycle is one cooperative launch whose phases (sweeps, residuals, banded
transfers, the dense coarsest matvec) are separated by grid barriers, and
its device code (``csrc/mg_cycle2d.cuh``) is the cycle the PCG segment
kernel runs as its preconditioner (`ops.pcg`). On the H100 the barriers
bound it, not bytes: the coarse levels hold a few hundred to a few thousand
nodes.

Lanes (the kernels under ``vmap``: the batched cycle of ``batch.py``'s
``"cycle"`` route): r [B, n0, n1] with every operand but Rs and the Weights
leading with B is ONE launch for all lanes, whose phases each cover every
lane's nodes, so the batch pays one field's grid barriers; a lane's z is the
same bits as its single-field call.

Each wrapper launches the kernel for CUDA tensors and runs `mg_cycle_plain`
for CPU tensors, and counts its launches in ``fused_vcycle_2d.launches`` /
``fused_wcycle_2d.launches``, those in Chebyshev mode also in
``.cheb_launches`` and those with lanes also in ``.lane_launches``. The
schedules stay on the device: the kernel reads them there.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..multigrid import _resize_matrix
from ..weights import Weights
from . import _build
from .smooth import check_schedule, fused_smooth_plain
from .stencil import fused_normal_apply_plain, order_w2

MAX_LEVELS = 8  # csrc/mg_cycle2d.cuh: kMaxLevels


def level_shapes(coeffs: list[torch.Tensor]) -> list[tuple[int, int]]:
    """Per-level grid shapes off the operand ranks: [9, n0, n1] full stencils
    vs bare [n0, n1] diagonals (pallas_stencil.py:_lvl_shapes)."""
    return [tuple(c.shape[1:]) if c.ndim == 3 else tuple(c.shape) for c in coeffs]


def mg_cycle_plain(r, coeffs, sids, Rs, inv_c, level_weights: list[Weights],
                   nu_pre: int, nu_post: int, wdepth: int = 0,
                   cheb_coefs=None) -> torch.Tensor:
    """One symmetric cycle z = M⁻¹ r in plain torch ops, on the operands of
    `fused_vcycle_2d`: ν_pre sweeps from zero (the first is sid·r, or
    c2_0·sid·r under Chebyshev, and counts as one), residual, restriction
    R0·res·R1ᵀ, the coarser visit, prolong-add, ν_post sweeps from z. The
    sweeps are `fused_smooth_plain`'s, damped Jacobi or, with
    ``cheb_coefs[l]``, Chebyshev. A transition l < ``wdepth`` with l + 1
    above the coarsest level visits level l+1 a second time, on the
    residual the first visit leaves (the W-cycle of _vcycle_refs). Lanes:
    r [B, n0, n1] with every operand but Rs and the Weights leading with
    B (inv_c [B, Nc, Nc], cheb_coefs[l] [B, ν, 2]), each lane cycled on its
    own."""
    L = len(coeffs)

    def A(l, v):
        return fused_normal_apply_plain(v, coeffs[l], level_weights[l], 2)

    def smooth(l, r_l, z, sweeps):
        # z None = from zero; 0 sweeps from zero are zeros (_smooth_inplace).
        if sweeps == 0:
            return torch.zeros_like(r_l) if z is None else z
        return fused_smooth_plain(r_l, z, coeffs[l], sids[l], level_weights[l], 2,
                                  sweeps, z is None,
                                  None if cheb_coefs is None else cheb_coefs[l])

    def cycle(r_l, l):
        if l == L - 1:
            if r_l.ndim == 3:  # lanes
                return (inv_c @ r_l.reshape(r_l.shape[0], -1, 1)).reshape(r_l.shape)
            return (inv_c @ r_l.reshape(-1)).reshape(r_l.shape)
        R0, R1 = Rs[2 * l], Rs[2 * l + 1]
        z = smooth(l, r_l, None, nu_pre)
        rc = R0 @ (r_l - A(l, z)) @ R1.T
        zc = cycle(rc, l + 1)
        z = z + R0.T @ zc @ R1
        if l < wdepth and l + 1 < L - 1:
            z = z + R0.T @ cycle(rc - A(l + 1, zc), l + 1) @ R1
        return smooth(l, r_l, z, nu_post)

    return cycle(r, 0)


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


def _ok(t, device, shape, dtype=torch.float32) -> bool:
    return (t.device == device and t.dtype == dtype and t.is_contiguous()
            and tuple(t.shape) == tuple(shape))


def check_schedules(what: str, cheb_coefs, n_levels: int, nu: int, device,
                    lanes: int | None = None) -> None:
    """Raise ValueError unless ``cheb_coefs`` (not None) holds a Chebyshev
    schedule for ``nu`` sweeps (`smooth.check_schedule`, one a lane with
    ``lanes``) for each level that smooths, the first ``n_levels`` − 1."""
    if isinstance(cheb_coefs, torch.Tensor) or len(cheb_coefs) < n_levels - 1:
        raise ValueError(f"{what}: needs a list of per-level Chebyshev schedules, "
                         f">= {n_levels - 1} for {n_levels} levels")
    for l in range(n_levels - 1):
        check_schedule(f"{what} level {l}", cheb_coefs[l], nu, device, lanes)


def schedule_strides(cheb_coefs, n_levels: int) -> list[int]:
    """The kMaxLevels floats a lane of each level's [B, ν, 2] schedule, as
    the lane forms' int tables carry them (0 under damped Jacobi and on the
    coarsest level)."""
    strides = [0] * MAX_LEVELS
    if cheb_coefs is not None:
        for l in range(n_levels - 1):
            strides[l] = cheb_coefs[l][0].numel()
    return strides


def check_cycle_operands(what: str, device, coeffs, sids, Rs, inv_c,
                         bad: list[str]) -> None:
    """Raise ValueError unless the cycle's operands suit the CUDA kernels:
    2..MAX_LEVELS levels, contiguous float32 on ``device``, the fine level
    with the [9, n0, n1] data stencil, each coarse level with its diagonal or
    its [9, *shape] Galerkin stencil, the per-axis Rs [n_{l+1,d}, n_{l,d}]
    and the [Nc, Nc] coarsest inverse. ``bad``: what the caller found wrong
    with its own operands, reported with these."""
    L = len(coeffs)
    if not 2 <= L <= MAX_LEVELS or len(sids) != L or len(Rs) != 2 * (L - 1):
        raise ValueError(f"{what}: needs 2..{MAX_LEVELS} levels with one sid per "
                         f"level and two Rs per transition; got {L} levels, "
                         f"{len(sids)} sids, {len(Rs)} Rs")
    shapes = level_shapes(coeffs)
    bad = list(bad)
    if coeffs[0].ndim != 3:
        bad.append("the fine level needs the full [9, n0, n1] data stencil")
    for l, (c, s) in enumerate(zip(coeffs, sids)):
        cshape = ((9,) + shapes[l]) if c.ndim == 3 else shapes[l]
        if not _ok(c, device, cshape) or not _ok(s, device, shapes[l]):
            bad.append(f"level {l} coeff {tuple(c.shape)} / sid {tuple(s.shape)}")
    for l in range(L - 1):
        for d in range(2):
            R = Rs[2 * l + d]
            if not _ok(R, device, (shapes[l + 1][d], shapes[l][d])):
                bad.append(f"Rs[{2 * l + d}] {tuple(R.shape)}")
    nc = shapes[-1][0] * shapes[-1][1]
    if not _ok(inv_c, device, (nc, nc)):
        bad.append(f"inv_c {tuple(inv_c.shape)}")
    if bad:
        raise ValueError(f"{what}: needs contiguous float32 operands on {device}: "
                         + "; ".join(bad))


def cycle_tables(coeffs, sids, Rs, level_weights, nu_pre, nu_post, wdepth, device,
                 cheb_coefs=None, lanes: int = 1):
    """The cycle's part of the host tables of csrc/mg_cycle2d.cuh:fill_cycle,
    and the level buffers: (pointers, ints, w2s, scratch). Level 0's r
    pointer is 0: each entry point sets it to its own residual; a level's
    schedule pointer is 0 under damped Jacobi. The caller keeps ``scratch``
    alive until the launch is queued. ``lanes``: the level buffers of that
    many lanes, lane b's ``scratch.numel() // lanes`` floats past lane 0's
    (the operands given are lane 0's)."""
    shapes = level_shapes(coeffs)
    L = len(coeffs)
    # One allocation for every level's buffers: (r,) za, zb, az, level 0
    # without r (each entry point passes its own).
    counts = [(3 if l == 0 else 4) * s[0] * s[1] for l, s in enumerate(shapes)]
    scratch = torch.empty(lanes * sum(counts), dtype=torch.float32, device=device)
    ptrs, addr = [], scratch.data_ptr()
    for l, s in enumerate(shapes):
        n = s[0] * s[1]
        bufs = [addr + 4 * n * k for k in range(counts[l] // n)]
        ptrs += [coeffs[l].data_ptr(), sids[l].data_ptr()] + ([0] if l == 0 else []) + bufs
        addr += 4 * counts[l]
    for l in range(L - 1):
        ptrs += [Rs[2 * l].data_ptr(), Rs[2 * l + 1].data_ptr()]
        tabs = [_band_tensor(shapes[l][d], shapes[l + 1][d], device) for d in range(2)]
        ptrs += [t.data_ptr() for t in tabs]                        # restriction
        ptrs += [t.data_ptr() + 4 * 2 * shapes[l + 1][d]            # prolongation
                 for d, t in enumerate(tabs)]
    ptrs += [0 if cheb_coefs is None or l == L - 1 else cheb_coefs[l].data_ptr()
             for l in range(L)]
    ints = [L, int(nu_pre), int(nu_post), int(wdepth)]
    for l, s in enumerate(shapes):
        ints += [s[0], s[1], int(coeffs[l].ndim == 2)]
    w2s = [w for lw in level_weights for w in order_w2(lw)]
    return ptrs, ints, w2s, scratch


def call_tables(lib_fn, ptrs, ints, w2s, device) -> int:
    """Call a C entry point that takes (pointer table, int table, w2 table,
    stream) on ``device``'s current stream; returns its error code."""
    ptr_arr = (ctypes.c_longlong * len(ptrs))(*ptrs)
    int_arr = (ctypes.c_int * len(ints))(*ints)
    w2_arr = (ctypes.c_float * len(w2s))(*w2s)
    with torch.cuda.device(device):
        return lib_fn(ctypes.addressof(ptr_arr), ctypes.addressof(int_arr),
                      ctypes.addressof(w2_arr), _build.stream_handle(device))


def _cycle(name, counter, r, coeffs, sids, Rs, inv_c, level_weights, nu_pre,
           nu_post, wdepth, cheb_coefs):
    if min(int(nu_pre), int(nu_post), int(wdepth)) < 0:
        raise ValueError(f"{name}: nu_pre, nu_post and wdepth must be >= 0, got "
                         f"{nu_pre}, {nu_post}, {wdepth}")
    lanes = r.shape[0] if r.ndim == 3 else None
    if cheb_coefs is not None:
        check_schedules(name, cheb_coefs, len(coeffs), max(nu_pre, nu_post), r.device,
                        lanes)
    if r.device.type == "cpu":
        return mg_cycle_plain(r, coeffs, sids, Rs, inv_c, level_weights, nu_pre,
                              nu_post, wdepth, cheb_coefs)
    if r.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {r.device}")
    bad, B = [], lanes or 1
    if lanes is not None:
        # Lane 0's operands stand for every lane's: lanes contiguous, [B, ...].
        bad = [f"lane axis of {tuple(t.shape)}" for t in [r, inv_c, *coeffs, *sids]
               if t.ndim < 1 or t.shape[0] != B or not t.is_contiguous()]
        if bad or B * r[0].numel() > 2**31 - 1:
            raise ValueError(f"{name}: lanes need contiguous [B, ...] operands with "
                             f"B·n0·n1 < 2^31; got {'; '.join(bad) or tuple(r.shape)}")
        r0, inv0 = r[0], inv_c[0]
        coeffs, sids = [c[0] for c in coeffs], [t[0] for t in sids]
        cf0 = None if cheb_coefs is None else [c[0] for c in cheb_coefs]
    else:
        r0, inv0, cf0 = r, inv_c, cheb_coefs
    shape0 = level_shapes(coeffs)[0]
    check_cycle_operands(name, r.device, coeffs, sids, Rs, inv0,
                         [] if _ok(r0, r.device, shape0) else
                         [f"r {tuple(r.shape)} {r.dtype}"])
    lib = _build.library()
    z = torch.empty_like(r)
    lp, li, w2s, scratch = cycle_tables(coeffs, sids, Rs, level_weights, nu_pre, nu_post,
                                        wdepth, r.device, cf0, lanes=B)
    ints = [B, scratch.numel() // B] + schedule_strides(cheb_coefs, len(coeffs)) + li
    rc = call_tables(lib.fi_mg_cycle2d, [r.data_ptr(), z.data_ptr(), inv_c.data_ptr()]
                     + lp, ints, w2s, r.device)
    _build.check(rc, name)
    counter.launches += 1
    counter.cheb_launches += cheb_coefs is not None
    counter.lane_launches += lanes is not None
    return z


def fused_vcycle_2d(r, coeffs, sids, Rs, inv_c, level_weights: list[Weights],
                    nu_pre: int, nu_post: int, cheb_coefs=None) -> torch.Tensor:
    """One symmetric V-cycle z = M⁻¹ r (pallas_stencil.py:1172) in one launch.

    r: [n0, n1] float32 residual (lanes: [B, n0, n1], the module's
    docstring). coeffs[l]: the [9, n0, n1] data stencil
    (fine level; Galerkin coarse levels) or the [*shape_l] diagonal; sids[l]
    = τ_l·D_l⁻¹ (Jacobi) or D_l⁻¹ (Chebyshev, with ``cheb_coefs[l]`` the
    level's [≥ ν, 2] float32 schedule on r's device, for every level but
    the coarsest); Rs: per transition the two per-axis restriction matrices
    [n_{l+1,d}, n_{l,d}] (the transposes of ``multigrid._resize_matrix``,
    read by the kernel only over their bands); inv_c: the dense inverse of
    the coarsest operator."""
    return _cycle("fused_vcycle_2d", fused_vcycle_2d, r, coeffs, sids, Rs, inv_c,
                  level_weights, nu_pre, nu_post, 0, cheb_coefs)


def fused_wcycle_2d(r, coeffs, sids, Rs, inv_c, level_weights: list[Weights],
                    nu: int, cheb_coefs=None, wdepth: int = 99) -> torch.Tensor:
    """One symmetric W-cycle z = M⁻¹ r (pallas_stencil.py:1192) in one launch,
    ν sweeps each way, the second child visit on transitions l < ``wdepth``
    (99: every one, the textbook W). Operands as `fused_vcycle_2d`."""
    return _cycle("fused_wcycle_2d", fused_wcycle_2d, r, coeffs, sids, Rs, inv_c,
                  level_weights, nu, nu, wdepth, cheb_coefs)


fused_vcycle_2d.launches = fused_vcycle_2d.cheb_launches = fused_vcycle_2d.lane_launches = 0
fused_wcycle_2d.launches = fused_wcycle_2d.cheb_launches = fused_wcycle_2d.lane_launches = 0
