"""Kernels 3 and 4: multigrid smoothing, damped Jacobi or Chebyshev.

    damped Jacobi:  z ← z + sid·(r − A z)                          (sid = τ·D⁻¹)
    Chebyshev:      z ← z + c1_k·(z − z_prev) + c2_k·sid·(r − A z)  (sid = D⁻¹)

with (c1_k, c2_k) row k of a [ν, 2] schedule (``multigrid.chebyshev_coefs``)
that stays on the device: the kernels read it there, so a Chebyshev phase
copies nothing to the host. Two CUDA kernels stand in for the smoothers of
``field_interpolation_tpu/ops/pallas_stencil.py``, each with both modes.

``csrc/jacobi_sweep.cu``, one host call per smoothing phase:

* `fused_smooth` — ``fused_smooth`` (513) in its Jacobi form (→ 559) and
  its Chebyshev form (→ 537): ν sweeps on a level, 2-D or 3-D, and on
  request the level's residual r − A z after them, all enqueued by one call
  into the library (one launch per sweep that reads neighbours, one for the
  residual); the multigrid cycle sends it the diagonal-data levels and 3-D
  full-data levels, the Chebyshev mode included where the reference runs
  Jacobi launches plus XLA axpys (1813, 1959), and takes the residual it
  restricts from the pre-smoothing call;
* `fused_sweep` — ``fused_sweep_striped2_3d`` (1813) and
  ``fused_sweep_striped_diag`` (1959): ONE damped-Jacobi sweep with a
  diagonal data term (the lumped fine level of a large 3-D grid; the
  1024²/2048² coarse levels of a large 2-D grid), which is `fused_smooth`
  with one sweep from z.

``csrc/jacobi_multisweep2d.cu``, one host call per smoothing phase:

* `fused_smooth_2d` — ``fused_smooth_striped`` (653) and
  ``fused_smooth_tiled`` (876), each with its Chebyshev mode, and the 2-D
  full-data form of ``fused_smooth`` (513): ν sweeps on a 2-D level with the
  9-channel data term and on request the residual after them, each block
  streaming a strip of rows through shared memory with every sweep a stage
  a few rows behind the last, so the coefficients come from memory once per
  smoothing phase; the multigrid cycle takes the residual it restricts from
  the pre-smoothing call.

The TPU kernels update z in place inside one program; across CUDA blocks an
in-place sweep would race, so in `fused_smooth` the sweeps ping-pong two
buffers and the launch boundary is the barrier between sweeps; in
`fused_smooth_2d` each stage keeps its own z in shared memory. Chebyshev's
z_prev rides in the buffer that z⁺ overwrites (per-sweep kernel) or is the
z two stages back (multi-sweep kernel).
On the H100 both kernels are bound by memory. Each wrapper launches its
kernel for CUDA tensors and runs `fused_smooth_plain` for CPU tensors, and
counts its launches in ``fused_smooth.launches`` (the launches of
`fused_sweep` included) and ``fused_smooth_2d.launches``, those in
Chebyshev mode also in ``.cheb_launches``.
"""

from __future__ import annotations

import ctypes

import torch

from ..stencils import max_stencil_radius
from ..weights import Weights
from . import _build
from .stencil import (check_operands, fused_normal_apply_plain, kernel_dims,
                      order_w2)


def check_schedule(what: str, cf, rows: int, device) -> None:
    """Raise ValueError unless ``cf`` is a Chebyshev schedule for ``rows``
    sweeps: a contiguous float32 [≥ rows, 2] tensor on ``device``."""
    if not (isinstance(cf, torch.Tensor) and cf.ndim == 2 and cf.shape[1] == 2
            and cf.shape[0] >= rows and cf.dtype == torch.float32
            and cf.device == torch.device(device) and cf.is_contiguous()):
        got = (f"{tuple(cf.shape)} {cf.dtype} on {cf.device}"
               if isinstance(cf, torch.Tensor) else type(cf).__name__)
        raise ValueError(f"{what}: a Chebyshev schedule must be a contiguous float32 "
                         f"[>= {rows}, 2] tensor on {device}; got {got}")


def fused_smooth_plain(r: torch.Tensor, z: torch.Tensor, coeff: torch.Tensor,
                       scaled_inv_diag: torch.Tensor, weights: Weights,
                       ndim: int, sweeps: int, from_zero: bool = False,
                       cheb_coefs: torch.Tensor | None = None,
                       residual: bool = False):
    """``sweeps`` smoothing sweeps in plain torch ops, with the reference
    kernel's semantics. Damped Jacobi (pallas_stencil.py:547-557): with
    ``from_zero`` the first sweep is z = sid·r (z is not read) and counts as
    one of the ``sweeps``, so 0 sweeps from zero still return sid·r.
    Chebyshev (``cheb_coefs``, the [ν, 2] schedule; _cheb_inplace 483-507):
    from zero, z = c2_0·sid·r with z_prev = 0 and 0 sweeps return zeros;
    from z, z_prev = z, so the c1 term of the first sweep vanishes. With
    ``residual``, returns (z, r − A z). Lanes ([B, *grid] arrays, [B, 3^D,
    *grid] or [B, *grid] coefficients) smooth each on its own, under
    [B, ν, 2] schedules."""
    out = _smooth_plain(r, z, coeff, scaled_inv_diag, weights, ndim, sweeps, from_zero,
                        cheb_coefs)
    if residual:
        return out, r - fused_normal_apply_plain(out, coeff, weights, ndim)
    return out


def _schedule_entry(cf: torch.Tensor, k: int, j: int, ndim: int) -> torch.Tensor:
    """cf[k, j] of a [ν, 2] schedule; of lanes' [B, ν, 2] schedules, the
    lanes' entries shaped to scale their [B, *grid] arrays."""
    if cf.ndim == 2:
        return cf[k, j]
    return cf[..., k, j].reshape(cf.shape[:-2] + (1,) * ndim)


def _smooth_plain(r, z, coeff, scaled_inv_diag, weights, ndim, sweeps, from_zero,
                  cheb_coefs):
    if cheb_coefs is not None:
        def cf(k, j):
            return _schedule_entry(cheb_coefs, k, j, ndim)
        if from_zero:
            if sweeps == 0:
                return torch.zeros_like(r)
            out, prev, start = cf(0, 1) * (scaled_inv_diag * r), torch.zeros_like(r), 1
        else:
            out, prev, start = z, z, 0
        for k in range(start, sweeps):
            az = fused_normal_apply_plain(out, coeff, weights, ndim)
            out, prev = out + (cf(k, 0) * (out - prev)
                               + cf(k, 1) * (scaled_inv_diag * (r - az))), out
        return out
    if from_zero:
        out, n = scaled_inv_diag * r, sweeps - 1
    else:
        out, n = z, sweeps
    for _ in range(n):
        out = out + scaled_inv_diag * (
            r - fused_normal_apply_plain(out, coeff, weights, ndim))
    return out


def _smoothing_call(name, launch, r, z, coeff, scaled_inv_diag, weights, ndim,
                    sweeps, from_zero, cheb_coefs, residual=False):
    """The part both kernel wrappers share: the checks of the counts and
    the schedule, the plain version for CPU tensors; for CUDA tensors the
    sweeps to run (a Jacobi from-zero step counts as one, so it runs even
    at 0), the operand checks, and ``launch(count, diag, lib, w2, stream)``
    on r's device. With ``residual`` the result is (z, r − A z)."""
    if sweeps < 0:
        raise ValueError(f"{name}: sweeps must be >= 0, got {sweeps}")
    if cheb_coefs is not None:
        check_schedule(name, cheb_coefs, sweeps, r.device)
    if r.device.type == "cpu":
        return fused_smooth_plain(r, z, coeff, scaled_inv_diag, weights, ndim,
                                  sweeps, from_zero, cheb_coefs, residual)
    if r.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {r.device}")
    if cheb_coefs is not None and from_zero and sweeps == 0:
        zero = torch.zeros_like(r)
        return (zero, r) if residual else zero
    count = max(sweeps, 1) if from_zero and cheb_coefs is None else sweeps
    if count == 0 and not residual:
        return z
    diag = check_operands(name, r, coeff, ndim, z, scaled_inv_diag)
    with torch.cuda.device(r.device):
        return launch(count, diag, _build.library(), order_w2(weights),
                      _build.stream_handle(r.device))


def _ptr(t):
    return None if t is None else t.data_ptr()


def fused_smooth(r: torch.Tensor, z: torch.Tensor, coeff: torch.Tensor,
                 scaled_inv_diag: torch.Tensor, weights: Weights, ndim: int,
                 sweeps: int, from_zero: bool = False,
                 cheb_coefs: torch.Tensor | None = None, residual: bool = False):
    """``sweeps`` damped-Jacobi sweeps, or Chebyshev sweeps on the schedule
    ``cheb_coefs``, on (S + data) z = r, in one call into the library: one
    kernel launch per sweep that reads neighbours, out of place into the
    other of two buffers (the from-zero step reads none and is computed by
    the next launch), and with ``residual`` one more that writes r − A z;
    the result is then (z, r − A z). ``scaled_inv_diag`` = τ·D⁻¹ (Jacobi)
    or D⁻¹ (Chebyshev); ``coeff`` is the [3^D, *grid] data stencil or a
    [*grid] diagonal (read off the rank). Semantics of
    `fused_smooth_plain`."""
    def launch(count, diag, lib, w2, stream):
        # Sweeps that read neighbours: the from-zero step rides on the next.
        steps = count - (1 if from_zero else 0)
        zout = torch.empty_like(r) if count else None
        tmp = torch.empty_like(r) if steps >= 2 else None
        res = torch.empty_like(r) if residual else None
        launches = ctypes.c_int(0)
        rc = lib.fi_smooth_phase(r.data_ptr(), None if from_zero else z.data_ptr(),
                                 coeff.data_ptr(), scaled_inv_diag.data_ptr(), _ptr(zout),
                                 _ptr(tmp), _ptr(res), *kernel_dims(tuple(r.shape)), *w2,
                                 int(diag), _ptr(cheb_coefs), count, int(from_zero),
                                 ctypes.byref(launches), stream)
        fused_smooth.launches += launches.value
        if cheb_coefs is not None:
            fused_smooth.cheb_launches += launches.value
        _build.check(rc, "fused_smooth")
        out = z if zout is None else zout
        return (out, res) if residual else out
    return _smoothing_call("fused_smooth", launch, r, z, coeff, scaled_inv_diag,
                           weights, ndim, sweeps, from_zero, cheb_coefs, residual)


def fused_sweep(r: torch.Tensor, z: torch.Tensor, cdiag: torch.Tensor,
                scaled_inv_diag: torch.Tensor, weights: Weights,
                residual: bool = False):
    """ONE damped-Jacobi sweep z + sid·(r − (S + diag cdiag) z): the
    counterpart of ``fused_sweep_striped2_3d`` (3-D) and
    ``fused_sweep_striped_diag`` (2-D), run as `fused_smooth` with one sweep
    from z (its plain version is `fused_smooth_plain` likewise), with
    ``residual`` as there. The grid's rank is z's."""
    if cdiag.ndim != z.ndim:
        raise ValueError(f"fused_sweep: cdiag must be a [*grid] diagonal, got "
                         f"{tuple(cdiag.shape)} for grid {tuple(z.shape)}")
    return fused_smooth(r, z, cdiag, scaled_inv_diag, weights, z.ndim, 1,
                        residual=residual)


def multisweep_max_halo() -> int:
    """The halo, in nodes, that one launch of csrc/jacobi_multisweep2d.cu
    reads on each side: a launch takes as many neighbour-reading stages
    (sweeps, then the residual) as keep stages·ρ within it. Read from the
    library, which holds the one copy of the number."""
    return _build.library().fi_multisweep2d_max_halo()


def fused_smooth_2d(r: torch.Tensor, z: torch.Tensor, coeff: torch.Tensor,
                    scaled_inv_diag: torch.Tensor, weights: Weights,
                    sweeps: int, from_zero: bool = False,
                    cheb_coefs: torch.Tensor | None = None, residual: bool = False):
    """``sweeps`` damped-Jacobi sweeps, or Chebyshev sweeps on the schedule
    ``cheb_coefs``, on (S + data) z = r on a 2-D grid with the [9, n0, n1]
    data stencil, and with ``residual`` the level's r − A z after them (the
    result is then (z, r − A z)), in one call into the library
    (``csrc/jacobi_multisweep2d.cu``): the counterpart of
    ``fused_smooth_striped``, ``fused_smooth_tiled`` and the 2-D full-data
    ``fused_smooth``. A launch runs as many neighbour-reading stages as fit
    its halo (`multisweep_max_halo`, in nodes, over the operator radius ρ),
    so a longer phase (more than 8 nodes from z at ρ = 2, the residual
    counting as a stage) is several launches, each handing the next its z
    and, under Chebyshev, z_prev. Semantics of `fused_smooth_plain`,
    ``from_zero`` included."""
    def launch(count, diag, lib, w2, stream):
        if diag:
            raise ValueError("fused_smooth_2d: needs the [9, n0, n1] data stencil; "
                             "a diagonal data term goes through fused_smooth")
        # The library splits the phase into launches and uses tmp (and,
        # under Chebyshev, the two z_prev buffers) only where it does.
        zout = torch.empty_like(r) if count else None
        tmp = torch.empty_like(r)
        prev = [torch.empty_like(r) if cheb_coefs is not None else None for _ in range(2)]
        res = torch.empty_like(r) if residual else None
        launches = ctypes.c_int(0)
        rc = lib.fi_multisweep2d_phase(
            r.data_ptr(), None if from_zero else z.data_ptr(), coeff.data_ptr(),
            scaled_inv_diag.data_ptr(), _ptr(zout), _ptr(tmp), *map(_ptr, prev), _ptr(res),
            *r.shape, *w2, max(max_stencil_radius(weights), 1), _ptr(cheb_coefs), count,
            int(from_zero), ctypes.byref(launches), stream)
        fused_smooth_2d.launches += launches.value
        if cheb_coefs is not None:
            fused_smooth_2d.cheb_launches += launches.value
        _build.check(rc, "fused_smooth_2d")
        out = z if zout is None else zout
        return (out, res) if residual else out
    return _smoothing_call("fused_smooth_2d", launch, r, z, coeff, scaled_inv_diag,
                           weights, 2, sweeps, from_zero, cheb_coefs, residual)


fused_smooth.launches = fused_smooth.cheb_launches = 0
fused_smooth_2d.launches = fused_smooth_2d.cheb_launches = 0
