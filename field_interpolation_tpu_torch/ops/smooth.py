"""Kernel 3: damped-Jacobi smoothing, ``z ← z + sid·(r − A z)``.

One CUDA kernel (``csrc/jacobi_sweep.cu``, one sweep per launch) stands in
for two TPU kernels of ``field_interpolation_tpu/ops/pallas_stencil.py``:

* `fused_smooth` — ``fused_smooth`` in its Jacobi form (513 → 559): ν sweeps
  on a level, 2-D or 3-D, full 3^D-channel or diagonal data term, launched
  as ν sweeps of the kernel;
* `fused_sweep` — ``fused_sweep_striped2_3d`` (1813): ONE sweep with a
  diagonal data term (the lumped fine level of a large 3-D grid), which is
  `fused_smooth` with one sweep from z.

The TPU kernels update z in place inside one program; across CUDA blocks an
in-place sweep would race, so the sweeps ping-pong two buffers and the
launch boundary is the barrier between sweeps. On the H100 a sweep is bound
by memory (r, sid, z and the data term per node). `fused_smooth` launches
the kernel for CUDA tensors and runs `fused_smooth_plain` for CPU tensors,
and counts every launch of the kernel in ``fused_smooth.launches`` (the
launches of `fused_sweep` included). Chebyshev smoothing
(pallas_stencil.py:537) is not ported (ROADMAP.md).
"""

from __future__ import annotations

import torch

from ..weights import Weights
from . import _build
from .stencil import (check_operands, fused_normal_apply_plain, kernel_dims,
                      order_w2)


def fused_smooth_plain(r: torch.Tensor, z: torch.Tensor, coeff: torch.Tensor,
                       scaled_inv_diag: torch.Tensor, weights: Weights,
                       ndim: int, sweeps: int,
                       from_zero: bool = False) -> torch.Tensor:
    """``sweeps`` damped-Jacobi sweeps in plain torch ops, with the
    reference kernel's semantics (pallas_stencil.py:547-557): with
    ``from_zero`` the first sweep is z = sid·r (z is not read) and counts as
    one of the ``sweeps``, so 0 sweeps from zero still return sid·r."""
    if from_zero:
        out, n = scaled_inv_diag * r, sweeps - 1
    else:
        out, n = z, sweeps
    for _ in range(n):
        out = out + scaled_inv_diag * (
            r - fused_normal_apply_plain(out, coeff, weights, ndim))
    return out


def fused_smooth(r: torch.Tensor, z: torch.Tensor, coeff: torch.Tensor,
                 scaled_inv_diag: torch.Tensor, weights: Weights, ndim: int,
                 sweeps: int, from_zero: bool = False) -> torch.Tensor:
    """``sweeps`` damped-Jacobi sweeps on (S + data) z = r, one kernel launch
    per sweep into the other of two buffers. ``scaled_inv_diag`` = τ·D⁻¹;
    ``coeff`` is the [3^D, *grid] data stencil or a [*grid] diagonal (read
    off the rank). With ``from_zero`` the first launch reads no z. Semantics
    of `fused_smooth_plain`."""
    if sweeps < 0:
        raise ValueError(f"fused_smooth: sweeps must be >= 0, got {sweeps}")
    if r.device.type == "cpu":
        return fused_smooth_plain(r, z, coeff, scaled_inv_diag, weights, ndim,
                                  sweeps, from_zero)
    if r.device.type != "cuda":
        raise ValueError(f"fused_smooth: no kernel for device {r.device}")
    count = max(sweeps, 1) if from_zero else sweeps
    if count == 0:
        return z
    diag = check_operands("fused_smooth", r, coeff, ndim, z, scaled_inv_diag)
    lib = _build.library()
    bufs = [torch.empty_like(r) for _ in range(min(count, 2))]
    dims = kernel_dims(tuple(r.shape))
    w2 = order_w2(weights)
    stream = _build.stream_handle(r.device)
    src = None if from_zero else z
    with torch.cuda.device(r.device):
        for k in range(count):
            dst = bufs[k % 2]
            rc = lib.fi_jacobi_sweep(r.data_ptr(),
                                     None if src is None else src.data_ptr(),
                                     coeff.data_ptr(), scaled_inv_diag.data_ptr(),
                                     dst.data_ptr(), *dims, *w2, int(diag), stream)
            _build.check(rc, "fused_smooth")
            fused_smooth.launches += 1
            src = dst
    return src


def fused_sweep(r: torch.Tensor, z: torch.Tensor, cdiag: torch.Tensor,
                scaled_inv_diag: torch.Tensor, weights: Weights) -> torch.Tensor:
    """ONE damped-Jacobi sweep z + sid·(r − (S + diag cdiag) z): the
    counterpart of ``fused_sweep_striped2_3d``, run as `fused_smooth` with
    one sweep from z (its plain version is `fused_smooth_plain` likewise).
    The grid's rank is z's."""
    if cdiag.ndim != z.ndim:
        raise ValueError(f"fused_sweep: cdiag must be a [*grid] diagonal, got "
                         f"{tuple(cdiag.shape)} for grid {tuple(z.shape)}")
    return fused_smooth(r, z, cdiag, scaled_inv_diag, weights, z.ndim, 1)


fused_smooth.launches = 0
