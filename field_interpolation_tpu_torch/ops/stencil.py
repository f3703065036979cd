"""Kernel 1: the fused normal-operator apply, ``(S + DᵀWD) x`` in one pass.

One CUDA kernel (``csrc/normal_apply.cu``) stands in for three TPU kernels
of ``field_interpolation_tpu/ops/pallas_stencil.py`` that compute the same
function and differ only in how they tile VMEM: ``fused_normal_apply``
(170-183, body ``_kernel_body`` 104-166), ``fused_normal_apply_striped``
(300) and ``fused_normal_apply_striped2_3d`` (1662). One thread per node,
gather form, the stencil recomputed on the fly, on 2-D and 3-D grids. On the
H100 it is bound by memory: 3^D coefficient planes per node (108 B/node in
3-D, 226 MB per apply at 128³, read from HBM). Its per-node routine
(``csrc/normal_apply.cuh``) is shared with the Jacobi sweep and PCG segment
kernels.

``fused_normal_apply`` launches the kernel for a CUDA tensor and runs
``fused_normal_apply_plain`` for a CPU tensor; nothing else decides.
``fused_normal_apply_batch`` is the same function over a leading lane axis
(the reference's ``fused_normal_apply`` under ``vmap``): one launch of the
same kernels for B fields, the lane from ``blockIdx.y`` (one field is one
lane); its plain version is
``fused_normal_apply_plain`` too, which takes lanes. Each counts its
launches in ``.launches``.
"""

from __future__ import annotations

import math

import torch

from .. import constraints as cons
from .. import stencils
from ..weights import Weights
from . import _build

_INT32_MAX = 2**31 - 1


def order_w2(weights: Weights) -> tuple[float, float, float, float]:
    """w_k² per smoothness order 0..3, 0 where the order is inactive."""
    active = weights.active_orders()
    return tuple(weights.model_weight(k) ** 2 if k in active else 0.0
                 for k in range(4))


def fused_normal_apply_plain(x: torch.Tensor, coeff: torch.Tensor,
                             weights: Weights, ndim: int) -> torch.Tensor:
    """(S + data) x with plain torch ops. ``coeff`` is the [3^D, *grid]
    stencil, or a bare [*grid] diagonal (multigrid coarse levels); lane
    axes in front of x's grid lead coeff's too ([B, *grid] with [B, 3^D,
    *grid] or [B, *grid])."""
    s = stencils.smoothness_apply(x, weights, ndim)
    if coeff.ndim == x.ndim:
        return s + coeff * x
    return s + cons.data_apply(x, coeff, ndim)


def check_operands(what: str, x: torch.Tensor, coeff: torch.Tensor, ndim: int,
                   *others: torch.Tensor) -> bool:
    """Validate the operands of a kernel built on ``csrc/normal_apply.cuh``
    and return whether the data term is diagonal (``coeff`` of the grid's
    rank, as the reference reads it). ``others`` must match x exactly."""
    if ndim not in (2, 3):
        raise ValueError(f"{what}: the CUDA kernel covers 2-D and 3-D grids, "
                         f"got ndim={ndim}")
    diag = coeff.ndim == ndim
    shape = tuple(x.shape)
    want = shape if diag else (3 ** ndim,) + shape
    tensors = (x, coeff) + others
    if (x.ndim != ndim or tuple(coeff.shape) != want
            or any(t.dtype != torch.float32 or t.device != x.device
                   or not t.is_contiguous() for t in tensors)
            or any(tuple(t.shape) != shape for t in others)):
        raise ValueError(
            f"{what}: needs contiguous float32 tensors on one device, grid "
            f"tensors of x's shape and coeff {want}; got "
            + ", ".join(f"{tuple(t.shape)} {t.dtype} on {t.device}"
                        for t in tensors))
    # Node indices are 32-bit in the kernels; 2-D channel offsets too.
    n = math.prod(shape)
    if n > _INT32_MAX or (ndim == 2 and not diag and 9 * n > _INT32_MAX):
        raise ValueError(f"{what}: grid {shape} exceeds the kernels' 32-bit "
                         "node indexing")
    return diag


def kernel_dims(shape: tuple[int, ...]) -> tuple[int, int, int, int]:
    """(ndim, n0, n1, n2) as the C entry points take them (n2 = 1 in 2-D)."""
    return (len(shape), shape[0], shape[1], shape[2] if len(shape) == 3 else 1)


def fused_normal_apply(x: torch.Tensor, coeff: torch.Tensor, weights: Weights,
                       ndim: int) -> torch.Tensor:
    """One-pass fused (S + DᵀWD) x on a 2-D or 3-D grid; the data term is
    diagonal when ``coeff`` has the grid's rank."""
    if x.device.type == "cpu":
        return fused_normal_apply_plain(x, coeff, weights, ndim)
    if x.device.type != "cuda":
        raise ValueError(f"fused_normal_apply: no kernel for device {x.device}")
    diag = check_operands("fused_normal_apply", x, coeff, ndim)
    lib = _build.library()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = lib.fi_normal_apply(x.data_ptr(), coeff.data_ptr(), out.data_ptr(), 1,
                                 *kernel_dims(tuple(x.shape)), *order_w2(weights),
                                 int(diag), _build.stream_handle(x.device))
    _build.check(rc, "fused_normal_apply")
    fused_normal_apply.launches += 1
    return out


fused_normal_apply.launches = 0


# gridDim.y's limit; csrc/normal_apply.cu takes the lane from blockIdx.y.
_MAX_LANES = 65535


def check_lanes(what: str, x: torch.Tensor, coeff: torch.Tensor, ndim: int,
                *others: torch.Tensor) -> tuple[int, bool]:
    """`check_operands` for B lanes: x [B, *grid], coeff [B, 3^D, *grid] or
    [B, *grid], ``others`` like x, all contiguous; each lane must suit the
    kernels as one field would. Returns (B, diagonal data)."""
    tensors = (x, coeff) + others
    if (x.ndim != ndim + 1 or x.shape[0] < 1
            or any(t.shape[0] != x.shape[0] or not t.is_contiguous() for t in tensors)):
        raise ValueError(f"{what}: needs contiguous lanes [B, ...] with B >= 1 on every "
                         "operand; got " + ", ".join(str(tuple(t.shape)) for t in tensors))
    return x.shape[0], check_operands(what, x[0], coeff[0], ndim, *(t[0] for t in others))


def fused_normal_apply_batch(x: torch.Tensor, coeff: torch.Tensor, weights: Weights,
                             ndim: int) -> torch.Tensor:
    """B independent fused (S + DᵀWD) x in one launch (pallas_stencil.py:170
    under vmap): x [B, *grid] with coeff [B, 3^D, *grid] (or [B, *grid],
    diagonal data), 2-D or 3-D; the Weights are shared."""
    if x.device.type == "cpu":
        return fused_normal_apply_plain(x, coeff, weights, ndim)
    if x.device.type != "cuda":
        raise ValueError(f"fused_normal_apply_batch: no kernel for device {x.device}")
    B, diag = check_lanes("fused_normal_apply_batch", x, coeff, ndim)
    if B > _MAX_LANES:
        raise ValueError(f"fused_normal_apply_batch: at most {_MAX_LANES} lanes in one "
                         f"launch (the kernel's lane is blockIdx.y), got {B}")
    lib = _build.library()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = lib.fi_normal_apply(x.data_ptr(), coeff.data_ptr(), out.data_ptr(), B,
                                       *kernel_dims(tuple(x.shape[1:])), *order_w2(weights),
                                       int(diag), _build.stream_handle(x.device))
    _build.check(rc, "fused_normal_apply_batch")
    fused_normal_apply_batch.launches += 1
    return out


fused_normal_apply_batch.launches = 0
