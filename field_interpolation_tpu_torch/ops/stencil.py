"""Kernel 1: the fused normal-operator apply, ``(S + DᵀWD) x`` in one pass.

Replaces ``field_interpolation_tpu/ops/pallas_stencil.py:fused_normal_apply``
(lines 170-183, body ``_kernel_body`` 104-166). The CUDA kernel is
``csrc/normal_apply.cu``: one thread per node, gather form, the stencil
recomputed on the fly; on the H100 it is bound by memory (nine coefficient
planes per node), and at 256² the working set sits in L2. Its per-node
routine (``csrc/normal_apply.cuh``) is shared with the PCG segment kernel.

``fused_normal_apply`` launches the kernel for a CUDA tensor and runs
``fused_normal_apply_plain`` for a CPU tensor; nothing else decides.
"""

from __future__ import annotations

import math

import torch

from .. import constraints as cons
from .. import stencils
from ..weights import Weights
from . import _build

# The reference keeps the fused path to problems whose operands fit half
# of a TPU core's VMEM (8 MB). TPU policy, kept as the same pure shape rule
# so the port takes the fused path exactly where the reference does;
# re-decided on the H100 in a later PR.
_VMEM_BUDGET_BYTES = 8 * 1024 * 1024


def fits_vmem(shape: tuple[int, ...], diag_data: bool = False) -> bool:
    """The reference's whole-array gate (pallas_stencil.py:79-96).
    ``diag_data``: the data term is a single diagonal plane (multigrid
    coarse levels) instead of 3^D channels."""
    if len(shape) < 2:
        return False
    n = math.prod(shape)
    channels = 1 if diag_data else 3 ** len(shape)
    extra = 5 if diag_data else 2
    return n * (channels + extra) * 4 <= _VMEM_BUDGET_BYTES


def order_w2(weights: Weights) -> tuple[float, float, float, float]:
    """w_k² per smoothness order 0..3, 0 where the order is inactive."""
    active = weights.active_orders()
    return tuple(weights.model_weight(k) ** 2 if k in active else 0.0
                 for k in range(4))


def fused_normal_apply_plain(x: torch.Tensor, coeff: torch.Tensor,
                             weights: Weights, ndim: int) -> torch.Tensor:
    """(S + data) x with plain torch ops. ``coeff`` is the [3^D, *grid]
    stencil, or a bare [*grid] diagonal (multigrid coarse levels)."""
    s = stencils.smoothness_apply(x, weights, ndim)
    if coeff.ndim == ndim:
        return s + coeff * x
    return s + cons.data_apply(x, coeff, ndim)


def fused_normal_apply(x: torch.Tensor, coeff: torch.Tensor, weights: Weights,
                       ndim: int) -> torch.Tensor:
    """One-pass fused (S + DᵀWD) x; the data term is diagonal when ``coeff``
    has the grid's rank (the reference reads the form off the rank too)."""
    diag = coeff.ndim == ndim
    if x.device.type == "cpu":
        return fused_normal_apply_plain(x, coeff, weights, ndim)
    if x.device.type != "cuda":
        raise ValueError(f"fused_normal_apply: no kernel for device {x.device}")
    if ndim != 2:
        raise NotImplementedError(
            "fused_normal_apply: the CUDA kernel covers 2-D grids; the 3-D "
            "apply kernels are ROADMAP queue 2 (fused_normal_apply_striped, "
            "fused_normal_apply_striped2_3d)")
    want = tuple(x.shape) if diag else (9,) + tuple(x.shape)
    if (x.ndim != 2 or x.dtype != torch.float32 or coeff.dtype != torch.float32
            or tuple(coeff.shape) != want or coeff.device != x.device
            or not x.is_contiguous() or not coeff.is_contiguous()):
        raise ValueError(
            f"fused_normal_apply: needs contiguous float32 x [n0, n1] and "
            f"coeff {want} on one device; got x {tuple(x.shape)} {x.dtype}, "
            f"coeff {tuple(coeff.shape)} {coeff.dtype} on {coeff.device}")
    lib = _build.library()
    out = torch.empty_like(x)
    w2 = order_w2(weights)
    with torch.cuda.device(x.device):
        rc = lib.fi_normal_apply(x.data_ptr(), coeff.data_ptr(), out.data_ptr(),
                                 x.shape[0], x.shape[1], *w2, int(diag),
                                 _build.stream_handle(x.device))
    _build.check(rc, "fused_normal_apply")
    fused_normal_apply.launches += 1
    return out


fused_normal_apply.launches = 0
